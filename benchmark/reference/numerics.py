"""How the reference rounds a weight or an activation before a product.

``Exact`` uses the values as given, in f32.  ``PerChannel(bits)`` is
weight-only integer quantization per output channel, as served:
s = max|w| / (2^(bits-1) - 1) over the input dimension (at least 1e-12),
q = round(w / s) (half to even) clipped to the range, in f32, and the
product uses q * s.  With 8 bits that is the int8 configuration's own
arithmetic; with 4 it is the int8 configuration's control.  ``Fp8``
computes each product as fp8 training does: the weight per output
channel and the activation per row rounded to float8 e4m3 (largest
magnitude scaled to 448), and in the backward the incoming gradient per
row rounded to float8 e5m2 (largest magnitude scaled to 57344) before
both of its products.

Only the large products' weights and the token table are rounded
(``QUANT_KEYS``); norms, biases and position tables stay as given.  A
rounding's gradient is taken as the identity (straight through), so the
training reference can run under any of them.
"""

from __future__ import annotations

import torch

QUANT_KEYS = frozenset({
    "attn_qkv_w", "attn_proj_w", "mlp_w1", "mlp_w2", "mlp_proj_w", "mlp_fc_w", "lm_head",
    "wte", "patch_w", "kv_proj_w", "attn_q_w", "attn_k_w", "attn_v_w", "attn_out_w", "proj",
})
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


class Exact:
    name = "exact"

    def matmul(self, x: torch.Tensor, key: str, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ self.weight(key, w)

    def weight(self, key: str, w: torch.Tensor) -> torch.Tensor:
        return w.float()

    def table_scale(self, key: str, table: torch.Tensor):
        return None

    def rows(self, key: str, rows: torch.Tensor, scale) -> torch.Tensor:
        return rows.float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _straight(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded``'s value with ``x``'s gradient."""
    xf = x.float()
    return rounded if not xf.requires_grad else xf + (rounded - xf).detach()


def _channel_scale(w: torch.Tensor, top: float) -> torch.Tensor:
    """Per output channel (last axis) scale over the input axis (-2),
    taken in row blocks so a large table needs no f32 copy of itself."""
    amax = torch.zeros(w.shape[-1], dtype=torch.float32, device=w.device)
    flat = w.reshape(-1, w.shape[-1])
    for r in range(0, flat.shape[0], 8192):
        amax = torch.maximum(amax, flat[r:r + 8192].float().abs().amax(0))
    return (amax / top).clamp_min(1e-12)


class PerChannel(Exact):
    def __init__(self, bits: int):
        self.bits, self.top = bits, float(2 ** (bits - 1) - 1)
        self.name = f"int{bits}_per_channel"

    def _round(self, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            r = torch.round(w.float() / s).clamp_(-self.top, self.top) * s
        return _straight(w, r)

    def weight(self, key: str, w: torch.Tensor) -> torch.Tensor:
        if key not in QUANT_KEYS:
            return w.float()
        return self._round(w, _channel_scale(w, self.top))

    def table_scale(self, key: str, table: torch.Tensor):
        return _channel_scale(table, self.top) if key in QUANT_KEYS else None

    def rows(self, key: str, rows: torch.Tensor, scale) -> torch.Tensor:
        return rows.float() if scale is None else self._round(rows, scale)


def _fp8(x: torch.Tensor, dtype, top: float, dim: int) -> torch.Tensor:
    s = (x.abs().amax(dim, keepdim=True) / top).clamp_min(1e-12)
    return (x / s).to(dtype).float() * s


class _Fp8Product(torch.autograd.Function):
    """x [..., K] @ w [K, N] with both operands in e4m3 and, backward, the
    incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, x, w):
        xq = _fp8(x.float(), torch.float8_e4m3fn, FP8_MAX, -1)
        wq = _fp8(w.float(), torch.float8_e4m3fn, FP8_MAX, -2)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g.float(), torch.float8_e5m2, FP8_E5M2_MAX, -1)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


class Fp8:
    name = "fp8_e4m3"

    def matmul(self, x: torch.Tensor, key: str, w: torch.Tensor) -> torch.Tensor:
        if key not in QUANT_KEYS:
            return x @ w.float()
        return _Fp8Product.apply(x, w.float())

    @staticmethod
    def _round(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            r = (x.float() / s).to(torch.float8_e4m3fn).float() * s
        return _straight(x, r)

    def table_scale(self, key: str, table: torch.Tensor):
        return _channel_scale(table, FP8_MAX) if key in QUANT_KEYS else None

    def rows(self, key: str, rows: torch.Tensor, scale) -> torch.Tensor:
        return rows.float() if scale is None else self._round(rows, scale)



def named(name: str):
    """The numerics a configuration file or a limits file names."""
    if name in ("bfloat16", "float32", "exact"):
        return Exact()
    if name.startswith("int") and name.endswith("_per_channel"):
        return PerChannel(int(name[3:name.index("_")]))
    if name == "fp8_e4m3":
        return Fp8()
    raise ValueError(f"unknown numerics {name!r}")
