"""Plain f32 reference of the text-only fine-tune step: masked next-token
cross entropy, its gradient, optax's global-norm clip at 1.0 and AdamW
(b1 0.9, b2 0.95, eps 1e-8, weight decay 0.01, constant learning rate),
followed for a few steps from the initial weights.

The model is ``qwen_vl.Model``'s decoder with the LM head.  The loss and
the gradient are formed a block at a time: the forward keeps each
block's input, the backward replays one block with autograd and carries
the gradient down, and the head's logits are formed a row of the batch
at a time.  A step's gradient is summed into its global norm in f32 and
kept, per leaf, as bf16; the parameters of any step are worked out from
the initial bf16 weights and that history, leaf by leaf, in f32.  So the
card holds the initial weights and one bf16 gradient per step followed
(15.4 GB each at the full width) instead of an f32 copy of the
parameters and both moments (92.7 GB).  Keeping the history in bf16
rounds each past gradient by at most 2^-9 of itself, far below the
program's own bf16 rounding of its moments.

Leaves are the program's optimizer leaves: ``wte``, ``ln_f``,
``lm_head`` and each layer's slice of every stacked weight, named
``layers/<name>/<i>``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.qwen_vl import Model, rms_norm

B1, B2, EPS, WEIGHT_DECAY, CLIP = 0.9, 0.95, 1e-8, 0.01, 1.0
CHUNK = 1 << 26  # elements a leaf is replayed in at once


def leaf_names(p0: dict, n_layers: int) -> list[str]:
    names = ["wte"]
    for w in p0["layers"]:
        names += [f"layers/{w}/{i}" for i in range(n_layers)]
    return names + ["ln_f", "lm_head"]


def _initial(p0: dict, name: str) -> torch.Tensor:
    if name.startswith("layers/"):
        _, w, i = name.split("/")
        return p0["layers"][w][int(i)]
    return p0[name]


class TrainReference:
    """Follows ``steps`` of the fine-tune from ``p0`` (bf16 weights, the
    benchmark's tree without the visual tower)."""

    def __init__(self, p0: dict, md, numerics, lr: float):
        self.p0, self.md, self.num, self.lr = p0, md, numerics, lr
        self.names = leaf_names(p0, md.layers)
        self.history: list[tuple[dict, float]] = []  # (bf16 gradient per leaf, clip factor)
        self.losses: list[float] = []
        self.grad_norms: list[dict] = []

    # --- parameters at the current step -------------------------------
    def _replay(self, p0: torch.Tensor, grads: list, steps: int) -> torch.Tensor:
        """One leaf's f32 value after ``steps`` AdamW updates."""
        p = p0.to(torch.float32, copy=True).reshape(-1)
        if steps == 0:
            return p.reshape(p0.shape)
        out = torch.empty_like(p)
        lr = self.lr
        for s in range(0, p.numel(), CHUNK):
            x = p[s:s + CHUNK].clone()
            m = torch.zeros_like(x)
            v = torch.zeros_like(x)
            for t in range(1, steps + 1):
                g, c = grads[t - 1]
                g = g.reshape(-1)[s:s + CHUNK].float() * c
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).addcmul_(g, g, value=1 - B2)
                x.mul_(1 - lr * WEIGHT_DECAY)
                x.sub_(lr * (m / (1 - B1 ** t)) / ((v / (1 - B2 ** t)).sqrt() + EPS))
            out[s:s + CHUNK] = x
        return out.reshape(p0.shape)

    def param(self, name: str) -> torch.Tensor:
        steps = len(self.history)
        return self._replay(_initial(self.p0, name),
                            [(h[name], c) for h, c in self.history], steps)

    def _layer(self, i: int, grad: bool) -> dict:
        out = {}
        for w in self.p0["layers"]:
            t = self.param(f"layers/{w}/{i}")
            out[w] = t.requires_grad_(grad)
        return out

    # --- one step -----------------------------------------------------
    def step(self, ids: torch.Tensor, attn_mask: torch.Tensor) -> float:
        """The loss at the current parameters; its gradient joins the
        history.  Returns the loss."""
        md, eps = self.md, 1e-6
        grads: dict[str, torch.Tensor] = {}
        norms: dict[str, torch.Tensor] = {}

        def keep(name, g):
            norms[name] = g.float().norm()
            grads[name] = g.to(torch.bfloat16)

        positions = torch.arange(ids.shape[1], device=ids.device)
        wte = self.param("wte")
        model = Model({}, md, self.num, eps)
        xs = []
        with torch.no_grad():
            x = model.num.rows("wte", wte[ids], model.num.table_scale("wte", wte))
            for i in range(md.layers):
                xs.append(x)
                x = model.block(x, self._layer(i, False), positions, attn_mask)
        targets = ids[:, 1:]
        tmask = (attn_mask[:, 1:] > 0).float()
        n_tok = tmask.sum().clamp_min(1.0)
        ln_f = self.param("ln_f").requires_grad_(True)
        head = self.param("lm_head").requires_grad_(True)
        top = x.requires_grad_(True)
        loss = torch.zeros((), dtype=torch.float32, device=ids.device)
        for r in range(ids.shape[0]):  # one row of the batch at a time
            h = rms_norm(top[r, :-1], ln_f, eps)
            logits = model.num.matmul(h, "lm_head", head)
            ce = F.cross_entropy(logits, targets[r], reduction="none")
            part = (ce * tmask[r]).sum() / n_tok
            part.backward()
            loss += part.detach()
            del logits, ce, part
        keep("ln_f", ln_f.grad)
        keep("lm_head", head.grad)
        del ln_f, head
        dx = top.grad
        for i in reversed(range(md.layers)):
            layer = self._layer(i, True)
            xin = xs[i].requires_grad_(True)
            out = model.block(xin, layer, positions, attn_mask)
            out.backward(dx)
            for w, t in layer.items():
                keep(f"layers/{w}/{i}", t.grad)
            dx = xin.grad
            xs[i] = None
            del layer, xin, out
        g_wte = torch.zeros_like(wte)
        g_wte.index_put_((ids.reshape(-1),), dx.reshape(-1, dx.shape[-1]), accumulate=True)
        keep("wte", g_wte)
        del g_wte, wte, dx
        leaf_norms = {name: float(norms[name]) for name in self.names}
        norm = sum(n * n for n in leaf_norms.values()) ** 0.5
        self.grad_norms.append(leaf_norms)
        self.history.append((grads, 1.0 if norm < CLIP else CLIP / norm))
        self.losses.append(float(loss))
        return self.losses[-1]

    def first_update_norms(self) -> dict:
        """Per leaf, the norm of the first gradient as the optimizer gets
        it (clipped)."""
        c = self.history[0][1]
        return {name: n * c for name, n in self.grad_norms[0].items()}

    def change_norms(self) -> dict:
        """Per leaf, the norm of the parameters' change over the steps
        followed."""
        out = {}
        for name in self.names:
            p0 = _initial(self.p0, name)
            out[name] = float((self.param(name) - p0.float()).norm())
        return out
