"""The expert layer of a mixture of experts (DeepSeek-V3's, as Kimi-VL's
decoder runs it): route, dispatch, the grouped products, combine.

tdax has no expert layer and no Pallas kernel for one; this module
replaces none.  For T tokens of width H, E experts of width F and k
experts a token:

- ``route``: s = sigmoid(h W_g) in f32 [T, E]; the k experts of largest
  s + bias (the correction bias picks, ties to the lower index); their
  weights are their s, without the bias, normalised to sum 1 (+1e-20)
  and multiplied by ``scale`` (DeepSeek-V3's ``noaux_tc`` with one
  group, ``norm_topk_prob``, ``routed_scaling_factor``).
- ``dispatch``: the T k (token, expert) pairs sorted by expert (stable, so
  each expert's rows keep token order), the device-side int32 ends of
  each expert's rows, and the rows' tokens.
- ``experts``: the grouped products over all experts at once: gate and
  up as one product with each expert's [H, 2F] weights, SiLU(gate) *
  up, then down with its [F, H] weights.  On the card each product is
  one ``torch._grouped_mm`` launch (CUTLASS's grouped GEMM on sm90: one
  launch over the E groups, each its own rows); on the CPU the plain
  version loops over the experts (``grouped_mm_plain``).
- ``combine``: each pair's output weighted and summed back per token in
  f32, in the order of the token's k choices: no atomics, so a run is
  deterministic.

On the card nothing in the layer waits for the host: the sorts, the
per-expert counts (a scatter-add into E slots), their cumulative ends and
the gathers all stay on the device, and no tensor is sized by a count.
What bounds it on an H100 at Kimi-VL's capture (16 x 320 tokens, 64
experts of 1408, top 6): each layer's grouped products are 0.53 TFLOP
(0.54 ms at 989 TFLOP/s) against 1.11 GB of expert weights (0.33 ms at
3.35 TB/s), so the tensor cores, with about 480 rows an expert.

``GROUPED_LAUNCHES`` counts grouped launches on the card (two a layer).
While a profiler records (``utils.log.recording``), ``LOAD`` tallies the
routed rows of each expert of each layer on the device, with no sync;
``LOAD.take()`` reads them back once.  Inside ``PICKS.record()`` each
layer keeps its picked experts on the device; ``PICKS.take()`` reads
them back once.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from tdax_torch.utils.log import recording, span

GROUPED_LAUNCHES = 0


class ExpertLoad:
    """Routed rows per expert, per layer, summed on the device over the
    batches a profiler recorded."""

    def __init__(self):
        self.counts: dict[int, torch.Tensor] = {}

    def add(self, layer: int, counts: torch.Tensor) -> None:
        held = self.counts.get(layer)
        self.counts[layer] = counts.to(torch.int64) if held is None else held + counts

    def take(self) -> dict[int, list[int]]:
        """Every layer's tally (one read back to the host), then none."""
        out = {layer: c.tolist() for layer, c in sorted(self.counts.items())}
        self.counts = {}
        return out


LOAD = ExpertLoad()


class Picks:
    """Each layer's picked experts [T, k], kept on the device (no sync)
    while ``record()`` is open; nothing is kept outside it."""

    def __init__(self):
        self.on = False
        self.picked: dict[int, torch.Tensor] = {}

    @contextlib.contextmanager
    def record(self):
        self.on, self.picked = True, {}
        try:
            yield self
        finally:
            self.on = False

    def add(self, layer: int, picked: torch.Tensor) -> None:
        if self.on:
            self.picked[layer] = picked

    def take(self) -> dict[int, torch.Tensor]:
        """Every layer's picks on the CPU, then none."""
        out = {layer: p.cpu() for layer, p in sorted(self.picked.items())}
        self.picked = {}
        return out


PICKS = Picks()


def balance(load: dict[int, list[int]]) -> dict[int, dict[str, float]]:
    """Per layer: the busiest and the idlest expert's rows over the mean."""
    out = {}
    for layer, counts in load.items():
        mean = sum(counts) / len(counts)
        if mean > 0:
            out[layer] = {"max_over_mean": max(counts) / mean, "min_over_mean": min(counts) / mean}
    return out


def route(h: torch.Tensor, w_gate: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """h [T, H], w_gate [H, E], bias [E] -> (experts [T, k] int64 in order of
    choice, weights [T, k] f32)."""
    s = torch.sigmoid(h.float() @ w_gate.float())
    choice = s + bias.float()
    picked = torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, :top_k]
    w = s.gather(1, picked)
    return picked, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale


def dispatch(picked: torch.Tensor, n_experts: int):
    """(order, ends, tokens, counts): the pairs (flattened token-major, t k
    + j) sorted by expert, each expert's int32 end in that order, each
    sorted pair's token, and each expert's rows."""
    flat = picked.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(n_experts, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    return order, ends, order // picked.shape[1], counts


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """x [N, K] rows sorted by group, w [G, K, M], ends [G] -> [N, M]: each
    group's rows times its weights, one product per group (the plain
    version of the grouped launch)."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    start = 0
    for g, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[g]
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``grouped_mm_plain``'s function: one ``torch._grouped_mm`` launch on
    the card (bf16), the per-group loop on the CPU."""
    global GROUPED_LAUNCHES
    if not x.is_cuda:
        return grouped_mm_plain(x, w, ends)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"grouped_mm: the card's grouped product takes bf16, got {x.dtype}, "
                        f"{w.dtype}")
    out = torch._grouped_mm(x, w, offs=ends)
    GROUPED_LAUNCHES += 1
    return out


def experts(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
            ends: torch.Tensor) -> torch.Tensor:
    """Each row through its expert's SwiGLU: down(SiLU(gate) * up), gate
    and up the two halves of one grouped product."""
    gu = grouped_mm(x, gate_up, ends)
    gate, up = gu.chunk(2, dim=-1)
    return grouped_mm(F.silu(gate) * up, down, ends)


def combine(y: torch.Tensor, order: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """y [T k, H] in dispatch order -> [T, H] in y's type: each pair's row
    back in its place, weighted, summed over the token's k choices in
    f32."""
    t, k = weights.shape
    pairs = torch.empty_like(y).index_copy_(0, order, y)
    return (pairs.view(t, k, -1).float() * weights[..., None]).sum(dim=1).to(y.dtype)


def moe(h: torch.Tensor, layer: dict, top_k: int, scale: float, layer_index: int) -> torch.Tensor:
    """The routed experts' share of an expert FFN: h [T, H] -> [T, H].
    ``layer`` holds ``router_w`` [H, E], ``router_bias`` [E],
    ``experts_gate_up`` [E, H, 2F] and ``experts_down`` [E, F, H].  The
    routing, the dispatch and the combine are the ``tdax.route`` span."""
    with span("route"):
        picked, weights = route(h, layer["router_w"], layer["router_bias"], top_k, scale)
        order, ends, tokens, counts = dispatch(picked, layer["router_w"].shape[-1])
        x = h.index_select(0, tokens)
    if recording():
        LOAD.add(layer_index, counts)
    PICKS.add(layer_index, picked)
    y = experts(x, layer["experts_gate_up"], layer["experts_down"], ends)
    with span("route"):
        return combine(y, order, weights)
