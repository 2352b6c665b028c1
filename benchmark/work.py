"""What one unit of a cell's traffic asks of the card, from the model's
shapes alone: its model FLOPs and the attention calls and int8 weight
products it contains.  The per-layer readers turn these into utilization
and roofline shares, so they read the same work whatever implements it.

``Model`` is the configuration file read as sizes (``model(cfg)``); the
capture and training units follow the port's forward: the ViT's 48
blocks, the 256-query resampler, the decoder's blocks, and for training
the LM head, the backward and remat's replay of each block.
"""

from __future__ import annotations

import dataclasses

from benchmark import roofline


@dataclasses.dataclass(frozen=True)
class Model:
    hidden: int
    layers: int
    heads: int
    ff_half: int
    vocab: int
    image_size: int
    patch: int
    width: int
    vit_layers: int
    vit_heads: int
    mlp_dim: int
    out_dim: int
    n_queries: int
    resampler_heads: int

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


def model(cfg: dict) -> Model:
    """The sizes of a configuration file (Hugging Face key names, with
    the visual tower's and the resampler's groups)."""
    vis, res = cfg["visual"], cfg["resampler"]
    return Model(hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
                 heads=cfg["num_attention_heads"], ff_half=cfg["intermediate_size"] // 2,
                 vocab=cfg["vocab_size"], image_size=vis["image_size"],
                 patch=vis["patch_size"], width=vis["width"], vit_layers=vis["layers"],
                 vit_heads=vis["heads"], mlp_dim=round(vis["width"] * vis["mlp_ratio"]),
                 out_dim=vis["output_dim"], n_queries=res["n_queries"],
                 resampler_heads=res["heads"])


@dataclasses.dataclass
class Work:
    """One unit (a capture batch, a training step): model FLOPs, and the
    calls of each kernel family as (shape, calls) pairs."""
    flops: float
    attn_fwd: list = dataclasses.field(default_factory=list)   # ((b, tq, tk, nh, hd, causal), n)
    attn_bwd: list = dataclasses.field(default_factory=list)   # same shapes
    qmm: list = dataclasses.field(default_factory=list)        # ((m, k, n), calls)

    def attn_fwd_bound_s(self) -> float:
        return sum(roofline.attn_fwd_bound(*shape) * n for shape, n in self.attn_fwd)

    def attn_bwd_bound_s(self) -> float:
        return sum(sum(roofline.attn_bwd_pair_bound(*shape)) * n for shape, n in self.attn_bwd)

    def qmm_bound_s(self) -> float:
        return sum(roofline.qmm_bound(*shape) * n for shape, n in self.qmm)


def _dense(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def capture_batch(md: Model, batch: int, seq: int) -> Work:
    """One capture batch: the visual tower on ``batch`` images, the
    decoder over ``batch`` x ``seq`` positions (no LM head).  Causal
    attention counts its visible pairs."""
    w, d, h, hd = md.width, md.out_dim, md.hidden, md.head_dim
    n_img, n_q, n_txt = batch * md.n_patches, batch * md.n_queries, batch * seq
    vit = md.vit_layers * (_dense(n_img, w, 3 * w) + _dense(n_img, w, w)
                           + _dense(n_img, w, md.mlp_dim) + _dense(n_img, md.mlp_dim, w)
                           + 4.0 * batch * md.n_patches ** 2 * w)
    vit += _dense(n_img, 3 * md.patch ** 2, w)
    resampler = (_dense(n_img, w, d) + _dense(n_q, d, d) + 2 * _dense(n_img, d, d)
                 + _dense(n_q, d, d) + 4.0 * batch * md.n_queries * md.n_patches * d
                 + _dense(n_q, d, d))
    decoder = md.layers * (_dense(n_txt, h, 3 * h) + _dense(n_txt, h, h)
                           + 3 * _dense(n_txt, h, md.ff_half)
                           + 4.0 * batch * md.heads * roofline.visible_pairs(seq, seq, True) * hd)
    attn = [((batch, seq, seq, md.heads, hd, True), md.layers),
            ((batch, md.n_patches, md.n_patches, md.vit_heads, w // md.vit_heads, False),
             md.vit_layers),
            ((batch, md.n_queries, md.n_patches, md.resampler_heads, d // md.resampler_heads,
              False), 1)]
    return Work(flops=vit + resampler + decoder, attn_fwd=attn)


def capture_qmm(md: Model, batch: int, seq: int) -> list:
    """The int8 weight products of one capture batch, (m, k, n) and calls:
    every ViT block's four, the patch embedding, the resampler's five and
    the visual projection, every decoder layer's five (w1 and w2 apart)."""
    w, d, h = md.width, md.out_dim, md.hidden
    n_img, n_q, n_txt = batch * md.n_patches, batch * md.n_queries, batch * seq
    return [((n_img, 3 * md.patch ** 2, w), 1),
            ((n_img, w, 3 * w), md.vit_layers), ((n_img, w, w), md.vit_layers),
            ((n_img, w, md.mlp_dim), md.vit_layers), ((n_img, md.mlp_dim, w), md.vit_layers),
            ((n_img, w, d), 1), ((n_q, d, d), 1), ((n_img, d, d), 2), ((n_q, d, d), 1),
            ((n_q, d, d), 1),
            ((n_txt, h, 3 * h), md.layers), ((n_txt, h, h), md.layers),
            ((n_txt, h, md.ff_half), 2 * md.layers), ((n_txt, md.ff_half, h), md.layers)]


def train_flops(md: Model, batch: int, seq: int) -> float:
    """One text-only training step: 3 x the forward's FLOPs (decoder
    products, LM head, attention over all t^2 pairs), remat's replay not
    credited."""
    h, ff = md.hidden, md.ff_half
    per_token = md.layers * 2 * (h * 3 * h + h * h + 3 * h * ff)
    fwd = batch * seq * (per_token + 2 * h * md.vocab) + md.layers * 4 * seq * seq * h * batch
    return 3.0 * fwd


def train_step(md: Model, batch: int, seq: int, remat: bool) -> Work:
    """One training step: the forward and, under remat, its replay (two
    flash forwards a layer), and one backward pair a layer."""
    shape = (batch, seq, seq, md.heads, md.head_dim, True)
    return Work(flops=train_flops(md, batch, seq),
                attn_fwd=[(shape, md.layers * (2 if remat else 1))],
                attn_bwd=[(shape, md.layers)])
