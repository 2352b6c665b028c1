"""Kimi-VL-A3B-Instruct's architecture (moonshotai/Kimi-VL-A3B-Instruct
``config.json``; MoonViT and the projector as arXiv:2504.07491 and the
model's ``modeling_kimi_vl.py`` describe them).

``KimiVLConfig`` holds the text model's keys (a DeepSeek-V3 decoder:
latent attention, one dense layer, then expert layers of 64 routed and 2
shared experts) and ``MoonViTConfig`` the tower's and the projector's,
which the text config does not give.  Full-size defaults are the
published ones: ~16.4 B parameters, 32.8 GB in bf16.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoonViTConfig:
    image_size: int = 448          # the capture's input; MoonViT takes native sizes
    patch_size: int = 14
    width: int = 1152
    layers: int = 27
    heads: int = 16
    mlp_dim: int = 4304
    pos_grid: int = 64             # the learned position table, init_pos_emb_height / _width
    merge: int = 2                 # merge_kernel_size (2, 2)
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    image_mean: float = 0.5        # the image processor's, every channel
    image_std: float = 0.5

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size  # 32

    @property
    def n_patches(self) -> int:
        return self.grid_size ** 2  # 1024

    @property
    def head_dim(self) -> int:
        return self.width // self.heads  # 72

    @property
    def n_queries(self) -> int:
        """Image tokens the decoder sees: the patches after the merge (256)."""
        return (self.grid_size // self.merge) ** 2


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 11264      # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408   # each expert's
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6           # kv_a_layernorm: the modeling code's default
    rope_theta: float = 800000.0
    visual: MoonViTConfig = dataclasses.field(default_factory=MoonViTConfig)
    dtype: str = "bfloat16"

    # the byte-level ToyTokenizer's image span (the positions are what the
    # model reads; the ids are taken modulo the vocabulary)
    img_start_id: int = 151857
    img_end_id: int = 151858
    img_pad_id: int = 151859

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim  # 192

    @property
    def n_dense(self) -> int:
        return self.first_k_dense_replace

    @property
    def n_moe(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @property
    def shared_intermediate(self) -> int:
        """The shared experts act as one SwiGLU of this width."""
        return self.moe_intermediate_size * self.n_shared_experts

    @classmethod
    def tiny(cls, **kw) -> "KimiVLConfig":
        """Every mechanism at a small size, for tests and the CPU path: one
        dense and two expert layers, 8 experts with top 3 and 2 shared,
        latent attention with its nope, rope and v widths apart, a tower
        of 2 blocks at head width 16 and a position table larger than the
        image's 8 x 8 grid (so it is resized)."""
        return cls(vocab_size=512, hidden_size=64, num_layers=3, num_heads=4,
                   intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
                   n_shared_experts=2, num_experts_per_tok=3, kv_lora_rank=32,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                   visual=MoonViTConfig(image_size=112, width=32, layers=2, heads=2, mlp_dim=64,
                                        pos_grid=10),
                   **kw)
