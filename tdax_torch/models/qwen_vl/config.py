"""Qwen-VL-Chat architecture configuration (copy of
``tdax/models/qwen_vl/config.py``).

Full-size defaults match the public Qwen-VL-Chat checkpoint: QWen-7B
decoder (32 layers, 4096 hidden, 32 heads, SwiGLU 22016, vocab 151936)
+ ViT-bigG visual encoder (448px, patch 14, width 1664, 48 layers) with
a 256-query resampler at output dim 4096.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisualConfig:
    image_size: int = 448
    patch_size: int = 14
    width: int = 1664
    layers: int = 48
    heads: int = 16
    mlp_dim: int = 8192
    output_dim: int = 4096
    n_queries: int = 256
    resampler_heads: int = 32
    layer_norm_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size  # 32

    @property
    def n_patches(self) -> int:
        return self.grid_size ** 2  # 1024


@dataclasses.dataclass(frozen=True)
class QwenVLConfig:
    vocab_size: int = 151936
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    intermediate_size: int = 22016  # SwiGLU total; each branch is half
    rope_base: float = 10000.0
    layer_norm_eps: float = 1e-6
    seq_length: int = 2048
    visual: VisualConfig = dataclasses.field(default_factory=VisualConfig)
    dtype: str = "bfloat16"

    # special token ids (Qwen-VL tokenizer contract)
    img_start_id: int = 151857
    img_end_id: int = 151858
    img_pad_id: int = 151859

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ff_half(self) -> int:
        return self.intermediate_size // 2

    @classmethod
    def tiny(cls, **kw) -> "QwenVLConfig":
        """Small config for tests and the toy end-to-end path."""
        return cls(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
                   intermediate_size=256, seq_length=512,
                   visual=VisualConfig(image_size=56, patch_size=14, width=32,
                                       layers=2, heads=2, mlp_dim=64,
                                       output_dim=64, n_queries=16,
                                       resampler_heads=4),
                   **kw)
