"""Qwen-VL-Chat in PyTorch (port of ``tdax.models.qwen_vl``).

ViT-bigG visual encoder with a 256-query cross-attention resampler
feeding a 32-layer QWen decoder; every attention goes through the
port's flash-attention kernel on the card.  The per-layer capture
returns [n_layers, batch, hidden] last-token vectors from one batched
forward.
"""

from tdax_torch.models.qwen_vl.config import QwenVLConfig, VisualConfig
from tdax_torch.models.qwen_vl.model import (extract_layer_activations, forward,
                                             init_params)

__all__ = ["QwenVLConfig", "VisualConfig", "init_params", "forward",
           "extract_layer_activations"]
