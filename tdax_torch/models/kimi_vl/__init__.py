"""Kimi-VL-A3B-Instruct in PyTorch: MoonViT with its 2 x 2 patch merge
and projector feeding a DeepSeek-V3 decoder (latent attention, one dense
layer, 26 expert layers of 64 routed and 2 shared experts).  The capture
returns [n_layers, batch, hidden] last-token vectors from one batched
forward, with Qwen-VL's signature, so the extract loop runs it as is.
"""

from tdax_torch.models.kimi_vl.config import KimiVLConfig, MoonViTConfig
from tdax_torch.models.kimi_vl.model import (embed_inputs, extract_layer_activations,
                                             init_params)

__all__ = ["KimiVLConfig", "MoonViTConfig", "init_params", "embed_inputs",
           "extract_layer_activations"]
