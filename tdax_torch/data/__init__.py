"""Dataset generation and artifact IO (PyTorch port of ``tdax.data``)."""

from tdax_torch.data.adversarial import generate_adversarial_metadata
from tdax_torch.data.dataset import create_image, generate_dataset
from tdax_torch.data.io import (
    activations_to_layer_clouds,
    load_activations,
    load_metadata,
    save_activations,
)

__all__ = [
    "create_image",
    "generate_dataset",
    "generate_adversarial_metadata",
    "load_activations",
    "save_activations",
    "load_metadata",
    "activations_to_layer_clouds",
]
