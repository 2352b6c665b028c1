"""The port's multi-device path over NCCL, on a card: a world of one.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_parallel_cuda.py

A world of one over NCCL (a ``FileStore``, no network port): the tiny
bf16 capture and extraction inside the group are bitwise the same
without it, every attention on the flash kernels, and the extraction's
rows gathered by an NCCL all_gather.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL and the kernels have no CPU mode)")
    from tdax_torch.runtime import get_device
    return get_device("cuda:0")


def test_world_of_one_over_nccl_is_bitwise_one_device(device, tmp_path):
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import mesh as pm
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig.tiny()
    params = init_params(cfg, device, seed=0)
    metadata = generate_dataset(DatasetConfig(data_dir=str(tmp_path / "data")))[:10]
    ecfg = ExtractConfig(model_dir=None, batch_size=4, save_interval=4)

    def capture(name):
        res = extract_activations(metadata, str(tmp_path / name), cfg, ecfg, params=params,
                                  device=device, verbose=False)
        return np.stack([[res[m["id"]]["activations"][f"layer_{i}"] for m in metadata]
                         for i in range(cfg.num_layers)])

    one = capture("one.pt")
    pm.init_distributed(device, rank=0, world_size=1, store_path=str(tmp_path / "store"))
    try:
        fa.LAUNCHES = 0
        pm.COLLECTIVES.clear()
        grouped = capture("grouped.pt")
        assert torch.distributed.get_backend() == "nccl"
        assert pm.COLLECTIVES == {"nccl.all_gather": 3}  # one a batch
        assert fa.LAUNCHES == 3 * (cfg.visual.layers + 1 + cfg.num_layers)
    finally:
        pm.shutdown()
    np.testing.assert_array_equal(grouped, one)
