"""A cell end to end on the CPU at a tiny size: the explicit rehearsal
path of ``benchmark.run`` for tests and for trying a change without the
card.  The measurement path itself (``python3 -m benchmark.run``) refuses
to run without a card.

The cell's configuration is replaced by the tiny sizes below (the port's
``QwenVLConfig.tiny()``) in ``dtype``, its mix by the mix file's
``rehearse`` overrides; everything else is the cell's own path: the
job, the port on CPU tensors (the kernels' plain versions), the
window, the trace readers and the check against the reference with the
cell's limits.  A number it prints is a CPU number and names no device.
"""

from __future__ import annotations

import copy
import time

from benchmark import spec
from benchmark.run import run_cell

TINY = {
    "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4, "kv_channels": 16,
    "intermediate_size": 256, "vocab_size": 512, "layer_norm_epsilon": 1e-06,
    "rotary_emb_base": 10000, "seq_length": 512,
    "visual": {"image_size": 56, "patch_size": 14, "width": 32, "layers": 2, "heads": 2,
               "mlp_ratio": 2.0, "output_dim": 64},
    "resampler": {"n_queries": 16, "heads": 4},
}


def tiny_cell(workload: str, dtype: str = "float32", root=spec.ROOT) -> spec.Cell:
    cell = spec.cell(workload, root=root)
    cell.config = {**copy.deepcopy(TINY), "dtype": dtype,
                   "weights": dtype if cell.config["weights"] == cell.config["dtype"]
                   else cell.config["weights"]}
    cell.traffic = {**cell.traffic, **cell.traffic.get("rehearse", {})}
    return cell


def rehearse(workload: str, seed: int = 0, seconds: float = 0.5, trace: bool = False,
             dtype: str = "float32", root=spec.ROOT) -> dict:
    return run_cell(tiny_cell(workload, dtype, root), seed, seconds, trace, "cpu",
                    t_start=time.perf_counter())
