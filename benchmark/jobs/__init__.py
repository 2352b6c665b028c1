"""Jobs: what a cell's window calls in the program, one module per kind
of traffic (a mix file names its ``job``).

A job is built from a cell, a seed and a device, and offers:

- ``setup()``: the program's inputs and state, made from the seed, and
  every shape of the window warmed up;
- ``unit(i)``: the i-th unit of work (a batch, a step), returning the
  samples it completed; ``drain()`` waits for the card;
- ``work``: what a unit asks of the card (``benchmark.work.Work``);
- ``release()``: frees the program's state once the window has closed;
- ``check()``: the numbers that decide ``correct``, each with its limit.

A job class also declares what the harness needs of its kind of model:

- ``FAULTS``: the faults that can be planted under its window
  (``benchmark.faults``);
- ``tiny(cfg, dtype)``: the configuration its rehearsals run on the CPU
  in place of ``cfg`` (``benchmark.rehearse``);
- ``SPANS``: the port's ``tdax.*`` spans (prefix left out) that its
  traced units hold.

Spans (``span(name)``) wrap the job's calls into the program; they
record only in a traced run.
"""

from __future__ import annotations

import contextlib
import copy

import torch

# Qwen-VL's rehearsal sizes: the port's ``QwenVLConfig.tiny()``
TINY = {
    "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4, "kv_channels": 16,
    "intermediate_size": 256, "vocab_size": 512, "layer_norm_epsilon": 1e-06,
    "rotary_emb_base": 10000, "seq_length": 512,
    "visual": {"image_size": 56, "patch_size": 14, "width": 32, "layers": 2, "heads": 2,
               "mlp_ratio": 2.0, "output_dim": 64},
    "resampler": {"n_queries": 16, "heads": 4},
}


class Spans:
    """``torch.profiler.record_function`` ranges named ``bench.<name>``
    while ``on``; nothing otherwise."""

    def __init__(self, on: bool = False):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")


def qwen_config(cfg: dict):
    """The port's ``QwenVLConfig`` for a configuration file."""
    from tdax_torch.models.qwen_vl.config import QwenVLConfig, VisualConfig

    vis, res = cfg["visual"], cfg["resampler"]
    if cfg["kv_channels"] * cfg["num_attention_heads"] != cfg["hidden_size"]:
        raise ValueError("the port takes heads of hidden_size / num_attention_heads")
    visual = VisualConfig(image_size=vis["image_size"], patch_size=vis["patch_size"],
                          width=vis["width"], layers=vis["layers"], heads=vis["heads"],
                          mlp_dim=round(vis["width"] * vis["mlp_ratio"]),
                          output_dim=vis["output_dim"], n_queries=res["n_queries"],
                          resampler_heads=res["heads"])
    return QwenVLConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                        num_layers=cfg["num_hidden_layers"],
                        num_heads=cfg["num_attention_heads"],
                        intermediate_size=cfg["intermediate_size"],
                        rope_base=float(cfg["rotary_emb_base"]),
                        layer_norm_eps=cfg["layer_norm_epsilon"],
                        seq_length=cfg["seq_length"], visual=visual, dtype=cfg["dtype"])


def qwen_tiny(cfg: dict, dtype: str) -> dict:
    """``TINY`` in ``dtype``, with the configuration's weights where they
    are served in other numerics than its dtype (int8)."""
    return {**copy.deepcopy(TINY), "dtype": dtype,
            "weights": dtype if cfg["weights"] == cfg["dtype"] else cfg["weights"]}


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| / |want| over the last axis, per vector."""
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
