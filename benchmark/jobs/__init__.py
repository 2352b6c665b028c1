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

Spans (``span(name)``) wrap the job's calls into the program; they
record only in a traced run.
"""

from __future__ import annotations

import contextlib

import torch


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


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| / |want| over the last axis, per vector."""
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
