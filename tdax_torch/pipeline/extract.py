"""Batched activation extraction (port of ``tdax/pipeline/extract.py``).

One batched forward per batch returns [n_layers, batch, hidden]
last-token activations.  As in tdax:

  * the whole dataset is tokenized once, and every batch is padded to
    one length, ``round_up(longest + 1, 64)``;
  * the ragged tail batch is padded back up to ``batch_size`` by
    repeating its first row, and the padded rows are sliced off;
  * results accumulate in a ``.tmp.npz`` checkpoint every
    ``save_interval`` samples; a restart resumes by sample id, unless
    the checkpoint holds ids foreign to the current metadata (a stale
    checkpoint from another run), and the file is removed after the
    final save;
  * the outputs are the reference's ``.pt`` and a sibling ``.npz``;
  * the weights and the tokenizer come from ``extract_cfg.model_dir``
    when it holds a checkpoint, and are random (seed 0) and byte-level
    otherwise.

The model is the configuration's: a ``QwenVLConfig`` runs Qwen-VL-Chat,
a ``KimiVLConfig`` Kimi-VL-A3B-Instruct (``models/kimi_vl``: its seeded
``init_params``, its image processor's normalization and its
``extract_layer_activations``, which takes Qwen-VL's arguments; no
checkpoint loader and no int8 path).  With a ``KimiVLConfig`` and
``TDAX_LOG`` set, a run whose batches a profiler recorded logs the
expert layers' load once, as a ``moe_load`` event
(``ops.moe.LOAD``: per layer the busiest and the idlest expert's routed
rows over the mean).

Under a ``torch.distributed`` process group of W ranks
(``tdax_torch.parallel.mesh.init_distributed``, or ``torchrun``), as
tdax's dp mesh over its devices: when W divides ``batch_size`` each rank
runs its ``batch_size / W`` rows of every batch (the padded tail
included) inside ``flash_sharding(mesh, "dp")``, the rows are gathered
over the group, and rank 0 alone writes the ``.tmp.npz``, ``.pt`` and
``.npz``, a barrier after each write; otherwise every rank runs whole
batches, tdax's replicated case, and rank 0 writes.  On a restart every
rank reads the same checkpoint and skips the same ids.  Every rank
returns the whole result.  The next batch's images are decoded on a
host thread while the current batch runs.

Under torch.profiler the loop's stretches are ``tdax.*`` ranges
(``tdax_torch.utils.log.span``): ``host_prep`` on the image thread,
``h2d``, the model's ``capture``, ``readout`` and ``write`` (each
``.tmp.npz``, ``.pt`` and ``.npz`` save).  With ``TDAX_LOG`` set, each
batch logs an ``extract_batch`` event: the bytes copied to the device
(``h2d_bytes``) and back (``d2h_bytes``) and the seconds the loop
waited on the image thread (``wait_s``).
"""

from __future__ import annotations

import os
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from tdax_torch.config import ExtractConfig
from tdax_torch.data.io import load_activations_npz, save_activations, save_activations_npz
from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.kimi_vl.config import KimiVLConfig
from tdax_torch.models.qwen_vl.model import extract_layer_activations, init_params
from tdax_torch.models.qwen_vl.quantize import quantize_params
from tdax_torch.models.qwen_vl.preprocess import load_image_batch
from tdax_torch.models.qwen_vl.tokenizer import batch_encode, get_tokenizer
from tdax_torch.ops.flash_attention import flash_sharding
from tdax_torch.parallel.mesh import barrier, dp_mesh, gather_batch, is_writer
from tdax_torch.runtime import get_device
from tdax_torch.utils.log import log_event, span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _has_checkpoint(model_dir: str | None) -> bool:
    return bool(model_dir) and os.path.isdir(model_dir) and any(
        f.endswith((".bin", ".safetensors")) for f in os.listdir(model_dir))


def load_or_init_params(model_dir: str | None, cfg: QwenVLConfig, device, seed: int = 0,
                        quantize: bool = False) -> dict:
    """The converted checkpoint when ``model_dir`` holds one (``seed`` is
    then unused, as in tdax), a random init from ``seed`` otherwise, on
    ``device`` in ``cfg.dtype``.  With ``quantize`` the large matmul
    weights come out int8, each quantized from its value as read (or as
    drawn) and the whole fp tree never built."""
    if _has_checkpoint(model_dir):
        from tdax_torch.models.qwen_vl.convert import load_qwen_checkpoint
        return load_qwen_checkpoint(model_dir, cfg, device, quantize=quantize)
    return init_params(cfg, device, seed, quantize=quantize)


class _Model(NamedTuple):
    """What the extract loop asks of the configuration's model."""
    tokenizer_dir: str | None
    params: Callable  # (device) -> params
    images: Callable  # (image paths) -> [B, 3, S, S] float32
    capture: Callable  # extract_layer_activations
    after_run: Callable  # () -> None, once the batches are done


def _family(cfg, extract_cfg: ExtractConfig) -> _Model:
    """The configuration's model: Qwen-VL-Chat (its checkpoint or seeded
    weights, int8 on request), or Kimi-VL on seeded bf16 weights."""
    if isinstance(cfg, KimiVLConfig):
        from tdax_torch.models.kimi_vl import model, preprocess
        if extract_cfg.quantize_int8 or _has_checkpoint(extract_cfg.model_dir):
            raise NotImplementedError("Kimi-VL runs on seeded bf16 weights: the port has no "
                                      "checkpoint loader and no int8 path for it")
        return _Model(None, lambda device: model.init_params(cfg, device),
                      lambda paths: preprocess.load_image_batch(paths, cfg.visual),
                      model.extract_layer_activations, model.log_expert_load)
    return _Model(extract_cfg.model_dir,
                  lambda device: load_or_init_params(extract_cfg.model_dir, cfg, device,
                                                     quantize=extract_cfg.quantize_int8),
                  lambda paths: load_image_batch(paths, cfg.visual.image_size),
                  extract_layer_activations, lambda: None)


def _load_checkpoint(tmp_path: str, metadata: list[dict], announce: bool = True):
    """(activations, ids) from a resumable checkpoint, or (None, []);
    ``announce`` prints what was found."""
    if not os.path.exists(tmp_path):
        return None, []
    try:
        done_acts, done_ids, _ = load_activations_npz(tmp_path)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
        if announce:
            print(f"Warning: Could not load checkpoint: {e}. Starting fresh.")
        return None, []
    current_ids = {m["id"] for m in metadata}
    stale = [i for i in done_ids if i not in current_ids]
    if stale:
        if announce:
            print(f"Warning: checkpoint {tmp_path} holds {len(stale)} sample ids not in "
              f"the current metadata (e.g. {stale[0]!r}) — stale checkpoint from "
              f"another run; starting fresh.")
        return None, []
    if announce:
        print(f"Found existing checkpoint, resuming... ({len(done_ids)} samples done)")
    return done_acts, done_ids


def extract_activations(metadata: list[dict], output_path: str,
                        cfg: QwenVLConfig | None = None,
                        extract_cfg: ExtractConfig | None = None,
                        params: dict | None = None,
                        tokenizer=None,
                        device=None,
                        verbose: bool = True) -> dict:
    """Run extraction over metadata samples; returns the nested-dict
    results and writes output_path (.pt) and its sibling .npz.

    ``params`` default to ``load_or_init_params(extract_cfg.model_dir)``
    on ``device`` (the card unless ``device="cpu"``).  With
    ``extract_cfg.quantize_int8`` those are quantized as they are loaded
    or drawn, and given params are quantized (a no-op on nodes that
    already are), as in tdax."""
    device = get_device(device)
    cfg = cfg or QwenVLConfig()
    extract_cfg = extract_cfg or ExtractConfig()
    family = _family(cfg, extract_cfg)
    tokenizer = tokenizer or get_tokenizer(family.tokenizer_dir, cfg)
    if params is None:
        params = family.params(device)
    elif extract_cfg.quantize_int8:
        params = quantize_params(params)

    bs = extract_cfg.batch_size
    mesh = dp_mesh(bs)
    writer = is_writer()
    tmp_path = output_path + ".tmp.npz"
    done_acts, done_ids = _load_checkpoint(tmp_path, metadata, announce=writer)
    done = set(done_ids)
    todo = [m for m in metadata if m["id"] not in done]
    verbose = verbose and writer
    # this rank's rows of a padded batch (its images alone are decoded):
    # its dp share, or all of them
    if mesh is None:
        share = slice(None)
    else:
        per = bs // mesh.shape["dp"]
        share = slice(mesh.local_rank("dp") * per, (mesh.local_rank("dp") + 1) * per)

    encoded = batch_encode(tokenizer, metadata, cfg)
    max_len = _round_up(encoded["input_ids"].shape[1] + 1, 64)
    pad = max_len - encoded["input_ids"].shape[1]
    enc_ids = np.pad(encoded["input_ids"], ((0, 0), (0, pad)),
                     constant_values=tokenizer.pad_id)
    enc_mask = np.pad(encoded["attn_mask"], ((0, 0), (0, pad)))
    row_of = {m["id"]: j for j, m in enumerate(metadata)}

    def host_prep(chunk):
        with span("host_prep"):
            rows = np.asarray([row_of[m["id"]] for m in chunk]
                              + [row_of[chunk[0]["id"]]] * (bs - len(chunk)))[share]
            images = family.images([encoded["image_paths"][r] for r in rows])
            return (enc_ids[rows], enc_mask[rows], encoded["last_token_idx"][rows],
                    images, encoded["image_positions"][rows])

    dtypes = (torch.long, torch.int32, torch.long, torch.float32, torch.long)

    def to_device(arrays) -> list[torch.Tensor]:
        with span("h2d"):
            return [torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)
                    for a, dt in zip(arrays, dtypes)]

    def run(inputs) -> torch.Tensor:
        with torch.inference_mode():
            return family.capture(params, cfg, *inputs)

    collected_ids = list(done_ids)
    collected: list[np.ndarray] = [] if done_acts is None else [done_acts]
    since_save = 0
    batches = [todo[s:s + bs] for s in range(0, len(todo), bs)]

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(host_prep, batches[0]) if batches else None
        for i, chunk in enumerate(batches):
            t_wait = time.perf_counter()
            args = fut.result()
            wait_s = time.perf_counter() - t_wait
            fut = pool.submit(host_prep, batches[i + 1]) if i + 1 < len(batches) else None
            inputs = to_device(args)
            if mesh is None:
                acts = run(inputs)
            else:
                with flash_sharding(mesh, batch_axis="dp"):
                    acts = gather_batch(run(inputs).float(), mesh, dim=1)
            with span("readout"):
                acts = acts.float().cpu().numpy()
            log_event("extract_batch", batch=i, samples=len(chunk),
                      h2d_bytes=sum(t.nbytes for t in inputs), d2h_bytes=acts.nbytes,
                      wait_s=round(wait_s, 6))
            collected.append(acts[:, :len(chunk)])
            collected_ids.extend(m["id"] for m in chunk)
            since_save += len(chunk)
            if verbose:
                print(f"  extracted {len(collected_ids)}/{len(metadata)}", flush=True)
            if since_save >= extract_cfg.save_interval:
                all_acts = np.concatenate(collected, axis=1)
                if writer:
                    with span("write"):
                        save_activations_npz(tmp_path, all_acts, collected_ids, metadata)
                barrier()
                collected = [all_acts]
                since_save = 0
                if verbose:
                    print(f"Checkpoint: Saving {len(collected_ids)} samples...")

    all_acts = np.concatenate(collected, axis=1) if collected else np.zeros(
        (cfg.num_layers, 0, cfg.hidden_size), np.float32)
    family.after_run()

    if collected_ids:
        if writer:
            with span("write"):
                save_activations(output_path, all_acts, collected_ids, metadata)
                save_activations_npz(output_path.rsplit(".", 1)[0] + ".npz",
                                     all_acts, collected_ids, metadata)
            if os.path.exists(tmp_path):
                os.remove(tmp_path)
        barrier()
        if verbose:
            print(f"Extracted activations for {len(collected_ids)} samples. "
                  f"Saved to {output_path}")
    meta_by_id = {m["id"]: m for m in metadata}
    return {sid: {"metadata": meta_by_id[sid],
                  "activations": {f"layer_{i}": all_acts[i, j]
                                  for i in range(all_acts.shape[0])}}
            for j, sid in enumerate(collected_ids)}
