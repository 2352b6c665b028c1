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
"""

from __future__ import annotations

import os
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from tdax_torch.config import ExtractConfig
from tdax_torch.data.io import load_activations_npz, save_activations, save_activations_npz
from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.model import extract_layer_activations, init_params
from tdax_torch.models.qwen_vl.quantize import quantize_params
from tdax_torch.models.qwen_vl.preprocess import load_image_batch
from tdax_torch.models.qwen_vl.tokenizer import batch_encode, get_tokenizer
from tdax_torch.ops.flash_attention import flash_sharding
from tdax_torch.parallel.mesh import gather_batch, make_mesh
from tdax_torch.runtime import get_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _has_checkpoint(model_dir: str | None) -> bool:
    return bool(model_dir) and os.path.isdir(model_dir) and any(
        f.endswith((".bin", ".safetensors")) for f in os.listdir(model_dir))


def load_or_init_params(model_dir: str | None, cfg: QwenVLConfig, device,
                        quantize: bool = False) -> dict:
    """The converted checkpoint when ``model_dir`` holds one, a random
    init (seed 0) otherwise, on ``device`` in ``cfg.dtype``.  With
    ``quantize`` the large matmul weights come out int8, each quantized
    from its value as read (or as drawn) and the whole fp tree never
    built."""
    if _has_checkpoint(model_dir):
        from tdax_torch.models.qwen_vl.convert import load_qwen_checkpoint
        return load_qwen_checkpoint(model_dir, cfg, device, quantize=quantize)
    return init_params(cfg, device, quantize=quantize)


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
    tokenizer = tokenizer or get_tokenizer(extract_cfg.model_dir, cfg)
    if params is None:
        params = load_or_init_params(extract_cfg.model_dir, cfg, device,
                                     quantize=extract_cfg.quantize_int8)
    elif extract_cfg.quantize_int8:
        params = quantize_params(params)

    bs = extract_cfg.batch_size
    group = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if group else 1
    mesh = make_mesh(dp=world) if group and bs % world == 0 else None
    writer = not group or dist.get_rank() == 0
    tmp_path = output_path + ".tmp.npz"
    done_acts, done_ids = _load_checkpoint(tmp_path, metadata, announce=writer)
    done = set(done_ids)
    todo = [m for m in metadata if m["id"] not in done]
    verbose = verbose and writer
    # this rank's rows of a padded batch (its images alone are decoded):
    # its dp share, or all of them
    per, r = bs // world, mesh.local_rank("dp") if mesh is not None else 0
    share = slice(None) if mesh is None else slice(r * per, (r + 1) * per)

    def written():
        if group:
            dist.barrier()

    encoded = batch_encode(tokenizer, metadata, cfg)
    max_len = _round_up(encoded["input_ids"].shape[1] + 1, 64)
    pad = max_len - encoded["input_ids"].shape[1]
    enc_ids = np.pad(encoded["input_ids"], ((0, 0), (0, pad)),
                     constant_values=tokenizer.pad_id)
    enc_mask = np.pad(encoded["attn_mask"], ((0, 0), (0, pad)))
    row_of = {m["id"]: j for j, m in enumerate(metadata)}

    def host_prep(chunk):
        rows = np.asarray([row_of[m["id"]] for m in chunk]
                          + [row_of[chunk[0]["id"]]] * (bs - len(chunk)))[share]
        images = load_image_batch([encoded["image_paths"][r] for r in rows],
                                  cfg.visual.image_size)
        return (enc_ids[rows], enc_mask[rows], encoded["last_token_idx"][rows],
                images, encoded["image_positions"][rows])

    def run(ids, mask, last_idx, images, img_pos) -> torch.Tensor:
        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
        with torch.inference_mode():
            return extract_layer_activations(
                params, cfg, dev(ids, torch.long), dev(mask, torch.int32),
                dev(last_idx, torch.long), dev(images, torch.float32),
                dev(img_pos, torch.long))

    collected_ids = list(done_ids)
    collected: list[np.ndarray] = [] if done_acts is None else [done_acts]
    since_save = 0
    batches = [todo[s:s + bs] for s in range(0, len(todo), bs)]

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(host_prep, batches[0]) if batches else None
        for i, chunk in enumerate(batches):
            args = fut.result()
            fut = pool.submit(host_prep, batches[i + 1]) if i + 1 < len(batches) else None
            if mesh is None:
                acts = run(*args).float()
            else:
                with flash_sharding(mesh, batch_axis="dp"):
                    acts = gather_batch(run(*args).float(), mesh, dim=1)
            acts = acts.cpu().numpy()[:, :len(chunk)]
            collected.append(acts)
            collected_ids.extend(m["id"] for m in chunk)
            since_save += len(chunk)
            if verbose:
                print(f"  extracted {len(collected_ids)}/{len(metadata)}", flush=True)
            if since_save >= extract_cfg.save_interval:
                all_acts = np.concatenate(collected, axis=1)
                if writer:
                    save_activations_npz(tmp_path, all_acts, collected_ids, metadata)
                written()
                collected = [all_acts]
                since_save = 0
                if verbose:
                    print(f"Checkpoint: Saving {len(collected_ids)} samples...")

    all_acts = np.concatenate(collected, axis=1) if collected else np.zeros(
        (cfg.num_layers, 0, cfg.hidden_size), np.float32)

    if collected_ids:
        if writer:
            save_activations(output_path, all_acts, collected_ids, metadata)
            save_activations_npz(output_path.rsplit(".", 1)[0] + ".npz",
                                 all_acts, collected_ids, metadata)
            if os.path.exists(tmp_path):
                os.remove(tmp_path)
        written()
        if verbose:
            print(f"Extracted activations for {len(collected_ids)} samples. "
                  f"Saved to {output_path}")
    meta_by_id = {m["id"]: m for m in metadata}
    return {sid: {"metadata": meta_by_id[sid],
                  "activations": {f"layer_{i}": all_acts[i, j]
                                  for i in range(all_acts.shape[0])}}
            for j, sid in enumerate(collected_ids)}
