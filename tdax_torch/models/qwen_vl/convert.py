"""Parameters from a tree of numpy arrays, and from a Hugging Face
Qwen-VL-Chat checkpoint (port of ``tdax/models/qwen_vl/convert.py``).

``params_from_numpy`` takes a tdax-layout parameter tree whose leaves
are numpy arrays (for example ``jax.tree.map(np.asarray,
tdax.models.qwen_vl.init_params(...))``: [in, out] weights, layer
weights stacked [n_layers, ...]) and returns the port's parameters: the
same tree of tensors on ``device`` in ``dtype``.  The port keeps tdax's
layout, so this is a leaf-by-leaf copy and both packages compute the
same function of the same numbers.

An int8 tree (tdax's ``quantize_params`` or ``init_params_quantized``)
crosses as it is: int8 leaves stay int8, and the scales of a
``{"q", "s"}`` node stay f32 whatever the model dtype, as tdax keeps
them.  Every leaf owns its storage (a contiguous copy of the input), so
it can be trained: the training step updates it in place.

``params_to_numpy`` is the inverse, into tdax's layout: float leaves as
float32 arrays (numpy has no bfloat16), int8 leaves as int8.

The checkpoint loader maps the state-dict names of the snapshot the
reference downloads onto the same layout (T = transpose, S = stack over
layers i):

  transformer.wte.weight                  -> wte
  transformer.ln_f.weight                 -> ln_f
  lm_head.weight                          -> lm_head (T)
  transformer.h.{i}.ln_{1,2}.weight       -> layers.ln_{1,2} (S)
  transformer.h.{i}.attn.c_attn.{w,b}     -> layers.attn_qkv_{w (S,T), b (S)}
  transformer.h.{i}.attn.c_proj.weight    -> layers.attn_proj_w (S,T)
  transformer.h.{i}.mlp.{w1,w2,c_proj}.weight -> layers.mlp_{w1,w2,proj_w} (S,T)
  transformer.visual.conv1.weight         -> visual.patch_w ([w, 3*p*p], T)
  transformer.visual.positional_embedding -> visual.pos_embed
  transformer.visual.ln_{pre,post}.{w,b}  -> visual.ln_{pre,post}_{w,b}
  transformer.visual.proj                 -> visual.proj (already [in, out])
  transformer.visual.transformer.resblocks.{i}.* -> visual.blocks.* (S; Linears T)
  transformer.visual.attn_pool.query      -> visual.resampler.query
  transformer.visual.attn_pool.pos_embed  -> visual.resampler.q_pos, and
                                             bicubic-upsampled to the patch
                                             grid -> visual.resampler.kv_pos
  transformer.visual.attn_pool.kv_proj.weight -> visual.resampler.kv_proj_w (T)
  transformer.visual.attn_pool.ln_{q,kv}.{w,b} -> visual.resampler.ln_*
  transformer.visual.attn_pool.attn.in_proj_{weight,bias} (rows split q|k|v)
                                          -> visual.resampler.attn_{q,k,v}_{w (T),b}
  transformer.visual.attn_pool.attn.out_proj.{w,b} -> visual.resampler.attn_out_{w (T),b}

tdax reads the whole checkpoint into one f32 numpy dict and then stacks
it again (the full config's ~39 GB of f32, held twice on the host).
The port streams it instead: shard by shard (``torch.load(mmap=True)``
for ``.bin`` shards, one tensor at a time for safetensors), each tensor
moved to ``device`` in its stored dtype and written into its
preallocated stacked leaf there, so the host holds about one shard.
The values are tdax's: a float leaf is the checkpoint's value rounded
once to ``dtype`` (as ``params_from_numpy`` rounds tdax's f32 tree), and
with ``quantize`` each large matmul weight is quantized from its value
as read (in f32, as tdax's ``quantize_params`` of its f32 tree), never
from a rounded copy.
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np
import torch

from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.model import torch_dtype
from tdax_torch.models.qwen_vl.quantize import (_QUANT_KEYS, _quantize_2d, is_quantized,
                                               quantize_weight)
from tdax_torch.models.qwen_vl.vit import interp_pos_embed, sincos_2d


def params_from_numpy(tree: dict, device, dtype) -> dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    dtype = torch_dtype(dtype)
    out = {}
    for name, leaf in tree.items():
        if is_quantized(leaf):
            out[name] = {"q": _tensor(leaf["q"], np.int8, device, torch.int8),
                         "s": _tensor(leaf["s"], np.float32, device, torch.float32)}
        elif isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device, dtype)
        elif np.asarray(leaf).dtype == np.int8:
            out[name] = _tensor(leaf, np.int8, device, torch.int8)
        else:
            out[name] = _tensor(leaf, np.float32, device, dtype)
    return out


def _tensor(leaf, np_dtype, device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.array(leaf, dtype=np_dtype)  # a copy, writable
    return torch.from_numpy(arr).to(device=device, dtype=dtype).contiguous()


def params_to_numpy(tree: dict) -> dict:
    """Nested dict of tensors -> the same nested dict of numpy arrays."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_to_numpy(leaf)
        else:
            t = leaf.detach().cpu()
            out[name] = np.array((t if t.dtype == torch.int8 else t.float()).numpy())  # a copy
    return out


# --- the Hugging Face checkpoint ----------------------------------------------

_VISUAL = "transformer.visual."
_POOL = _VISUAL + "attn_pool."
_Q_POS_KEY = _POOL + "pos_embed"  # optional: the query-grid sincos table by default

# (leaf, HF name under the layer prefix, transposed)
_DECODER_KEYS = (
    ("ln_1", "ln_1.weight", False),
    ("ln_2", "ln_2.weight", False),
    ("attn_qkv_w", "attn.c_attn.weight", True),
    ("attn_qkv_b", "attn.c_attn.bias", False),
    ("attn_proj_w", "attn.c_proj.weight", True),
    ("mlp_w1", "mlp.w1.weight", True),
    ("mlp_w2", "mlp.w2.weight", True),
    ("mlp_proj_w", "mlp.c_proj.weight", True),
)
_VIT_BLOCK_KEYS = (
    ("ln_1_w", "ln_1.weight", False), ("ln_1_b", "ln_1.bias", False),
    ("ln_2_w", "ln_2.weight", False), ("ln_2_b", "ln_2.bias", False),
    ("attn_qkv_w", "attn.in_proj_weight", True), ("attn_qkv_b", "attn.in_proj_bias", False),
    ("attn_proj_w", "attn.out_proj.weight", True), ("attn_proj_b", "attn.out_proj.bias", False),
    ("mlp_fc_w", "mlp.c_fc.weight", True), ("mlp_fc_b", "mlp.c_fc.bias", False),
    ("mlp_proj_w", "mlp.c_proj.weight", True), ("mlp_proj_b", "mlp.c_proj.bias", False),
)


def _same(t):
    return t


def _transposed(t):
    return t.T


def _rows(a: int, b: int, transpose: bool):
    return lambda t: t[a:b].T if transpose else t[a:b]


def _rules(cfg: QwenVLConfig) -> tuple[dict[str, list[tuple]], list[tuple]]:
    """HF name -> [(leaf path, layer index or None, view of the tensor)],
    and every leaf path in tdax's tree order."""
    rules: dict[str, list[tuple]] = {}
    order: list[tuple] = []

    def add(key, path, layer=None, view=_same):
        rules.setdefault(key, []).append((path, layer, view))
        if path not in order:
            order.append(path)

    def stacked(prefix, n, table, path):
        for name, suffix, transpose in table:
            for i in range(n):
                add(f"{prefix}{i}.{suffix}", path + (name,), i,
                    _transposed if transpose else _same)

    add("transformer.wte.weight", ("wte",))
    stacked("transformer.h.", cfg.num_layers, _DECODER_KEYS, ("layers",))
    add("transformer.ln_f.weight", ("ln_f",))
    add("lm_head.weight", ("lm_head",), view=_transposed)

    v, d = cfg.visual, cfg.visual.output_dim
    add(_VISUAL + "conv1.weight", ("visual", "patch_w"),  # [width, 3, p, p] -> [3*p*p, width]
        view=lambda t: t.reshape(t.shape[0], -1).T)
    add(_VISUAL + "positional_embedding", ("visual", "pos_embed"))
    for name in ("ln_pre", "ln_post"):
        add(f"{_VISUAL}{name}.weight", ("visual", f"{name}_w"))
        add(f"{_VISUAL}{name}.bias", ("visual", f"{name}_b"))
    stacked(_VISUAL + "transformer.resblocks.", v.layers, _VIT_BLOCK_KEYS, ("visual", "blocks"))
    res = ("visual", "resampler")
    add(_POOL + "query", res + ("query",))
    add(_Q_POS_KEY, res + ("q_pos",))
    order.append(res + ("kv_pos",))  # derived from q_pos
    add(_POOL + "kv_proj.weight", res + ("kv_proj_w",), view=_transposed)
    for name in ("ln_q", "ln_kv"):
        add(f"{_POOL}{name}.weight", res + (f"{name}_w",))
        add(f"{_POOL}{name}.bias", res + (f"{name}_b",))
    for j, name in enumerate("qkv"):
        add(_POOL + "attn.in_proj_weight", res + (f"attn_{name}_w",),
            view=_rows(j * d, (j + 1) * d, True))
        add(_POOL + "attn.in_proj_bias", res + (f"attn_{name}_b",),
            view=_rows(j * d, (j + 1) * d, False))
    add(_POOL + "attn.out_proj.weight", res + ("attn_out_w",), view=_transposed)
    add(_POOL + "attn.out_proj.bias", res + ("attn_out_b",))
    add(_VISUAL + "proj", ("visual", "proj"))
    return rules, order


class _Converter:
    """Writes checkpoint tensors, in any order, into the parameter tree
    on ``device``: stacked leaves are allocated at their first layer and
    filled layer by layer; ``finish`` checks that every key came and
    returns the tree in tdax's order."""

    def __init__(self, cfg: QwenVLConfig, device, dtype, quantize: bool):
        self.cfg, self.device, self.quantize = cfg, torch.device(device), quantize
        self.dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
        self.rules, self.order = _rules(cfg)
        self.leaves: dict[tuple, object] = {}
        self.seen: set[str] = set()

    def put(self, key: str, t: torch.Tensor) -> None:
        targets = self.rules.get(key)
        if targets is None:
            return  # a key the model does not use (tdax ignores it too)
        self.seen.add(key)
        t = t.to(self.device)  # in its stored dtype
        for path, layer, view in targets:
            self._write(path, layer, view(t))
        if key == _Q_POS_KEY:
            self._kv_pos(t.float().cpu().numpy())

    def _kv_pos(self, q_pos: np.ndarray) -> None:
        # keys add the query-grid table bicubic-upsampled to the patch grid
        # (Qwen's get_abs_pos), computed from its f32 value, as tdax does
        kv_pos = interp_pos_embed(q_pos, self.cfg.visual.grid_size)
        self._write(("visual", "resampler", "kv_pos"), None, torch.from_numpy(kv_pos))

    def _write(self, path: tuple, layer: int | None, w: torch.Tensor) -> None:
        quantize = self.quantize and path[-1] in _QUANT_KEYS
        w = w.to(self.device)
        if layer is None:
            if quantize:
                self.leaves[path] = quantize_weight(w)
            else:
                self.leaves[path] = torch.empty(w.shape, dtype=self.dtype,
                                                device=self.device).copy_(w)
            return
        leaf = self.leaves.get(path)
        if leaf is None:
            n = self.cfg.num_layers if path[0] == "layers" else self.cfg.visual.layers
            if quantize:
                leaf = {"q": torch.empty((n, *w.shape), dtype=torch.int8, device=self.device),
                        "s": torch.empty((n, w.shape[-1]), dtype=torch.float32,
                                         device=self.device)}
            else:
                leaf = torch.empty((n, *w.shape), dtype=self.dtype, device=self.device)
            self.leaves[path] = leaf
        have = (leaf["q"] if quantize else leaf).shape[1:]
        if have != w.shape:
            # copy_ would broadcast; tdax's np.stack refuses ragged layers
            raise ValueError(f"{'.'.join(path)} layer {layer}: shape {tuple(w.shape)}, "
                             f"other layers {tuple(have)}")
        if quantize:
            leaf["q"][layer], leaf["s"][layer] = _quantize_2d(w)
        else:
            leaf[layer].copy_(w)

    def finish(self) -> dict:
        with_visual = any(k.startswith(_VISUAL) for k in self.seen)
        required = [k for k in self.rules
                    if k != _Q_POS_KEY and (with_visual or not k.startswith(_VISUAL))]
        missing = [k for k in required if k not in self.seen]
        if missing:
            raise KeyError(f"the checkpoint has no {missing[0]!r} "
                           f"({len(missing)} keys of the model missing)")
        if with_visual and _Q_POS_KEY not in self.seen:
            v = self.cfg.visual
            q_pos = sincos_2d(math.isqrt(v.n_queries), v.output_dim)
            self._write(("visual", "resampler", "q_pos"), None, torch.from_numpy(q_pos))
            self._kv_pos(q_pos)
        tree: dict = {}
        for path in self.order:
            if path in self.leaves:
                node = tree
                for name in path[:-1]:
                    node = node.setdefault(name, {})
                node[path[-1]] = self.leaves[path]
        return tree


def convert_hf_state_dict(state: dict, cfg: QwenVLConfig, device, dtype=None) -> dict:
    """A flat dict of HF-named arrays or tensors -> the port's parameters
    on ``device`` in ``dtype`` (``cfg.dtype`` by default).  A visual tree
    is built when any ``transformer.visual.*`` key is present, as in
    tdax."""
    conv = _Converter(cfg, device, dtype, quantize=False)
    for key, value in state.items():
        conv.put(key, torch.as_tensor(value))
    return conv.finish()


def _shard_files(model_dir: str) -> list[str]:
    """The snapshot's shards: ``*.safetensors`` when there are any, else
    the non-empty ``pytorch_model*.bin`` files, in name order."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        files = [f for f in sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
                 if os.path.getsize(f) > 0]
    if not files:
        raise FileNotFoundError(f"no checkpoint shards under {model_dir}")
    return files


def _iter_hf_checkpoint(model_dir: str):
    """Yield (name, CPU tensor in its stored dtype) over every shard of a
    local HF snapshot, one shard open at a time.

    Reads sharded or single safetensors (``safetensors`` is imported
    here, one tensor at a time), else ``pytorch_model*.bin`` shards
    (memory-mapped, ``weights_only``; the layout of the Qwen-VL-Chat
    snapshot the reference downloads).  A key in two shards raises
    ValueError: a corrupt snapshot fails loudly rather than letting the
    last shard win."""
    seen: dict[str, str] = {}

    def check(key, path):
        if key in seen:
            raise ValueError(f"duplicate checkpoint key {key!r} in {path} "
                             f"(also in {seen[key]})")
        seen[key] = path

    for path in _shard_files(model_dir):
        if path.endswith(".safetensors"):
            from safetensors import safe_open
            with safe_open(path, framework="pt") as f:
                for key in f.keys():
                    check(key, path)
                    yield key, f.get_tensor(key)
        else:
            shard = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
            for key in list(shard):
                check(key, path)
                yield key, shard.pop(key)
            del shard


def load_hf_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """A local HF snapshot as one flat {name: CPU tensor} dict, in the
    stored dtypes (tdax's returns f32 numpy arrays of the same values)."""
    return dict(_iter_hf_checkpoint(model_dir))


def load_qwen_checkpoint(model_dir: str, cfg: QwenVLConfig, device, dtype=None,
                         quantize: bool = False) -> dict:
    """A local HF snapshot -> the port's parameters on ``device`` in
    ``dtype`` (``cfg.dtype`` by default), streamed shard by shard; with
    ``quantize`` the large matmul weights are quantized to int8 as they
    are read.  Raises FileNotFoundError when the directory holds no
    shards, ValueError on a key in two shards and KeyError naming a key
    of the model that no shard holds."""
    conv = _Converter(cfg, device, dtype, quantize)
    for key, t in _iter_hf_checkpoint(model_dir):
        conv.put(key, t)
    return conv.finish()
