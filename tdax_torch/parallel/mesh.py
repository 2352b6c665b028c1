"""Process group, mesh and parameter sharding (port of ``tdax/parallel/mesh.py``).

dp = data parallel over the batch axis; tp = tensor parallel in the
Megatron pattern, as tdax's rules: QKV and the two up-projections are
sharded on their output features (heads / ff split across tp), the
attention and MLP down-projections on their input features, and the LM
head on vocab; everything else (norms, embeddings) is replicated.

tdax lets GSPMD place every collective.  The port runs one process per
rank over ``torch.distributed``: each rank holds its local tensors (its
dp rows, its tp heads) and the model's row-parallel sites sum their
partial products over the tp group explicitly (``all_reduce``), the LM
head gathers its vocab shards (``all_gather``).  There is no DTensor:
the hand-written kernels take raw pointers, so local tensors and
explicit collectives are the idiom.  The model reads the tp group from
``tdax_torch.ops.flash_attention.flash_sharding``, the context tdax's
callers enter too.

The backend follows the device: NCCL for CUDA tensors, gloo for the
CPU.  gloo also takes CUDA tensors for ``all_reduce`` and ``broadcast``
(PyTorch's table of backends); for its other collectives this module
copies a CUDA tensor through the host, by rule.  A failed collective
raises; nothing here catches it.

``COLLECTIVES`` counts the collectives run, by backend and kind
(``"nccl.all_gather"``, ...), so a run can show which ran.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tdax_torch.runtime import get_device

COLLECTIVES: dict[str, int] = {}


class P(tuple):
    """A partition spec: one mesh axis name (or None) per leading
    dimension of a leaf, as ``jax.sharding.PartitionSpec``; the dims past
    its length are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


class Mesh:
    """A dp x tp grid of the process group's ranks (``make_mesh``), over a
    ``DeviceMesh`` whose sub-groups carry the collectives.  ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape = dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def local_rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def launched_by_torchrun() -> bool:
    """True when torchrun's environment (RANK, WORLD_SIZE) is present."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device=None, *, rank: int | None = None, world_size: int | None = None,
                     store_path: str | None = None, backend: str | None = None) -> torch.device:
    """Join the process group and return this rank's device.

    With ``rank`` None the group is joined from torchrun's environment
    (RANK, WORLD_SIZE and its rendezvous); otherwise from ``rank``,
    ``world_size`` and a ``FileStore`` at ``store_path`` (no network
    port).  The device is ``cuda:LOCAL_RANK`` (``cuda:rank`` without
    torchrun) unless ``device`` names one; ``"cpu"`` only when asked for.
    The backend follows the device (NCCL for CUDA, gloo for the CPU)
    unless ``backend`` names one: ranks sharing one card need gloo."""
    if rank is None:
        if not launched_by_torchrun():
            raise RuntimeError("init_distributed: no torchrun environment (RANK, WORLD_SIZE); "
                               "pass rank, world_size and store_path")
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        store = None
    else:
        if world_size is None or store_path is None:
            raise ValueError("init_distributed: an explicit rank needs world_size and store_path")
        store = dist.FileStore(store_path, world_size)
    if device is None or str(device) == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    device = get_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return device


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(dp: int | None = None, tp: int = 1, cp: int = 1) -> Mesh:
    """dp x tp mesh over the process group's ranks, tp innermost (a tp
    group is ``tp`` consecutive ranks).  ``cp > 1`` (context parallelism)
    is not ported."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    n = dist.get_world_size()
    if dp is None:
        dp = n // (tp * cp)
    if dp * tp * cp != n:
        raise ValueError(f"dp*tp*cp = {dp}*{tp}*{cp} != {n} ranks")
    if cp > 1:
        raise NotImplementedError("make_mesh: cp > 1 (context parallelism, ring attention) "
                                  "comes with the port's multi-device training")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp")))


def _count(kind: str, group) -> None:
    key = f"{dist.get_backend(group)}.{kind}"
    COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s group, in place; returns ``x``."""
    group = mesh.group(axis)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    _count("all_reduce", group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ``x`` of every rank of ``axis``'s group, concatenated along
    ``dim`` in the group's rank order (every rank's ``x`` has one shape).
    Under gloo a CUDA tensor goes through the host."""
    group = mesh.group(axis)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=group)
    _count("all_gather", group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` of the first rank of ``axis``'s group on every rank of it,
    in place; returns ``x``."""
    group = mesh.group(axis)
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    _count("broadcast", group)
    return x


def split_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous share of ``x``'s rows (dim 0) over dp, whose
    size must divide them."""
    n = mesh.shape["dp"]
    if x.shape[0] % n:
        raise ValueError(f"split_batch: batch {x.shape[0]} does not divide over dp={n}")
    per = x.shape[0] // n
    return x[mesh.local_rank("dp") * per:(mesh.local_rank("dp") + 1) * per]


def gather_batch(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The whole batch back from every dp rank's share along ``dim``
    (``split_batch``'s inverse)."""
    return all_gather(x, mesh, "dp", dim)


def param_sharding_rules(with_visual: bool = True) -> dict:
    """Partition-spec tree matching the Qwen-VL parameter layout, leaf for
    leaf tdax's ``param_sharding_rules``."""
    layers = {
        "ln_1": P(), "ln_2": P(),
        "attn_qkv_w": P(None, None, "tp"),   # [L, H, 3H] heads over tp
        "attn_qkv_b": P(None, "tp"),
        "attn_proj_w": P(None, "tp", None),  # row-parallel -> all_reduce
        "mlp_w1": P(None, None, "tp"),
        "mlp_w2": P(None, None, "tp"),
        "mlp_proj_w": P(None, "tp", None),
    }
    rules = {
        "wte": P(),
        "layers": layers,
        "ln_f": P(),
        "lm_head": P(None, "tp"),            # vocab-parallel logits
    }
    if with_visual:
        vis_blocks = {
            "ln_1_w": P(), "ln_1_b": P(), "ln_2_w": P(), "ln_2_b": P(),
            "attn_qkv_w": P(None, None, "tp"), "attn_qkv_b": P(None, "tp"),
            "attn_proj_w": P(None, "tp", None), "attn_proj_b": P(),
            "mlp_fc_w": P(None, None, "tp"), "mlp_fc_b": P(None, "tp"),
            "mlp_proj_w": P(None, "tp", None), "mlp_proj_b": P(),
        }
        rules["visual"] = {
            "patch_w": P(), "pos_embed": P(),
            "ln_pre_w": P(), "ln_pre_b": P(), "ln_post_w": P(), "ln_post_b": P(),
            "blocks": vis_blocks,
            "resampler": {
                "query": P(), "q_pos": P(), "kv_pos": P(),
                "kv_proj_w": P(), "ln_q_w": P(), "ln_q_b": P(),
                "ln_kv_w": P(), "ln_kv_b": P(),
                "attn_q_w": P(None, "tp"), "attn_q_b": P("tp"),
                "attn_k_w": P(None, "tp"), "attn_k_b": P("tp"),
                "attn_v_w": P(None, "tp"), "attn_v_b": P("tp"),
                "attn_out_w": P("tp", None), "attn_out_b": P(),
            },
            "proj": P(),
        }
    return rules


# the fused [q | k | v] leaves: rank r takes heads r*nh/tp .. (r+1)*nh/tp
# of each third, not a contiguous third of the whole
_FUSED_QKV = {("layers", "attn_qkv_w"), ("layers", "attn_qkv_b"),
              ("visual", "blocks", "attn_qkv_w"), ("visual", "blocks", "attn_qkv_b")}


def _tp_divisor(path: tuple, cfg) -> int:
    """The count that tp must divide for the site of a tp-sharded leaf to
    be split: its heads, its MLP width or the vocabulary."""
    v = cfg.visual
    name = path[-1]
    if path[0] == "lm_head":
        return cfg.vocab_size
    if path[0] == "layers":
        return cfg.num_heads if name.startswith("attn") else cfg.ff_half
    if path[:2] == ("visual", "blocks"):
        return v.heads if name.startswith("attn") else v.mlp_dim
    if path[:2] == ("visual", "resampler"):
        return v.resampler_heads
    raise ValueError(f"shard_params: no tp site for {'.'.join(path)}")


def _shard_leaf(leaf: torch.Tensor, spec: P, path: tuple, mesh: Mesh, cfg):
    axes = [a for a in spec if a is not None]
    if not axes:
        return leaf
    if axes != ["tp"]:
        raise NotImplementedError(f"shard_params: {'.'.join(path)} is sharded over {axes}; "
                                  "only tp is ported")
    if isinstance(leaf, dict):
        raise NotImplementedError(f"shard_params: {'.'.join(path)} is int8; int8 weights "
                                  "under tp are not ported (tdax's rules describe fp leaves)")
    n, r = mesh.shape["tp"], mesh.local_rank("tp")
    if n == 1 or _tp_divisor(path, cfg) % n:
        return leaf  # a site whose heads tp does not divide runs replicated
    dim = spec.index("tp")
    if path in _FUSED_QKV:
        thirds = leaf.chunk(3, dim=dim)
        return torch.cat([t.chunk(n, dim=dim)[r] for t in thirds], dim=dim)
    return leaf.chunk(n, dim=dim)[r].clone(memory_format=torch.contiguous_format)


def shard_params(params: dict, mesh: Mesh, rules: dict | None = None, *, cfg) -> dict:
    """This rank's local tree of ``params`` under ``rules`` (default
    ``param_sharding_rules``): each tp-sharded leaf's slice for this
    rank's tp index, copied so the whole tree can be freed; replicated
    leaves are the same tensors.  The fused qkv leaves are split by
    heads within each of q, k and v.  A site whose head count (MLP
    width, vocabulary) ``cfg``'s tp does not divide keeps its whole
    weights and runs replicated: the model sees whole shapes there and
    sums nothing."""
    rules = rules or param_sharding_rules("visual" in params)

    def walk(tree, spec_tree, path):
        out = {}
        for key, leaf in tree.items():
            spec = spec_tree[key]
            if isinstance(spec, dict):
                out[key] = walk(leaf, spec, path + (key,))
            else:
                out[key] = _shard_leaf(leaf, spec, path + (key,), mesh, cfg)
        return out

    return walk(params, rules, ())
