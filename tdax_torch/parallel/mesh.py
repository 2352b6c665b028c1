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
(``"nccl.all_gather"``, ...), so a run can show which ran;
``COLLECTIVE_BYTES`` adds up the bytes of the tensors they took or
gave this rank, under the same keys.  Under gloo ``reduce_scatter`` is
an all_reduce of the whole tensor and this rank's slice of the sum,
counted as ``"gloo.reduce_scatter"`` with the whole tensor's bytes: it
adds in the all_reduce's order, so a sequence-parallel forward over gloo
is the plain tp forward bit for bit, at tp times the bytes of gloo's
own ``reduce_scatter_tensor``.

``COLLECTIVES_BY_AXIS`` counts the same calls by mesh axis and kind
(``"dp.all_gather"``, ``"dcn.all_reduce"``, ``"dcn+dp.all_reduce"`` for
the combined batch axes of a hybrid mesh), so a run shows which axis
each crossed.

FSDP (ZeRO-3): ``fsdp_sharding_rules`` adds a ``"dp"`` dim to the large
leaves' specs, ``shard_params`` keeps this rank's contiguous share of it
(after its tp split) and ``unshard_params`` gathers it back; the model
gathers such a leaf where a block reads it (``models/qwen_vl/fsdp.py``).
``make_hybrid_mesh`` lays the ranks out as (dcn, dp, tp) slices, its
batch over the combined ``("dcn", "dp")`` axes.

Context parallelism: ``make_mesh(cp > 1)`` adds tdax's innermost "cp"
axis and the combined ``("dp", "cp")`` group the loss and the gradients
are summed over; ``ppermute`` is tdax's ``lax.ppermute`` over a mesh
axis (point-to-point sends, differentiable: its backward sends each
gradient along the inverse permutation; a partial permutation such as a
chain gives zeros where no rank sends), which the ring attention's
rotations and zigzag relayout run (``tdax_torch.ops.ring_attention``),
counted as ``"<backend>.ppermute"`` and ``"cp.ppermute"``.  The
pipeline (``tdax_torch.parallel.pipeline``) moves its activations and
gradients with ``send_recv``: only the transfers its static schedule
names, counted once a tensor sent (``"pp.ppermute"``).

Every collective here, and every function of the port that runs one
(``sharded_ops``, the sweep and scale paths under a process group), is
called by every rank of the group with the same arguments: a rank that
skips the call leaves the others waiting until the group's timeout.
``send_recv`` is the exception: only the ranks it names take part.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from tdax_torch.runtime import get_device

COLLECTIVES: dict[str, int] = {}
COLLECTIVE_BYTES: dict[str, int] = {}
COLLECTIVES_BY_AXIS: dict[str, int] = {}


class P(tuple):
    """A partition spec: one mesh axis name (or None) per leading
    dimension of a leaf, as ``jax.sharding.PartitionSpec``; the dims past
    its length are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


class Mesh:
    """A grid of the process group's ranks (``make_mesh``: dp x tp, or dp
    x tp x cp; ``make_hybrid_mesh``: dcn x dp x tp;
    ``pipeline.make_pp_mesh``: dp x pp), over a ``DeviceMesh`` whose
    sub-groups carry the collectives.  ``shape`` maps each axis name to
    its size and ``axis_names`` lists them, as ``jax.sharding.Mesh``'s
    do.  An axis argument is one name or a tuple of names (their ranks
    together, outer axis first), such as ``batch_axis``: the axes the
    batch is split over, ``"dp"``, or ``("dcn", "dp")`` on a hybrid
    mesh."""

    def __init__(self, device_mesh, batch_axis="dp", groups: dict | None = None):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.batch_axis = batch_axis
        self._groups = groups or {}

    def group(self, axis):
        if isinstance(axis, tuple):
            return self._groups[axis]
        return self.device_mesh.get_group(axis)

    def size(self, axis) -> int:
        """The number of ranks along ``axis``."""
        return math.prod(self.shape[a] for a in _axes(axis))

    def local_rank(self, axis) -> int:
        """This rank's index along ``axis`` (row-major over a tuple)."""
        r = 0
        for a in _axes(axis):
            r = r * self.shape[a] + self.device_mesh.get_local_rank(a)
        return r


class NamedSharding(NamedTuple):
    """A partition spec bound to a mesh: where tdax has
    ``jax.sharding.NamedSharding`` (``named_shardings``,
    ``batch_sharding``, ``replicated``)."""

    mesh: Mesh
    spec: P


def _axes(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def axis_label(axis) -> str:
    """``"dp"``, or ``"dcn+dp"`` for the combined axes ``("dcn", "dp")``."""
    return "+".join(_axes(axis))


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


def joined() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def is_writer() -> bool:
    """Whether this process writes the files of a run: rank 0 of the
    process group, or the process itself without one."""
    return not joined() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits for the others (after the writer's files); a
    no-op without a process group."""
    if joined():
        dist.barrier()


def dp_mesh(n: int) -> "Mesh | None":
    """A dp mesh over every rank of the process group when one is joined
    and its size divides ``n`` (a batch's rows, a stack's layers), as
    tdax splits such an axis over its devices only when they divide it;
    None otherwise: every rank then runs the whole axis."""
    if not joined() or n % dist.get_world_size():
        return None
    return make_mesh(dp=dist.get_world_size())


def make_mesh(dp: int | None = None, tp: int = 1, cp: int = 1) -> Mesh:
    """dp x tp mesh over the process group's ranks, tp innermost (a tp
    group is ``tp`` consecutive ranks).  ``cp > 1`` adds the
    context-parallel axis innermost, as tdax's: the mesh ("dp", "tp",
    "cp"), rank (d * tp + t) * cp + c, a cp ring being ``cp``
    consecutive ranks.  Its batch is split over dp; the loss and the
    gradients are summed over the combined ("dp", "cp") group
    (``mesh.group(("dp", "cp"))``), one a tp index.  At cp = 1 the mesh
    has no "cp" axis, as tdax's."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    n = dist.get_world_size()
    if dp is None:
        dp = n // (tp * cp)
    if dp * tp * cp != n:
        raise ValueError(f"dp*tp*cp = {dp}*{tp}*{cp} != {n} ranks")
    if cp == 1:
        return Mesh(_device_mesh((dp, tp), ("dp", "tp")))
    device_mesh = _device_mesh((dp, tp, cp), ("dp", "tp", "cp"))
    # the combined (dp, cp) group of each tp index, ranks in (dp, cp) order;
    # every rank creates every group, in one order
    sum_group, _ = dist.new_subgroups_by_enumeration(
        [[(d * tp + t) * cp + c for d in range(dp) for c in range(cp)] for t in range(tp)])
    return Mesh(device_mesh, groups={("dp", "cp"): sum_group})


def _device_mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_hybrid_mesh(dcn: int, dp: int | None = None, tp: int = 1) -> Mesh:
    """dcn x dp x tp mesh over the process group's ranks (tdax's hybrid
    ICI x DCN mesh for multi-slice topologies): ``dcn`` slices of
    ``dp * tp`` consecutive ranks each, tp innermost.  Only collectives
    over ``"dcn"`` cross slices.  The batch is split over the combined
    ``("dcn", "dp")`` axes (``hybrid_batch_sharding``, the mesh's
    ``batch_axis``); FSDP rules built on this mesh shard over the
    within-slice ``"dp"`` only, so a weight gather never crosses a
    slice and a gradient's one cross-slice collective is its all_reduce
    over ``"dcn"``.  tdax places slices by the devices' ``slice_index``;
    here a slice is a block of consecutive ranks, as tdax's virtual
    devices are."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_hybrid_mesh: no process group; call init_distributed first")
    n = dist.get_world_size()
    if dcn < 1 or n % dcn:
        raise ValueError(f"{n} devices do not divide into dcn={dcn} slices")
    per_slice = n // dcn
    if dp is None:
        dp = per_slice // tp
    if dp * tp != per_slice:
        raise ValueError(f"dp*tp = {dp}*{tp} != {per_slice} devices/slice "
                         f"({n} devices / dcn={dcn})")
    device_mesh = _device_mesh((dcn, dp, tp), ("dcn", "dp", "tp"))
    # the combined (dcn, dp) group of each tp index, ranks in (dcn, dp) order;
    # every rank creates every group, in one order
    batch_group, _ = dist.new_subgroups_by_enumeration(
        [[(s * dp + d) * tp + t for s in range(dcn) for d in range(dp)] for t in range(tp)])
    return Mesh(device_mesh, batch_axis=("dcn", "dp"), groups={("dcn", "dp"): batch_group})


def _count(kind: str, group, nbytes: int = 0, axis=None) -> None:
    key = f"{dist.get_backend(group)}.{kind}"
    COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1
    COLLECTIVE_BYTES[key] = COLLECTIVE_BYTES.get(key, 0) + nbytes
    if axis is not None:
        key = f"{axis_label(axis)}.{kind}"
        COLLECTIVES_BY_AXIS[key] = COLLECTIVES_BY_AXIS.get(key, 0) + 1


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s group, in place; returns ``x``."""
    group = mesh.group(axis)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    _count("all_reduce", group, _nbytes(x), axis)
    return x


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's 1/p of ``x``'s sum over ``axis``'s group along ``dim``
    (p the group's size, which must divide it), a contiguous tensor.
    ``x`` is the caller's scratch (every caller's is a fresh f32 buffer):
    gloo sums in it when it is contiguous, and the result may view it.
    NCCL runs ``reduce_scatter_tensor``; gloo an all_reduce of the whole
    tensor, then the slice (the module's docstring has why)."""
    group = mesh.group(axis)
    p, r = mesh.size(axis), mesh.local_rank(axis)
    if x.shape[dim] % p:
        raise ValueError(f"reduce_scatter: {x.shape[dim]} does not divide over the {p} ranks "
                         f"of mesh axis {axis!r}")
    per = x.shape[dim] // p
    if dist.get_backend(group) == "gloo":
        buf = x.contiguous()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        out = buf.narrow(dim, r * per, per).contiguous()
    else:
        src = x.movedim(dim, 0).contiguous()
        part = src.new_empty((per,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(part, src, op=dist.ReduceOp.SUM, group=group)
        out = part.movedim(0, dim).contiguous()
    _count("reduce_scatter", group, _nbytes(x), axis)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ``x`` of every rank of ``axis``'s group, concatenated along
    ``dim`` in the group's rank order (every rank's ``x`` has one shape).
    Under gloo a CUDA tensor goes through the host."""
    group = mesh.group(axis)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    _count("all_gather", group, _nbytes(src) * len(parts), axis)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int = 0) -> torch.Tensor:
    """``x`` of the rank at index ``src`` of ``axis``'s group (its first
    by default) on every rank of it, in place; returns ``x``."""
    group = mesh.group(axis)
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    _count("broadcast", group, _nbytes(x), axis)
    return x


def _post(group, sends: list, recvs: list) -> None:
    """Every send ``(index, tensor, tag)`` and receive ``(index, buffer,
    tag)`` (index: the peer's place in ``group``) posted as one batch of
    point-to-point ops, then waited for.  A pair of ranks posts its
    sends and receives in one order (gloo matches them by peer and tag,
    NCCL by peer and order)."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group, tag=tag)
           for peer, t, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer), group, tag=tag)
            for peer, t, tag in recvs]
    if not ops:
        return
    works = (dist.batch_isend_irecv(ops) if dist.get_backend(group) == "nccl"
             else [op.op(op.tensor, op.peer, op.group, op.tag) for op in ops])
    for work in works:
        work.wait()


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as this group sends it: through the host when it is a CUDA
    tensor under gloo; contiguous."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = x.cpu()
    return x.contiguous()


def _buffer(like: torch.Tensor, group) -> torch.Tensor:
    """An empty tensor shaped like ``like`` where this group receives it
    (the host for a CUDA tensor under gloo)."""
    staged = like.is_cuda and dist.get_backend(group) == "gloo"
    return torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)


def _check_perm(perm, n: int, axis: str) -> None:
    """A (partial) permutation of the ``n`` indices along ``axis``, as
    ``lax.ppermute`` takes it: no index twice as a source or as a
    destination."""
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a permutation of mesh axis {axis!r} "
                         f"({n} ranks): an index is named twice as a source or a "
                         "destination, or lies outside the axis")


def _exchange(xs: list, mesh: Mesh, axis: str, perms: list) -> list:
    """``ppermute``'s collective: every tensor sent along its perm in one
    batch of point-to-point ops (tensor i tagged i, so gloo cannot swap
    two tensors of one shape); a pair from this rank to itself is a copy,
    a rank no pair sends to gets zeros."""
    group = mesh.group(axis)
    me = mesh.local_rank(axis)
    outs, sends, recvs, sent = [None] * len(xs), [], [], 0
    for i, (x, perm) in enumerate(zip(xs, perms)):
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if src == [me]:
            outs[i] = x.clone(memory_format=torch.contiguous_format)
            continue  # a permutation's fixed point: no send, no receive
        if dst:
            src_x = _staged(x, group)
            sends.append((dst[0], src_x, i))
            sent += _nbytes(src_x)
        if src:
            outs[i] = _buffer(x, group)
            recvs.append((src[0], outs[i], i))
        else:
            outs[i] = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    _post(group, sends, recvs)
    _count("ppermute", group, sent, axis)
    return [out.to(x.device) if out.device != x.device else out for out, x in zip(outs, xs)]


def _inverse(perm) -> list:
    return [(d, s) for s, d in perm]


class _PPermute(torch.autograd.Function):
    """``_exchange`` with the inverse permutations in the backward; a
    tensor that needs no gradient (a key bias) is not sent back."""

    @staticmethod
    def forward(ctx, mesh, axis, perms, *xs):
        ctx.mesh, ctx.axis, ctx.perms = mesh, axis, perms
        ctx.shapes, ctx.dtypes = [x.shape for x in xs], [x.dtype for x in xs]
        ctx.device = xs[0].device
        ctx.set_materialize_grads(False)
        outs = _exchange(list(xs), mesh, axis, perms)
        ctx.mark_non_differentiable(*[o for o, x in zip(outs, xs) if not x.requires_grad])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        idx = [i for i, need in enumerate(ctx.needs_input_grad[3:]) if need]
        # a gradient autograd left undefined is zero: every rank sends each
        # tensor that needs one, whatever its own graph used
        back = _exchange([torch.zeros(ctx.shapes[i], dtype=ctx.dtypes[i], device=ctx.device)
                          if gs[i] is None else gs[i] for i in idx],
                         ctx.mesh, ctx.axis, [_inverse(ctx.perms[i]) for i in idx])
        grads = [None] * len(gs)
        for i, g in zip(idx, back):
            grads[i] = g
        return (None, None, None, *grads)


def ppermute(x, mesh: Mesh, axis: str, perm):
    """``x`` moved along ``axis`` as ``lax.ppermute`` moves it: for each
    (src, dst) pair of ``perm`` (a permutation of the indices along the
    axis, or a partial one: no index twice as a source or as a
    destination) the rank at src sends its ``x`` to the rank at dst; a
    rank no pair sends to gets zeros, a rank that is no pair's source
    sends nothing (a chain ``[(i, i + 1) ...]``: the first rank gets
    zeros, the last sends nothing).  ``x`` may be a list of tensors,
    sent together in one batch of point-to-point ops (the same sends in
    the same order on every rank); ``perm`` is then one permutation for
    all or a list of them, one a tensor.  Differentiable: the backward
    sends each gradient along the inverse permutation.  Under gloo a
    CUDA tensor goes through the host.  Collective over ``axis``'s
    group, counted as ``"<backend>.ppermute"`` with the bytes this rank
    sent."""
    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    perms = list(perm) if isinstance(perm[0][0], (list, tuple)) else [list(perm)] * len(xs)
    for p in perms:
        _check_perm(p, mesh.shape[axis], axis)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        outs = list(_PPermute.apply(mesh, axis, perms, *xs))
    else:
        outs = _exchange(xs, mesh, axis, perms)
    return outs[0] if isinstance(x, torch.Tensor) else outs


def send_recv(sends: list, mesh: Mesh, axis: str, recvs: list) -> list:
    """Point-to-point transfers along ``axis`` that a static schedule
    names (the pipeline's): each ``(index, tensor, tag)`` of ``sends``
    goes to the rank at that index of the axis, and for each ``(index,
    like, tag)`` of ``recvs`` a tensor shaped like ``like`` (its dtype and
    device) comes from the rank at that index; all posted as one batch,
    then waited for.  Returns the received tensors in ``recvs``' order.
    Only the ranks named take part: each peer posts the matching
    receives and sends, with the same tags, in the same order.  Under
    gloo a CUDA tensor goes through the host.  Counted as one
    ``"<backend>.ppermute"`` a tensor sent, with its bytes."""
    group = mesh.group(axis)
    sends = [(peer, _staged(t, group), tag) for peer, t, tag in sends]
    bufs = [_buffer(like, group) for _, like, _ in recvs]
    _post(group, sends, [(peer, buf, tag) for (peer, _, tag), buf in zip(recvs, bufs)])
    for _, t, _ in sends:
        _count("ppermute", group, _nbytes(t), axis)
    return [buf.to(like.device) for buf, (_, like, _) in zip(bufs, recvs)]


def _first_rank(mesh: Mesh) -> int:
    return int(mesh.device_mesh.mesh.flatten()[0])


def broadcast_object(obj, mesh: Mesh, axis: str | None = None, src: int = 0):
    """The mesh's first rank's ``obj`` (any picklable value) on every rank
    of the process group, which ``make_mesh``'s meshes span; with
    ``axis``, the ``obj`` of the rank at index ``src`` of this rank's
    group along it on every rank of that group.  The other ranks' ``obj``
    is ignored."""
    box = [obj]
    if axis is None:
        dist.broadcast_object_list(box, src=_first_rank(mesh))
        _count("broadcast_object", None)
    else:
        group = mesh.group(axis)
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, src), group=group)
        _count("broadcast_object", group, axis=axis)
    return box[0]


def is_first_rank(mesh: Mesh) -> bool:
    """Whether this rank is the mesh's first."""
    return dist.get_rank() == _first_rank(mesh)


def split_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous share of ``x``'s rows (dim 0) over the mesh's
    ``batch_axis`` (dp, or dcn x dp on a hybrid mesh), whose size must
    divide them."""
    n, r = mesh.size(mesh.batch_axis), mesh.local_rank(mesh.batch_axis)
    if x.shape[0] % n:
        raise ValueError(f"split_batch: batch {x.shape[0]} does not divide over "
                         f"{axis_label(mesh.batch_axis)}={n}")
    per = x.shape[0] // n
    return x[r * per:(r + 1) * per]


def gather_batch(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The whole batch back from every batch rank's share along ``dim``
    (``split_batch``'s inverse)."""
    return all_gather(x, mesh, mesh.batch_axis, dim)


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


def _splits(spec: P, path: tuple, mesh: Mesh, cfg) -> bool:
    """Whether ``shard_params`` splits the leaf at ``path`` (under
    ``spec``) over tp: its rule names tp, tp > 1 and tp divides its site."""
    axes = [a for a in spec if a is not None]
    if any(a not in ("tp", "dp") for a in axes):
        raise NotImplementedError(f"shard_params: {'.'.join(path)} is sharded over {axes}; "
                                  "only tp and dp are ported")
    if "tp" not in axes:
        return False
    n = mesh.shape["tp"]
    return n > 1 and _tp_divisor(path, cfg) % n == 0  # else the site runs replicated


def dp_dim(spec: P) -> int | None:
    """The dimension ``spec`` shards over dp (an FSDP rule), or None."""
    return spec.index("dp") if "dp" in spec else None


def spec_at(rules: dict, path: tuple) -> P:
    """The spec of the leaf at ``path`` (a tuple of keys) in ``rules``."""
    for key in path:
        rules = rules[key]
    return rules


def tp_split(path: tuple, mesh: Mesh, cfg) -> bool:
    """Whether this rank holds a tp shard of the leaf at ``path`` (a
    tuple of keys of ``param_sharding_rules``), not the whole leaf."""
    return _splits(spec_at(param_sharding_rules(), path), path, mesh, cfg)


def dp_split(path: tuple, mesh: Mesh, rules: dict) -> bool:
    """Whether this rank holds a dp share of the leaf at ``path`` under
    ``rules`` (FSDP): its rule names dp and dp > 1."""
    return dp_dim(spec_at(rules, path)) is not None and mesh.shape["dp"] > 1


def _shard_leaf(leaf: torch.Tensor, spec: P, path: tuple, mesh: Mesh, cfg):
    if isinstance(leaf, dict) and any(a is not None for a in spec):
        raise NotImplementedError(f"shard_params: {'.'.join(path)} is int8; int8 weights "
                                  "under tp or dp are not ported (tdax's rules describe fp "
                                  "leaves)")
    if _splits(spec, path, mesh, cfg):
        n, r = mesh.shape["tp"], mesh.local_rank("tp")
        dim = spec.index("tp")
        if path in _FUSED_QKV:
            thirds = leaf.chunk(3, dim=dim)
            leaf = torch.cat([t.chunk(n, dim=dim)[r] for t in thirds], dim=dim)
        else:
            leaf = leaf.chunk(n, dim=dim)[r].clone(memory_format=torch.contiguous_format)
    dim, n = dp_dim(spec), mesh.shape["dp"]
    if dim is not None and n > 1:
        if leaf.shape[dim] % n:
            raise ValueError(f"shard_params: {'.'.join(path)}'s dim {dim} "
                             f"({leaf.shape[dim]}) does not divide over dp={n}")
        per = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, mesh.local_rank("dp") * per, per).clone(
            memory_format=torch.contiguous_format)
    return leaf


def _unshard_leaf(leaf: torch.Tensor, spec: P, path: tuple, mesh: Mesh, cfg):
    dim = dp_dim(spec)
    if dim is not None and mesh.shape["dp"] > 1:
        leaf = all_gather(leaf, mesh, "dp", dim=dim)
    if not _splits(spec, path, mesh, cfg):
        return leaf
    dim = spec.index("tp")
    whole = all_gather(leaf, mesh, "tp", dim=dim)
    if path in _FUSED_QKV:  # [q_0 k_0 v_0 | q_1 k_1 v_1 | ...] -> [q | k | v]
        thirds = [part.chunk(3, dim=dim) for part in whole.chunk(mesh.shape["tp"], dim=dim)]
        whole = torch.cat([t[j] for j in range(3) for t in thirds], dim=dim)
    return whole


def _walk(tree: dict, spec_tree: dict, path: tuple, fn) -> dict:
    out = {}
    for key, leaf in tree.items():
        spec = spec_tree[key]
        if isinstance(spec, dict):
            out[key] = _walk(leaf, spec, path + (key,), fn)
        else:
            out[key] = fn(leaf, spec, path + (key,))
    return out


def unshard_params(tree: dict, mesh: Mesh, cfg, rules: dict | None = None) -> dict:
    """``shard_params``' inverse: every sharded leaf of this rank's tree
    gathered whole (collective), over dp first (FSDP rules), then over
    tp, the fused qkv put back in [q | k | v] order; replicated leaves as
    they are.  Any tree in the params' layout (AdamW's moments too)."""
    rules = rules or param_sharding_rules("visual" in tree)
    return _walk(tree, rules, (), lambda leaf, spec, path: _unshard_leaf(
        leaf, spec, path, mesh, cfg))


def shard_params(params: dict, mesh: Mesh, rules: dict | None = None, *, cfg) -> dict:
    """This rank's local tree of ``params`` under ``rules`` (default
    ``param_sharding_rules``): each tp-sharded leaf's slice for this
    rank's tp index, copied so the whole tree can be freed; replicated
    leaves are the same tensors.  The fused qkv leaves are split by
    heads within each of q, k and v.  A site whose head count (MLP
    width, vocabulary) ``cfg``'s tp does not divide keeps its whole
    weights and runs replicated: the model sees whole shapes there and
    sums nothing.  Under FSDP rules (``fsdp_sharding_rules``) a leaf
    whose spec names dp then keeps this rank's contiguous 1/dp of that
    dimension (with dp > 1)."""
    rules = rules or param_sharding_rules("visual" in params)
    return _walk(params, rules, (), lambda leaf, spec, path: _shard_leaf(
        leaf, spec, path, mesh, cfg))


def fsdp_sharding_rules(params: dict, dp, base_rules: dict | None = None,
                        min_size: int = 2 ** 14) -> dict:
    """ZeRO-3 parameter sharding rules (FSDP), tdax's: each large leaf of
    ``base_rules`` (default ``param_sharding_rules``) is also sharded over
    dp on its largest dimension that carries no mesh axis and that
    ``dp`` divides, so params, gradients and AdamW's moments live 1/dp
    on each rank.  ``dp`` is the dp size or a ``Mesh`` (its own ``"dp"``
    size: on a hybrid mesh the within-slice dp).
    - a leaf of fewer than ``min_size`` elements keeps its base rule;
    - a stacked leaf (under ``layers`` / ``blocks``) never shards dim 0,
      the layer axis;
    - the dim carrying tp is skipped;
    - the spec's trailing Nones are trimmed (P(a, None) is P(a)).
    ``params`` may be any tree of objects with a ``shape``."""
    if isinstance(dp, Mesh):
        dp = dp.shape["dp"]
    base = base_rules or param_sharding_rules("visual" in params)

    def extend(leaf, spec, path):
        if isinstance(leaf, dict):
            raise NotImplementedError(f"fsdp_sharding_rules: {'.'.join(path)} is int8; FSDP "
                                      "takes floating-point parameters")
        shape = tuple(leaf.shape)
        full = tuple(spec) + (None,) * (len(shape) - len(spec))
        if math.prod(shape) < min_size:
            return spec
        first = 1 if any(key in ("layers", "blocks") for key in path) else 0
        cand = [(shape[d], d) for d in range(first, len(shape))
                if full[d] is None and shape[d] % dp == 0]
        if not cand:
            return spec
        d = max(cand)[1]
        out = ["dp" if i == d else a for i, a in enumerate(full)]
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    return _walk(params, base, (), extend)


def named_shardings(mesh: Mesh, rules: dict) -> dict:
    """Partition-spec tree -> ``NamedSharding`` tree over ``mesh`` (what
    ``make_train_step``'s ``param_shardings`` takes)."""
    return {key: named_shardings(mesh, spec) if isinstance(spec, dict)
            else NamedSharding(mesh, spec) for key, spec in rules.items()}


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """The batch over dp."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def hybrid_batch_sharding(mesh: Mesh) -> NamedSharding:
    """The batch over every data-parallel degree of a hybrid mesh: slices
    x within-slice dp (``split_batch`` splits over it)."""
    return NamedSharding(mesh, P(("dcn", "dp")))
