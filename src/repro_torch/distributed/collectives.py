"""The collectives a mesh needs, which GSPMD inserts for the JAX
package: a differentiable all-gather, a sum (and max) all-reduce, a
reduce-scatter, a broadcast and a gather to rank 0, over ``mesh.group``
or, with ``axis=``, over one axis's group (``Mesh.group_of``); a call
over an axis of size 1 returns at once.

Tensor parallelism (the LM family on the model axis) uses three
autograd-aware ones:

- ``copy_to(x, mesh, axis)`` -- Megatron's *f*, "copy to the model
  region": identity forward, an all-reduce of the gradient backward. It
  stands where a tensor that every rank of the axis holds whole enters
  a computation each rank does on its own block of the weights.
- ``reduce_from(x, mesh, axis)`` -- Megatron's *g*, "reduce from the
  model region": an all-reduce forward, identity backward. It sums the
  partial outputs of a row-parallel product (or any value each rank
  holds a part of), and each rank's gradient is its own part's.
- ``gather_weight(w, mesh, dim)`` -- FSDP: the data axis's blocks of a
  weight joined along ``dim`` forward; the gradient of the whole summed
  over the data axis and this rank's block kept (a reduce-scatter)
  backward.

A table cut by rows over ``model`` (the LM's vocabulary, the recsys
families' embedding tables) is read through ``owned_rows``: the rows of
the ids this rank's block holds, 0 for the others, whose sum over the
axis (``reduce_from``) is the whole lookup. ``gather_tree`` joins every
rank's blocks of a placed tree back into the whole tree, blocks of
unequal length too (``gather_blocks``).

``axis`` is an axis name, a tuple of them (the data axes, ``("pod",
"data")``), or a ``sharding.SubAxis``: the group of consecutive model
ranks that share a replicated KV head, over which ``copy_to`` sums the
head's gradient parts.

NCCL runs them on the card's tensors. gloo runs them on host tensors: its
CUDA paths copy to the host anyway and not every collective has one (no
CUDA all-gather or reduce-scatter in some versions), so a CUDA tensor on
a gloo group is staged through a pinned host buffer of the mesh's
(``Mesh.staging``) and copied back. Only the communication leaves the
card; the computation never does.

Every call is synchronous and collective: each rank of the group makes
it, in the same order.

On meta tensors (the dry-run's count of one rank's step,
``launch/dryrun.py``) a collective calls no ``dist`` function and needs
no process group: it returns a meta tensor of the shape the real call
returns and records its kind, result bytes and group size in each active
dispatch mode that counts collectives (``op_analysis.OpCounter``), as the
kernels' meta routes record their work. Its wire bytes a rank follow the
ring formulas of the JAX package's ``launch/hlo_analysis.py``. A
sum-reduced block (``reduce_scatter``) counts as a reduce-scatter on
every backend (gloo makes it an all-reduce and a slice), a broadcast as
a point-to-point transfer of its tensor.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def _counted(kind: str, result, mesh, axis=None):
    """``result`` (a meta tensor), after recording a collective of
    ``kind`` (the JAX package's names: "all-gather", "all-reduce",
    "reduce-scatter", "collective-permute") over ``axis``'s group in each
    active dispatch mode with ``add_collective``."""
    n = result.numel() * result.element_size()
    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "add_collective"):
            mode.add_collective(kind, n, mesh.size(axis),
                                mesh.in_one_node(axis))
    return result


def _meta(t) -> bool:
    return t.device.type == "meta"


def _gloo(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _staged(mesh, t, group=None) -> bool:
    return t.device.type == "cuda" and \
        _gloo(mesh.group if group is None else group)


def all_reduce(t, mesh, op: str = "sum", axis: str | None = None):
    """``t`` reduced over the ranks (``op`` "sum" or "max"), or over
    ``axis``'s, in place; returns ``t``. The result is the same on every
    rank of the group."""
    if mesh.size(axis) == 1:
        return t
    if _meta(t):
        return _counted("all-reduce", t, mesh, axis)
    group = mesh.group_of(axis)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if not _staged(mesh, t, group):
        dist.all_reduce(t, red, group=group)
        return t
    host = mesh.staging(t.shape, t.dtype)
    host.copy_(t)
    dist.all_reduce(host, red, group=group)
    return t.copy_(host)


def broadcast(t, mesh, src: int = 0):
    """``t`` from rank ``src`` into every rank's ``t``, in place (a bool
    tensor goes as its bytes)."""
    if mesh.world == 1:
        return t
    if _meta(t):
        return _counted("collective-permute", t, mesh)
    if t.dtype == torch.bool:
        broadcast(t.view(torch.uint8), mesh, src)
        return t
    if not _staged(mesh, t):
        dist.broadcast(t, src, group=mesh.group)
        return t
    host = mesh.staging(t.shape, t.dtype)
    host.copy_(t)
    dist.broadcast(host, src, group=mesh.group)
    return t.copy_(host)


def all_gather(t, mesh, axis: str | None = None, dim: int = 0):
    """Every rank's ``t`` (the same shape on each) joined along ``dim``
    in rank order (over ``axis``'s ranks, in their order along it), on
    ``t``'s device: dim 0 of [world * t.shape[0], ...] by default."""
    n = mesh.size(axis)
    if n == 1:
        return t
    if _meta(t):
        shape = list(t.shape)
        shape[dim] *= n
        return _counted("all-gather", t.new_empty(shape), mesh, axis)
    group = mesh.group_of(axis)
    if not _gloo(group):
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim) if dim else out
    if _staged(mesh, t, group):
        host = mesh.staging(t.shape, t.dtype)
        host.copy_(t)
    else:
        host = t.detach().contiguous()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    if t.device.type == "cpu":
        return torch.cat(parts, dim)
    # each part straight into its place on the card (no joined host copy)
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = n * size
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    for i, part in enumerate(parts):
        out.narrow(dim, i * size, size).copy_(part)
    return out


def reduce_scatter(t, mesh, axis: str | None = None, dim: int = 0):
    """``t`` summed over the ranks (of ``axis``), and this rank's block
    along ``dim`` kept: [t.shape[dim] / n] there, a tensor of its own.
    gloo has no reduce-scatter: an all-reduce, then the block."""
    n = mesh.size(axis)
    if n == 1:
        return t
    i, size = mesh.index(axis), t.shape[dim] // n
    if _meta(t):
        shape = list(t.shape)
        shape[dim] = size
        return _counted("reduce-scatter", t.new_empty(shape), mesh, axis)
    group = mesh.group_of(axis)
    if not _gloo(group):
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((size,) + tuple(src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim) if dim else out
    whole = all_reduce(t.detach().contiguous().clone(), mesh, axis=axis)
    return whole.narrow(dim, i * size, size).clone()


def gather_to_rank0(t, mesh):
    """Every rank's ``t`` stacked along dim 0 in rank order, as a host
    tensor on rank 0 (``None`` on the others): what rank 0 writes to a
    checkpoint."""
    if _meta(t):
        return all_gather(t, mesh) if mesh.rank == 0 else None
    if t.device.type == "cuda" and not _staged(mesh, t):
        full = all_gather(t, mesh)           # NCCL: gather onto the card
        return full.cpu() if mesh.rank == 0 else None
    host = t.detach().cpu().contiguous()
    parts = ([torch.empty_like(host) for _ in range(mesh.world)]
             if mesh.rank == 0 else None)
    dist.gather(host, parts, dst=0, group=mesh.group)
    return torch.cat(parts) if mesh.rank == 0 else None


class _AllGather(torch.autograd.Function):
    """Forward: every rank's block, concatenated. Backward: the gradient
    of the whole summed over the ranks (each rank's loss reads the whole),
    and this rank's block of it kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_gather(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad.contiguous(), ctx.mesh), None


def all_gather_grad(t, mesh):
    """``all_gather`` under autograd: the backward sums the whole's
    gradient over the ranks and keeps this rank's block."""
    return _AllGather.apply(t, mesh)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.mesh,
                          axis=ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous().clone(), mesh, axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherWeight(torch.autograd.Function):
    """FSDP: all-gather along ``dim`` forward, reduce-scatter (a sum)
    backward."""

    @staticmethod
    def forward(ctx, w, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(w, mesh, axis=axis, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.mesh, axis=ctx.axis,
                              dim=ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """reduce_scatter forward; all_gather of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(x, mesh, axis=axis, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), ctx.mesh, axis=ctx.axis,
                          dim=ctx.dim), None, None, None


def reduce_scatter_grad(x, mesh, axis: str, dim: int = 0):
    """``reduce_scatter`` under autograd: the sum over ``axis`` and this
    rank's block along ``dim`` forward; the blocks' gradients joined
    backward (each rank's partial input feeds every rank's block)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim)


def copy_to(x, mesh, axis: str = "model"):
    """Megatron's *f* over ``axis``: x forward; the gradient all-reduced
    over the axis backward (x itself where the axis has size 1)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis: str = "model"):
    """Megatron's *g* over ``axis``: x summed over the axis forward (a new
    tensor); the gradient passed through backward."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather_weight(w, mesh, dim: int, axis: str = "data"):
    """FSDP's gather of a weight's blocks over ``axis`` along ``dim``; the
    backward sums the gradient of the whole over the axis and keeps this
    rank's block."""
    if mesh is None or mesh.size(axis) == 1:
        return w
    return _GatherWeight.apply(w, mesh, axis, dim)


def owned_rows(table, ids, mesh, axis: str = "model", dtype=None):
    """The rows of ``ids`` that this rank's block of a table cut by rows
    over ``axis`` holds (``table`` is that block, rows [i V/M, (i+1)
    V/M)), 0 for the ids it does not hold; cast to ``dtype``. Summed over
    the axis (``reduce_from``) they are the whole lookup. The ids another
    rank holds read row ``id % (V/M)`` before they are zeroed, spread over
    the block: pointed at one row they would make it one hot key in the
    gather's backward (an index-add that serialises a row's
    duplicates)."""
    Vl = table.shape[0]
    local = ids - mesh.index(axis) * Vl
    own = (local >= 0) & (local < Vl)
    rows = table[torch.where(own, local, ids % Vl)]
    if dtype is not None:
        rows = rows.to(dtype)
    return torch.where(own[..., None], rows, rows.new_zeros(()))


def gather_blocks(t, mesh, entry, dim: int):
    """The whole dim ``dim`` of a leaf cut by ``entry`` (a
    ``sharding.Blocks``: blocks of their own lengths, replicas shared)
    from every rank's block ``t``: each block padded to the longest, one
    all-gather over the entry's axis, then each rank's block put at its
    bounds (a replica's copies alike)."""
    n = mesh.size(entry.axis)
    longest = max(hi - lo for lo, hi in entry.bounds)
    pad = list(t.shape)
    pad[dim] = longest - t.shape[dim]
    padded = torch.cat([t, t.new_zeros(pad)], dim) if pad[dim] else t
    every = all_gather(padded.contiguous(), mesh, entry.axis, dim=dim)
    shape = list(t.shape)
    shape[dim] = entry.size
    out = t.new_empty(shape)
    if _meta(t):
        return out
    for i in range(n):
        lo, hi = entry.block(i)
        out.narrow(dim, lo, hi - lo).copy_(
            every.narrow(dim, i * longest, hi - lo))
    return out


def gather_tree(blocks, specs, mesh):
    """The whole tree from every rank's ``blocks`` (``specs`` a tree of
    Specs of the same layout): each leaf all-gathered over each axis its
    spec names (a ``Blocks`` entry by ``gather_blocks``), on every rank.
    A check's and a checkpoint's read, not a step's."""
    from .sharding import Blocks, tree_map

    def whole(spec, leaf):
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            if isinstance(entry, Blocks):
                leaf = gather_blocks(leaf, mesh, entry, d)
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            for a in reversed(axes):         # the minor axis first
                leaf = all_gather(leaf, mesh, a, dim=d)
        return leaf

    return tree_map(whole, specs, blocks)


def barrier(mesh, axis: str | None = None):
    if mesh.size(axis) > 1 and mesh.group is not None:
        dist.barrier(group=mesh.group_of(axis))
