"""The collectives a data mesh needs, which GSPMD inserts for the JAX
package: a differentiable all-gather, a sum (and max) all-reduce, a
broadcast and a gather to rank 0, over ``mesh.group``.

NCCL runs them on the card's tensors. gloo runs them on host tensors: its
CUDA paths copy to the host anyway and not every collective has one (no
CUDA all-gather or reduce-scatter in some versions), so a CUDA tensor on
a gloo group is staged through a pinned host buffer of the mesh's
(``Mesh.staging``) and copied back. Only the communication leaves the
card; the computation never does.

Every call is synchronous and collective: each rank of the group makes
it, in the same order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(mesh, t) -> bool:
    return t.device.type == "cuda" and \
        dist.get_backend(mesh.group) == dist.Backend.GLOO


def all_reduce(t, mesh, op: str = "sum"):
    """``t`` reduced over the ranks (``op`` "sum" or "max"), in place;
    returns ``t``. The result is the same on every rank."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if not _staged(mesh, t):
        dist.all_reduce(t, red, group=mesh.group)
        return t
    host = mesh.staging(t.shape, t.dtype)
    host.copy_(t)
    dist.all_reduce(host, red, group=mesh.group)
    return t.copy_(host)


def broadcast(t, mesh, src: int = 0):
    """``t`` from rank ``src`` into every rank's ``t``, in place (a bool
    tensor goes as its bytes)."""
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


def all_gather(t, mesh):
    """Every rank's ``t`` (the same shape on each) stacked along dim 0 in
    rank order: [world * t.shape[0], ...], on ``t``'s device."""
    if dist.get_backend(mesh.group) != dist.Backend.GLOO:
        out = torch.empty((mesh.world * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group)
        return out
    if _staged(mesh, t):
        host = mesh.staging(t.shape, t.dtype)
        host.copy_(t)
    else:
        host = t.detach().contiguous()
    parts = [torch.empty_like(host) for _ in range(mesh.world)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat(parts).to(t.device)


def gather_to_rank0(t, mesh):
    """Every rank's ``t`` stacked along dim 0 in rank order, as a host
    tensor on rank 0 (``None`` on the others): what rank 0 writes to a
    checkpoint."""
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
        ctx.mesh, ctx.n = mesh, t.shape[0]
        return all_gather(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        mesh, n = ctx.mesh, ctx.n
        grad = all_reduce(grad.contiguous().clone(), mesh)
        return grad[mesh.rank * n:(mesh.rank + 1) * n], None


def all_gather_grad(t, mesh):
    """``all_gather`` under autograd: the backward sums the whole's
    gradient over the ranks and keeps this rank's block."""
    return _AllGather.apply(t, mesh)


def barrier(mesh):
    dist.barrier(group=mesh.group)
