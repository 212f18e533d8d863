"""Mixture-of-Experts substrate.

Three implementations of one routing:
  * ``moe_dense``  -- every expert runs on every token, gated by the top-k
                      mask. O(E) FLOPs; only for small tests.
  * ``moe_gather`` -- sort-based capacity dispatch: top-k -> stable argsort
                      by expert -> fixed-capacity gather -> grouped GEMMs
                      -> combine. The one-process path.
  * ``moe_ep``     -- expert parallelism on a mesh (``launch/mesh.py``):
                      the experts over the ``model`` axis, each model rank
                      running ``moe_gather`` on its E/M experts over its
                      data shard's tokens, the outputs summed over
                      ``model``, the balance loss averaged over the data axes.

The routing (router logits in the activation dtype, softmax in f32, top-k
with ties to the lower expert index, renormalised gates, the switch
balance loss, the capacity drop) is the JAX package's, so both packages
send every token to the same experts and drop the same assignments. As
in the JAX package, ``moe_ep``'s capacity comes from the data shard's
tokens, so it drops differently from one ``moe_gather`` over the whole
batch once an expert overflows, and its balance loss is the mean of the
shards' (a function of each shard's routing, not the whole batch's).

The stages of ``moe_gather`` run under ``torch.profiler.record_function``
ranges (``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.combine``), so a profile splits an MoE layer's device time by
stage; outside a profile a range costs a few microseconds of host time.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.distributed.collectives import copy_to, reduce_from
from repro_torch.distributed.sharding import DATA_AXES

from .core import normal_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    gated: bool = True          # SwiGLU experts (w1, w3, w2) vs GELU (w1, w2)
    norm_topk: bool = True      # renormalise the top-k gates to sum to 1


def init_moe(gen: torch.Generator, cfg: MoEConfig, param_dtype=torch.float32):
    """``router`` [d, E] and the experts' ``w1``/``w3`` [E, d, f], ``w2``
    [E, f, d], drawn from ``gen`` on its device (the JAX tree's keys and
    shapes)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": normal_init(gen, (d, E), 0.02, param_dtype),
         "w1": normal_init(gen, (E, d, f), 0.02, param_dtype),
         "w2": normal_init(gen, (E, f, d), 0.02, param_dtype)}
    if cfg.gated:
        p["w3"] = normal_init(gen, (E, d, f), 0.02, param_dtype)
    return p


def _expert_ffn(p, x_e, cfg: MoEConfig):
    """x_e: [E, C, d] -> [E, C, d], grouped GEMMs (one batched product per
    weight)."""
    h1 = torch.bmm(x_e, p["w1"].to(x_e.dtype))
    if cfg.gated:
        h = F.silu(h1) * torch.bmm(x_e, p["w3"].to(x_e.dtype))
    else:
        h = F.gelu(h1, approximate="tanh")        # jax.nn.gelu's default
    del h1
    return torch.bmm(h, p["w2"].to(x_e.dtype))


def _route(p, x2d, cfg: MoEConfig):
    """x2d: [T, d] -> (gates [T, k] f32, experts [T, k] int64, aux f32
    scalar: the switch balance loss E * sum(mean probs * share of first
    choices))."""
    logits = (x2d @ p["router"].to(x2d.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    # jax.lax.top_k: equal values in order of their index, which
    # torch.topk does not promise (and bf16 router logits tie often); a
    # stable descending sort's first k
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :cfg.top_k], eidx[:, :cfg.top_k]       # [T, k]
    if cfg.norm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)                                       # [E]
    ce = F.one_hot(eidx[:, 0], cfg.n_experts).float().mean(dim=0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return gate, eidx, aux


def moe_dense(p, x, cfg: MoEConfig):
    """All experts on every token (small tests only). x: [..., d] ->
    (y, aux)."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    T = x2.shape[0]
    gate, eidx, aux = _route(p, x2, cfg)
    gmat = torch.zeros(T, cfg.n_experts, dtype=x2.dtype, device=x2.device)
    gmat[torch.arange(T, device=x2.device)[:, None], eidx] = gate.to(x2.dtype)
    y_all = _expert_ffn(p, x2.expand(cfg.n_experts, T, shp[-1]), cfg)
    y = torch.einsum("te,etd->td", gmat, y_all)
    return y.reshape(shp), aux


def capacity_for(tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert gets for a call over ``tokens`` tokens: the JAX
    package's rule, ceil(T k / E * factor) rounded up to a multiple of 8,
    at least 8. It depends on the call's token count, so a prefill and a
    decode step can drop differently."""
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def moe_gather(p, x, cfg: MoEConfig, *, expert_start: int = 0,
               n_local: int | None = None, capacity: int | None = None):
    """Sort-based capacity dispatch. x: [..., d] -> (y, aux).

    ``expert_start``/``n_local`` restrict the experts computed to the
    contiguous slice whose weights are ``p["w*"]`` (the JAX package's
    expert-parallel path calls it so); routing is always over every
    expert. Each expert takes at most ``capacity`` (default
    ``capacity_for(T)``) assignments in token order; the rest add 0.

    The k contributions of a token are gathered as [T, k, d] in (token,
    choice) order and summed: a fixed order (no atomics), so a call
    repeats bit for bit.
    """
    shp = x.shape
    d = shp[-1]
    x2 = x.reshape(-1, d)
    T, k = x2.shape[0], cfg.top_k
    E_local = n_local if n_local is not None else cfg.n_experts
    C = capacity if capacity is not None else capacity_for(T, cfg)

    with record_function("moe.route"):
        gate, eidx, aux = _route(p, x2, cfg)
    with record_function("moe.dispatch"):
        # assignments sorted by expert, token order kept within each; an
        # assignment's rank in its expert picks its slot, or the spare
        # row E_local C where it is dropped (past C, or outside the slice)
        flat_e = eidx.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        # assignments an expert takes, in a tensor of static size (a
        # bincount's size depends on the ids, so it waits on the device)
        counts = torch.zeros(cfg.n_experts, dtype=flat_e.dtype,
                             device=x.device).index_add_(
            0, flat_e, torch.ones_like(flat_e))
        rank = (torch.arange(T * k, device=x.device)
                - (torch.cumsum(counts, 0) - counts)[sorted_e])
        local_e = sorted_e - expert_start
        valid = (rank < C) & (local_e >= 0) & (local_e < E_local)
        slot = torch.where(valid, local_e * C + rank,
                           torch.full_like(rank, E_local * C))
        # the spare row takes every dropped write (JAX's scatter with
        # mode="drop"), then is cut off
        x_e = x2.new_zeros(E_local * C + 1, d)
        x_e[slot] = x2[order // k]
    with record_function("moe.experts"):
        y_e = _expert_ffn(p, x_e[:-1].view(E_local, C, d), cfg)
        y_e = y_e.view(E_local * C, d)
        del x_e
    with record_function("moe.combine"):
        # back to (token, choice) order; a dropped assignment reads the
        # last row (JAX's clamp) and is weighted 0
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * k, device=order.device)
        slot_read = slot.clamp_max(E_local * C - 1)[inv]
        w = (gate.reshape(-1) * valid[inv]).to(y_e.dtype)
        y = (y_e[slot_read] * w[:, None]).view(T, k, d).sum(dim=1)
    return y.reshape(shp), aux


class _ScaleGrad(torch.autograd.Function):
    """x forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def moe_ep_partial(p, x, cfg: MoEConfig, mesh):
    """This model rank's part of ``moe_ep``: (y_partial, aux), y_partial
    the contributions of its own experts only (summed over ``model`` by
    the caller, with any other partial output of the layer: Scout's
    shared expert joins the same all-reduce).

    ``x`` [..., d] holds this rank's tokens (its block over the data
    axes, ``pod`` and ``data``), whole over ``model`` and
    already through ``copy_to`` (whose backward sums the model ranks'
    gradients of x); ``p["router"]`` is whole, ``p["w*"]`` this rank's
    E/M experts (``expert_start = index("model") * E/M``), whole over
    ``data``. The capacity is ``capacity_for`` of this rank's tokens.

    Every model rank routes the same tokens and so computes the same
    balance loss, while each gate weighs only its own experts' outputs.
    So the router is read through ``copy_to`` (its gradient summed over
    ``model``: the gates' parts added, as the one-process gradient has
    them) and the balance loss's gradient is scaled by 1/M on each model
    rank (counted once in that sum, and once in x's). ``aux`` is the mean
    of the data shards' balance losses (``reduce_from`` over the data
    axes, over D: each rank's gradient is its own shard's share), the JAX
    package's ``pmean`` over its ``data_axes=("pod", "data")``; the same
    value on every rank.
    """
    M = mesh.size("model")
    if cfg.n_experts % M:
        raise ValueError(f"moe_ep: {cfg.n_experts} experts do not divide "
                         f"over model={M}")
    E_local = cfg.n_experts // M
    if p["w1"].shape[0] != E_local:
        raise ValueError(f"moe_ep: p holds {p['w1'].shape[0]} experts, "
                         f"a model rank's block is {E_local}")
    T = x.numel() // x.shape[-1]
    local = dict(p, router=copy_to(p["router"], mesh, "model"))
    y, aux = moe_gather(local, x, cfg, expert_start=mesh.index("model")
                        * E_local, n_local=E_local,
                        capacity=capacity_for(T, cfg))
    if M > 1:
        aux = _ScaleGrad.apply(aux, 1.0 / M)
    D = mesh.size(DATA_AXES)
    return y, reduce_from(aux, mesh, DATA_AXES) / D if D > 1 else aux


def moe_ep(p, x, cfg: MoEConfig, mesh):
    """Expert-parallel MoE, the JAX package's ``moe_ep`` on a mesh of
    ranks: x [..., d] is this rank's block of the batch over the data
    axes, ``pod`` and ``data`` (the whole batch where they cannot divide
    it: routing is then recomputed on each data rank, as JAX drops those
    axes), whole over ``model``; ``p`` the router and this rank's E/M
    experts (see ``moe_ep_partial``). Returns (y, aux): y this rank's
    block, summed over ``model``; aux the mean of the data shards'
    balance losses."""
    y, aux = moe_ep_partial(p, copy_to(x, mesh, "model"), cfg, mesh)
    return reduce_from(y, mesh, "model"), aux
