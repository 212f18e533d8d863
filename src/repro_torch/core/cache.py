"""Cache-accelerated news encoding (§4.1.2, Algorithm 2).

A device-resident cache of fresh news embeddings (emb [N, d],
written_step [N]); each step, with probability p_t = 1 - exp(-beta t),
the step reads entries younger than ``gamma`` steps instead of
re-encoding. Shapes are fixed, so the saving is a fixed encode budget E:
at most E of the M merged news are encoded (cache misses first), the rest
reuse cached rows.

One difference from the JAX package: ``cache_refresh`` writes the cache
in place (at the production config it is 1.2M x 768 f32, 3.7 GB) where
the JAX function returns new arrays into donated buffers.

On a data mesh the cache is row-sharded (``speedyfeed_cache_spec``):
rank r holds the contiguous rows ``cache_shard`` names, and ``state``'s
tensors are that block. ``cache_plan`` and ``assemble_embeddings`` read
the merged set's rows through one sum all-reduce each (the owner's row,
zeros from the others), and ``cache_refresh`` writes only the rows this
rank owns. Where the rank count does not divide the rows, the cache is
replicated, as ``guard_divisible`` makes it in JAX: each rank holds all
of it and no collective runs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.distributed.collectives import all_reduce

NEVER = -(2 ** 30)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    n_news: int            # global news id space (rows in the cache)
    news_dim: int
    gamma: int = 20        # expiry steps; 0 disables the cache
    beta: float = 2e-3     # lookup-rate growth (p_t = 1 - exp(-beta t))
    encode_budget: int = 64  # E: static number of news encoded per step


class CacheState(NamedTuple):
    emb: torch.Tensor            # [N, d]
    written_step: torch.Tensor   # [N] int32, NEVER = not present


class RowShard(NamedTuple):
    """This rank's rows [lo, lo + rows) of a row-sharded cache; the other
    ranks of ``mesh`` own the rest."""
    lo: int
    rows: int
    mesh: object


def cache_shard(cfg: CacheConfig, mesh) -> RowShard | None:
    """This rank's block of a cache on ``mesh`` (pure data parallelism:
    the rows split over every rank); None without a mesh, or where the
    rank count does not divide the rows (a replicated cache)."""
    if mesh is None or mesh.world == 1 or cfg.n_news % mesh.world:
        return None
    rows = cfg.n_news // mesh.world
    return RowShard(mesh.rank * rows, rows, mesh)


def _read_rows(t, ids, shard: RowShard | None):
    """``t[ids]``; on a sharded cache each rank gives the rows it owns and
    zeros for the others, summed over the ranks."""
    if shard is None:
        return t[ids]
    local = ids.long() - shard.lo
    own = (local >= 0) & (local < shard.rows)
    vals = t[local.clamp(0, shard.rows - 1)]
    vals = torch.where(own.reshape(own.shape + (1,) * (vals.dim() - 1)),
                       vals, 0)
    return all_reduce(vals, shard.mesh)


class CachePlan(NamedTuple):
    enc_pos: torch.Tensor     # [E] positions into the merged set to encode
    enc_valid: torch.Tensor   # [E] bool: slot actually needs encoding
    reuse: torch.Tensor       # [M] bool: read from cache (a cache hit)
    overflow: torch.Tensor    # scalar: must-encode news beyond the budget
    p_t: torch.Tensor         # scalar: scheduled lookup rate
    expired: torch.Tensor     # [M] bool: cached but older than gamma
    missing: torch.Tensor     # [M] bool: never cached (true miss)


def init_cache(cfg: CacheConfig, device="cuda",
               dtype=torch.float32) -> CacheState:
    return CacheState(
        emb=torch.zeros((cfg.n_news, cfg.news_dim), dtype=dtype,
                        device=device),
        written_step=torch.full((cfg.n_news,), NEVER, dtype=torch.int32,
                                device=device))


def cache_plan(state: CacheState, news_ids, step: int, u,
               cfg: CacheConfig, *, shard: RowShard | None = None
               ) -> CachePlan:
    """news_ids: [M] global ids (0 = pad). ``u`` is the step's one uniform
    draw in [0, 1): a single Bernoulli(p_t) gate on all lookups, exactly
    as Algorithm 2. ``shard``: this rank's block of a row-sharded cache
    (the plan is the same on every rank)."""
    dev = news_ids.device
    p_t = 1.0 - torch.exp(-cfg.beta * torch.tensor(float(step), device=dev))
    use_cache = (u < p_t) & (cfg.gamma > 0)
    written = _read_rows(state.written_step, news_ids, shard)
    age = step - written
    fresh = (age >= 0) & (age <= cfg.gamma)
    is_pad = news_ids == 0
    reuse = use_cache & fresh & ~is_pad
    must_encode = ~reuse & ~is_pad
    # cache-content accounting from the same age computation: a true miss
    # was never written, an expired entry was written but is past gamma.
    # Both describe the cache, not the gate; ``reuse`` is the realised hit
    present = written != NEVER
    expired = present & ~fresh & ~is_pad
    missing = ~present & ~is_pad

    # encode-budget selection: must-encode first, in stable order
    order = torch.argsort(-must_encode.int(), stable=True)
    enc_pos = order[:cfg.encode_budget]
    enc_valid = must_encode[enc_pos]
    overflow = (must_encode.sum() - cfg.encode_budget).clamp_min(0)
    return CachePlan(enc_pos, enc_valid, reuse, overflow, p_t, expired,
                     missing)


def assemble_embeddings(state: CacheState, plan: CachePlan, news_ids,
                        new_emb, *, shard: RowShard | None = None):
    """Combine cached and freshly encoded embeddings for the merged set.

    new_emb: [E, d] encoder output for ``plan.enc_pos``. Returns [M, d];
    cached rows carry no gradient (a previous model state produced them);
    pad rows (id 0) are the zero vector (paper §4.1.1).
    """
    cached = _read_rows(state.emb, news_ids, shard).detach().to(
        new_emb.dtype)
    rows = torch.where(plan.enc_valid[:, None], new_emb,
                       cached[plan.enc_pos])
    emb = cached.index_copy(0, plan.enc_pos, rows)
    return emb * (news_ids != 0)[:, None]


def cache_refresh(state: CacheState, plan: CachePlan, news_ids, new_emb,
                  step: int, *, commit=None,
                  shard: RowShard | None = None) -> CacheState:
    """Write freshly encoded embeddings back (Algorithm 2 line 12), in
    place; returns ``state``.

    Only valid slots write. Slots that must not write rewrite their row's
    current value, so the scatter needs no host-side filtering: they name
    pad rows or rows that no valid slot names (the merged set holds each
    id once). ``commit`` (a bool scalar tensor) holds every row when
    False, for the trainer's non-finite guard.

    On a sharded cache (``shard``) a rank writes the rows it owns. A slot
    it does not own repeats the first owned slot's write (or, with none,
    slot 0's rewrite of its row's current value), so no row is named by
    two slots with two values.
    """
    tgt = news_ids[plan.enc_pos].long()
    write = plan.enc_valid if commit is None else plan.enc_valid & commit
    if shard is not None:
        tgt = tgt - shard.lo
        own = (tgt >= 0) & (tgt < shard.rows)
        write = write & own
        tgt = tgt.clamp(0, shard.rows - 1)
    rows = torch.where(write[:, None],
                       new_emb.detach().to(state.emb.dtype), state.emb[tgt])
    steps = torch.where(write, torch.full_like(tgt, step, dtype=torch.int32),
                        state.written_step[tgt])
    if shard is not None:
        # a one-element index, not a 0-d one (which reads its value on
        # the host, and cannot on meta tensors)
        j = torch.argmax(own.to(torch.int32)).reshape(1)
        tgt = torch.where(own, tgt, tgt[j])
        rows = torch.where(own[:, None], rows, rows[j])
        steps = torch.where(own, steps, steps[j])
    state.emb.index_copy_(0, tgt, rows)
    state.written_step.index_copy_(0, tgt, steps)
    return state
