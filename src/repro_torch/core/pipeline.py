"""SpeedyFeed's light-weighted encoding pipeline (Algorithm 1).

One training step over a centralized batch:
  1. merged news set M (deduplicated by the loader or by gather_dedup)
  2. cache plan: which news reuse cached embeddings, which get encoded
     (fixed budget E; p_t scheduler; gamma expiry)                  §4.1.2
  3. BusLM-encode the encode set                                    §4.1.3
  4. assemble and dispatch embeddings to history positions          §4.1.1
  5. autoregressive user modelling and the Eq. 5 loss               §4.1.4
  6. refresh the cache

Also the conventional workflow's loss (per-instance encoding, no
dedup, cache or autoregression), the baseline of the paper's speedup
ladder (Table 4).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.distributed.collectives import all_gather_grad, all_reduce
from repro_torch.distributed.sharding import (shard_block,
                                              speedyfeed_batch_specs)

from .buslm import buslm_encode
from .cache import (CacheConfig, CacheState, assemble_embeddings, cache_plan,
                    cache_refresh, cache_shard, init_cache)
from .centralized import dispatch
from .loss import ar_loss, click_loss, sample_negatives
from .plm import PLMConfig, init_plm
from .user_model import (UserModelConfig, attentive_user, init_user_model,
                         user_embeddings)


@dataclasses.dataclass(frozen=True)
class SpeedyFeedConfig:
    plm: PLMConfig
    user: UserModelConfig
    cache: CacheConfig
    batch_users: int = 32     # B
    hist_len: int = 100       # L
    merged_cap: int = 512     # M
    n_neg: int = 4            # negatives per prediction


def make_config(*, vocab=30522, n_layers=12, d_model=768, n_heads=12,
                d_ff=3072, n_segments=3, seg_len=32, news_dim=64,
                n_news=1_202_576, gamma=20, beta=2e-3, encode_budget=256,
                batch_users=32, hist_len=100, merged_cap=512, n_neg=4,
                user_kind="attentive", use_bus=True, use_freq=True,
                remat=False) -> SpeedyFeedConfig:
    plm = PLMConfig(vocab=vocab, n_layers=n_layers, d_model=d_model,
                    n_heads=n_heads, d_ff=d_ff, n_segments=n_segments,
                    seg_len=seg_len, news_dim=news_dim, use_bus=use_bus,
                    use_freq_embedding=use_freq, remat=remat)
    user = UserModelConfig(news_dim=news_dim, kind=user_kind, causal=True)
    cache = CacheConfig(n_news=n_news, news_dim=news_dim, gamma=gamma,
                        beta=beta, encode_budget=encode_budget)
    return SpeedyFeedConfig(plm=plm, user=user, cache=cache,
                            batch_users=batch_users, hist_len=hist_len,
                            merged_cap=merged_cap, n_neg=n_neg)


def init_speedyfeed(gen: torch.Generator, cfg: SpeedyFeedConfig):
    """Random parameters on ``gen``'s device: {"plm": ..., "user": ...}."""
    return {"plm": init_plm(gen, cfg.plm),
            "user": init_user_model(gen, cfg.user)}


def speedyfeed_state(cfg: SpeedyFeedConfig, gen: torch.Generator):
    """(params, cold cache) on ``gen``'s device."""
    return init_speedyfeed(gen, cfg), init_cache(cfg.cache, gen.device)


class StepOut(NamedTuple):
    loss: torch.Tensor
    cache: CacheState
    metrics: dict


def _encode_on_mesh(plm, cfg, tokens, freq, mesh, impl):
    """This rank's E/N rows of the encode set through ``buslm_encode``,
    all-gathered under autograd into the [E, d] whole."""
    E, n = tokens.shape[0], mesh.world
    if E % n:
        raise ValueError(f"the encode budget E={E} does not split over "
                         f"{n} ranks")
    rows = slice(mesh.rank * (E // n), (mesh.rank + 1) * (E // n))
    part = buslm_encode(plm, cfg, tokens[rows], freq[rows], impl=impl)
    return all_gather_grad(part, mesh)


def speedyfeed_forward(params, cfg: SpeedyFeedConfig, batch,
                       cache: CacheState, step: int, gen=None, *, u=None,
                       neg_idx=None, impl: str = "kernel",
                       mesh=None) -> StepOut:
    """Algorithm 1. ``batch`` holds the loader's centralized tensors:
      news_tokens [M, K, S]  news_freq [M, K, S]  news_ids [M]
      hist_inv [B, L]        hist_mask [B, L]

    The step's two random draws, the cache gate's uniform ``u`` and the
    negatives ``neg_idx`` [B, L-1, n_neg], come from ``gen`` unless given.
    Exactly E rows are encoded every step, pad slots included. The cache
    is refreshed in place, and only when the loss is finite (the
    trainer's non-finite guard). ``impl`` is passed to ``buslm_encode``.
    ``metrics["loss"]`` is the step's loss.

    ``mesh`` (a data mesh, ``launch/mesh.py``; the counterpart of JAX's
    ``constrain(..., "encode_batch")``): every rank holds the whole batch
    and the same draws, and the cache is row-sharded (``cache_shard``).
    Each rank encodes its E/N slice of the encode set (the bus kernels run
    on every rank), and the slices are all-gathered into the [E, d]
    embeddings. The merged news set stays whole; the user side
    (``hist_inv``, ``hist_mask``, the negatives) is this rank's block
    where the ranks divide B (``speedyfeed_batch_specs``), else the
    whole, weighted 1/N. The returned loss is this rank's part,
    normalised by the global count of valid predictions, so the ranks'
    gradients sum to the one-process gradient; ``metrics["loss"]`` and
    ``"ar_acc"`` are summed over the ranks.
    """
    news_ids = batch["news_ids"]
    if u is None:
        u = torch.rand((), generator=gen, device=gen.device)
    sharded = mesh is not None and mesh.world > 1
    shard = cache_shard(cfg.cache, mesh)
    plan = cache_plan(cache, news_ids, step, u, cfg.cache, shard=shard)
    enc_tokens = batch["news_tokens"][plan.enc_pos]
    enc_freq = batch["news_freq"][plan.enc_pos]
    if sharded:
        new_emb = _encode_on_mesh(params["plm"], cfg.plm, enc_tokens,
                                  enc_freq, mesh, impl)
    else:
        new_emb = buslm_encode(params["plm"], cfg.plm, enc_tokens, enc_freq,
                               impl=impl)

    emb_m = assemble_embeddings(cache, plan, news_ids, new_emb, shard=shard)
    hist_inv, mask = batch["hist_inv"], batch["hist_mask"]
    if neg_idx is None:
        neg_idx = sample_negatives(gen, cfg.merged_cap, mask[:, 1:].shape,
                                   cfg.n_neg)
    n_valid = None
    if sharded:
        n_valid = (mask[:, 1:] & mask[:, :-1]).sum()
        spec = speedyfeed_batch_specs(mesh, {"hist_inv": hist_inv})[
            "hist_inv"]
        hist_inv, mask, neg_idx = (shard_block(t, spec, mesh)
                                   for t in (hist_inv, mask, neg_idx))
        weight = 1.0 if spec[0] is not None else 1.0 / mesh.world
    theta = dispatch(emb_m, hist_inv)                     # [B, L, d]
    mu = user_embeddings(params["user"], cfg.user, theta, mask)
    loss, m = ar_loss(mu, theta, mask, emb_m, news_ids, neg_idx,
                      hist_inv=hist_inv, n_valid=n_valid)
    total = loss.detach()
    if sharded:
        loss = loss * weight
        sums = all_reduce(torch.stack([total * weight,
                                       m["ar_acc"] * weight]), mesh)
        total, m["ar_acc"] = sums[0], sums[1]

    cache = cache_refresh(cache, plan, news_ids, new_emb, step,
                          commit=torch.isfinite(total), shard=shard)

    n_tok = (enc_tokens != 0).sum()
    m.update({
        "loss": total,
        "p_t": plan.p_t,
        "encoded": plan.enc_valid.sum(),
        "reused": plan.reuse.sum(),
        "cache_overflow": plan.overflow,
        "cache_hits": plan.reuse.sum(),
        "cache_misses": plan.missing.sum(),
        "cache_expired": plan.expired.sum(),
        "data_efficiency": n_tok / max(enc_tokens.numel(), 1),
    })
    return StepOut(loss, cache, m)


# ---------------------------------------------------------------------------
# conventional workflow (the paper's baseline; Figure 1 left)
# ---------------------------------------------------------------------------

def conventional_forward(params, cfg: SpeedyFeedConfig, batch, *,
                         impl: str = "kernel"):
    """Typical workflow: every training instance encodes its own history
    and candidates with the PLM; one click prediction per instance.

    batch: hist_tokens [B, L, K, S], hist_freq, hist_mask [B, L],
    cand_tokens [B, C, K, S], cand_freq, label [B], cand_mask [B, C].
    The B*L history news and B*C candidates go through one
    ``buslm_encode`` call (``impl`` as in ``speedyfeed_forward``), all-pad
    history slots included. Returns ``click_loss``'s (loss, metrics).
    """
    B, L, K, S = batch["hist_tokens"].shape
    C = batch["cand_tokens"].shape[1]
    tokens = torch.cat([batch["hist_tokens"].reshape(B * L, K, S),
                        batch["cand_tokens"].reshape(B * C, K, S)])
    freq = torch.cat([batch["hist_freq"].reshape(B * L, K, S),
                      batch["cand_freq"].reshape(B * C, K, S)])
    emb = buslm_encode(params["plm"], cfg.plm, tokens, freq, impl=impl)
    theta = emb[:B * L].reshape(B, L, -1)
    cand = emb[B * L:].reshape(B, C, -1)
    user = attentive_user(params["user"], theta, batch["hist_mask"])
    return click_loss(user, cand, batch["label"], batch["cand_mask"])
