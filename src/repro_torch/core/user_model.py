"""User encoders (§4.1.4).

* ``attentive``: Attentive YouTube-DNN (the paper's default), a
  learnable-query additive attention over history news embeddings.
* ``attentive_user_causal``: its autoregressive form, mu_t over
  {theta_l}_{l<=t}. Additive attention is a weighted mean, so the causal
  variant is a pair of prefix sums in O(L).
* ``nrms``: multi-head self-attention over the history (NRMS), then the
  attentive pooling, causal or not. The attention carries a key mask, so
  it is plain attention (``nn.attention``), never the flash kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import (AttnConfig, attention, dense, init_attention,
                           init_dense, normal_init)


@dataclasses.dataclass(frozen=True)
class UserModelConfig:
    news_dim: int
    kind: str = "attentive"   # attentive | nrms
    n_heads: int = 4          # nrms only
    causal: bool = True


def init_user_model(gen: torch.Generator, cfg: UserModelConfig):
    if cfg.kind not in ("attentive", "nrms"):
        raise ValueError(f"unknown user model {cfg.kind!r}")
    d = cfg.news_dim
    p = {"proj": init_dense(gen, d, d, use_bias=True),
         "query": normal_init(gen, (d,), 0.02)}
    if cfg.kind == "nrms":
        p["self_attn"] = init_attention(gen, _nrms_attn_cfg(cfg))
    return p


def _nrms_attn_cfg(cfg: UserModelConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.news_dim, n_heads=cfg.n_heads,
                      n_kv=cfg.n_heads, head_dim=cfg.news_dim // cfg.n_heads,
                      qkv_bias=True, out_bias=True, rope_fraction=0.0,
                      causal=cfg.causal)


def _scores(p, theta):
    return torch.einsum("bld,d->bl",
                        torch.tanh(dense(p["proj"], theta).float()),
                        p["query"].float())


def attentive_user(p, theta, mask):
    """theta: [B, L, d]; mask: [B, L] -> [B, d] (non-causal pooling). A row
    with an empty history averages its (pad) rows uniformly."""
    a = _scores(p, theta).masked_fill(~mask, -1e30)
    w = torch.softmax(a, dim=-1).to(theta.dtype)
    return torch.einsum("bl,bld->bd", w, theta)


def attentive_user_causal(p, theta, mask):
    """Autoregressive user embeddings: mu_t from {theta_l}_{l<=t}.

    mu_t = sum_{l<=t} alpha_l theta_l / sum_{l<=t} alpha_l, with the max
    subtracted from the scores (and carrying no gradient) before exp.
    Returns [B, L, d]; positions with an empty prefix yield zeros.
    """
    a = _scores(p, theta)                                # [B, L] f32
    a = a - a.max(dim=-1, keepdim=True).values.detach()
    w = torch.exp(a) * mask.float()
    num = torch.cumsum(w[..., None] * theta.float(), dim=1)
    den = torch.cumsum(w, dim=1)[..., None]
    return (num / den.clamp_min(1e-9)).to(theta.dtype)


def user_embeddings(p, cfg: UserModelConfig, theta, mask):
    """Dispatch on kind and causality: causal -> [B, L, d], else [B, d].
    NRMS adds its self-attention over the history to theta first."""
    if cfg.kind == "nrms":
        theta = theta + attention(p["self_attn"], theta, _nrms_attn_cfg(cfg),
                                  mask=mask)
    if cfg.causal:
        return attentive_user_causal(p, theta, mask)
    return attentive_user(p, theta, mask)
