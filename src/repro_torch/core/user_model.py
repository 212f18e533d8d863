"""User encoders (§4.1.4).

* ``attentive``: Attentive YouTube-DNN (the paper's default), a
  learnable-query additive attention over history news embeddings.
* ``attentive_user_causal``: its autoregressive form, mu_t over
  {theta_l}_{l<=t}. Additive attention is a weighted mean, so the causal
  variant is a pair of prefix sums in O(L).

The NRMS user encoder is not ported (it is not on the production path).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import dense, init_dense, normal_init


@dataclasses.dataclass(frozen=True)
class UserModelConfig:
    news_dim: int
    kind: str = "attentive"   # attentive | nrms
    n_heads: int = 4          # nrms only
    causal: bool = True


def init_user_model(gen: torch.Generator, cfg: UserModelConfig):
    if cfg.kind != "attentive":
        raise NotImplementedError(f"user model {cfg.kind!r} is not ported")
    d = cfg.news_dim
    return {"proj": init_dense(gen, d, d, use_bias=True),
            "query": normal_init(gen, (d,), 0.02)}


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
    """Dispatch on kind and causality: causal -> [B, L, d], else [B, d]."""
    if cfg.kind != "attentive":
        raise NotImplementedError(f"user model {cfg.kind!r} is not ported")
    if cfg.causal:
        return attentive_user_causal(p, theta, mask)
    return attentive_user(p, theta, mask)
