"""User encoder (§4.1.4): Attentive YouTube-DNN, a learnable-query additive
attention over history news embeddings. The causal and NRMS variants
belong to the training slice."""
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
