"""SpeedyFeed configuration and parameter initialisation.

The Algorithm-1 training forward and the conventional baseline belong to
the training slice.
"""
from __future__ import annotations

import dataclasses

import torch

from .cache import CacheConfig
from .plm import PLMConfig, init_plm
from .user_model import UserModelConfig, init_user_model


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
