"""Cache configuration (§4.1.2, Algorithm 2).

Only the configuration is ported: ``SpeedyFeedConfig`` carries it. The
cache plan, assembly and refresh belong to the training slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    n_news: int            # global news id space (rows in the cache)
    news_dim: int
    gamma: int = 20        # expiry steps; 0 disables the cache
    beta: float = 2e-3     # lookup-rate growth (p_t = 1 - exp(-beta t))
    encode_budget: int = 64  # E: static number of news encoded per step
