"""SpeedyFeed's production configuration (the JAX package's
``configs/speedyfeed_arch.py:PROD``), as a configuration constant.

UniLMv2-base-scale PLM (12L x 768 x 12H), K=3 segments of 32 tokens,
user history L=100, news universe 1.2M (Table 2), cache gamma=20 /
beta=2e-3 (§A.3).
"""
from __future__ import annotations

from repro_torch import core

PROD = core.make_config(
    vocab=30720,   # UniLM's 30 522 padded to /512
    n_layers=12, d_model=768, n_heads=12, d_ff=3072,
    n_segments=3, seg_len=32, news_dim=768,
    n_news=1_204_224,   # Table 2's 1 202 576 row-padded to /4096
    gamma=20, beta=2e-3, encode_budget=4096,
    batch_users=1024, hist_len=100, merged_cap=8192, n_neg=4, remat=True)
