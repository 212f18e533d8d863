"""Configuration and corpus helpers shared by the launchers.

The training loop itself belongs to the training slice; the serve
launcher and its tests need the small configuration and the loader's
corpus, click log and news store.
"""
from __future__ import annotations

import numpy as np

from repro_torch import core, data


def small_speedyfeed_config(**over):
    base = dict(vocab=5000, n_layers=2, d_model=64, n_heads=4, d_ff=128,
                n_segments=3, seg_len=16, news_dim=32, n_news=2001,
                gamma=20, beta=2e-2, encode_budget=96, batch_users=16,
                hist_len=30, merged_cap=256, n_neg=4)
    base.update(over)
    return core.make_config(**base)


def make_loader(cfg, *, n_news=2000, n_users=400, seed=0, buckets=None,
                token_budget=4000, corpus_kw=None, log_kw=None):
    """-> (corpus, click log, news store, loader config), all from ``seed``."""
    rng = np.random.default_rng(seed)
    corpus = data.make_corpus(rng, n_news=n_news, **(corpus_kw or {}))
    log = data.make_click_log(rng, corpus, n_users=n_users,
                              max_hist=cfg.hist_len, **(log_kw or {}))
    stats = data.build_corpus_stats(
        [corpus.text(i) for i in range(corpus.n_news)])
    lcfg = data.LoaderConfig(
        vocab=cfg.plm.vocab, n_segments=cfg.plm.n_segments,
        seg_len=cfg.plm.seg_len,
        buckets=buckets or data.default_buckets(cfg.plm.seg_len),
        token_budget=token_budget, b_cap=cfg.batch_users, m_cap=cfg.merged_cap,
        hist_len=cfg.hist_len)
    store = data.NewsStore(corpus, stats, lcfg)
    return corpus, log, store, lcfg
