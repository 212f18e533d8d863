"""Loader configuration and the pre-tokenized news store (paper §4.2).

The serving slice needs only the store and its configuration; the dynamic
batcher and the centralized batch belong to the training slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .news_synth import NewsCorpus
from .refine import CorpusStats, refined_tokens
from .tokenizer import encode


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    vocab: int = 30522
    n_segments: int = 3
    seg_len: int = 32                      # max tokens per segment
    buckets: tuple = (8, 16, 24, 32)       # seg-length buckets
    token_budget: int = 39_800             # paper §A.3
    b_cap: int = 64                        # users per batch (static)
    m_cap: int = 512                       # merged-set capacity (static)
    hist_len: int = 100
    top_k: int = 32                        # BM25 keep-k per segment
    refine: bool = True


class NewsStore:
    """Pre-tokenized news: id -> ([K, S] tokens, [K, S] freq, length).
    Row 0 is the pad news."""

    def __init__(self, corpus: NewsCorpus, stats: CorpusStats,
                 cfg: LoaderConfig):
        K, S = cfg.n_segments, cfg.seg_len
        N = corpus.n_news
        self.tokens = np.zeros((N + 1, K, S), np.int32)
        self.freq = np.zeros((N + 1, K, S), np.int32)
        self.lengths = np.zeros(N + 1, np.int32)
        for i in range(N):
            segs = corpus.segments(i)[:K]
            for j, seg in enumerate(segs):
                if cfg.refine:
                    t, f = refined_tokens(seg, stats, cfg.vocab, S,
                                          top_k=cfg.top_k)
                else:
                    t = encode(seg, cfg.vocab, S)
                    f = [1 if x else 0 for x in t]
                self.tokens[i + 1, j] = t
                self.freq[i + 1, j] = f
            self.lengths[i + 1] = int((self.tokens[i + 1] != 0).sum(-1).max())


def default_buckets(seg_len: int, base: tuple | None = None) -> tuple:
    """Derive the seg-length bucket set for a config from the LoaderConfig
    defaults, clipped to ``seg_len`` (which is always the top bucket)."""
    base = base if base is not None else LoaderConfig.buckets
    return tuple(sorted({min(int(b), int(seg_len))
                         for b in base} | {int(seg_len)}))
