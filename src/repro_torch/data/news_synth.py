"""Synthetic Microsoft-News-like corpus + click log.

Matches the paper's dataset statistics structurally (Table 1, 2, §A.2):
  * news popularity ~ Zipf: top-1% of news draw ~60% of clicks (Table 1),
  * text lengths ~ lognormal with mean ~660 words, split into
    title/abstract/body segments,
  * user activity long-tailed, history truncated at L=100,
  * click behavior is topic-driven (users have latent topic prefs), so a
    real recommender trains to better-than-chance accuracy on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_TOPIC_WORDS = 400   # vocabulary of word stems per topic


@dataclasses.dataclass
class NewsCorpus:
    titles: list
    abstracts: list
    bodies: list
    topics: np.ndarray          # [N] topic id per news
    popularity: np.ndarray      # [N] click propensity (Zipf)

    @property
    def n_news(self) -> int:
        return len(self.titles)

    def text(self, i: int) -> str:
        return f"{self.titles[i]} {self.abstracts[i]} {self.bodies[i]}"

    def segments(self, i: int):
        return (self.titles[i], self.abstracts[i], self.bodies[i])


def _words_for(rng, topic, n, n_topics):
    base = topic * _TOPIC_WORDS
    ids = base + rng.zipf(1.3, size=n) % _TOPIC_WORDS
    # mix in global common words
    common = rng.random(n) < 0.3
    ids[common] = n_topics * _TOPIC_WORDS + rng.integers(0, 200, common.sum())
    return " ".join(f"w{j}" for j in ids)


def make_corpus(rng: np.random.Generator, *, n_news: int = 2000,
                n_topics: int = 16, zipf_a: float = 1.6,
                short_frac: float = 0.8) -> NewsCorpus:
    """``short_frac`` of the news are headline-style (MIND-like: title and a
    short or missing body), giving the long-tailed *token*-length
    distribution that makes seg-length bucketing (§4.2.2, Figure 8)
    meaningful — full-length articles saturate every segment after OBoW
    refinement, so without short news all batches land in the top bucket."""
    topics = rng.integers(0, n_topics, n_news)
    lengths = np.clip(rng.lognormal(6.0, 0.7, n_news), 40, 3000).astype(int)
    short = rng.random(n_news) < short_frac
    titles, abstracts, bodies = [], [], []
    for i in range(n_news):
        L = lengths[i]
        if short[i]:
            L = int(np.clip(rng.lognormal(2.0, 0.9), 3, 60))
            titles.append(_words_for(rng, topics[i], max(3, L // 3),
                                     n_topics))
            abstracts.append(_words_for(rng, topics[i], max(4, L // 2),
                                        n_topics))
            bodies.append(_words_for(rng, topics[i], L, n_topics))
            continue
        titles.append(_words_for(rng, topics[i], max(4, L // 40), n_topics))
        abstracts.append(_words_for(rng, topics[i], max(8, L // 10), n_topics))
        bodies.append(_words_for(rng, topics[i], L, n_topics))
    # Zipf popularity over a random permutation of news
    ranks = rng.permutation(n_news) + 1
    pop = ranks.astype(np.float64) ** (-zipf_a)
    pop /= pop.sum()
    return NewsCorpus(titles, abstracts, bodies, topics, pop)


@dataclasses.dataclass
class ClickLog:
    """users' clicked news ids in time order; id 0 is reserved (PAD)."""
    histories: list      # list of np.ndarray of news ids (1-based)

    @property
    def n_users(self) -> int:
        return len(self.histories)


def make_click_log(rng: np.random.Generator, corpus: NewsCorpus, *,
                   n_users: int = 500, mean_clicks: float = 8.0,
                   max_hist: int = 100, topic_affinity: float = 0.8
                   ) -> ClickLog:
    """MIND-like activity: lognormal click counts with median
    ``mean_clicks`` (most users have short histories, a long tail reaches
    ``max_hist``) — short histories over a mostly-headline corpus are what
    populate the lower seg-length buckets in the dynamic batcher."""
    n_topics = corpus.topics.max() + 1
    histories = []
    for _ in range(n_users):
        n_clicks = int(np.clip(rng.lognormal(np.log(mean_clicks), 0.8),
                               2, max_hist))
        # user prefers 1-3 topics
        prefs = rng.choice(n_topics, size=rng.integers(1, 4), replace=False)
        topic_w = np.full(n_topics, (1 - topic_affinity) / n_topics)
        topic_w[prefs] += topic_affinity / len(prefs)
        w = corpus.popularity * topic_w[corpus.topics]
        w /= w.sum()
        clicks = rng.choice(corpus.n_news, size=n_clicks, replace=False
                            if n_clicks <= corpus.n_news else True, p=w)
        histories.append(clicks.astype(np.int64) + 1)   # 1-based ids
    return ClickLog(histories)


def click_share_topk(log: ClickLog, corpus: NewsCorpus, fracs) -> dict:
    """Table 1: the share of all clicks that the top ``f`` of the news by
    clicks take, for each ``f`` in ``fracs`` (at least one news each)."""
    counts = np.zeros(corpus.n_news + 1, np.int64)
    for h in log.histories:
        np.add.at(counts, h, 1)
    counts = counts[1:]
    order = np.argsort(-counts)
    total = counts.sum()
    out = {}
    for f in fracs:
        k = max(1, int(round(corpus.n_news * f)))
        out[f] = counts[order[:k]].sum() / max(total, 1)
    return out
