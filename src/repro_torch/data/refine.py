"""Content refinement (paper §4.2.1, Figure 7): the Ordered Bag-of-Words.

1. drop special characters / stopwords,
2. collapse the article into (word, count) tuples ordered by first appearance,
3. score words with BM25 (k1 = 2, as §A.3) against corpus document frequency,
4. keep the top-k words per segment; the counts feed the *frequency
   embedding* added to the token embeddings by the PLM.
"""
from __future__ import annotations

import collections
import dataclasses
import math

from .tokenizer import CLS, PAD, hash_token, words

STOPWORDS = frozenset(
    "a an and are as at be by for from has have he her his i in is it its "
    "not of on or s she that the their them they this to was we were will "
    "with you your".split())


@dataclasses.dataclass
class CorpusStats:
    """Document frequencies for BM25 idf (built once over the corpus)."""
    n_docs: int
    doc_freq: dict
    avg_len: float

    def idf(self, w: str) -> float:
        df = self.doc_freq.get(w, 0)
        return math.log(1 + (self.n_docs - df + 0.5) / (df + 0.5))


def build_corpus_stats(texts) -> CorpusStats:
    df = collections.Counter()
    total = 0
    for t in texts:
        ws = [w for w in words(t) if w not in STOPWORDS]
        total += len(ws)
        df.update(set(ws))
    n = max(len(texts), 1)
    return CorpusStats(n_docs=n, doc_freq=dict(df),
                       avg_len=total / n if n else 1.0)


def obow(text: str):
    """(word, count) ordered by first appearance, stopwords removed."""
    counts = collections.Counter()
    order = []
    for w in words(text):
        if w in STOPWORDS:
            continue
        if w not in counts:
            order.append(w)
        counts[w] += 1
    return [(w, counts[w]) for w in order]


def bm25_scores(pairs, stats: CorpusStats, *, k1: float = 2.0,
                b: float = 0.75):
    dl = sum(c for _, c in pairs)
    out = {}
    for w, c in pairs:
        denom = c + k1 * (1 - b + b * dl / max(stats.avg_len, 1e-9))
        out[w] = stats.idf(w) * c * (k1 + 1) / max(denom, 1e-9)
    return out


def refine(text: str, stats: CorpusStats, *, top_k: int = 32):
    """-> list of (word, count) keeping the top-k BM25 words, original order
    (paper keeps first-appearance order after filtering)."""
    pairs = obow(text)
    if len(pairs) <= top_k:
        return pairs
    scores = bm25_scores(pairs, stats)
    keep = set(sorted(scores, key=scores.get, reverse=True)[:top_k])
    return [(w, c) for w, c in pairs if w in keep]


def refined_tokens(text: str, stats: CorpusStats, vocab: int, seg_len: int,
                   *, top_k: int = 32, max_freq: int = 32):
    """-> (token_ids, freq_ids) fixed length ``seg_len`` with a leading CLS.

    The frequency channel carries each word's appearance count (clipped),
    feeding the frequency embedding (§4.2.1)."""
    pairs = refine(text, stats, top_k=top_k)
    toks = [CLS] + [hash_token(w, vocab) for w, _ in pairs]
    freq = [1] + [min(c, max_freq - 1) for _, c in pairs]
    toks, freq = toks[:seg_len], freq[:seg_len]
    pad = seg_len - len(toks)
    return toks + [PAD] * pad, freq + [0] * pad
