"""Dynamic batching and centralized batch building (paper §4.1.1, §4.2.2).

Host-side loader (numpy) that:
  * length-buckets training instances by their longest contained news,
  * pads news only to the bucket length (not the global max),
  * emits a mini-batch when a bucket reaches the token budget (39 800 in
    the paper's config),
  * builds the centralized batch: the mini-batch's unique news merged
    into one deduplicated set with inverse index maps (the in-graph
    equivalent is ``core.centralized.gather_dedup``).

``build_conventional_batch`` builds the conventional workflow's batch
instead: every instance's own padded history and candidates.

Each bucket emits fixed shapes (b_cap users, m_cap merged news, the
bucket's segment length). Data efficiency (Eq. 1) is reported per batch.
Runs multi-threaded over a work-stealing queue (``distributed.straggler``).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.distributed.straggler import WorkStealingQueue

from .news_synth import ClickLog, NewsCorpus
from .refine import CorpusStats, refined_tokens
from .tokenizer import encode


class Sentinel:
    """Named identity-compared marker (``is`` against the module-level
    instance); shared by the loader and prefetcher stream contracts."""

    def __init__(self, name: str):
        self._name = name

    def __repr__(self):
        return self._name


# epoch exhausted: distinct from a timeout, which ``get`` signals with None
EPOCH_END = Sentinel("EPOCH_END")


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


def bucket_for(length: int, buckets) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def default_buckets(seg_len: int, base: tuple | None = None) -> tuple:
    """Derive the seg-length bucket set for a config from the LoaderConfig
    defaults, clipped to ``seg_len`` (which is always the top bucket)."""
    base = base if base is not None else LoaderConfig.buckets
    return tuple(sorted({min(int(b), int(seg_len))
                         for b in base} | {int(seg_len)}))


def synth_centralized_batch(*, m_cap: int, n_segments: int, seg_len: int,
                            b_cap: int, hist_len: int, vocab: int,
                            seed: int = 0) -> dict:
    """Random centralized batch with the loader's schema/dtypes — executable
    warm-up and schema-shaped tests (single source of truth for the batch
    keys)."""
    rng = np.random.default_rng(seed)
    return {
        "news_tokens": rng.integers(
            1, vocab, (m_cap, n_segments, seg_len)).astype(np.int32),
        "news_freq": rng.integers(
            0, 8, (m_cap, n_segments, seg_len)).astype(np.int32),
        "news_ids": np.arange(m_cap, dtype=np.int32),
        "hist_inv": rng.integers(1, m_cap, (b_cap, hist_len)).astype(np.int32),
        "hist_mask": np.ones((b_cap, hist_len), bool),
    }


def build_centralized_batch(instances, store: NewsStore, cfg: LoaderConfig,
                            seg_len: int):
    """instances: list of np arrays of news ids -> centralized batch dict."""
    B, L, K = cfg.b_cap, cfg.hist_len, cfg.n_segments
    hist = np.zeros((B, L), np.int64)
    mask = np.zeros((B, L), bool)
    for b, h in enumerate(instances[:B]):
        h = h[-L:]
        hist[b, :len(h)] = h
        mask[b, :len(h)] = True
    uniq = np.unique(hist[mask])
    uniq = uniq[uniq != 0][:cfg.m_cap - 1]
    ids = np.zeros(cfg.m_cap, np.int64)
    ids[1:1 + len(uniq)] = uniq
    lut = {int(v): i + 1 for i, v in enumerate(uniq)}
    inv = np.zeros((B, L), np.int32)
    for b in range(B):
        for l in range(L):
            if mask[b, l]:
                inv[b, l] = lut.get(int(hist[b, l]), 0)
    tokens = store.tokens[ids][:, :, :seg_len]
    freq = store.freq[ids][:, :, :seg_len]
    # Eq. 1 over the encoded set (rows 1..n_unique hold real news; the
    # static m_cap padding is a shape artifact, not encoded work)
    used = tokens[1:1 + len(uniq)]
    valid = int((used != 0).sum())
    return {
        "news_tokens": tokens.astype(np.int32),
        "news_freq": freq.astype(np.int32),
        "news_ids": ids.astype(np.int32),
        "hist_inv": inv,
        "hist_mask": mask,
        "_bucket": seg_len,
        "_stats": {
            "seg_len": seg_len,
            "n_unique": int(len(uniq)),
            "n_news_slots": int(mask.sum()),
            "data_efficiency": valid / max(used.size, 1),
        },
    }



def build_conventional_batch(instances, store: NewsStore, cfg: LoaderConfig,
                             *, n_cands: int = 2,
                             rng: np.random.Generator | None = None):
    """Typical-workflow batch: per-instance history tensors, full padding,
    one click prediction per instance (the last click is the positive,
    the ``n_cands - 1`` negatives are drawn uniformly from the store, and
    the candidates are shuffled). ``_stats["data_efficiency"]`` (Eq. 1)
    counts the non-pad tokens over every encoded slot."""
    rng = rng or np.random.default_rng(0)
    B, L, K, S = len(instances), cfg.hist_len, cfg.n_segments, cfg.seg_len
    ht = np.zeros((B, L, K, S), np.int32)
    hf = np.zeros((B, L, K, S), np.int32)
    hm = np.zeros((B, L), bool)
    ct = np.zeros((B, n_cands, K, S), np.int32)
    cf = np.zeros((B, n_cands, K, S), np.int32)
    label = np.zeros((B,), np.int32)
    for b, h in enumerate(instances):
        h = h[-(L + 1):]
        hist, pos = h[:-1], h[-1]
        ht[b, :len(hist)] = store.tokens[hist]
        hf[b, :len(hist)] = store.freq[hist]
        hm[b, :len(hist)] = True
        negs = rng.integers(1, store.tokens.shape[0], n_cands - 1)
        cands = np.concatenate([[pos], negs])
        perm = rng.permutation(n_cands)
        ct[b] = store.tokens[cands[perm]]
        cf[b] = store.freq[cands[perm]]
        label[b] = int(np.argwhere(perm == 0)[0, 0])
    valid = int((ht != 0).sum() + (ct != 0).sum())
    return {"hist_tokens": ht, "hist_freq": hf, "hist_mask": hm,
            "cand_tokens": ct, "cand_freq": cf, "label": label,
            "cand_mask": np.ones((B, n_cands), bool),
            "_stats": {"data_efficiency":
                       valid / max(ht.size + ct.size, 1)}}

class DynamicBatcher:
    """Multi-threaded bucketed loader -> queue of centralized batches.

    ``get`` distinguishes the two empty-queue cases: ``EPOCH_END`` when every
    worker has drained its shard (including the final partial buckets), and
    ``None`` when the call merely timed out while workers are still
    producing. Callers must not treat ``None`` as end-of-data.
    """

    def __init__(self, log: ClickLog, store: NewsStore, cfg: LoaderConfig,
                 *, n_threads: int = 2, seed: int = 0):
        self.log, self.store, self.cfg = log, store, cfg
        self.queue = WorkStealingQueue(n_threads)
        self.n_threads = n_threads
        self._seed = seed
        self._stop = threading.Event()
        self._threads = []
        self._done = 0
        self._done_lock = threading.Lock()
        self._error: BaseException | None = None

    def _worker(self, shard: int):
        try:
            self._produce(shard)
        except BaseException as e:   # surfaced by get(); a dead worker must
            self._error = e          # not leave the epoch hanging forever
        finally:
            if not self._stop.is_set():
                with self._done_lock:
                    self._done += 1

    def _produce(self, shard: int):
        rng = np.random.default_rng(self._seed + shard)
        buckets = {b: [] for b in self.cfg.buckets}
        fill = {b: 0 for b in self.cfg.buckets}
        hists = self.log.histories[shard::self.n_threads]
        order = rng.permutation(len(hists))
        for idx in order:
            if self._stop.is_set():
                return
            h = hists[idx]
            if len(h) < 2:
                continue
            max_len = int(self.store.lengths[h].max())
            b = bucket_for(max_len, self.cfg.buckets)
            buckets[b].append(h)
            fill[b] += len(h) * self.cfg.n_segments * b
            if (fill[b] >= self.cfg.token_budget
                    or len(buckets[b]) >= self.cfg.b_cap):
                batch = build_centralized_batch(buckets[b], self.store,
                                                self.cfg, b)
                self.queue.put(shard, batch)
                buckets[b], fill[b] = [], 0
                while self.queue.qsize() > 8 and not self._stop.is_set():
                    self._stop.wait(0.002)
        for b, insts in buckets.items():
            if insts and not self._stop.is_set():
                self.queue.put(shard, build_centralized_batch(
                    insts, self.store, self.cfg, b))

    def start(self):
        for i in range(self.n_threads):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def exhausted(self) -> bool:
        """All workers finished their shard (final partials already queued)."""
        with self._done_lock:
            return bool(self._threads) and self._done >= self.n_threads

    def get(self, timeout: float = 5.0):
        """Next batch, ``EPOCH_END`` once the epoch is fully drained, or
        ``None`` on timeout (loader still running, just slow). Re-raises a
        worker's exception instead of hanging on its missing shard."""
        deadline = time.monotonic() + timeout
        while True:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            item = self.queue.get(0, timeout=0.02)
            if item is not None:
                return item
            if self.exhausted() and self.queue.qsize() == 0:
                if self._error is not None:   # a crash is not a clean epoch:
                    continue                  # re-loop raises it, not EPOCH_END
                return EPOCH_END
            if time.monotonic() >= deadline:
                return None

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
