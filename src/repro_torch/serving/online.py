"""Online index deltas: serve news published after the last index build.

Fresh embeddings land in a small brute-force tier that is scanned exactly
on every query and merged with the main ANN snapshot. ``publish`` is a
pure append here, and the ``IndexBuilder`` absorbs the buffered rows off
the request path (``RetrievalService.rebuild``). Each ``add`` stamps a
monotone sequence number; a build records the ``watermark()`` it
absorbed, and the post-swap ``prune(watermark)`` drops exactly the
absorbed entries — an id re-published during the build keeps its newer
stamp and keeps overriding the stale row the build captured. Queries see
the buffer only through frozen ``DeltaView``s.

Embeddings enter either straight from the training cache
(``ingest_from_cache`` reads ``core.cache.CacheState`` rows the trainer
already paid to encode) or from a fresh encoder call (``add``). A
``max_size`` hard cap bounds the tier for degraded-mode serving.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cache import NEVER, CacheState

from .index import PAD_ID, FlatIndex, _topk_padded


class DeltaOverflowError(RuntimeError):
    """An ``add`` would grow the delta tier past its ``max_size`` hard cap.

    The cap exists for degraded-mode serving: when index rebuilds keep
    failing, the delta must not grow unboundedly (its exact scan is on
    every query's critical path); the service surfaces this as
    backpressure on ``publish`` while queries keep serving the last good
    snapshot (see ``RetrievalService.health``)."""


@dataclasses.dataclass(frozen=True)
class DeltaView:
    """Frozen view of the delta tier at one instant (host ids + embeddings;
    a search moves them to ``device``). Zero-copy: DeltaBuffer mutation
    rebinds fresh arrays."""
    ids: np.ndarray          # [n] int64
    emb: np.ndarray          # [n, d] float32
    device: torch.device

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    def search(self, queries, k: int):
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        B = q.shape[0]
        if len(self) == 0:
            return (torch.full((B, k), float("-inf"), device=self.device),
                    torch.full((B, k), PAD_ID, dtype=torch.int64,
                               device=self.device))
        scores = q @ torch.as_tensor(self.emb, device=self.device).T
        ids = torch.as_tensor(self.ids, device=self.device)
        cand = ids[None].expand(B, -1)
        return _topk_padded(scores, cand, k)


class DeltaBuffer:
    """Brute-force tier for fresh news; id-keyed, newest write wins.

    Storage is a FlatIndex (whose add() is an upsert); this class adds the
    sequence-stamped publish/prune lifecycle. ``should_compact`` only
    signals — compaction itself is the builder's job, off the request path.
    """

    def __init__(self, dim: int, *, compact_threshold: int = 512,
                 max_size: int | None = None, device="cuda"):
        self.dim = dim
        self.compact_threshold = compact_threshold
        self.max_size = max_size       # hard cap; None = unbounded
        self.device = torch.device(device)
        self._flat = FlatIndex(dim, self.device)
        self._seq = 0                  # bumps once per add() batch
        self._id_seq: dict[int, int] = {}

    def __len__(self) -> int:
        return self._flat.ntotal

    @property
    def ids(self):
        return self._flat._ids

    @property
    def emb(self):
        return self._flat._vecs

    def would_overflow(self, ids) -> bool:
        """Would upserting ``ids`` grow the buffer past ``max_size``?
        (Re-published ids overwrite in place and never grow it.)"""
        if self.max_size is None:
            return False
        fresh = sum(1 for i in np.unique(np.asarray(ids, np.int64))
                    if int(i) not in self._id_seq)
        return len(self) + fresh > self.max_size

    def add(self, ids, emb):
        """Upsert fresh embeddings (re-published ids overwrite in place).
        Raises ``DeltaOverflowError`` past the ``max_size`` hard cap."""
        if self.would_overflow(ids):
            raise DeltaOverflowError(
                f"delta tier at hard cap ({len(self)}/{self.max_size}); "
                f"a rebuild/compaction must absorb it before more "
                f"publishes are accepted")
        self._seq += 1
        ids = np.asarray(ids, np.int64)
        self._flat.add(ids, emb)
        for i in ids:
            self._id_seq[int(i)] = self._seq

    def view(self) -> DeltaView:
        """Frozen (ids, emb) for the query path."""
        return DeltaView(self._flat._ids, self._flat._vecs, self.device)

    def watermark(self) -> int:
        """Sequence stamp covering everything currently buffered."""
        return self._seq

    def prune(self, upto: int):
        """Drop entries a build with ``watermark() == upto`` absorbed; ids
        re-published since then carry a newer stamp and stay."""
        drop = [i for i, s in self._id_seq.items() if s <= upto]
        if drop:
            self._flat.remove(np.asarray(drop, np.int64))
            for i in drop:
                del self._id_seq[i]

    @property
    def should_compact(self) -> bool:
        return len(self) >= self.compact_threshold

    def compact_into(self, index):
        """Bulk-add the buffered embeddings into ``index`` and clear.

        Low-level escape hatch (tests, offline tools): the service
        compacts through ``IndexBuilder.compact`` + swap instead, keeping
        the encode work off the request path."""
        if len(self):
            index.add(self.ids, self.emb)
        self._flat = FlatIndex(self.dim, self.device)
        self._id_seq.clear()


def ingest_from_cache(delta: DeltaBuffer, state: CacheState, ids):
    """Pull rows the trainer already encoded (``core.cache.CacheState``,
    gathered on the state's device) into the delta tier; rows never
    written (written_step == NEVER) are skipped. Returns the number
    ingested."""
    ids = np.asarray(ids, np.int64)
    written = state.written_step.cpu().numpy()[ids] != NEVER
    if written.any():
        rows = torch.as_tensor(ids[written], device=state.emb.device)
        delta.add(ids[written], state.emb[rows].cpu().numpy())
    return int(written.sum())


def merge_topk_dedup(scores, ids, k: int):
    """Row-wise top-k of (scores [B, C], ids [B, C]) tensors with id dedup:
    stable descending sort by score, the first (best-scoring, earliest
    column on ties) occurrence of each id wins, PAD_ID slots are skipped,
    and rows with fewer than k distinct valid ids pad with (-inf, PAD_ID).
    """
    B = scores.shape[0]
    dev = scores.device
    s_sorted, order = torch.sort(scores, dim=1, descending=True, stable=True)
    i_sorted = torch.gather(ids, 1, order)
    # first occurrence per id within each row: stable-sort the id lane, so
    # within an id group the (descending-score) positions stay ascending
    sid, perm = torch.sort(i_sorted, dim=1, stable=True)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    keep = torch.empty_like(first).scatter_(1, perm, first)
    keep &= i_sorted != PAD_ID
    rank = torch.cumsum(keep.long(), dim=1) - 1   # 0-based rank among kept
    take = keep & (rank < k)
    out_s = torch.full((B, k), float("-inf"), device=dev)
    out_i = torch.full((B, k), PAD_ID, dtype=torch.int64, device=dev)
    rows, cols = torch.nonzero(take, as_tuple=True)
    out_s[rows, rank[rows, cols]] = s_sorted[rows, cols].float()
    out_i[rows, rank[rows, cols]] = i_sorted[rows, cols].long()
    return out_s, out_i


def hybrid_search(main, delta, queries, k: int):
    """Main-tier ANN + exact delta scan, merged to one top-k.

    ``main`` is an IndexSnapshot; ``delta`` a DeltaView or None. Ids in
    both tiers resolve to the delta score (freshest embedding wins). The
    main tier is over-fetched by len(delta), rounded up to a power of two:
    every main hit that also lives in the delta tier is nulled as stale,
    so k fresh survivors need up to k + len(delta) main results.
    """
    if delta is None or len(delta) == 0:
        return main.search(queries, k)
    k_main = k + len(delta)
    k_main = 1 << (k_main - 1).bit_length()
    s_main, i_main = main.search(queries, k_main)
    s_d, i_d = delta.search(queries, k)
    stale = torch.isin(i_main, torch.as_tensor(delta.ids,
                                               device=i_main.device))
    s_main = s_main.masked_fill(stale, float("-inf"))
    i_main = i_main.masked_fill(stale, PAD_ID)
    return merge_topk_dedup(torch.cat([s_d, s_main], dim=1),
                            torch.cat([i_d, i_main], dim=1), k)
