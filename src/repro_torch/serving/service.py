"""Two-stage retrieval service on a versioned index-snapshot lifecycle.

Stage 1 asks the compressed/ANN tier for k' >> k candidates; stage 2
re-scores those k' with the full-precision embeddings (one [B, k', d]
gather + einsum on the device store) and returns the exact
top-k of the candidate set.

Lifecycle — the only write surface of the serving tier:

    publish(ids, emb)     O(delta append): store grow-and-scatter + delta
                          tier; never an IVF assignment or PQ encode
    rebuild(mode=...)     IndexBuilder produces a new IndexSnapshot off the
                          request path — "full" retrains quantizers over
                          all live ids, "compact" absorbs the delta into
                          the current build; block=False runs it on a
                          background thread
    swap(snapshot)        atomic install: ONE reference assignment
    snapshot()            the currently published immutable snapshot

Queries read one frozen ``ServiceView`` (snapshot + delta view) reference
and never take a lock. Retries, health and backpressure belong to a later
slice.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.device import check_device

from .index import _topk_padded
from .online import DeltaBuffer, DeltaView, hybrid_search
from .snapshot import IndexSnapshot
from .store import EmbeddingStore


@dataclasses.dataclass(frozen=True)
class ServiceView:
    """Everything one query sees, frozen together: exactly one index
    snapshot and one delta view, published as a single reference."""
    snapshot: IndexSnapshot
    delta: DeltaView


class RetrievalService:
    """Snapshot lifecycle + delta tier + full-precision re-rank."""

    def __init__(self, builder, store_emb, *, k: int = 10,
                 k_prime: int | None = None, compact_threshold: int = 512,
                 auto_compact: bool = True, store_grow_chunk: int = 1,
                 device="cuda"):
        """builder: IndexBuilder on the same device. store_emb: [N_global,
        d] full-precision embeddings keyed by global news id (row 0 = pad
        news, never a candidate). The service starts on the empty
        version-0 snapshot; bootstrap by publishing the corpus and calling
        ``rebuild(mode="full")``, or by swapping in a snapshot."""
        self.device = check_device(device)
        if builder.device != self.device:
            raise ValueError(f"builder on {builder.device}, service on "
                             f"{self.device}")
        self.builder = builder
        self.store = EmbeddingStore(store_emb, grow_chunk=store_grow_chunk,
                                    device=self.device)
        self.k = k
        self.k_prime = k_prime or max(4 * k, 32)
        self.auto_compact = auto_compact
        self.delta = DeltaBuffer(builder.dim,
                                 compact_threshold=compact_threshold,
                                 device=self.device)
        self.n_swaps = 0
        # _lock serializes WRITERS only (publish / swap / delta prune);
        # the query path reads self._view once and never locks
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()    # one build in flight
        self._build_thread: threading.Thread | None = None
        self._build_error: BaseException | None = None
        self._view = ServiceView(builder.empty(), self.delta.view())

    # ------------------------------------------------------------ reads
    def snapshot(self) -> IndexSnapshot:
        return self._view.snapshot

    @property
    def version(self) -> int:
        return self._view.snapshot.version

    @property
    def ntotal(self) -> int:
        """Ids served by the main tier (excludes pending delta entries)."""
        return self._view.snapshot.ntotal

    @property
    def n_pending(self) -> int:
        return len(self._view.delta)

    # ----------------------------------------------------------- writes
    def publish(self, ids, emb):
        """Fresh news: grow-and-scatter the store, append to the delta
        tier. Past the threshold a compaction is scheduled on a background
        thread (auto_compact=False leaves that to the caller)."""
        with self._lock:
            ids, emb = self.store.scatter(ids, emb)
            self.delta.add(ids, emb)
            self._view = ServiceView(self._view.snapshot, self.delta.view())
        if self.auto_compact and self.delta.should_compact:
            self.rebuild(mode="compact", block=False)

    def swap(self, snapshot: IndexSnapshot, *, prune_upto: int | None = None):
        """Atomically install ``snapshot``; ``prune_upto`` (the builder-side
        ``delta.watermark()``) first drops exactly the absorbed delta."""
        with self._lock:
            if prune_upto is not None:
                self.delta.prune(prune_upto)
            self._view = ServiceView(snapshot, self.delta.view())
            self.n_swaps += 1

    def rebuild(self, *, mode: str = "full", block: bool = True):
        """Produce a new snapshot off the request path and swap it in.

        block=False runs the build on a daemon thread (on this service's
        device) and returns it, or None if a build is already in flight;
        its error is re-raised by ``wait_for_build``."""
        if mode not in ("full", "compact"):
            raise ValueError(f"unknown rebuild mode: {mode!r}")
        if block:
            with self._build_lock:
                return self._build_and_swap(mode)
        if not self._build_lock.acquire(blocking=False):
            return None
        # the caller's device, resolved here: a bare "cuda" means the
        # current device of the calling thread, not of the new one
        cuda_index = None
        if self.device.type == "cuda":
            cuda_index = (self.device.index if self.device.index is not None
                          else torch.cuda.current_device())

        def _worker():
            try:
                if cuda_index is not None:
                    torch.cuda.set_device(cuda_index)
                self._build_and_swap(mode)
            except BaseException as e:   # surfaced via wait_for_build
                self._build_error = e
            finally:
                self._build_lock.release()

        t = threading.Thread(target=_worker, name="index-rebuild",
                             daemon=True)
        self._build_thread = t
        t.start()
        return t

    def wait_for_build(self):
        """Join the most recent background rebuild, if any, and re-raise
        the error that killed it (once)."""
        t = self._build_thread
        if t is not None:
            t.join()
            self._build_thread = None
        err, self._build_error = self._build_error, None
        if err is not None:
            raise err

    def _build_and_swap(self, mode: str):
        with self._lock:             # consistent (view, watermark) pair
            view = self._view
            watermark = self.delta.watermark()
        d = view.delta
        if mode == "compact" and view.snapshot.ntotal > 0:
            snap = self.builder.compact(view.snapshot, d.ids, d.emb)
        else:
            ids = np.union1d(view.snapshot.member_ids,
                             np.asarray(d.ids, np.int64))
            snap = self.builder.build(ids, self.store.emb[
                torch.as_tensor(ids, device=self.device)])
        self.swap(snap, prune_upto=watermark)
        return snap

    # ------------------------------------------------------------ query
    def query(self, user_emb, k: int | None = None):
        """user_emb: [B, d] -> (scores [B, k], ids [B, k]) numpy, the
        response that leaves the device.

        Stage 1: ANN + delta hybrid recall of k' candidate ids from ONE
        frozen ServiceView. Stage 2: exact re-rank in full precision.
        """
        k = self.k if k is None else k
        if k > self.k_prime:
            raise ValueError(
                f"query k={k} exceeds k_prime={self.k_prime}: stage 1 only "
                f"recalls k_prime candidates")
        # grab the view BEFORE the store: the store only grows, so every
        # id the (older) view can return has a row in the store
        view = self._view
        store = self.store.emb
        q = torch.as_tensor(user_emb, dtype=torch.float32, device=self.device)
        _, cand = hybrid_search(view.snapshot, view.delta, q, self.k_prime)
        cand_vecs = store[cand.clamp_min(0)]          # PAD -> row 0
        scores = torch.einsum("bd,bcd->bc", q, cand_vecs)
        s, ids = _topk_padded(scores, cand, k)
        return s.cpu().numpy(), ids.cpu().numpy()
