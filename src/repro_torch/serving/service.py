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
and never take a lock.

Degraded mode: a failed rebuild is retried with backoff and jitter,
consecutive failures flip the index component of ``health()`` to
degraded, and past ``delta_hard_cap`` ``publish`` raises
``BackpressureError`` before any mutation while queries keep serving the
last good snapshot and the capped delta. The lifecycle series
(``index_publish_total``, ``index_swap_total``, ``index_build_*``,
``health_*``, the ``index_delta_size`` / ``index_snapshot_version`` /
``index_staleness_s`` gauges and the ``index_rebuild`` span) are the JAX
package's.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import check_device
from repro_torch.resilience import faults

from .index import _topk_padded
from .online import DeltaBuffer, DeltaView, hybrid_search
from .snapshot import IndexSnapshot
from .store import EmbeddingStore


class BackpressureError(RuntimeError):
    """``publish`` refused: the delta tier is at its hard cap.

    The write side of the degraded-mode contract: when rebuilds keep
    failing, the delta cannot grow unboundedly, so publishers back off
    and retry after a successful rebuild/compaction absorbs the buffer.
    The read side is unaffected: queries keep serving the last good
    snapshot + the capped delta."""


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
                 auto_compact: bool = True, delta_hard_cap: int | None = None,
                 build_retries: int = 2, build_backoff_s: float = 0.1,
                 build_backoff_factor: float = 2.0,
                 build_backoff_jitter: float = 0.25,
                 degraded_after_failures: int = 2,
                 store_grow_chunk: int = 1, device="cuda"):
        """builder: IndexBuilder on the same device. store_emb: [N_global,
        d] full-precision embeddings keyed by global news id (row 0 = pad
        news, never a candidate). The service starts on the empty
        version-0 snapshot; bootstrap by publishing the corpus and calling
        ``rebuild(mode="full")``, or by swapping in a snapshot.

        Degraded-mode knobs: ``delta_hard_cap`` (default ``8 *
        compact_threshold``) bounds the delta tier, beyond it ``publish``
        raises ``BackpressureError``; rebuild failures are retried
        ``build_retries`` times with exponential backoff
        (``build_backoff_s * build_backoff_factor**attempt``, stretched by
        up to ``build_backoff_jitter``), and ``degraded_after_failures``
        consecutive failures flip the index component of ``health()`` to
        degraded. ``store_grow_chunk``: the store's capacity growth, in
        rows."""
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
        self.delta_hard_cap = (delta_hard_cap if delta_hard_cap is not None
                               else 8 * compact_threshold)
        self.delta = DeltaBuffer(builder.dim,
                                 compact_threshold=compact_threshold,
                                 max_size=self.delta_hard_cap,
                                 device=self.device)
        self.build_retries = build_retries
        self.build_backoff_s = build_backoff_s
        self.build_backoff_factor = build_backoff_factor
        self.build_backoff_jitter = build_backoff_jitter
        self.degraded_after_failures = degraded_after_failures
        self.n_swaps = 0
        # _lock serializes WRITERS only (publish / swap / delta prune);
        # the query path reads self._view once and never locks
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()    # one build in flight
        self._build_thread: threading.Thread | None = None
        self._build_error: BaseException | None = None   # for wait_for_build
        self._last_build_exc: BaseException | None = None  # shown by health()
        self._build_failures = 0               # consecutive; reset on success
        self._health_last: dict = {}
        # externally attached components (the request scheduler's
        # admission queue): component -> (ok_fn, info_fn)
        self._extra_health: dict = {}
        self._view = ServiceView(builder.empty(), self.delta.view())
        # lifecycle telemetry: write-path counters count in place; the
        # state gauges are computed at collect off the live view, so the
        # request path pays nothing (the last-constructed service wins the
        # gauges when a process holds several)
        self._c_publish = obs.counter("index_publish_total")
        self._c_swap = obs.counter("index_swap_total")
        obs.gauge("index_delta_size").set_fn(lambda: len(self._view.delta))
        obs.gauge("index_snapshot_version").set_fn(
            lambda: self._view.snapshot.version)
        obs.gauge("index_staleness_s").set_fn(
            lambda: max(0.0, time.time() - self._view.snapshot.built_at)
            if self._view.snapshot.built_at else 0.0)
        # health: 1.0 healthy / 0.0 degraded at collect; transitions also
        # count into health_transitions_total{component=,to=}
        obs.gauge("health_status", component="index").set_fn(
            lambda: float(self._index_ok()))
        obs.gauge("health_status", component="delta").set_fn(
            lambda: float(self._delta_ok()))
        obs.gauge("health_status", component="service").set_fn(
            lambda: float(self._service_ok()))
        self._note_health()                    # baseline, no transitions

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

    @property
    def build_in_flight(self) -> bool:
        return self._build_lock.locked()

    @property
    def store_emb(self) -> torch.Tensor:
        """The full-precision store on the device (alias of store.emb)."""
        return self.store.emb

    # ----------------------------------------------------------- health
    def _index_ok(self) -> bool:
        return self._build_failures < self.degraded_after_failures

    def _delta_ok(self) -> bool:
        return len(self._view.delta) < self.delta_hard_cap

    def _service_ok(self) -> bool:
        return (self._index_ok() and self._delta_ok()
                and all(bool(ok_fn()) for ok_fn, _
                        in self._extra_health.values()))

    def attach_health(self, component: str, ok_fn, info_fn=None):
        """Fold an external component into this service's health surface.

        ``ok_fn() -> bool`` is polled by ``health()``, the computed-at-
        collect ``health_status{component=...}`` gauge and the transition
        counters; ``info_fn() -> dict`` (optional) gives the component's
        detail block. ``RequestScheduler.attach_to`` uses this, so a
        saturated admission queue degrades the service the way failing
        rebuilds or a capped delta tier do."""
        self._extra_health[component] = (ok_fn, info_fn or (lambda: {}))
        obs.gauge("health_status", component=component).set_fn(
            lambda: float(bool(ok_fn())))
        self._note_health()

    def _note_health(self):
        """Record component health and count state *transitions* (the
        degraded->healthy edge survives in the counter even when no
        metrics snapshot sampled the bad window)."""
        cur = {"index": self._index_ok(), "delta": self._delta_ok()}
        for comp, (ok_fn, _) in self._extra_health.items():
            cur[comp] = bool(ok_fn())
        cur["service"] = all(cur.values())
        for comp, ok in cur.items():
            prev = self._health_last.get(comp)
            if prev is not None and prev != ok:
                obs.counter("health_transitions_total", component=comp,
                            to="healthy" if ok else "degraded").inc()
        self._health_last = cur

    def health(self) -> dict:
        """Structured health view of the serving tier.

        'degraded' never means wrong or blocked reads: queries always
        serve the last good snapshot + delta. It means the freshness
        machinery is behind: rebuilds keep failing (index component)
        and/or the delta tier hit its hard cap, so ``publish`` refuses
        writes (delta component)."""
        view = self._view
        delta_n = len(view.delta)
        index_ok, delta_ok = self._index_ok(), delta_n < self.delta_hard_cap
        err = self._last_build_exc
        comps = {
            "index": {"ok": index_ok,
                      "consecutive_build_failures": self._build_failures,
                      "degraded_after_failures": self.degraded_after_failures,
                      "last_build_error": repr(err) if err else None},
            "delta": {"ok": delta_ok, "size": delta_n,
                      "hard_cap": self.delta_hard_cap},
        }
        for comp, (ok_fn, info_fn) in self._extra_health.items():
            comps[comp] = {"ok": bool(ok_fn()), **info_fn()}
        ok = all(c["ok"] for c in comps.values())
        return {"status": "healthy" if ok else "degraded", "ok": ok,
                "components": comps,
                "snapshot_version": view.snapshot.version,
                "ntotal": view.snapshot.ntotal}

    # ----------------------------------------------------------- writes
    def publish(self, ids, emb):
        """Fresh news: grow-and-scatter the store, append to the delta
        tier. Past the threshold a compaction is scheduled on a background
        thread (auto_compact=False leaves that to the caller).

        Backpressure: when the delta tier is at ``delta_hard_cap`` (only
        reachable when rebuilds keep failing) this raises
        ``BackpressureError`` before any mutation; the store is untouched
        and queries keep serving."""
        with self._lock:       # serialize writers; queries never take this
            if self.delta.would_overflow(ids):
                obs.counter("publish_backpressure_total").inc()
                self._note_health()
                raise BackpressureError(
                    f"delta tier at hard cap "
                    f"({len(self._view.delta)}/{self.delta_hard_cap}); "
                    f"rebuild/compaction must drain it first "
                    f"(health: {self.health()['status']})")
            ids, emb = self.store.scatter(ids, emb)
            self.delta.add(ids, emb)
            self._view = ServiceView(self._view.snapshot, self.delta.view())
            self._note_health()
        self._c_publish.inc()
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
            # absorbing the delta may drop it back under the hard cap:
            # the delta component's degraded->healthy edge
            self._note_health()
        self._c_swap.inc()

    def rebuild(self, *, mode: str = "full", block: bool = True,
                retries: int | None = None):
        """Produce a new snapshot off the request path and swap it in.

        mode="full" retrains quantizers from the store over every live id;
        mode="compact" absorbs the delta into the current build. block=False
        runs the build on a daemon thread (on this service's device) and
        returns it, or None if a build is already in flight. A failure is
        retried ``retries`` times (default ``self.build_retries``) with
        backoff, counted (``index_build_failures_total``), folded into
        ``health`` and, from a background build, re-raised by
        ``wait_for_build``."""
        if mode not in ("full", "compact"):
            raise ValueError(f"unknown rebuild mode: {mode!r}")
        if block:
            with self._build_lock:
                return self._build_with_retries(mode, retries)
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
                self._build_with_retries(mode, retries)
            except BaseException as e:   # surfaced via wait_for_build/health
                self._build_error = e
            finally:
                self._build_thread = None      # no dangling ref on failure
                self._build_lock.release()

        t = threading.Thread(target=_worker, name="index-rebuild",
                             daemon=True)
        self._build_thread = t
        t.start()
        return t

    def wait_for_build(self):
        """Join the most recent background rebuild, if any, and re-raise
        the error that killed it (once; ``health()`` keeps reporting it)."""
        t = self._build_thread
        if t is not None:
            t.join()
            self._build_thread = None
        err, self._build_error = self._build_error, None
        if err is not None:
            raise err

    def _build_with_retries(self, mode: str, retries: int | None):
        """One build, retrying failures with backoff + jitter. Callers
        hold ``_build_lock``. Success resets the consecutive-failure count;
        exhaustion re-raises the last failure after counting it."""
        retries = self.build_retries if retries is None else retries
        last: BaseException | None = None
        for attempt in range(retries + 1):
            if attempt:
                delay = (self.build_backoff_s
                         * self.build_backoff_factor ** (attempt - 1)
                         * (1.0 + self.build_backoff_jitter
                            * random.random()))
                obs.counter("index_build_retries_total", mode=mode).inc()
                time.sleep(delay)
            try:
                snap = self._build_and_swap(mode)
            except Exception as e:
                last = e
                self._last_build_exc = e
                self._build_failures += 1
                obs.counter("index_build_failures_total", mode=mode).inc()
                self._note_health()
                continue
            self._build_failures = 0
            self._build_error = None
            self._last_build_exc = None
            self._note_health()
            return snap
        raise last

    def _build_and_swap(self, mode: str):
        faults.fire("index.rebuild")
        with obs.span("index_rebuild", mode=mode):
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
        obs.counter("index_build_total", mode=mode).inc()
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
