"""Continuous-batching request scheduler for the serving front end.

Real traffic is an *open-loop* arrival process: requests show up on their
own clock, not after the previous answer came back. This is the in-flight
batching front end that the launcher's closed-loop driver and the
open-loop Poisson harness (``loadgen.py``) both run on:

  admission     ``submit()`` appends to a *bounded* queue; at
                ``max_queue`` it raises ``BackpressureError`` before any
                mutation (the contract of ``publish`` at the delta hard
                cap): callers shed load instead of growing a backlog.
  batching      a worker thread pops the oldest request and gathers
                followers until ``max_batch`` is reached or
                ``max_wait_ms`` has elapsed since the gather began, so a
                lone request is never starved behind an unfilled batch.
                New submissions land in the queue while a batch executes.
  shape buckets batches are padded to the smallest power-of-two bucket
                that fits (never to ``max_batch``); ``warmup()`` runs one
                batch per bucket up front (the caching allocator's blocks
                and the kernels' first launches), and partial batches
                never encode junk rows at the full ``max_batch`` shape.
  SLO           each request may carry a deadline (``slo_ms``). A request
                already past it when dequeued is *late-dropped* (never
                executed); one that completes past it is delivered but
                counted. Both land in ``serve_slo_violations_total{kind}``;
                goodput is what completed within the SLO.
  drain         ``stop(drain=True)`` flushes the queue in max-batch gulps
                (no timeout waits) before the worker exits;
                ``drain=False`` cancels everything still queued.

``execute`` runs on the scheduler's own thread. That thread takes the
CUDA device that was current where the scheduler was made, as the
service's rebuild worker does, so a bare ``"cuda"`` means the same card
on both threads. ``execute`` returns host values: the completion stamp is
when the answers reached the host, not when their launches were queued.

Telemetry (the JAX package's series): ``sched_queue_depth``,
``sched_flush_total{reason}``, ``sched_batch_occupancy``,
``sched_execute_errors_total``, ``serve_rejected_total``,
``serve_slo_violations_total{kind}``, ``query_latency_ms{phase=queued|
execute|e2e}``, ``serve_batch_size``, ``serve_requests_total``,
``serve_batches_total`` and the ``serve_batch`` span. ``attach_to(service)``
folds the admission queue into the service's ``health()`` as a
``scheduler`` component (saturated queue = degraded).
"""
from __future__ import annotations

import collections
import threading
import time

import torch

from repro_torch import obs

from .service import BackpressureError

__all__ = ["RequestScheduler", "ScheduledRequest", "DeadlineExceededError",
           "RequestCancelledError", "pow2_buckets", "bucket_for"]


class DeadlineExceededError(RuntimeError):
    """The request missed its SLO deadline while queued and was dropped
    without executing (late-drop)."""


class RequestCancelledError(RuntimeError):
    """The scheduler was stopped without draining while the request was
    still queued."""


def pow2_buckets(max_batch: int) -> tuple[int, ...]:
    """Shape buckets 1, 2, 4, ... up to (and always including)
    ``max_batch``."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket that fits ``n`` live requests."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


class ScheduledRequest:
    """One admitted request: payload + lifecycle timestamps + outcome.

    ``status``: ``pending`` -> ``ok`` | ``late`` (SLO late-drop) |
    ``cancelled`` (non-drain stop) | ``error`` (execute raised).
    ``slo_ok`` is True when the request completed within its deadline
    (always True without one): the goodput predicate. Timestamps are
    ``time.monotonic()``; only differences are meaningful.
    """

    __slots__ = ("payload", "t_enq", "deadline", "status", "slo_ok",
                 "t_deq", "t_done", "value", "error", "_event")

    def __init__(self, payload, t_enq: float, deadline: float | None):
        self.payload = payload
        self.t_enq = t_enq
        self.deadline = deadline
        self.status = "pending"
        self.slo_ok = False
        self.t_deq = float("nan")
        self.t_done = float("nan")
        self.value = None
        self.error: BaseException | None = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: float | None = None):
        """Block for the outcome; returns the value or raises the
        request's terminal error (late-drop / cancel / execute error)."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self.status == "ok":
            return self.value
        if self.status == "late":
            raise DeadlineExceededError(
                f"request past its SLO deadline by "
                f"{(self.t_deq - self.deadline) * 1e3:.1f}ms at dequeue")
        if self.status == "cancelled":
            raise RequestCancelledError("scheduler stopped without drain")
        raise self.error

    @property
    def queued_ms(self) -> float:
        return (self.t_deq - self.t_enq) * 1e3

    @property
    def e2e_ms(self) -> float:
        return (self.t_done - self.t_enq) * 1e3


class RequestScheduler:
    """Continuous-batching front end: bounded admission + shape-bucketed
    batches + timeout flush + SLO accounting, on a dedicated worker.

    ``execute(payloads, pad_to)`` is the model-side callable: it pads
    ``len(payloads)`` requests up to the batch dim ``pad_to`` (one of
    ``self.buckets``), runs the pipeline, and returns one host result per
    payload **in order**. It runs on the worker thread only.
    """

    def __init__(self, execute, *, max_batch: int = 16,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 slo_ms: float | None = None, drop_late: bool = True,
                 buckets=None, on_batch=None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._execute = execute
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.slo_ms = slo_ms
        self.drop_late = drop_late
        self.buckets = tuple(buckets) if buckets else pow2_buckets(max_batch)
        if any(b > max_batch for b in self.buckets):
            raise ValueError(f"bucket beyond max_batch: {self.buckets}")
        self._on_batch = on_batch
        self.n_batches = 0
        self._q: collections.deque[ScheduledRequest] = collections.deque()
        self._cv = threading.Condition()
        self._stopping = False
        self._drain = True
        # the caller's device, resolved here: on the worker thread a bare
        # "cuda" would otherwise mean device 0
        self._cuda_index = (torch.cuda.current_device()
                            if torch.cuda.is_available() else None)
        self._h_queued = obs.histogram("query_latency_ms", phase="queued")
        self._h_exec = obs.histogram("query_latency_ms", phase="execute")
        self._h_e2e = obs.histogram("query_latency_ms", phase="e2e")
        self._h_bsz = obs.histogram("serve_batch_size")
        self._h_occ = obs.histogram("sched_batch_occupancy")
        self._c_req = obs.counter("serve_requests_total")
        self._c_batch = obs.counter("serve_batches_total")
        self._c_rejected = obs.counter("serve_rejected_total")
        self._c_late_drop = obs.counter("serve_slo_violations_total",
                                        kind="late_drop")
        self._c_completed_late = obs.counter("serve_slo_violations_total",
                                             kind="completed_late")
        # computed at collect; the last-constructed scheduler wins the
        # gauge when a process holds several
        obs.gauge("sched_queue_depth").set_fn(lambda: len(self._q))
        self._thread = threading.Thread(target=self._run,
                                        name="request-scheduler", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ admission
    @property
    def depth(self) -> int:
        """Requests admitted but not yet dequeued into a batch."""
        return len(self._q)

    @property
    def saturated(self) -> bool:
        return len(self._q) >= self.max_queue

    def submit(self, payload, *,
               slo_ms: float | None = None) -> ScheduledRequest:
        """Admit one request (non-blocking). Raises ``BackpressureError``
        when the admission queue is full: nothing was enqueued. ``slo_ms``
        overrides the scheduler default for this request (``float("inf")``
        for no deadline)."""
        t_enq = time.monotonic()
        slo = self.slo_ms if slo_ms is None else slo_ms
        deadline = None
        if slo is not None and slo != float("inf"):
            deadline = t_enq + slo / 1e3
        r = ScheduledRequest(payload, t_enq, deadline)
        with self._cv:
            if self._stopping:
                raise RuntimeError("scheduler is stopped")
            if len(self._q) >= self.max_queue:
                self._c_rejected.inc()
                raise BackpressureError(
                    f"admission queue full ({len(self._q)}/{self.max_queue});"
                    f" shed load and retry: queued work would only make "
                    f"every deadline worse")
            self._q.append(r)
            self._cv.notify()
        return r

    # ------------------------------------------------------------ lifecycle
    def warmup(self, payload) -> int:
        """One ``execute`` call per shape bucket, with a single live row,
        before traffic arrives. Returns the number of buckets warmed."""
        for b in self.buckets:
            self._execute([payload], b)
        return len(self.buckets)

    def stop(self, drain: bool = True, timeout: float | None = 30.0):
        """Stop the worker. ``drain=True`` executes everything still
        queued (max-batch gulps, no timeout waits) first; ``drain=False``
        cancels queued requests (``RequestCancelledError``). The batch in
        flight always runs to completion."""
        with self._cv:
            self._stopping = True
            self._drain = drain
            self._cv.notify_all()
        self._thread.join(timeout)

    def attach_to(self, service):
        """Fold the admission queue into ``service.health()`` as a
        ``scheduler`` component: a saturated queue (``submit`` rejecting)
        reads as degraded, with transition edges counted."""
        service.attach_health(
            "scheduler", lambda: not self.saturated,
            lambda: {"queue_depth": len(self._q),
                     "max_queue": self.max_queue,
                     "rejected_total": int(self._c_rejected.value)})

    # --------------------------------------------------------------- worker
    def _run(self):
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            with self._cv:
                while not self._q and not self._stopping:
                    self._cv.wait(0.5)
                if self._stopping and (not self._q or not self._drain):
                    leftovers = list(self._q)
                    self._q.clear()
                    break
                batch = [self._q.popleft()]
            reason = self._gather(batch)
            self._execute_batch(batch, reason)
        for r in leftovers:
            r.status = "cancelled"
            r._event.set()

    def _gather(self, batch) -> str:
        """Fill ``batch`` until max_batch / timeout / drain; returns the
        flush reason. The timeout window opens when gathering starts, so
        a lone request waits at most ``max_wait_ms`` beyond its dequeue."""
        flush_by = time.monotonic() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            with self._cv:
                while not self._q and not self._stopping:
                    remaining = flush_by - time.monotonic()
                    if remaining <= 0:
                        return "timeout"
                    self._cv.wait(remaining)
                if self._q:
                    batch.append(self._q.popleft())
                    continue
            return "drain"          # stopping and queue empty: flush now
        return "full"

    def _execute_batch(self, batch, reason):
        t_deq = time.monotonic()
        live = []
        for r in batch:
            r.t_deq = t_deq
            self._h_queued.observe(r.queued_ms)
            if (self.drop_late and r.deadline is not None
                    and t_deq > r.deadline):
                r.status = "late"
                self._c_late_drop.inc()
                r._event.set()
            else:
                live.append(r)
        obs.counter("sched_flush_total", reason=reason).inc()
        if not live:
            return                   # the whole batch expired while queued
        pad_to = bucket_for(len(live), self.buckets)
        t0 = time.monotonic()
        try:
            with obs.span("serve_batch"):
                out = list(self._execute([r.payload for r in live], pad_to))
        except Exception as e:       # noqa: BLE001 - delivered per request
            obs.counter("sched_execute_errors_total").inc()
            for r in live:
                r.status, r.error = "error", e
                r._event.set()
            return
        t_done = time.monotonic()
        exec_ms = (t_done - t0) * 1e3
        if len(out) != len(live):
            e = RuntimeError(f"execute returned {len(out)} results for "
                             f"{len(live)} requests")
            obs.counter("sched_execute_errors_total").inc()
            for r in live:
                r.status, r.error = "error", e
                r._event.set()
            return
        for r, v in zip(live, out):
            r.value = v
            r.t_done = t_done
            r.slo_ok = r.deadline is None or t_done <= r.deadline
            if not r.slo_ok:
                self._c_completed_late.inc()
            self._h_exec.observe(exec_ms)
            self._h_e2e.observe(r.e2e_ms)
            r.status = "ok"
            r._event.set()
        self.n_batches += 1
        self._h_bsz.observe(len(live))
        self._h_occ.observe(len(live) / pad_to)
        self._c_req.inc(len(live))
        self._c_batch.inc()
        obs.tick()
        if self._on_batch is not None:
            self._on_batch(self.n_batches)
