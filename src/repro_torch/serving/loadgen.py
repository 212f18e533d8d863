"""Open-loop Poisson load harness for the request scheduler.

Closed-loop drivers (submit, wait, submit, ...) can never observe
overload: the arrival rate self-throttles to the service rate, so every
latency number looks flat.  An *open-loop* generator fires requests on
an exogenous Poisson clock regardless of completions — exactly the
regime where queues grow, deadlines slip, and admission control starts
rejecting — which is what a p50/p99-under-SLO claim has to be measured
in.

The harness is deterministic per seed: the whole arrival schedule is
drawn up front from ``numpy.random.default_rng(seed)`` exponential
inter-arrival gaps, so two runs at the same (qps, duration, seed) offer
the identical request trace.  Per-request outcomes come from the
``ScheduledRequest`` handles themselves (status + monotonic
timestamps) — each sweep point is summarized in isolation, while the
process-wide obs registry keeps the cumulative counters the CI smoke
reads.

    sched = RequestScheduler(execute, max_batch=16, slo_ms=50.0, ...)
    sched.warmup(payloads[0])
    entry = sweep(sched, payloads, [100, 200, 400],
                  duration_s=2.0, slo_ms=50.0)
    record_sweep([entry], "chiprun_out/serve_sweep.json")

Each point records offered vs completed/rejected/late-dropped counts,
queued + e2e p50/p99, goodput under SLO (completed within deadline,
per second), and the reject rate; ``record_sweep`` merges entries into
a JSON document by (kind, source, scenario) so re-runs replace their own
rows and leave every other section alone. Both packages draw the trace
from numpy's ``default_rng``, so a trace at one (qps, duration, seed) is
the JAX package's, bit for bit, on the same host.
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np

from .service import BackpressureError

__all__ = ["arrival_offsets", "open_loop", "summarize", "sweep",
           "record_sweep"]


def arrival_offsets(qps: float, duration_s: float, seed: int = 0,
                    max_n: int = 1_000_000) -> np.ndarray:
    """Poisson arrival times in [0, duration_s), seconds from t0.

    Cumulative sum of exponential(1/qps) gaps — deterministic per seed,
    so a sweep point is a reproducible trace, not a new random process
    per run.  ``max_n`` bounds the draw (qps * duration far beyond any
    sweep this harness runs)."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    rng = np.random.default_rng(seed)
    n = min(max_n, max(16, int(qps * duration_s * 2 + 64)))
    t = np.cumsum(rng.exponential(1.0 / qps, size=n))
    while t[-1] < duration_s and n < max_n:     # tail top-up, rarely taken
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / qps, size=n))])
        n = t.shape[0]
    return t[t < duration_s]


def open_loop(sched, payloads, *, qps: float, duration_s: float,
              seed: int = 0, settle_timeout_s: float = 30.0):
    """Fire one open-loop Poisson trace at the scheduler.

    Submissions never wait on completions (that would close the loop);
    a submission the admission queue refuses is counted as rejected and
    the clock keeps running.  After the trace ends, outstanding requests
    get ``settle_timeout_s`` to finish.  Returns
    ``(handles, offered, rejected)``.
    """
    offsets = arrival_offsets(qps, duration_s, seed)
    t0 = time.monotonic()
    handles, rejected = [], 0
    for i, off in enumerate(offsets):
        delay = (t0 + float(off)) - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            handles.append(sched.submit(payloads[i % len(payloads)]))
        except BackpressureError:
            rejected += 1
    deadline = time.monotonic() + settle_timeout_s
    for h in handles:
        h.wait(max(0.0, deadline - time.monotonic()))
    return handles, len(offsets), rejected


def _pct(vals, p) -> float:
    return round(float(np.percentile(vals, p)), 3) if len(vals) else float("nan")


def summarize(handles, offered: int, rejected: int, *, qps: float,
              duration_s: float, slo_ms: float | None) -> dict:
    """One sweep point -> a JSON-ready record.

    goodput_qps counts requests that *completed within the SLO*, per
    offered second — late-drops, completed-late, rejects, and errors all
    fall out of it.  Percentiles come from the handles' own monotonic
    stamps, so each point is isolated from the previous points' traffic.
    """
    done = [h for h in handles if h.status == "ok"]
    late = sum(1 for h in handles if h.status == "late")
    errors = sum(1 for h in handles if h.status == "error")
    good = [h for h in done if h.slo_ok]
    queued = [h.queued_ms for h in handles if np.isfinite(h.queued_ms)]
    e2e = [h.e2e_ms for h in done]
    return {
        "offered_qps": round(float(qps), 1),
        "duration_s": round(float(duration_s), 2),
        "slo_ms": slo_ms,
        "offered": int(offered),
        "completed": len(done),
        "rejected": int(rejected),
        "late_dropped": int(late),
        "errors": int(errors),
        "completed_late": len(done) - len(good),
        "goodput_qps": round(len(good) / duration_s, 1),
        "reject_rate": round(rejected / max(offered, 1), 4),
        "queued_ms_p50": _pct(queued, 50), "queued_ms_p99": _pct(queued, 99),
        "e2e_ms_p50": _pct(e2e, 50), "e2e_ms_p99": _pct(e2e, 99),
    }


def sweep(sched, payloads, qps_points, *, duration_s: float = 2.0,
          slo_ms: float | None = None, seed: int = 0,
          scenario: str = "quiescent", source: str = "serve",
          settle_timeout_s: float = 30.0, extra: dict | None = None) -> dict:
    """Sweep offered QPS through one (already warmed) scheduler.

    The same scheduler serves every point — its executables stay warm
    across the sweep, so point-to-point deltas are load effects, not
    compile effects.  Each point gets its own derived seed (seed + index)
    and its own isolated summary.  ``scenario`` labels what else was
    going on (``quiescent`` vs ``during_rebuild``); ``extra`` is merged
    into the entry (index kind, corpus size, ...).
    """
    points = []
    for j, qps in enumerate(qps_points):
        handles, offered, rejected = open_loop(
            sched, payloads, qps=float(qps), duration_s=duration_s,
            seed=seed + j, settle_timeout_s=settle_timeout_s)
        points.append(summarize(handles, offered, rejected, qps=float(qps),
                                duration_s=duration_s, slo_ms=slo_ms))
    entry = {"kind": "load_sweep", "source": source, "scenario": scenario,
             "slo_ms": slo_ms, "max_batch": sched.max_batch,
             "max_wait_ms": sched.max_wait_ms, "max_queue": sched.max_queue,
             "buckets": list(sched.buckets), "seed": seed, "points": points}
    entry.update(extra or {})
    return entry


def record_sweep(entries, out_path) -> pathlib.Path:
    """Merge load-sweep entries into a JSON document.

    Replacement key is (kind, source, scenario): re-running a sweep
    replaces its own previous rows and leaves every other section
    (retrieval QPS, lifecycle, mesh, scan sweeps) untouched.  Creates a
    minimal document when ``out_path`` does not exist yet."""
    p = pathlib.Path(out_path)
    doc = json.loads(p.read_text()) if p.exists() else {"results": []}
    fresh_keys = {(e.get("kind"), e.get("source"), e.get("scenario"))
                  for e in entries}
    doc["results"] = [
        e for e in doc.get("results", [])
        if (e.get("kind"), e.get("source"), e.get("scenario"))
        not in fresh_keys] + list(entries)
    p.write_text(json.dumps(doc, indent=2))
    return p
