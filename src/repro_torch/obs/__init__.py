"""Unified telemetry for the train->publish->serve loop.

SpeedyFeed's speedup story rests on mechanisms that are invisible
without measurement: embedding-cache reuse (§4.1.2), eliminated
non-informative encoding, pipeline overlap.  This package is the one
place they all report to — a process-wide ``MetricsRegistry`` of
counters / gauges / log2 latency histograms, a ``span`` context manager
for wall-time sections (forwarding to ``torch.profiler.record_function``
inside a profiler trace), and exporters (JSONL snapshots, Prometheus
text, periodic in-loop Reporter).  The series names, the JSONL lines and
the Prometheus text are those of the JAX package's ``obs`` for the same
calls, so one dashboard reads either package's run.

Everything instrumented writes to the module-default registry via the
helpers below:

    obs.counter("ckpt_corrupt_total").inc()
    obs.gauge("prefetch_queue_depth").set(q.qsize())
    obs.histogram("train_step_ms", bucket="16").observe(ms)
    with obs.span("prefetch_h2d"): ...
    obs.write_jsonl("metrics.jsonl")

Launcher entry points call ``obs.reset()`` on startup so one run's
export is exactly that run, and ``obs.set_enabled(False)`` flips the
whole layer to its near-zero-cost disabled path.

The metric-name catalog (units, labels, who writes what) is the JAX
package's ``docs/observability.md``; the port writes the training,
checkpoint, fault-injection, index-lifecycle, health and request-loop
series listed there.
"""
from __future__ import annotations

from ._default import registry as default_registry
from .export import Reporter, prometheus_text, write_jsonl
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       bucket_le, series_key)
from .span import set_trace_annotations, span

_reporter: Reporter | None = None


def counter(name: str, /, **labels) -> Counter:
    return default_registry().counter(name, **labels)


def gauge(name: str, /, **labels) -> Gauge:
    return default_registry().gauge(name, **labels)


def histogram(name: str, /, **labels) -> Histogram:
    return default_registry().histogram(name, **labels)


def collect() -> dict:
    return default_registry().collect()


def reset():
    """Drop all series in the default registry (and the reporter)."""
    global _reporter
    _reporter = None
    default_registry().reset()


def set_enabled(on: bool):
    default_registry().set_enabled(on)


def enabled() -> bool:
    return default_registry().enabled


def configure_reporter(*, path: str | None = None, every_s: float = 10.0,
                       printer=None) -> Reporter:
    """Install the process reporter that ``tick()`` drives (hot loops call
    ``obs.tick()``; it no-ops when nothing is configured)."""
    global _reporter
    _reporter = Reporter(path=path, every_s=every_s, printer=printer)
    return _reporter


def tick(force: bool = False) -> bool:
    """Drive the configured periodic reporter from any loop."""
    if _reporter is None:
        return False
    return _reporter.tick(force)
