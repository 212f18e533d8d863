"""Process-wide metrics registry: counters, gauges, log2 latency histograms.

One registry serves the whole train->publish->serve loop; every series is
identified by ``(name, labels)`` so the same metric name carries multiple
labeled streams (``query_latency_ms{phase="queued"}`` vs ``{phase="e2e"}``)
without separate bookkeeping per call site.

Design constraints (these are the paper's hot paths — §4's 100x claim is
about *removing* per-step host work, so the meter must not add it back):

* **Lock-cheap.** Series creation takes the registry lock once; after
  that an increment/observe is one per-series ``threading.Lock`` (tens of
  ns uncontended) around a few float ops.  The overhead budget is a
  tested invariant (tests/test_torch_obs.py): counter inc and span enter/exit
  in single-digit µs, the disabled path in fractions of one.
* **Disabled path near-zero.** Every mutate checks ``registry.enabled``
  first and returns; flipping one bool de-instruments the process.
* **Exact percentiles, bounded memory.** Histograms keep fixed log2
  buckets (frexp-indexed, O(1), unbounded stream) *plus* a bounded
  reservoir ring of raw samples: ``percentile(p)`` is exact
  (``np.percentile``-identical) while the stream fits the reservoir and
  the percentile of the most recent ``reservoir`` samples after — which
  is the windowed view a latency SLO wants anyway.

Thread safety: all mutations are safe from any thread (serving's
background rebuild thread and the request loop write concurrently by
design); reads (``collect``) take per-series locks only long enough to
copy scalars.
"""
from __future__ import annotations

import math
import threading

import numpy as np

# log2 bucket geometry: bucket i >= 1 covers [2**(EMIN+i-1), 2**(EMIN+i));
# bucket 0 is the underflow (v < 2**EMIN), the last bucket the overflow.
# For millisecond-valued series this spans ~1 µs to ~17 min.
_EMIN = -10
_EMAX = 20
N_BUCKETS = _EMAX - _EMIN + 2


def bucket_le(i: int) -> float:
    """Exclusive upper bound of bucket ``i`` (inf for the overflow)."""
    return math.inf if i >= N_BUCKETS - 1 else 2.0 ** (_EMIN + i)


def _bucket_index(v: float) -> int:
    if v <= 0.0:
        return 0
    # frexp(v) = (m, e) with v = m * 2**e, m in [0.5, 1)  =>  v lands in
    # [2**(e-1), 2**e), i.e. bucket e - _EMIN
    return min(max(math.frexp(v)[1] - _EMIN, 0), N_BUCKETS - 1)


def series_key(name: str, labels: tuple) -> str:
    """Flat exported key: ``name`` or ``name{k="v",...}`` (sorted labels)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator (float — device scalars drain as floats)."""

    __slots__ = ("_reg", "_lock", "_value")

    def __init__(self, reg):
        self._reg = reg
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0):
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _collect(self):
        return self._value


class Gauge:
    """Last-write-wins scalar; ``set_fn`` makes it computed-at-collect
    (the serving lifecycle exports delta size / snapshot version /
    staleness age this way — always current, zero work on the write
    path)."""

    __slots__ = ("_reg", "_value", "_fn")

    def __init__(self, reg):
        self._reg = reg
        self._value = 0.0
        self._fn = None

    def set(self, v: float):
        if not self._reg.enabled:
            return
        self._value = float(v)      # one ref/float store: atomic under GIL

    def set_fn(self, fn):
        """Register a zero-arg callable evaluated at collect time."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._value

    def _collect(self):
        return self.value


class Histogram:
    """Fixed log2 buckets + bounded raw-sample reservoir (see module doc).

    ``observe`` is O(1): frexp bucket index, ring write, running
    sum/min/max — all under one per-series lock.
    """

    __slots__ = ("_reg", "_lock", "_counts", "_samples", "_n", "_cap",
                 "_sum", "_min", "_max")

    def __init__(self, reg, reservoir: int = 4096):
        self._reg = reg
        self._lock = threading.Lock()
        self._counts = [0] * N_BUCKETS
        self._samples: list = []
        self._n = 0
        self._cap = int(reservoir)
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float):
        if not self._reg.enabled:
            return
        v = float(v)
        i = _bucket_index(v)
        with self._lock:
            self._counts[i] += 1
            if self._n < self._cap:
                self._samples.append(v)
            else:
                self._samples[self._n % self._cap] = v
            self._n += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p):
        """Exact percentile(s) of the retained samples (all samples while
        count <= reservoir; the most recent ``reservoir`` after)."""
        with self._lock:
            if not self._samples:
                return float("nan") if np.ndim(p) == 0 else \
                    np.full(np.shape(p), np.nan)
            s = np.asarray(self._samples)
        out = np.percentile(s, p)
        return float(out) if np.ndim(out) == 0 else out

    def _collect(self):
        with self._lock:
            counts = list(self._counts)
            n, total = self._n, self._sum
            mn, mx = self._min, self._max
            s = np.asarray(self._samples) if self._samples else None
        out = {"count": n, "sum": total}
        if n:
            p50, p95, p99 = np.percentile(s, (50, 95, 99))
            out.update({"min": mn, "max": mx, "p50": float(p50),
                        "p95": float(p95), "p99": float(p99)})
        out["buckets"] = {f"{bucket_le(i):g}": c
                         for i, c in enumerate(counts) if c}
        return out

    def bucket_counts(self) -> list:
        """Raw per-bucket counts (index i bounded by ``bucket_le(i)``)."""
        with self._lock:
            return list(self._counts)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Keyed store of metric series; the process default lives in
    ``repro_torch.obs`` and everything (Trainer, prefetcher, checkpoint
    writer, fault sites) writes into it."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._series: dict = {}        # (kind, name, labels) -> series

    # -- series accessors (get-or-create, memoized) -------------------------

    def _get(self, kind: str, name: str, labels: dict, **kw):
        lab = tuple(sorted(labels.items()))
        key = (name, lab)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    s = _KINDS[kind](self, **kw)
                    self._series[key] = s
        if not isinstance(s, _KINDS[kind]):
            raise TypeError(
                f"metric {series_key(name, lab)!r} already registered as "
                f"{type(s).__name__}, requested {kind}")
        return s

    def counter(self, name: str, /, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, /, *, reservoir: int = 4096,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels, reservoir=reservoir)

    # -- lifecycle ----------------------------------------------------------

    def reset(self):
        """Drop every series (launcher entry points call this so one
        process run exports exactly its own numbers; series objects held
        by older components keep working but are no longer collected)."""
        with self._lock:
            self._series = {}

    def set_enabled(self, on: bool):
        self.enabled = bool(on)

    # -- export -------------------------------------------------------------

    def collect(self) -> dict:
        """Flat snapshot: ``{series_key: scalar | histogram dict}``."""
        with self._lock:
            items = sorted(self._series.items(), key=lambda kv: kv[0])
        return {series_key(name, lab): s._collect()
                for (name, lab), s in items}

    def series_names(self) -> list:
        with self._lock:
            return sorted({name for name, _ in self._series})
