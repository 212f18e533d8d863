"""Exporters: JSONL snapshot writer, Prometheus text dump, periodic
in-loop Reporter.

JSONL is the machine surface (smokes assert required keys on the last
line; the lines and the Prometheus text are the JAX package's for the
same calls); the Prometheus dump is the scrape surface; the Reporter is
the in-loop drip — call ``tick()`` from any hot loop and it
writes/prints at its own wall-clock cadence, costing one perf_counter
compare per call otherwise.
"""
from __future__ import annotations

import json
import math
import re
import time

from . import _default
from .registry import bucket_le

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def write_jsonl(path: str, *, registry=None, extra: dict | None = None):
    """Append one snapshot line: ``{"ts": ..., "metrics": {...}}``.
    ``extra`` keys (e.g. a run tag) merge into the top-level object."""
    reg = registry if registry is not None else _default.registry()
    rec = {"ts": time.time()}
    if extra:
        rec.update(extra)
    rec["metrics"] = reg.collect()
    with open(path, "a") as f:
        json.dump(rec, f)
        f.write("\n")
    return rec


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: tuple, extra: str = "") -> str:
    parts = [f'{_prom_name(k)}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry=None) -> str:
    """Prometheus exposition-format dump of every series."""
    from .registry import Counter, Gauge, Histogram
    reg = registry if registry is not None else _default.registry()
    with reg._lock:
        items = sorted(reg._series.items(), key=lambda kv: kv[0])
    typed: dict = {}
    for (name, lab), s in items:
        typed.setdefault(name, []).append((lab, s))
    lines = []
    for name, series in typed.items():
        pname = _prom_name(name)
        kind = ("counter" if isinstance(series[0][1], Counter) else
                "gauge" if isinstance(series[0][1], Gauge) else "histogram")
        lines.append(f"# TYPE {pname} {kind}")
        for lab, s in series:
            if kind in ("counter", "gauge"):
                v = s._collect()
                if isinstance(v, float) and math.isnan(v):
                    v = "NaN"
                lines.append(f"{pname}{_prom_labels(lab)} {v}")
                continue
            counts = s.bucket_counts()
            cum = 0
            for i, c in enumerate(counts):
                cum += c
                if c == 0 and i < len(counts) - 1:
                    continue
                le = bucket_le(i)
                le_s = "+Inf" if math.isinf(le) else f"{le:g}"
                le_lab = 'le="%s"' % le_s
                lines.append(f"{pname}_bucket"
                             f"{_prom_labels(lab, le_lab)} {cum}")
            lines.append(f"{pname}_sum{_prom_labels(lab)} {s.sum:g}")
            lines.append(f"{pname}_count{_prom_labels(lab)} {s.count}")
    return "\n".join(lines) + "\n"


class Reporter:
    """Periodic in-loop exporter: ``tick()`` from a hot loop; it writes a
    JSONL snapshot (and/or prints a one-liner) once per ``every_s`` of
    wall time and is a single float compare otherwise."""

    def __init__(self, *, path: str | None = None, every_s: float = 10.0,
                 printer=None, registry=None):
        self.path = path
        self.every_s = float(every_s)
        self.printer = printer
        self._reg = registry
        self._last = time.perf_counter()

    def tick(self, force: bool = False) -> bool:
        now = time.perf_counter()
        if not force and now - self._last < self.every_s:
            return False
        self._last = now
        self.write()
        return True

    def write(self, extra: dict | None = None):
        reg = self._reg if self._reg is not None else _default.registry()
        if self.path:
            write_jsonl(self.path, registry=reg, extra=extra)
        if self.printer is not None:
            snap = reg.collect()
            self.printer(", ".join(
                f"{k}={v if not isinstance(v, dict) else v.get('p50')}"
                for k, v in list(snap.items())[:8]))
