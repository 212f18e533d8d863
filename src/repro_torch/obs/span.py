"""Nestable wall-time spans -> ``span_ms{name=...}`` histograms.

``span("ckpt_save", mode="sync")`` times its body into the default
registry's ``span_ms`` histogram under the given name/labels.  Spans
nest freely (each ``with`` creates an independent timing — no implicit
parent/child naming) and are reentrant across threads: the prefetch
thread and the step loop time concurrently into their own series
without interference (per-series locks).

While a ``torch.profiler`` trace is being captured, spans additionally
forward to ``torch.profiler.record_function`` so the same names show up
on the host timeline of the trace next to the CUDA kernel lanes.  The
forwarding is auto-detected per span entry (one call into the autograd
profiler's state) and can be forced on/off with
``set_trace_annotations``.
"""
from __future__ import annotations

import time

import torch

from . import _default

# tri-state: None = auto (forward only while a profiler session is
# active), True/False = forced
_trace_mode = None


def set_trace_annotations(mode):
    """``True``/``False`` force ``record_function`` forwarding; ``None``
    restores auto-detection."""
    global _trace_mode
    _trace_mode = mode


def _profiling_active() -> bool:
    if _trace_mode is not None:
        return _trace_mode
    return torch.autograd._profiler_enabled()


class span:
    """Context manager timing its body into ``span_ms{name=..., labels}``.

    One instance per ``with`` statement (the normal idiom); a kept
    instance may be re-entered sequentially but not concurrently with
    itself — create per use for concurrent timing.
    """

    __slots__ = ("_hist", "_name", "_t0", "_rf")

    def __init__(self, name: str, *, registry=None, **labels):
        reg = registry if registry is not None else _default.registry()
        self._name = name
        self._hist = reg.histogram("span_ms", name=name, **labels) \
            if reg.enabled else None
        self._rf = None

    def __enter__(self):
        if self._hist is None:
            return self
        if _profiling_active():
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._hist is not None:
            self._hist.observe((time.perf_counter() - self._t0) * 1e3)
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None
        return False
