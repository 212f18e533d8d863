"""What every configuration shares. For now ``finite_metrics``, the
non-finite routing of drained step metrics (the JAX package's
``configs/base.py:finite_metrics``); the ``Cell`` and ``Arch`` registry
comes with the launchers that take ``--arch``.
"""
from __future__ import annotations

import math
import warnings

from repro_torch import obs

_nonfinite_warned: set = set()


def finite_metrics(metrics) -> dict:
    """Host metrics -> host floats, with NaN/Inf detection routed into the
    obs layer: every non-finite scalar bumps
    ``nonfinite_metrics_total{key=...}`` and warns ONCE per key per
    process (divergence shows up in the exported registry instead of
    scrolling past in a log). Non-scalars pass through."""
    out = {}
    for k, v in metrics.items():
        if getattr(v, "ndim", 0) == 0:
            f = float(v)
            if not math.isfinite(f):
                obs.counter("nonfinite_metrics_total", key=k).inc()
                if k not in _nonfinite_warned:
                    _nonfinite_warned.add(k)
                    warnings.warn(
                        f"non-finite metric {k!r} = {f} (warning once; "
                        f"see nonfinite_metrics_total{{key=\"{k}\"}})",
                        RuntimeWarning, stacklevel=2)
            out[k] = f
        else:
            out[k] = v
    return out
