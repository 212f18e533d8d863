"""The process-default MetricsRegistry (split out so span/export and
``obs.__init__`` can share it without an import cycle)."""
from __future__ import annotations

from .registry import MetricsRegistry

_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY
