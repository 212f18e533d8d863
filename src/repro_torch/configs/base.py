"""What every configuration shares: the registry's ``Cell`` and ``Arch``
(``configs.get_arch(name)``, the train launcher's ``--arch``), the
finiteness check the smokes run (``assert_finite``), and
``finite_metrics``, the non-finite routing of drained step metrics (the
JAX package's ``configs/base.py``).

A Cell packages one (arch, shape): its kind (train | prefill | decode |
serve | retrieval), ``make_fn()`` returning the step function (the JAX
cell's with no mesh), a documented ``skip`` and ``meta`` (the JAX cell's
``model_flops``, and what else it carries). The XLA dry-run and mesh
machinery of the JAX cells (``abstract_args``, ``activation_specs``,
``sds``, ``shard_abstract``) has no counterpart yet.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional

import torch

from repro_torch import obs
from repro_torch.optim.adam import leaves


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    make_fn: Callable          # (**device options) -> step fn
    skip: Optional[str] = None
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.arch}/{self.shape}"


@dataclasses.dataclass
class Arch:
    name: str
    family: str
    config: object
    cells: dict
    smoke: Callable            # (device="cuda") -> metrics dict (reduced)
    notes: str = ""


def assert_finite(tree, what=""):
    """Raise if any floating leaf of ``tree`` (tensors, numbers, nested
    dicts, lists and tuples) holds a NaN or an Inf."""
    for _, leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                raise AssertionError(f"non-finite values in {what}")
        elif isinstance(leaf, float) and not math.isfinite(leaf):
            raise AssertionError(f"non-finite values in {what}")


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
