"""What every configuration shares: the registry's ``Cell`` and ``Arch``
(``configs.get_arch(name)``, the train launcher's ``--arch``), the
finiteness check the smokes run (``assert_finite``), and
``finite_metrics``, the non-finite routing of drained step metrics (the
JAX package's ``configs/base.py``).

A Cell packages one (arch, shape): its kind (train | prefill | decode |
serve | retrieval), ``make_fn(device=)`` returning the step function (the
JAX cell's ``make_fn(mesh)`` with no mesh), a documented ``skip``,
``meta`` (the JAX cell's ``model_flops``, and what else it carries),
``abstract_args()``, the
step's arguments at the cell's own shape as meta tensors (the JAX cell's
``abstract_args(None)``: ``meta`` is the counterpart of ``sds``,
``abstract_params`` and ``abstract_opt`` of theirs), which the dry-run
(``launch/dryrun.py``) counts without allocating, and, where the port
has a batch builder at the cell's shape, ``concrete_args(device)``,
which it measures.

On a mesh (``launch/mesh.py``) every family's cells take ``mesh=``:
``make_fn(device=, mesh=)`` gives one rank's step (the LM family's
tensor parallelism and FSDP, the recsys family's row-sharded tables,
DimeNet's edges and triplets over every axis, SpeedyFeed's pure data
parallelism), which takes the parameters and Adam state as the rank's
blocks and the batch whole, each rank cutting its own block; and
``abstract_args(mesh=)`` gives a rank's meta blocks (the JAX cells'
``args(mesh)``, through ``shard_abstract``), or with
``whole_batch=True`` its arguments as the mesh step takes them, the
batch whole, which the dry-run counts (``launch/dryrun.py --mesh``).
``mesh_skip(mesh)`` gives the reason a cell cannot run on ``mesh`` (the
LM family's ``check_tp``), or None. The JAX cells' ``activation_specs``
stay unported: the port's ``constrain`` is the identity.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import obs
from repro_torch.optim.adam import adam_init, leaves, tree_map

I32, F32, BF16 = torch.int32, torch.float32, torch.bfloat16


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    # (device="cuda") -> step fn: a step that moves its batch itself (the
    # recsys family's) moves it to device; the others run where their
    # arguments are
    make_fn: Callable
    skip: Optional[str] = None
    meta: dict = dataclasses.field(default_factory=dict)
    # (mesh=None, whole_batch=False) -> the step's arguments at the cell's
    # shape, tensors on meta (a rank's blocks on a mesh)
    abstract_args: Optional[Callable] = None
    # (device) -> real arguments at the cell's shape, drawn from seed 0 on
    # device; None where the port has no batch builder for it
    concrete_args: Optional[Callable] = None
    # (mesh) -> why the cell cannot run on that mesh, or None
    mesh_skip: Optional[Callable] = None
    # how the port's mesh step departs from the JAX cell's layout, which
    # the dry-run's mesh records carry
    mesh_departure: Optional[str] = None

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


def meta(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` with no storage (the JAX
    package's ``sds`` with no mesh)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(init_fn, dtype=None):
    """The parameters ``init_fn(generator)`` builds, as meta tensors,
    allocating nothing: the init runs under ``FakeTensorMode`` (its draws
    and fills make no storage), then each leaf becomes ``meta`` of its
    shape and dtype. ``dtype`` casts every floating leaf, as a JAX init's
    ``param_dtype`` does."""
    with FakeTensorMode():
        fake = init_fn(torch.Generator().manual_seed(0))

    def to_meta(t):
        if dtype is not None and t.is_floating_point():
            return meta(t.shape, dtype)
        return meta(t.shape, t.dtype)

    return tree_map(to_meta, fake)


def shard_abstract(tree, specs, mesh):
    """One rank's blocks of a meta tree by ``specs`` (a tree of Specs of
    its layout): each leaf a meta tensor of its block's shape (the JAX
    package's ``shard_abstract``, whose arrays carry their sharding; a
    rank of the port holds its block; a ``Blocks`` entry gives this
    rank's own block, whose length may differ between ranks). ``mesh``
    None: the tree as it is."""
    if mesh is None:
        return tree
    from repro_torch.distributed.sharding import block_shape, tree_map
    return tree_map(lambda spec, leaf: meta(
        block_shape(tuple(leaf.shape), spec, mesh), leaf.dtype), specs, tree)


def abstract_opt(params):
    """``optim.adam_init`` of meta ``params``: meta moments and count."""
    return adam_init(params)


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
