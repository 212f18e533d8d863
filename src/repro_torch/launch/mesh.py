"""Data meshes on torch.distributed, and the launcher's ``--mesh`` flag.

The JAX package runs one controller over a ``Mesh`` of devices. PyTorch
runs one process per rank: ``run_on_mesh(fn, n, devices)`` spawns ``n``
ranks, each on its own device of ``devices``, joins them in one process
group and calls ``fn(mesh, *args)`` in each with that rank's ``Mesh``.
The ranks meet through a file (``init_method="file://..."``) in a fresh
temporary directory, never a fixed TCP port, so runs side by side cannot
collide.

The backend follows the devices the caller gives (``backend_for``): NCCL
when every rank has a card of its own, gloo when ranks share a card or
run on the CPU. Repeats are allowed in ``devices``: ``["cuda:0"] * 4``
puts four ranks on one card (over gloo), ``["cpu"] * 4`` four on the
CPU, the counterpart of the JAX package's forced host devices.

``run_on_mesh(..., model=M)`` lays the ranks out as a (data, model) mesh
in row-major order, as the JAX package's ``make_mesh_for(n, model=M)``
lays out its devices: rank ``r`` sits at data ``r // M``, model ``r % M``.
Each rank gets a process group per axis (``Mesh.groups``): its ``data``
group (the ranks that share its model coordinate) and its ``model`` group
(the ranks that share its data coordinate), which the collectives of
``distributed/collectives.py`` take by name; and, for every divisor R of
M between 1 and M, its group of R consecutive model ranks
(``SubAxis("model", R)``: the ranks that share a replicated KV head of
the LM family's head plan). ``submesh`` cuts a mesh's ranks into smaller
meshes of another shape, a (pod, data, model) one too, whose ranks also
get a ``pod`` group and, where pod and data both exceed 1, one over the
two data axes together, ``("pod", "data")`` (the tests run a (1, 2) and
a (2, 2) mesh in one group of 4 ranks, and a (1, 4) and a (2, 1, 2)
one).

``make_mesh_for`` and ``make_production_mesh`` give meshes of shapes
only (rank 0, no process group), which the sharding rules read.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.device import check_device
from repro_torch.distributed.sharding import SubAxis

RANK_TIMEOUT_S = 600.0     # a collective that waits longer fails its rank
RANKS_PER_NODE = 8         # cards a node (DGX H100, H100 SXM)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) mesh: ``shape`` maps each axis to its size. Inside
    a rank of ``run_on_mesh``, ``rank`` is this process's place in the
    mesh (row-major over ``axis_names``) and ``group`` the process group
    of the whole mesh; ``groups`` maps an axis to this rank's group along
    it (absent where the axis has size 1, or the mesh is the world's one
    data axis, whose group is ``group``); ``devices`` are the mesh's
    ranks' devices in mesh order."""
    axis_names: tuple
    shape: dict
    rank: int = 0
    devices: tuple = ()
    group: object = None
    groups: dict = dataclasses.field(default_factory=dict, repr=False)
    _staging: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def world(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    def size(self, axis=None) -> int:
        """The ranks along ``axis`` (the whole mesh for None; 1 for an
        axis the mesh lacks); a tuple of axes (``("pod", "data")``, the
        data axes) counts the ranks of their product; a ``SubAxis`` its
        group's."""
        if axis is None:
            return self.world
        if isinstance(axis, SubAxis):
            return min(axis.size, self.size(axis.axis))
        if isinstance(axis, tuple):
            return int(np.prod([self.size(a) for a in axis]))
        return int(self.shape.get(axis, 1))

    def index(self, axis=None) -> int:
        """This rank's coordinate along ``axis`` (its rank for None; for a
        tuple of axes, row-major over them in the tuple's order, as
        ``sharding.shard_block`` numbers the blocks of a dim they cut)."""
        if axis is None:
            return self.rank
        if isinstance(axis, SubAxis):
            return self.index(axis.axis) % self.size(axis)
        if isinstance(axis, tuple):
            i = 0
            for a in axis:
                i = i * self.size(a) + self.index(a)
            return i
        r = self.rank
        for a in reversed(self.axis_names):
            if a == axis:
                return r % self.shape[a]
            r //= self.shape[a]
        return 0

    def group_of(self, axis=None):
        """The process group along ``axis`` (the mesh's for None, or for
        the only axis of size above 1); for a tuple of axes, that of its
        one axis of size above 1, the mesh's where they span it, or the
        group a (pod, data, model) mesh makes over ``("pod", "data")``
        (any other tuple raises); for a ``SubAxis``, this rank's group of
        it (the axis's where the group is the whole axis)."""
        if axis is None:
            return self.group
        if isinstance(axis, SubAxis) and self.size(axis) == self.size(
                axis.axis):
            return self.group_of(axis.axis)
        if isinstance(axis, tuple):
            big = tuple(a for a in axis if self.size(a) > 1)
            if len(big) <= 1:
                return self.group_of(big[0]) if big else None
            if self.size(big) == self.world:
                return self.group
            if big in self.groups:
                return self.groups[big]
            raise ValueError(f"no process group of this mesh spans the "
                             f"axes {big}")
        g = self.groups.get(axis)
        if g is None and self.size(axis) == self.world:
            return self.group
        return g

    def in_one_node(self, axis=None, per_node: int = RANKS_PER_NODE) -> bool:
        """Whether the group of ``axis`` through this rank lies in one
        node of ``per_node`` cards, the ranks numbered row-major over the
        axes and the nodes holding consecutive ranks (DGX H100: 8 cards
        a node, joined by NVLink; nodes by InfiniBand)."""
        if isinstance(axis, SubAxis):
            stride = int(np.prod([self.shape[a] for a in self.axis_names[
                self.axis_names.index(axis.axis) + 1:]]))
            lo = self.rank - self.index(axis) * stride
            hi = lo + (self.size(axis) - 1) * stride
            return lo // per_node == hi // per_node
        axes = tuple(self.axis_names) if axis is None else (
            axis if isinstance(axis, tuple) else (axis,))
        stride, lo, hi = 1, self.rank, self.rank
        for a in reversed(self.axis_names):
            n = int(self.shape[a])
            if a in axes:
                i = (self.rank // stride) % n
                lo -= i * stride
                hi += (n - 1 - i) * stride
            stride *= n
        return lo // per_node == hi // per_node

    @property
    def name(self) -> str:
        """The shape by axis: ``"16x16"``, ``"2x16x16"``."""
        return "x".join(str(self.shape[a]) for a in self.axis_names)

    @property
    def device(self) -> torch.device | None:
        return self.devices[self.rank] if self.devices else None

    def staging(self, shape, dtype) -> torch.Tensor:
        """A pinned host buffer of ``shape`` and ``dtype`` (a view of one
        buffer a dtype, kept for the mesh's lifetime and grown to the
        largest request: ``distributed/collectives.py`` stages CUDA
        tensors through it on a gloo group, one collective at a time, so
        the pinned bytes stay those of the largest tensor staged, whatever
        the count of shapes)."""
        n = int(np.prod(shape))
        buf = self._staging.get(dtype)
        if buf is None or buf.numel() < n:
            self._staging.pop(dtype, None)
            buf = self._staging[dtype] = torch.empty(
                n, dtype=dtype, pin_memory=torch.cuda.is_available())
        return buf[:n].view(tuple(shape))


def make_mesh_for(n: int, *, model: int = 1, devices=()) -> Mesh:
    """A (data, model) mesh of ``n`` ranks, shapes only."""
    if n % model:
        raise ValueError(f"{n} ranks do not divide into model={model}")
    return Mesh(("data", "model"), {"data": n // model, "model": model},
                devices=tuple(torch.device(d) for d in devices))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production shapes: 16 x 16 (data, model), or 2 x
    16 x 16 (pod, data, model). Shapes only."""
    if multi_pod:
        return Mesh(("pod", "data", "model"),
                    {"pod": 2, "data": 16, "model": 16})
    return Mesh(("data", "model"), {"data": 16, "model": 16})


def parse_mesh_arg(spec: str | None, device="cuda") -> Mesh | None:
    """``--mesh data=N`` -> a mesh of N ranks on ``device``'s type (None
    for no flag or N == 1: the one-process path, unchanged).

    On CUDA each rank needs a card of its own (``cuda:0`` .. ``cuda:N-1``),
    so more ranks than cards exit; on the CPU any N runs N gloo processes.
    """
    if spec is None:
        return None
    try:
        axis, n = spec.split("=")
        n = int(n)
    except ValueError:
        raise SystemExit(f"--mesh expects AXIS=N (e.g. data=8), got {spec!r}")
    if axis != "data":
        raise SystemExit(f"--mesh supports only the data axis, got {axis!r}")
    if n <= 1:
        return None
    kind = torch.device(device).type
    if kind == "cpu":
        return make_mesh_for(n, devices=["cpu"] * n)
    have = torch.cuda.device_count()
    if have < n:
        raise SystemExit(
            f"--mesh data={n} but only {have} CUDA device(s) visible; "
            f"pass --device cpu to run {n} gloo processes on the CPU")
    return make_mesh_for(n, devices=[f"cuda:{i}" for i in range(n)])


def backend_for(devices) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    devices = [torch.device(d) for d in devices]
    cards = [d for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len({d.index for d in cards}) == \
            len(cards) and None not in {d.index for d in cards}:
        return "nccl"
    return "gloo"


def _to_host(obj):
    """A rank's result made safe to send: tensors as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


AXES_BY_RANK = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _axis_groups(shape: tuple, base: int = 0) -> list:
    """For a (data, model) or (pod, data, model) mesh of ``shape`` over
    ranks ``base`` .. ``base + prod(shape) - 1`` (row-major), every group
    of each axis as (axis, ranks), the minor axis first: the model groups
    (one a data row), then the data groups (one a model column), then the
    pod groups; then, with pod and data both above 1, the groups over
    both, keyed ``("pod", "data")``; then for every divisor R of M
    between 1 and M, the groups of R consecutive model ranks, keyed
    ``SubAxis("model", R)``."""
    names = AXES_BY_RANK[len(shape)]
    strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]

    def groups_along(axes):
        along = [names.index(a) for a in axes]
        others = [i for i in range(len(shape)) if i not in along]
        out = []
        for fixed in np.ndindex(*[shape[i] for i in others]):
            start = base + sum(c * strides[i] for c, i in zip(fixed, others))
            out.append([start + sum(c * strides[i] for c, i in zip(c_, along))
                        for c_ in np.ndindex(*[shape[i] for i in along])])
        return out

    out = [(a, g) for a in reversed(names) for g in groups_along((a,))]
    if len(shape) == 3 and shape[0] > 1 and shape[1] > 1:
        out += [(("pod", "data"), g) for g in groups_along(("pod", "data"))]
    M = shape[-1]
    for R in range(2, M):
        if M % R == 0:
            out += [(SubAxis("model", R), g[i:i + R])
                    for g in groups_along(("model",))
                    for i in range(0, M, R)]
    return out


def _new_groups(rank: int, specs: list) -> dict:
    """``dist.new_group`` for every (axis, ranks) of ``specs``, in order
    (each rank of the world must make every group, its own or not);
    returns {axis: group} of the groups that hold ``rank``."""
    import torch.distributed as dist
    mine = {}
    for axis, ranks in specs:
        g = dist.new_group(ranks)
        if rank in ranks:
            mine[axis] = g
    return mine


def submesh(mesh: Mesh, *, data: int, model: int, pod: int = 1) -> Mesh:
    """This rank's (data, model) mesh, or (pod, data, model) one where
    ``pod`` > 1, when ``mesh``'s ranks are cut into meshes of that shape,
    each of consecutive ranks. Collective: every rank of ``mesh`` calls it
    with the same shape, in the same order (it makes process groups)."""
    shape = (pod, data, model) if pod > 1 else (data, model)
    n = int(np.prod(shape))
    if mesh.world % n:
        raise ValueError(f"{mesh.world} ranks do not cut into meshes of "
                         f"{dict(zip(AXES_BY_RANK[len(shape)], shape))}")
    specs = []
    for b in range(0, mesh.world, n):
        specs += [("world", list(range(b, b + n)))] + _axis_groups(shape, b)
    groups = _new_groups(mesh.rank, specs)
    base = mesh.rank - mesh.rank % n
    names = AXES_BY_RANK[len(shape)]
    return Mesh(names, dict(zip(names, shape)), rank=mesh.rank - base,
                devices=tuple(mesh.devices[base:base + n]),
                group=groups.pop("world"), groups=groups)


def _rank_main(rank, n, devices, backend, init_file, threads, fn, args, out,
               model=1):
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            groups = (_new_groups(rank, _axis_groups((n // model, model)))
                      if model > 1 else {})
            mesh = Mesh(("data", "model"),
                        {"data": n // model, "model": model}, rank=rank,
                        devices=tuple(torch.device(d) for d in devices),
                        group=dist.group.WORLD, groups=groups)
            result = _to_host(fn(mesh, *args))
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:        # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_on_mesh(fn, n: int, devices=None, backend: str | None = None, *,
                args=(), timeout: float = 1800.0, model: int = 1) -> list:
    """Spawn ``n`` ranks and return ``[fn(mesh, *args) for each rank]`` in
    rank order (tensors in the results come back as numpy arrays).

    ``model`` lays the ranks out as (n // model, model), row-major, with a
    group per axis (``Mesh.groups``); the default is one data axis.
    ``devices`` (one a rank, repeats allowed) default to ``cuda:0`` ..
    ``cuda:n-1`` and raise without a GPU; pass ``["cpu"] * n`` for the
    CPU. ``backend`` defaults to ``backend_for(devices)``; NCCL with
    ranks that share a device raises. ``fn`` and ``args`` go to the
    ranks by pickle (``fn`` by its import path). A rank that raises, dies
    or outlives ``timeout`` fails the call: the other ranks are stopped
    and ``RuntimeError`` names each rank's error.
    """
    devices = [check_device(d) for d in (
        devices if devices is not None else [f"cuda:{i}" for i in range(n)])]
    if len(devices) != n:
        raise ValueError(f"{n} ranks need {n} devices, got {len(devices)}")
    if n % model:
        raise ValueError(f"{n} ranks do not divide into model={model}")
    backend = backend or backend_for(devices)
    if backend == "nccl" and backend_for(devices) != "nccl":
        raise ValueError(f"NCCL needs a card of its own for each rank, got "
                         f"{[str(d) for d in devices]}; use gloo")
    # CPU ranks share the cores rather than each taking all of them
    threads = max(1, (os.cpu_count() or 1) // n) \
        if all(d.type == "cpu" for d in devices) else 0
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="mesh_")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, [str(d) for d in devices], backend,
                               os.path.join(tmp, "rendezvous"), threads, fn,
                               tuple(args), out, model))
             for r in range(n)]
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < n:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                for r in dead:
                    errors[r] = f"rank {r} exited with {procs[r].exitcode}"
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"mesh of {n} timed out after {timeout} s; results "
                        f"from ranks {sorted(results)}")
                continue
            (results if ok else errors)[rank] = value
            if errors:
                break
    finally:
        for p in procs:
            p.join(timeout=5.0 if not errors else 0.5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("mesh rank failed:\n" + "\n".join(
            f"--- rank {r} ---\n{e}" for r, e in sorted(errors.items())))
    return [results[r] for r in range(n)]
