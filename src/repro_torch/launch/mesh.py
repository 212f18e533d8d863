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

RANK_TIMEOUT_S = 600.0     # a collective that waits longer fails its rank


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) mesh: ``shape`` maps each axis to its size. Inside
    a rank of ``run_on_mesh``, ``rank`` is this process's and ``group``
    the process group; ``devices`` are the ranks' devices in rank order."""
    axis_names: tuple
    shape: dict
    rank: int = 0
    devices: tuple = ()
    group: object = None
    _staging: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def world(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    @property
    def device(self) -> torch.device | None:
        return self.devices[self.rank] if self.devices else None

    def staging(self, shape, dtype) -> torch.Tensor:
        """A pinned host buffer of ``shape`` and ``dtype``, kept for the
        mesh's lifetime (``distributed/collectives.py`` stages CUDA
        tensors through it on a gloo group)."""
        key = (tuple(shape), dtype)
        buf = self._staging.get(key)
        if buf is None:
            buf = self._staging[key] = torch.empty(
                key[0], dtype=dtype, pin_memory=torch.cuda.is_available())
        return buf


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


def _rank_main(rank, n, devices, backend, init_file, threads, fn, args, out):
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
            mesh = Mesh(("data", "model"), {"data": n, "model": 1},
                        rank=rank,
                        devices=tuple(torch.device(d) for d in devices),
                        group=dist.group.WORLD)
            result = _to_host(fn(mesh, *args))
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:        # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_on_mesh(fn, n: int, devices=None, backend: str | None = None, *,
                args=(), timeout: float = 1800.0) -> list:
    """Spawn ``n`` ranks and return ``[fn(mesh, *args) for each rank]`` in
    rank order (tensors in the results come back as numpy arrays).

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
                               tuple(args), out))
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
