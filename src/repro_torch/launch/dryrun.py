"""Dry-run of the registry's cells on NVIDIA H100s: count every (arch x
shape) cell's step on meta tensors, allocating nothing, and turn the
counts into roofline terms, on one card or one rank of a production
mesh; with ``--measure``, also run on the card each cell that fits one
card and has a batch builder in the port, and set its time beside its
floor.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell on
a production mesh with ShapeDtypeStruct stand-ins and reads XLA's
memory and cost analyses. The port counts the step itself: the cell's
``abstract_args()`` (meta tensors at the cell's own shape) go through its
``make_fn`` under ``op_analysis.OpCounter``, and ``roofline.from_count``
gives the terms.

``--mesh single|multi|both`` counts rank 0 of the JAX package's
production meshes, 16 x 16 (data, model) and 2 x 16 x 16 (pod, data,
model) (``launch/mesh.make_production_mesh``: shapes, no process
group): ``cell.abstract_args(mesh=, whole_batch=True)`` (the rank's
parameter and state blocks, the batch whole as the mesh step takes it)
through ``cell.make_fn(device="meta", mesh=)``. Each collective records
its wire bytes (``distributed/collectives.py``), which give the
collective term; ``fits_one_card`` reads the rank's peak. A cell that
cannot run on the mesh (``Cell.mesh_skip``: the LM family's
``check_tp``) is recorded as a skip with the reason. With no ``--mesh``
the dry-run counts one card. A mesh record is never measured.

Rank 0 stands for every rank. Where the LM family's head plan cuts the
query heads unevenly (Qwen3-14B and Scout at model=16: 3, 2, 3, 2, ...
heads), lower model ranks take the larger share, so rank 0 holds the
most heads and its step is the slowest: the count is the mesh's step.

Usage (the counting needs no GPU):

    python -m repro_torch.launch.dryrun --all --out build/dryrun.jsonl
    python -m repro_torch.launch.dryrun --arch dlrm-rm2 --shape serve_p99
    python -m repro_torch.launch.dryrun --all --mesh both \
        --out build/dryrun_mesh.jsonl
    python -m repro_torch.launch.dryrun --all --measure   # on the card

A measured cell takes one warm-up and MEASURE_ITERS synchronised calls on
arguments drawn from seed 0 (``Cell.concrete_args``), counted and timed
under the same ``torch.backends.cuda.matmul.allow_tf32`` setting.
Its record adds ``measured_s`` (their median), ``achieved`` (the floor
``step_time_lb`` over it), ``mfu`` (model FLOPs over ``peak_flops`` x
``measured_s``) and the card's ``max_memory_allocated``. Measuring needs
a card unless ``device="cpu"`` is passed, as the tests do.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import resource
import statistics
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.device import check_device

from . import op_analysis
from . import roofline as rl
from .mesh import make_production_mesh

MEASURE_ITERS = 3
# --mesh: which production meshes (multi_pod flags)
MESH_SEL = {"single": (False,), "multi": (True,), "both": (False, True)}


def count_cell(cell, mesh=None) -> dict:
    """``op_analysis.OpCounter.result()`` of one step of ``cell`` on its
    ``abstract_args()``; with ``mesh``, of rank 0's step on its arguments
    (``abstract_args(mesh=, whole_batch=True)``)."""
    if mesh is None:
        args, step = cell.abstract_args(), cell.make_fn(device="meta")
    else:
        args = cell.abstract_args(mesh=mesh, whole_batch=True)
        step = cell.make_fn(device="meta", mesh=mesh)
    with op_analysis.OpCounter(args) as counter:
        step(*args)
    return counter.result()


def measures(cell, rec: dict) -> bool:
    """Whether ``--measure`` runs ``cell`` (counted as ``rec``): it fits one
    card and the port has a batch builder at its shape."""
    return rec["fits_one_card"] and cell.concrete_args is not None


def measure_cell(cell, rec: dict, *, device="cuda") -> dict:
    """Run ``cell``'s step on ``device`` at its own shape: one warm-up and
    MEASURE_ITERS synchronised calls on ``cell.concrete_args(device)``;
    its time beside the floor of ``rec`` (``run_cell``'s count of it,
    under the same TF32 setting)."""
    device = check_device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        sync()
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    args = cell.concrete_args(device)
    sync()
    build_s = time.perf_counter() - t0
    step = cell.make_fn(device=device)
    step(*args)
    sync()
    times = []
    for _ in range(MEASURE_ITERS):
        t0 = time.perf_counter()
        step(*args)
        sync()
        times.append(time.perf_counter() - t0)
    measured = statistics.median(times)
    out = {"measured_s": measured, "measured_s_each": times,
           "args_build_s": build_s,
           "achieved": rec["step_time_lb"] / measured,
           "mfu": rec["model_flops"] / (rec["peak_flops"] * measured),
           "measured_on": (torch.cuda.get_device_name(device) if cuda
                           else "cpu")}
    if cuda:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        out["allocated_before"] = before
    del args, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def run_cell(cell, *, mesh=None, measure: bool = False, device="cuda",
             verbose: bool = True) -> dict:
    """The cell's record: the roofline's ``to_dict()`` plus ``status``,
    ``kind``, ``t_count_s``, ``flops_by_dtype``, ``f32_rate``,
    ``peak_flops``, ``fits_one_card``, ``quad_bytes`` and the op-class
    ``breakdown``; with ``measure``, a cell that fits and has
    ``concrete_args`` is also measured (``measure_cell``). With ``mesh``
    (``launch/mesh.py``, shapes only), the count is rank 0's on it, its
    terms a rank's (the collective term from the wire bytes), and the
    cell's ``mesh_departure`` note is carried; it is never measured."""
    f32_rate = rl.current_f32_rate()
    t0 = time.time()
    count = count_cell(cell, mesh)
    r = rl.from_count(cell, count, f32_rate, mesh=mesh)
    rec = r.to_dict()
    if mesh is not None and cell.mesh_departure:
        rec["departure"] = cell.mesh_departure
    rec.update({"status": "ok", "kind": cell.kind,
                "t_count_s": time.time() - t0,
                "flops_by_dtype": count["flops_by_dtype"],
                "f32_rate": f32_rate, "peak_flops": r.peak_flops,
                "fits_one_card": r.fits_one_card,
                "quad_bytes": count["quad_bytes"],
                "args_bytes": count["args_bytes"],
                "breakdown": count["breakdown"]})
    if verbose:
        by_dtype = {k: f"{v:.3e}" for k, v in count["flops_by_dtype"].items()}
        print(f"  count: flops {r.flops_per_chip:.4e} {by_dtype} "
              f"bytes {r.bytes_per_chip:.4e} peak "
              f"{r.peak_memory_per_chip / 1e9:.2f} GB "
              f"(fits one card: {r.fits_one_card})")
        print(f"  roofline: compute={r.t_compute * 1e3:.3f}ms "
              f"memory={r.t_memory * 1e3:.3f}ms "
              f"collective={r.t_collective * 1e3:.3f}ms -> "
              f"{r.bottleneck}-bound; "
              f"useful-flops {r.useful_flops_fraction:.2%}; "
              f"mfu ub {r.mfu_upper_bound:.2%}", flush=True)
    if measure and mesh is None and measures(cell, rec):
        rec.update(measure_cell(cell, rec, device=device))
        if verbose:
            print(f"  measured: {rec['measured_s'] * 1e3:.3f} ms "
                  f"(floor {r.step_time_lb * 1e3:.3f} ms); achieved "
                  f"{rec['achieved']:.2%}; mfu {rec['mfu']:.2%}", flush=True)
    return rec


def run(arch_names, shape_filter=None, out_path=None, *,
        stop_on_error: bool = False, measure: bool = False,
        mesh_sel: str | None = None):
    """Count (and measure, on the card) every cell of ``arch_names``
    (those of ``shape_filter`` only, when given), on one card or, with
    ``mesh_sel`` ("single", "multi", "both"), on rank 0 of each
    production mesh it names; a cell with a ``skip``, or a ``mesh_skip``
    reason on the mesh, is recorded as skipped, never counted. When
    ``out_path`` is given it is emptied first, then each record is
    appended to it as a JSON line as soon as it is made."""
    if out_path:
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        open(out_path, "w").close()
    meshes = [None] if mesh_sel is None else [
        make_production_mesh(multi_pod=m) for m in MESH_SEL[mesh_sel]]
    records = []
    for name in arch_names:
        arch = configs.get_arch(name)
        for shape, cell in arch.cells.items():
            if shape_filter and shape != shape_filter:
                continue
            for mesh in meshes:
                rec = _record(name, shape, cell, mesh, measure=measure,
                              stop_on_error=stop_on_error)
                records.append(rec)
                if out_path:
                    with open(out_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return records


def _record(name, shape, cell, mesh, *, measure, stop_on_error) -> dict:
    """One cell's record on one card (``mesh`` None) or a mesh."""
    mesh_name = rl.MESH if mesh is None else mesh.name
    tag = f"{name}/{shape}@{mesh_name}"
    reason = cell.skip or (cell.mesh_skip(mesh) if mesh is not None
                           and cell.mesh_skip is not None else None)
    if reason:
        print(f"SKIP {tag}: {reason}")
        return {"arch": name, "shape": shape, "mesh": mesh_name,
                "status": "skip", "reason": reason}
    print(f"DRYRUN {tag} ...", flush=True)
    t0 = time.time()
    try:
        rec = run_cell(cell, mesh=mesh, measure=measure)
        print(f"OK   {tag} ({time.time() - t0:.1f}s)", flush=True)
        return rec
    except Exception as e:
        print(f"FAIL {tag}: {type(e).__name__}: {e}")
        traceback.print_exc()
        if stop_on_error:
            raise
        return {"arch": name, "shape": shape, "mesh": mesh_name,
                "status": "fail", "error": f"{type(e).__name__}: {e}"}


def max_rss_gb() -> float:
    """This process's peak resident memory (``ru_maxrss``, KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--assigned", action="store_true",
                    help="the 10 assigned archs only")
    ap.add_argument("--out", default=None)
    ap.add_argument("--stop-on-error", action="store_true")
    ap.add_argument("--measure", action="store_true",
                    help="also run, on the card, each cell that fits it and "
                         "has a batch builder (one card only)")
    ap.add_argument("--mesh", choices=sorted(MESH_SEL), default=None,
                    help="count rank 0 of the 16x16 (single), 2x16x16 "
                         "(multi) or both production meshes instead of one "
                         "card")
    args = ap.parse_args(argv)
    if args.measure and args.mesh:
        ap.error("--measure runs one card; a mesh record is never measured")
    if args.all:
        names = configs.list_archs()
    elif args.assigned:
        names = configs.ASSIGNED
    elif args.arch:
        names = [a.strip() for a in args.arch.split(",")]
    else:
        ap.error("need --arch, --assigned or --all")
    t0 = time.time()
    recs = run(names, args.shape, args.out, stop_on_error=args.stop_on_error,
               measure=args.measure, mesh_sel=args.mesh)
    ok = sum(1 for r in recs if r.get("status") == "ok")
    fail = sum(1 for r in recs if r.get("status") == "fail")
    skip = sum(1 for r in recs if r.get("status") == "skip")
    print(f"\n=== dry-run summary: {ok} ok, {fail} fail, {skip} skip; "
          f"{time.time() - t0:.1f} s; ru_maxrss {max_rss_gb():.3f} GB ===")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
