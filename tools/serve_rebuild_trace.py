#!/usr/bin/env python3
"""Where a served request's time goes while a full index rebuild runs.

    python3 tools/serve_rebuild_trace.py [--qps 4000] [--duration 1.0] \
        [--news 16384] [--out chiprun_out/serve_rebuild_trace.json]

Makes the slice ``chip_smoke.py`` serves (the production PLM with seeded
random weights over a ``make_loader`` corpus of ``--news`` news, IVF-PQ
with nprobe 16 and k' 64, a corpus-sized delta cap), puts the request
scheduler in front of it (batches of 16, 2 ms flush, 50 ms SLO), warms
every bucket and one publish -> full rebuild cycle, as the launcher's
open-loop harness does, then fires one seeded Poisson trace at ``--qps``
for ``--duration`` seconds in each of four windows:

* ``quiescent``: nothing else runs;
* ``delta_pending``: 32 fresh news wait in the delta tier, no rebuild
  (a query then also scores the delta);
* ``during_rebuild``: a churn thread re-publishes 32 news and fully
  rebuilds the index, over and over (the harness's ``during_rebuild``
  point);
* ``during_rebuild_switch_0.5ms``: the same, with the interpreter's
  thread switch interval cut from 5 ms to 0.5 ms.

Each window runs under ``torch.profiler`` with CUDA activity. CUPTI sees
the runtime calls and kernels of every thread, so the trace splits the
scheduler worker's time per batch into the CUDA calls that wait
(stream, event and device synchronise; copies) and the rest (Python,
launches, waiting for the GIL), beside the worker thread's CPU time a
batch, the churn thread's CPU share and the process's busy cores, gives
the delay from a query kernel's
launch to its start on the card, and the card's busy share by launching
thread. Per window it prints one JSON line; the last line is the whole
report, also written to ``--out``. It needs a GPU and fails without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, MAX_WAIT_MS, SLO_MS = 16, 2.0, 50.0
SWITCH_SHORT_S = 0.0005
WAITS = ("Synchronize", "Memcpy", "cudaStreamWaitEvent")


def _union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _pct(vals, p):
    import numpy as np
    return float(np.percentile(vals, p)) if len(vals) else None


def read_trace(path, worker_tid, n_batches: int) -> dict:
    """The scheduler worker's CUDA waits, its kernels' launch-to-start
    delays and the card's busy share, from one Chrome trace. The trace
    names threads by its own ids; ``worker_tid`` None takes the thread
    with the most CUDA calls (in a window where only the worker and the
    submitting thread run, the worker)."""
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    runtime = [e for e in spans if e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver")]
    device = [e for e in spans if e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset")]
    launch_of = {e["args"]["correlation"]: e for e in runtime
                 if "correlation" in e.get("args", {})}
    tids = {}
    for e in runtime:
        tids[e.get("tid")] = tids.get(e.get("tid"), 0) + 1
    if worker_tid is None:
        worker_tid = max(tids, key=tids.get)
    worker_rt = [e for e in runtime if e.get("tid") == worker_tid]
    wait_us = sum(e["dur"] for e in worker_rt
                  if any(w in e["name"] for w in WAITS))
    calls = [e["dur"] for e in worker_rt
             if not any(w in e["name"] for w in WAITS)]
    waits_by_name = {}
    for e in worker_rt:
        if any(w in e["name"] for w in WAITS):
            waits_by_name[e["name"]] = waits_by_name.get(e["name"], 0.0) \
                + e["dur"] / 1e3
    delays, busy_by = [], {"worker": [], "other": []}
    for e in device:
        launch = launch_of.get(e.get("args", {}).get("correlation"))
        mine = launch is not None and launch.get("tid") == worker_tid
        busy_by["worker" if mine else "other"].append(
            (e["ts"], e["ts"] + e["dur"]))
        if mine and e.get("cat") == "kernel":
            delays.append(e["ts"] - launch["ts"])
    stamps = [e["ts"] for e in spans] + [e["ts"] + e["dur"] for e in spans]
    span_us = (max(stamps) - min(stamps)) if stamps else 0.0
    all_dev = busy_by["worker"] + busy_by["other"]
    n = max(n_batches, 1)
    return {
        "trace_s": span_us / 1e6,
        "worker_tid": worker_tid,
        "runtime_calls_by_tid": {str(k): v for k, v in tids.items()},
        "worker_cuda_wait_ms_per_batch": wait_us / 1e3 / n,
        "worker_cuda_wait_ms_by_call": waits_by_name,
        "worker_runtime_calls_per_batch": len(worker_rt) / n,
        "worker_other_call_us_mean": sum(calls) / len(calls) if calls
        else None,
        "query_kernels_per_batch": len(delays) / n,
        "query_kernel_launch_to_start_us_p50": _pct(delays, 50),
        "query_kernel_launch_to_start_us_p99": _pct(delays, 99),
        "device_busy_share": _union_us(all_dev) / span_us if span_us else None,
        "device_ms_worker": sum(e - s for s, e in busy_by["worker"]) / 1e3,
        "device_ms_other": sum(e - s for s, e in busy_by["other"]) / 1e3,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--qps", type=float, default=4000.0)
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--news", type=int, default=16384)
    ap.add_argument("--out", default="chiprun_out/serve_rebuild_trace.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_rebuild_trace: needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, obs, serving
    from repro_torch.configs import PROD
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.profile import slice_recommender
    from repro_torch.launch.train import make_loader

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ops.build_all()
    _, log, store, _ = make_loader(PROD, n_news=args.news, seed=0)
    params = core.init_speedyfeed(
        torch.Generator(device=dev).manual_seed(0), PROD)
    obs.reset()
    rec = slice_recommender(params, store, store.tokens.shape[0], dev)
    svc = rec.build_index()
    reqs = list(log.histories[:128])

    worker = {}
    run = serve.make_recommend_execute(rec)
    batch_ms = []

    def execute(payloads, pad_to):
        t0, c0 = time.perf_counter(), time.thread_time()
        out = run(payloads, pad_to)
        batch_ms.append(((time.perf_counter() - t0) * 1e3,
                         (time.thread_time() - c0) * 1e3))
        return out

    sched = serving.RequestScheduler(execute, max_batch=BATCH,
                                     max_wait_ms=MAX_WAIT_MS, max_queue=256,
                                     slo_ms=SLO_MS)
    rng = np.random.default_rng(1)
    n0 = svc.store.emb.shape[0]
    fresh_ids = np.arange(n0, n0 + 32)

    def fresh_rows():
        return (svc.store.emb[1:33].cpu().numpy()
                + 0.01 * rng.normal(size=(32, svc.store.dim))
                ).astype(np.float32)

    sched.warmup(reqs[0])
    rec.publish(fresh_ids, fresh_rows())
    sched.warmup(reqs[0])
    svc.rebuild(mode="full", block=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report = {"card": card, "news": args.news, "qps": args.qps,
              "duration_s": args.duration, "batch": BATCH,
              "slo_ms": SLO_MS, "windows": {}}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="serve_rebuild_trace_"))
    switch0 = sys.getswitchinterval()
    try:
        for j, (name, mode, switch) in enumerate((
                ("quiescent", "", switch0),
                ("delta_pending", "publish", switch0),
                ("during_rebuild", "churn", switch0),
                (f"during_rebuild_switch_{SWITCH_SHORT_S * 1e3:g}ms",
                 "churn", SWITCH_SHORT_S))):
            churn = mode == "churn"
            stop = threading.Event()

            churn_cpu = []

            def churn_loop():
                torch.cuda.set_device(dev.index or 0)
                t0, c0 = time.perf_counter(), time.thread_time()
                while not stop.is_set():
                    rec.publish(fresh_ids, fresh_rows())
                    svc.rebuild(mode="full", block=True)
                churn_cpu.append((time.thread_time() - c0)
                                 / (time.perf_counter() - t0))

            if mode == "publish":
                # 32 fresh news wait in the delta tier the whole window
                rec.publish(fresh_ids, fresh_rows())
            batch_ms.clear()
            swaps0 = svc.n_swaps
            w0, p0 = time.perf_counter(), time.process_time()
            sys.setswitchinterval(switch)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = threading.Thread(target=churn_loop, daemon=True)
                if churn:
                    t.start()
                handles, offered, rejected = serving.loadgen.open_loop(
                    sched, reqs, qps=args.qps, duration_s=args.duration,
                    seed=31 + j)
                stop.set()
                if churn:
                    t.join()
                torch.cuda.synchronize()
            cores = (time.process_time() - p0) / (time.perf_counter() - w0)
            sys.setswitchinterval(switch0)
            pending = svc.n_pending
            if mode == "publish":
                svc.rebuild(mode="full", block=True)
            point = serving.loadgen.summarize(
                handles, offered, rejected, qps=args.qps,
                duration_s=args.duration, slo_ms=SLO_MS)
            path = tmp / f"{name}.json"
            prof.export_chrome_trace(str(path))
            execute_ms = [w for w, _ in batch_ms]
            row = {"window": name, "switch_interval_ms": switch * 1e3,
                   "swaps": svc.n_swaps - swaps0,
                   "delta_pending_after": pending,
                   "batches": len(execute_ms),
                   "execute_ms_p50": _pct(execute_ms, 50),
                   "execute_ms_p99": _pct(execute_ms, 99),
                   "execute_ms_mean": float(np.mean(execute_ms))
                   if execute_ms else None,
                   "worker_cpu_ms_per_batch": float(np.mean(
                       [c for _, c in batch_ms])) if batch_ms else None,
                   "process_cpu_cores": cores,
                   "churn_thread_cpu_share": churn_cpu[0] if churn_cpu
                   else None,
                   "torch_threads": torch.get_num_threads(),
                   **read_trace(path, worker.get("tid"), len(execute_ms)),
                   "point": point}
            if row["execute_ms_mean"] is not None:
                row["worker_host_ms_per_batch"] = (
                    row["execute_ms_mean"]
                    - row["worker_cuda_wait_ms_per_batch"])
            worker.setdefault("tid", row["worker_tid"])
            path.unlink()
            report["windows"][name] = row
            print(json.dumps(row), flush=True)
    finally:
        sys.setswitchinterval(switch0)
        sched.stop(drain=True)
        svc.wait_for_build()
        tmp.rmdir()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
