#!/usr/bin/env python3
"""Qwen3-14B on a (data=1, model=16) mesh of 16 gloo ranks sharing one
card: the LM head plan at the registry's own uneven cut (40 query heads
over 8 KV heads: each KV head replicated over 2 model ranks, which hold
3 and 2 of its 5 query heads), held against one process on the card.

    python3 tools/lm_heads_phase.py [--out chiprun_out/lm_heads_phase.json]

Qwen3-14B at full width, LAYERS layers, f32, TF32 off, from one seed:
prefill at B=2, S=``chip_smoke.LM_MESH_HOLD_SEQ`` with 4 decode steps,
and 2 train steps from Adam's count ``LM_MESH_OPT_COUNT``, each through
``lm_family.make_fn(cfg, kind, mesh)`` in the ranks and without a mesh in
one process, held by ``chip_smoke.lm_mesh_hold_check`` (``TOL_LM_MESH``:
logits, losses, grad norms, every leaf's sampled parameters and moments,
each leaf's change, the unchanged state as the control). Each rank's
flash launches are counted: the 3xTF32 pair at its own heads (3 or 2
over one KV head), LAYERS forwards a prefill, twice that a train step
(remat) and LAYERS backward pairs a step.

Memory: one process's 2-layer f32 train state is ~36 GB (8.9 GB of
parameters, their gradients and Adam's two moments), the 16 ranks' about
as much again plus 16 CUDA contexts, so the one-process reference runs
first and is freed (its results kept on the host) before the ranks,
started on a thread meanwhile, are let go (a ``go`` file). Each rank's
peak and the seconds of each part are reported. Every collective crosses
the host (gloo): the times are the transport's, not a speed figure.

Builds the kernel libraries first. Prints one JSON object with the card's
name and power limit and the run's seconds, also written to ``--out``.
It needs a GPU and fails without one (a failed check exits non-zero).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS, NAME, LAYERS = 16, "qwen3-14b", 2
SERVE_SEED, TRAIN_SEED = 40, 41


def config():
    from repro_torch.configs import lm_family
    return dataclasses.replace(lm_family.CONFIGS[NAME], n_layers=LAYERS,
                               dtype="float32")


def rank_main(mesh, go, tokens):
    """One rank, once the file ``go`` exists: the serve and train holds
    on ``mesh`` (``chip_smoke.lm_mesh_hold_run``), its query and KV heads
    by the plan, its peak memory and the seconds of each hold."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.models import lm_parallel as tp
    go, waited = pathlib.Path(go), time.time()
    while not go.exists():
        if time.time() - waited > 900:
            raise TimeoutError(f"rank {mesh.rank}: no {go} in 900 s")
        time.sleep(0.05)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops
    cfg = config()
    local = tp.local_attn_cfg(cfg.attn_cfg(), mesh)
    ops.reset_launch_counts()
    out = {"rank": mesh.rank, "index": {"data": 0,
                                        "model": mesh.index("model")},
           "heads": [local.n_heads, local.n_kv], "holds": {}, "s": {}}
    for kind, seed in (("serve", SERVE_SEED), ("train", TRAIN_SEED)):
        t0 = time.perf_counter()
        out["holds"][f"{NAME}/{kind}"] = cs.lm_mesh_hold_run(
            torch, np, mesh.device, cfg, kind, seed, tokens, mesh)
        out["s"][kind] = time.perf_counter() - t0
        cs.gc_collect(torch)
        if mesh.rank == 0:
            print(f"lm-heads: rank 0 held {kind} in {out['s'][kind]:.1f} s",
                  flush=True)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = {k: n for k, n in ops.launch_counts().items() if n}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "lm_heads_phase.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tools/lm_heads_phase.py needs a GPU")
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import lm_parallel as tp
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    ops.build_all()
    rep = {"card": card, "config": NAME, "layers": LAYERS, "ranks": RANKS,
           "mesh": [1, RANKS], "build_s": time.perf_counter() - t_all}
    cfg = config()
    plan = tp.head_plan(cfg.n_heads, cfg.n_kv, RANKS)
    rep["plan"] = {"q_heads": [hi - lo for lo, hi in plan.q], "R": plan.R}
    tokens = np.random.default_rng(37).integers(
        0, cfg.vocab, (cs.LM_MESH_HOLD_B, cs.LM_MESH_HOLD_SEQ))
    root = ROOT / "build" / "lm_heads_phase"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    go, ranks = root / "go", {}
    card0 = f"cuda:{torch.cuda.current_device()}"

    def spawn():
        try:
            ranks["out"] = run_on_mesh(
                rank_main, RANKS, [card0] * RANKS, "gloo",
                args=(str(go), tokens), timeout=1500.0, model=RANKS)
        except BaseException as e:      # raised again on the main thread
            ranks["error"] = e

    spawned = time.time()
    thread = threading.Thread(target=spawn, daemon=True)
    thread.start()
    try:
        refs = {}
        torch.cuda.reset_peak_memory_stats()
        for kind, seed in (("serve", SERVE_SEED), ("train", TRAIN_SEED)):
            t0 = time.perf_counter()
            refs[kind] = cs.lm_mesh_hold_run(torch, np, dev, cfg, kind, seed,
                                             tokens)
            cs.gc_collect(torch)
            rep[f"one_process_{kind}_s"] = time.perf_counter() - t0
            print(f"lm-heads: one process {kind} "
                  f"{rep[f'one_process_{kind}_s']:.1f} s", flush=True)
        rep["one_process_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        go.touch()
        rep["go_s"] = time.time() - spawned
        thread.join()
        if "error" in ranks:
            raise ranks["error"]
        out = ranks["out"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep["heads_by_rank"] = [r["heads"] for r in out]
    cs.check([r["heads"][0] for r in out] == rep["plan"]["q_heads"]
             and all(r["heads"][1] == 1 for r in out),
             f"lm-heads: the ranks' heads {rep['heads_by_rank']}")
    rep["peak_gb_by_rank"] = [r["peak_gb"] for r in out]
    # the holds' flash calls, f32 on the 3xTF32 pair at each rank's own
    # heads: a forward a layer in the prefill, two a layer in each of the
    # 2 train steps (remat), and a backward pair a layer a step
    rep["launches_by_rank"] = [r["launches"] for r in out]
    want = {"flash_attention_tf32": LAYERS * (1 + 2 * 2),
            "flash_attention_bwd_dq_tf32": LAYERS * 2,
            "flash_attention_bwd_dkv_tf32": LAYERS * 2}
    cs.check(all(r["launches"] == want for r in out),
             f"lm-heads: flash launches {rep['launches_by_rank']}, "
             f"expected {want} a rank")
    rep["rank_s"] = {k: max(r["s"][k] for r in out) for k in out[0]["s"]}
    rep["holds"] = {kind: cs.lm_mesh_hold_check(
        np, f"{NAME}/{kind}", kind, out, refs[kind], 1, label="lm-heads")
        for kind in ("serve", "train")}
    rep["seconds"] = time.perf_counter() - t_all
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rep, indent=1))
    print(json.dumps(rep), flush=True)
    print(json.dumps({"card": card, "seconds": rep["seconds"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
