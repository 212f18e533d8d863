#!/usr/bin/env python3
"""The mesh phase of ``chip_smoke.py`` alone, on one card: SpeedyFeed at
PROD on a 4-rank gloo data mesh sharing the card, and the slice's IVF-PQ
and IVF-Flat builds in 4 shards on it.

    python3 tools/mesh_phase.py [--out chiprun_out/mesh_phase.json]

Builds the kernel libraries, then the smoke's serve slice as the smoke
builds it (the 16,384-news corpus encoded at PROD, the IVF-PQ index, one
batch of 16 users), and runs ``chip_smoke.mesh_serve`` and
``chip_smoke.mesh_train`` with the smoke's checks (a failed check exits
non-zero). Prints one JSON object with the card's name and power limit
and the phase's seconds, also written to ``--out``. It needs a GPU and
fails without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "mesh_phase.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tools/mesh_phase.py needs a GPU")
    import chip_smoke as cs
    from repro_torch import core, data
    from repro_torch.configs import PROD
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Recommender, _pad_histories
    from repro_torch.launch.train import first_batch_of_bucket, make_loader
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ops.build_all()
    build_s = time.perf_counter() - t0
    cfg = PROD
    _, log, store, serve_lcfg = make_loader(cfg, n_news=cs.N_NEWS, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = Recommender(cfg, core.init_speedyfeed(gen, cfg), store, k=10,
                      index_kind="ivf-pq", nprobe=16, k_prime=64,
                      device=dev, service_kw={"delta_hard_cap": cs.N_NEWS})
    emb = rec._encode_corpus()
    svc = rec.build_index_from(emb)
    snap = svc.snapshot()
    reqs = list(log.histories[cs.BATCH:2 * cs.BATCH])
    hist, mask = _pad_histories(rec, reqs, cs.BATCH)
    with torch.inference_mode():
        user = rec.encode_users(hist, mask)
    lcfg = dataclasses.replace(serve_lcfg,
                               token_budget=data.LoaderConfig.token_budget)
    top_np = first_batch_of_bucket(log, store, lcfg, max(lcfg.buckets))
    t_mesh = time.perf_counter()
    serve_rep, pq = cs.mesh_serve(torch, np, dev, snap, emb, user)
    del rec, svc
    cs.gc_collect(torch)
    rep, bus = cs.mesh_train(torch, np, dev, cfg, card, top_np)
    rep.update(serve=serve_rep, wall_s=time.perf_counter() - t_mesh,
               build_s=build_s, mesh_launches={**bus, **pq})
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=1))
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
