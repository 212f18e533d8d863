#!/usr/bin/env python3
"""The news baselines' table lookup on one card: ``F.embedding`` (what
``models/news.py`` uses) against indexing (``nn.embed``), alone and
inside each baseline's train step, in turns.

    python3 tools/news_lookup_turns.py [--steps 3]
        [--out chiprun_out/news_lookup_turns.json]

The batch is ``chip_smoke.py``'s quality batch (512 users, L=100, 2
candidates, K=3 x S=32 at the baselines' 30,522 ids; ~97% of its tokens
are the pad). First the lookup alone, forward and backward into a
seeded 30,522 x 64 table at the histories' ids, each version timed in
turns (embedding, index, index, embedding) and their table gradients
compared. Then for each of NPA, NAML, LSTUR and NRMS at
``NewsBaselineConfig``'s defaults: ``--steps`` synchronised
``optim.make_train_step`` steps after one warm-up with each lookup, in
the same turns, and one step of the port's under ``torch.profiler``
(its device total and top kernels by self device time). TF32 is off.
Prints one JSON object with the card's name and power limit, also
written to ``--out``. It needs a GPU and fails without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
TURNS = ("embedding", "index", "index", "embedding")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "news_lookup_turns.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("news_lookup_turns: needs a GPU")
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch import optim
    from repro_torch.configs import PROD
    from repro_torch.launch.train import make_loader
    from repro_torch.models import news

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    corpus, _, _, lcfg = make_loader(PROD, n_news=chip_smoke.N_NEWS, seed=0)
    batch, shape = chip_smoke.baseline_batch(torch, np, dev, corpus, lcfg)
    out = {"card": card, "batch": shape, "steps": args.steps}
    lookups = {"embedding": news._lookup,
               "index": lambda p, ids: p["table"][ids]}

    def sync_ms(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    # the lookup alone, at the histories' ids
    ht = batch["hist_tokens"]
    ids = ht.reshape(-1, ht.shape[-2] * ht.shape[-1])
    g = torch.Generator(device=dev).manual_seed(0)
    p = {"table": (torch.randn(shape["vocab"], 64, generator=g, device=dev)
                   * 0.02).requires_grad_()}
    dout = torch.randn(ids.shape + (64,), generator=g, device=dev)
    grads, alone = {}, {k: [] for k in lookups}
    for name in TURNS:
        fn = lookups[name]
        grads[name] = torch.autograd.grad(fn(p, ids), p["table"], dout)[0]
        alone[name].append(sync_ms(lambda: torch.autograd.grad(
            fn(p, ids), p["table"], dout), 3))
    top = float(grads["index"].abs().max())
    out["lookup"] = {
        "ids": list(ids.shape), "ms": alone,
        "grad_max_abs_diff": float((grads["index"]
                                    - grads["embedding"]).abs().max()),
        "grad_max": top}
    del grads, dout, p
    print("lookup: " + json.dumps(out["lookup"]), flush=True)

    # each baseline's step with each lookup, in turns
    step_cfg = optim.AdamConfig(lr=1e-3)
    for bname in news.NAMES:
        cfg = news.NewsBaselineConfig(name=bname)
        params = news.init(torch.Generator(device=dev).manual_seed(0), cfg)
        opt = optim.adam_init(params)
        step = optim.make_train_step(lambda q, b: news.loss(q, cfg, b),
                                     step_cfg)
        row = {k: [] for k in lookups}
        try:
            for name in TURNS:
                news._lookup = lookups[name]
                step(params, opt, batch)                    # warm-up
                row[name].append(sync_ms(lambda: step(params, opt, batch),
                                         args.steps) / 1e3)
        finally:
            news._lookup = lookups["embedding"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, opt, batch)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        total = sum(e.self_device_time_total for e in ka) / 1e3
        kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                          for e in ka if e.self_device_time_total > 0),
                         key=lambda kv: -kv[1])[:6]
        row["profile"] = {"device_ms": total, "top_kernels_ms": kernels}
        out[bname] = row
        print(f"{bname}: " + json.dumps(row), flush=True)
        del params, opt, step
        torch.cuda.empty_cache()
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
