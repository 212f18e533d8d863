#!/usr/bin/env python3
"""Time SpeedyFeed's two main paths from two source trees in turns, on
one card: the corpus encode (news/s) and the PROD Algorithm-1 train step
(s/step).

    python3 tools/speedyfeed_turns.py --trees OLD/src src \
        [--order ABBA] [--news 16384] [--steps 3] \
        [--out chiprun_out/speedyfeed_turns.json]

``--trees`` names two ``src`` directories holding ``repro_torch`` (for
example the parent commit unpacked with ``git archive`` beside this
one's). ``--order`` runs them in turns, A the first and B the second,
each turn in a process of its own, so both are measured on the same card
within one call. A turn builds that tree's kernels (nvcc, into the
tree's own ``build/kernels``), makes the slice ``chip_smoke.py`` drives
(the production PLM with seeded random weights over a ``make_loader``
corpus of ``--news`` news), encodes the corpus twice through
``Recommender._encode_corpus`` (the second timed, synchronised), then
runs one warm-up and ``--steps`` synchronised ``Trainer.step`` calls on
the first batch of the top seg-length bucket (E=4096, remat). Each turn
prints one JSON line; the last line is the list of turns, also written
to ``--out``. It needs a GPU and fails without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

N_NEWS, TIMED_STEPS = 16384, 3


def one_turn(src: str, n_news: int, steps: int) -> dict:
    """Measure the tree under ``src`` in this process."""
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    import dataclasses

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("speedyfeed_turns: needs a GPU")
    from repro_torch import core, data, training
    from repro_torch.configs import PROD
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Recommender
    from repro_torch.launch.train import first_batch_of_bucket, make_loader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ops.build_all()
    cfg = PROD
    _, log, store, lcfg = make_loader(cfg, n_news=n_news, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = Recommender(cfg, core.init_speedyfeed(gen, cfg), store, k=10,
                      index_kind="ivf-pq", nprobe=16, k_prime=64, device=dev)
    encode_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = rec._encode_corpus()
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t0)
    n_rows = int(emb.shape[0])
    del rec, emb
    torch.cuda.empty_cache()

    lcfg = dataclasses.replace(lcfg, token_budget=data.LoaderConfig.token_budget)
    trainer = training.get_trainer("speedyfeed", cfg=cfg, device=dev)
    state = trainer.init_state(seed=0)
    top = max(lcfg.buckets)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             first_batch_of_bucket(log, store, lcfg, top).items()
             if not k.startswith("_")}
    state, _ = trainer.step(state, batch, top)             # warm-up
    ops.reset_launch_counts()
    step_s = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch, top)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(m["loss"])):
            raise SystemExit("speedyfeed_turns: non-finite train step")
    launches = ops.launch_counts()
    return {"src": src, "card": torch.cuda.get_device_name(0),
            "news": n_rows, "encode_s": encode_s,
            "encode_news_per_s": n_rows / encode_s[-1],
            "step_s": step_s, "s_per_step": float(np.mean(step_s)),
            "bus_launches_per_step": {
                n: launches[n] / steps
                for n in ("bus_attention", "bus_attention_bwd")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--news", type=int, default=N_NEWS)
    ap.add_argument("--steps", type=int, default=TIMED_STEPS)
    ap.add_argument("--out", default="chiprun_out/speedyfeed_turns.json")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_turn(args.one, args.news, args.steps)),
              flush=True)
        return 0
    if not args.trees or set(args.order) - {"A", "B"}:
        ap.error("give --trees A B and an --order of A and B")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(power, flush=True)
    turns = []
    for who in args.order:
        src = args.trees[who == "B"]
        proc = subprocess.run(
            [sys.executable, __file__, "--one", src, "--news",
             str(args.news), "--steps", str(args.steps)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"speedyfeed_turns: turn {who} ({src}) failed")
        turn = {"turn": who, **json.loads(proc.stdout.strip()
                                          .splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": power, "turns": turns}, indent=1))
    print(json.dumps(turns), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
