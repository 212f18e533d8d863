"""The paper's quality tables and figures at the JAX benchmark's scale
(``bench``: 2 layers, d 64, K=3 x 16, 16 users, L=30; 1,200 news, 300
users), on the card.

    python -m repro_torch.launch.tables [--only table1,table3,...]
        [--device cuda] [--out build/tables.jsonl]
        [--table3-steps 60] [--table5-steps 50] [--table6-steps 40]
        [--warmup 2] [--iters 5]

Functions, in order, with the JAX package's ``benchmarks/tables.py`` row
names, ``(name, µs, value)`` rows and default step counts:

  table1  the long tail: the share of clicks that the top 1-30% of the
          news take (5,000 news, 2,000 users; numpy only)
  table3  quality: SpeedyFeed's PLM recommender (its ``ar_acc``, the
          mean of the last 10 of 60 steps) against the NRMS baseline
          (``models.news``, d 32, trained with the conventional click
          loss and Adam at lr 1e-3; its ``click_acc``). Chance is 0.2.
  table5  ablations, 50 steps each: default, w/o bus (``use_bus=False``),
          w/o cache (``gamma=0``), w/o refine (``use_freq=False`` and a
          store of head-truncated news, ``LoaderConfig(refine=False)``)
  table6  the cache's expiry gamma in {0, 10, 20, 30}, 40 steps each
  fig8    data efficiency (Eq. 1): the conventional batch, then
          centralized batches over 1, 2 and 4 buckets (numpy only)
  fig9    BusLM: the encode of 256 news of random tokens, 48 tokens a
          news as K in {1, 2, 3, 4, 6} segments (time), and the analytic
          GFLOPs (``core.plm_flops``). K=1 has no bus: plain attention.

The µs of a training row is the wall time of its run (the batcher, the
steps and the accuracy read back after each) over its steps. Before the
timed run, one step at each bucket of the loader warms the kernels on a
copy of the state, which is then thrown away, so the measured run starts
from the seeded state. fig9's timer synchronises the device around every
call and takes the median of ``iters`` calls after ``warmup``. TF32
stays off. It runs on the card and raises without one; ``device="cpu"``
is for tests. It prints one JSON line a row, then one line of what the
rows were read from (seconds a function, peak memory, the card, numpy's
version), and writes the same lines to ``--out``.

Table 1's and fig 8's values come from numpy's Generator streams, which
numpy does not hold fixed from one version to the next (its ``zipf``
draws the corpus's words): another numpy gives another corpus, and every
table's readings move with it.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch import core, data, optim
from repro_torch.configs.speedyfeed_arch import make_sf_train_step
from repro_torch.device import check_device
from repro_torch.launch.speedup import (_card, _on, bench_cfg, bench_corpus,
                                        time_fn)
from repro_torch.models import news as news_mod

FUNCTIONS = ("table1", "table3", "table5", "table6", "fig8", "fig9")


def table1_longtail():
    rng = np.random.default_rng(0)
    corpus = data.make_corpus(rng, n_news=5000, zipf_a=1.6)
    log = data.make_click_log(rng, corpus, n_users=2000)
    share = data.click_share_topk(log, corpus,
                                  [0.01, 0.03, 0.05, 0.10, 0.20, 0.30])
    return [(f"table1/click_share_top{int(f*100)}pct", 0.0, round(s, 4))
            for f, s in share.items()]


def warm_up(step_fn, state, cfg, lcfg, *, seed: int = 0, device):
    """One step at each of the loader's buckets on a deep copy of
    ``state`` (params, opt, cache), thrown away after: the step updates in
    place, so the state the measured run starts from is left as it was.
    Returns the warm-up steps' losses."""
    gen = torch.Generator(device=device).manual_seed(seed)
    losses = []
    for bkt in lcfg.buckets:
        wb = data.synth_centralized_batch(
            m_cap=lcfg.m_cap, n_segments=lcfg.n_segments, seg_len=bkt,
            b_cap=cfg.batch_users, hist_len=cfg.hist_len, vocab=lcfg.vocab,
            seed=seed)
        params, opt, cache = copy.deepcopy(state)
        out = step_fn(params, opt, cache, 0, gen, _on(wb, device))
        losses.append(float(out[-1]["loss"]))
        del params, opt, cache, out
    return losses


def _train_speedy(cfg, log, store, lcfg, *, steps, seed=0, device):
    """``steps`` Algorithm-1 steps over the DynamicBatcher from a seeded
    state -> (mean ar_acc of the last 10 steps, wall seconds of the run)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params, cache = core.speedyfeed_state(cfg, gen)
    opt = optim.adam_init(params)
    step_fn = make_sf_train_step(cfg)
    warm_up(step_fn, (params, opt, cache), cfg, lcfg, seed=seed,
            device=device)
    batcher = data.DynamicBatcher(log, store, lcfg, n_threads=2,
                                  seed=seed).start()
    accs, t0 = [], time.perf_counter()
    try:
        s = 0
        while s < steps:
            b = batcher.get(timeout=5.0)
            if b is data.EPOCH_END:
                batcher.stop()
                batcher = data.DynamicBatcher(log, store, lcfg, n_threads=2,
                                              seed=seed + s + 1).start()
                continue
            if b is None:      # timeout: the loader is still running
                continue
            params, opt, cache, m = step_fn(params, opt, cache, s, gen,
                                            _on(b, device))
            accs.append(float(m["ar_acc"]))
            s += 1
    finally:
        batcher.stop()
    return float(np.mean(accs[-10:])), time.perf_counter() - t0


def table3_quality(steps=60, *, device="cuda"):
    """SpeedyFeed's PLM recommender against the NRMS baseline: the final
    click-prediction accuracy on the same synthetic log (chance 0.2)."""
    dev = check_device(device)
    rows = []
    cfg = bench_cfg()
    corpus, log, stats, lcfg, store = bench_corpus(cfg)
    acc_sf, t_sf = _train_speedy(cfg, log, store, lcfg, steps=steps,
                                 device=dev)
    rows.append(("table3/speedy_plm_ar_acc", t_sf * 1e6 / steps, acc_sf))

    # the baseline: NRMS with the conventional workflow on the same data
    ncfg = news_mod.NewsBaselineConfig(name="nrms", vocab=cfg.plm.vocab,
                                       n_users=len(log.histories),
                                       d_word=32, d_news=32, n_heads=4)
    params = news_mod.init(torch.Generator(device=dev).manual_seed(1), ncfg)
    opt = optim.adam_init(params)
    step_fn = optim.make_train_step(lambda p, b: news_mod.loss(p, ncfg, b),
                                    optim.AdamConfig(lr=1e-3))
    insts = [h for h in log.histories if len(h) >= 2]
    rng = np.random.default_rng(0)
    accs, t0 = [], time.perf_counter()
    for _ in range(steps):
        pick = rng.choice(len(insts), cfg.batch_users, replace=False)
        cb = data.build_conventional_batch(
            [insts[i] for i in pick], store, lcfg,
            n_cands=1 + cfg.n_neg, rng=rng)
        cb["user_id"] = np.asarray(pick, np.int32)
        params, opt, m = step_fn(params, opt, _on(cb, dev))
        accs.append(float(m["click_acc"]))
    rows.append(("table3/nrms_baseline_click_acc",
                 (time.perf_counter() - t0) * 1e6 / steps,
                 float(np.mean(accs[-10:]))))
    return rows


def table5_ablation(steps=50, *, device="cuda"):
    rows = []
    variants = {
        "default": {},
        "wo_bus": dict(use_bus=False),
        "wo_cache": dict(gamma=0),
        "wo_refine": dict(use_freq=False),
    }
    for name, over in variants.items():
        cfg = bench_cfg(**over)
        corpus, log, stats, lcfg, store = bench_corpus(cfg)
        if name == "wo_refine":   # head truncation instead of BM25 OBoW
            lcfg = dataclasses.replace(lcfg, refine=False)
            store = data.NewsStore(corpus, stats, lcfg)
        acc, t = _train_speedy(cfg, log, store, lcfg, steps=steps,
                               device=check_device(device))
        rows.append((f"table5/{name}_ar_acc", t * 1e6 / steps, acc))
    return rows


def table6_cache_gamma(steps=40, *, device="cuda"):
    rows = []
    for gamma in (0, 10, 20, 30):
        cfg = bench_cfg(gamma=gamma)
        corpus, log, stats, lcfg, store = bench_corpus(cfg)
        acc, t = _train_speedy(cfg, log, store, lcfg, steps=steps,
                               device=check_device(device))
        rows.append((f"table6/gamma{gamma}_ar_acc", t * 1e6 / steps, acc))
    return rows


def fig8_data_efficiency():
    """DE (Eq. 1) for 1 bucket w/o CNE -> n buckets + CNE."""
    rows = []
    cfg = bench_cfg()
    corpus, log, stats, lcfg, store = bench_corpus(cfg)
    insts = [h for h in log.histories if len(h) >= 2][:cfg.batch_users]
    conv = data.build_conventional_batch(insts, store, lcfg)
    rows.append(("fig8/de_1bucket_wo_cne", 0.0,
                 round(conv["_stats"]["data_efficiency"], 4)))
    for n_buckets in (1, 2, 4):
        S = cfg.plm.seg_len
        buckets = tuple(S * (i + 1) // n_buckets for i in range(n_buckets))
        lc = dataclasses.replace(lcfg, buckets=buckets)
        des = []
        for b in buckets:
            sub = [h for h in insts
                   if data.bucket_for(int(store.lengths[h].max()),
                                      buckets) == b]
            if not sub:
                continue
            cb = data.build_centralized_batch(sub, store, lc, b)
            des.append(cb["_stats"]["data_efficiency"])
        rows.append((f"fig8/de_{n_buckets}bucket_cne", 0.0,
                     round(float(np.mean(des)), 4)))
    return rows


FIG9_TOTAL, FIG9_NEWS, FIG9_SEGMENTS = 48, 256, (1, 2, 3, 4, 6)


def fig9_buslm(*, device="cuda", warmup: int = 2, iters: int = 5):
    """Encode time and analytic GFLOPs against the count of segments, at a
    fixed 48 tokens a news."""
    dev = check_device(device)
    rows = []
    for k_seg in FIG9_SEGMENTS:
        if FIG9_TOTAL % k_seg:
            continue
        S = FIG9_TOTAL // k_seg
        cfg = bench_cfg(n_segments=k_seg, seg_len=S)
        gen = torch.Generator(device=dev).manual_seed(0)
        params, _ = core.speedyfeed_state(cfg, gen)
        toks = torch.randint(1, cfg.plm.vocab, (FIG9_NEWS, k_seg, S),
                             generator=gen, device=dev)

        def enc(p=params, c=cfg, t=toks):
            with torch.inference_mode():
                return core.buslm_encode(p["plm"], c.plm, t)

        t = time_fn(enc, device=dev, warmup=warmup, iters=iters)
        fl = core.plm_flops(cfg.plm, FIG9_NEWS)
        rows.append((f"fig9/buslm_seg{k_seg}_encode", t * 1e6,
                     round(fl / 1e9, 2)))
    return rows


def run(only=FUNCTIONS, *, device="cuda", table3_steps=60, table5_steps=50,
        table6_steps=40, warmup: int = 2, iters: int = 5):
    """-> (rows, info): the rows of each function in ``only`` (in
    ``FUNCTIONS``' order) and what they were read from."""
    unknown = set(only) - set(FUNCTIONS)
    if unknown:
        raise ValueError(f"unknown functions {sorted(unknown)}; have "
                         f"{FUNCTIONS}")
    dev = check_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    calls = {
        "table1": table1_longtail,
        "table3": lambda: table3_quality(table3_steps, device=dev),
        "table5": lambda: table5_ablation(table5_steps, device=dev),
        "table6": lambda: table6_cache_gamma(table6_steps, device=dev),
        "fig8": fig8_data_efficiency,
        "fig9": lambda: fig9_buslm(device=dev, warmup=warmup, iters=iters),
    }
    rows, seconds = [], {}
    for name in FUNCTIONS:
        if name not in only:
            continue
        t0 = time.perf_counter()
        rows += calls[name]()
        seconds[name] = time.perf_counter() - t0
    info = {"device": str(dev), "seconds": seconds,
            "steps": {"table3": table3_steps, "table5": table5_steps,
                      "table6": table6_steps},
            "fig9_timer": {"warmup": warmup, "iters": iters},
            "chance_acc": 1 / (1 + bench_cfg().n_neg),
            # the synthetic corpus and log are numpy Generator draws, whose
            # streams numpy does not hold fixed from one version to the next
            "numpy": np.__version__}
    if dev.type == "cuda":
        info["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        info["card"] = _card()
        info["kind"] = torch.cuda.get_device_name(dev)
    return rows, info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(FUNCTIONS),
                    help=f"comma list of {','.join(FUNCTIONS)}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSONL of the printed lines")
    ap.add_argument("--table3-steps", type=int, default=60)
    ap.add_argument("--table5-steps", type=int, default=50)
    ap.add_argument("--table6-steps", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=2, help="fig9's timer")
    ap.add_argument("--iters", type=int, default=5, help="fig9's timer")
    args = ap.parse_args(argv)
    only = tuple(s.strip() for s in args.only.split(",") if s.strip())
    rows, info = run(only, device=args.device,
                     table3_steps=args.table3_steps,
                     table5_steps=args.table5_steps,
                     table6_steps=args.table6_steps, warmup=args.warmup,
                     iters=args.iters)
    lines = [json.dumps({"name": n, "us": us, "value": float(v)})
             for n, us, v in rows] + [json.dumps(info)]
    for ln in lines:
        print(ln, flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(lines) + "\n")
    return rows, info


if __name__ == "__main__":
    main()
