"""The paper's speedup ladder (Table 4) on the card: the wall-clock cost
of a click prediction at each rung, from the conventional workflow to
SpeedyFeed.

    python -m repro_torch.launch.speedup [--config bench|prod]
        [--warmup 2] [--iters 5] [--device cuda]
        [--out build/speedup.jsonl]

Rungs, the rows, their names, order and formulas as the JAX package's
``benchmarks/speedup.py:run`` gives them (each row: the time it is read
from, in µs, and the factor):

  conventional_us_per_click    per-instance encoding, 1 prediction a user
  central_batch_factor         + the deduplicated merged set, encoded
                               once (still 1 prediction a user)
  cache_encode_factor          + the cache: an encode of E news against
                               one of the whole merged set (forward only)
  autoregressive_us_per_click  + L-1 predictions a user from one encode:
                               the Algorithm-1 step over B*(L-1) clicks
  buslm_factor                 K segments of S tokens against one sequence
                               of K*S (forward only, E news of random
                               tokens; K=1 has no bus, so that encode
                               takes plain attention, not a kernel)
  overall_vs_conventional      conventional cost over Algorithm-1 cost

Configurations:

  bench  ``bench_cfg`` and ``bench_corpus`` (2 layers, d 64, K=3 x 16,
         16 users, L=30, M=384, E=128; 1,200 news, 300 users), the JAX
         benchmark's own.
  prod   PROD's widths and depth (UniLMv2-base, 12 layers, d 768, 12
         heads, K=3 x 32, news_dim 768, remat, f32), cut to one card:
         32 users (``CONV_ONE_CARD``: 32 x (100 + 2) = 3,264 news a
         conventional step, from PROD's 1,024 and ``CONV_BATCH``'s 512),
         L=100, the merged set ``merged_cap`` cut from 8,192 to the
         smallest multiple of 512 that holds its unique news and the pad,
         and E to half of that (PROD's own ratio, 4,096 to 8,192), over
         ``make_loader``'s 16,384 synthetic news (seed 0). The 32 users
         are the first 32 histories with at least 2 clicks; every rung
         sees them. Their unique news fit in E, so the Algorithm-1 step
         re-encodes all of them and never reads the cache, and the cache
         factor compares E rows with ``merged_cap`` rows, pads included
         (``encode_covers_merged_set`` in the info line).

Each rung starts from the same seeded parameters and Adam state. The
timer synchronises the device around every call and takes the median of
``iters`` calls after ``warmup``. TF32 stays off. It runs on the card and
raises without one; ``device="cpu"`` is for tests. It prints one JSON line
a row, then one line of what the rows are read from (the counts behind
them, the Algorithm-1 step's own valid predictions and the cost of each,
peak memory, the card), and writes the same lines to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

from repro_torch import core, data, optim
from repro_torch.configs.speedyfeed_arch import (
    CONV_BATCH, CONV_ONE_CARD, PROD, SF_OPT, make_conventional_step,
    make_sf_train_step)
from repro_torch.device import check_device
from repro_torch.launch.train import make_loader

CONFIGS = ("bench", "prod")
PROD_NEWS = 16384             # chip_smoke.py's corpus
MERGED_ROUND = 512            # prod's merged_cap: a multiple of this


def time_fn(fn, *, device, warmup: int = 2, iters: int = 5) -> float:
    """Median wall time per call (seconds), the device synchronised before
    and after every call."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
        sync()
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_cfg(**over):
    base = dict(vocab=5000, n_layers=2, d_model=64, n_heads=4, d_ff=128,
                n_segments=3, seg_len=16, news_dim=32, n_news=1201,
                gamma=20, beta=2e-2, encode_budget=128, batch_users=16,
                hist_len=30, merged_cap=384, n_neg=4)
    base.update(over)
    return core.make_config(**base)


def bench_corpus(cfg, *, n_news=1200, n_users=300, seed=0):
    """-> (corpus, click log, corpus stats, loader config, news store)."""
    rng = np.random.default_rng(seed)
    corpus = data.make_corpus(rng, n_news=n_news)
    log = data.make_click_log(rng, corpus, n_users=n_users,
                              max_hist=cfg.hist_len)
    stats = data.build_corpus_stats(
        [corpus.text(i) for i in range(corpus.n_news)])
    lcfg = data.LoaderConfig(vocab=cfg.plm.vocab,
                             n_segments=cfg.plm.n_segments,
                             seg_len=cfg.plm.seg_len,
                             buckets=data.default_buckets(cfg.plm.seg_len),
                             token_budget=6000, b_cap=cfg.batch_users,
                             m_cap=cfg.merged_cap, hist_len=cfg.hist_len)
    store = data.NewsStore(corpus, stats, lcfg)
    return corpus, log, stats, lcfg, store


def ladder_users(log, n: int) -> list:
    """The first ``n`` histories with at least 2 clicks."""
    return [h for h in log.histories if len(h) >= 2][:n]


def centralized_batch_from_log(cfg, log, store, lcfg):
    return data.build_centralized_batch(ladder_users(log, cfg.batch_users),
                                        store, lcfg, cfg.plm.seg_len)


def conventional_batch_from_log(cfg, log, store, lcfg, *, n_users=None):
    return data.build_conventional_batch(
        ladder_users(log, n_users or cfg.batch_users), store, lcfg)


def prod_setup():
    """-> (cfg, log, store, lcfg, cuts): PROD cut to one card as the
    module docstring says."""
    _, log, store, lcfg = make_loader(PROD, n_news=PROD_NEWS, seed=0)
    B, L = CONV_ONE_CARD["users"], CONV_ONE_CARD["hist"]
    users = ladder_users(log, B)
    uniq = np.unique(np.concatenate([h[-L:] for h in users]))
    n_unique = int((uniq != 0).sum())
    m_cap = -(-(n_unique + 1) // MERGED_ROUND) * MERGED_ROUND
    E = m_cap * PROD.cache.encode_budget // PROD.merged_cap
    cfg = dataclasses.replace(
        PROD, batch_users=B, hist_len=L, merged_cap=m_cap,
        cache=dataclasses.replace(PROD.cache, encode_budget=E))
    lcfg = dataclasses.replace(lcfg, b_cap=B, m_cap=m_cap, hist_len=L)
    cuts = {"news": PROD_NEWS, "users": B, "hist_len": L,
            "n_unique": n_unique, "merged_cap": m_cap, "encode_budget": E,
            "from": {"news": PROD.cache.n_news, "users": PROD.batch_users,
                     "conv_users": CONV_BATCH["users"],
                     "merged_cap": PROD.merged_cap,
                     "encode_budget": PROD.cache.encode_budget}}
    return cfg, log, store, lcfg, cuts


def central_loss(params, cfg, batch, neg_idx):
    """The central rung's loss: encode the merged set once and predict
    only each user's last click (``ar_loss`` over a masked history, as
    ``benchmarks/speedup.py`` writes it; ``neg_idx`` [B, L-1, n_neg])."""
    emb = core.buslm_encode(params["plm"], cfg.plm, batch["news_tokens"],
                            batch["news_freq"])
    emb = emb * (batch["news_ids"] != 0)[:, None].to(emb.dtype)
    theta = emb[batch["hist_inv"]]
    mask = batch["hist_mask"]
    mu = core.attentive_user(params["user"], theta, mask)[:, None, :]
    mu = mu.expand_as(theta)
    # keep only the final transition per user
    last = mask.sum(1) - 1
    lmask = (torch.arange(mask.shape[1] - 1, device=mask.device)[None, :]
             == (last - 1)[:, None])
    keep = torch.cat([torch.ones_like(lmask[:, :1]), lmask], dim=1)
    return core.ar_loss(mu, theta, mask & keep, emb, batch["news_ids"],
                        neg_idx, hist_inv=batch["hist_inv"])


def _on(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if not k.startswith("_")}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def run(config: str = "bench", *, device="cuda", warmup: int = 2,
        iters: int = 5):
    """-> (rows, info): rows are ``(name, us, factor)`` in the JAX
    benchmark's order; info holds what they are read from."""
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r}; have {CONFIGS}")
    dev = check_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    if config == "bench":
        cfg = bench_cfg()
        _, log, _, lcfg, store = bench_corpus(cfg)
        cuts = {}
    else:
        cfg, log, store, lcfg, cuts = prod_setup()
    B, L = cfg.batch_users, cfg.hist_len

    def timed(fn):
        return time_fn(fn, device=dev, warmup=warmup, iters=iters)

    def fresh(c=cfg):
        gen = torch.Generator(device=dev).manual_seed(0)
        params = core.init_speedyfeed(gen, c)
        return params, optim.adam_init(params)

    rows = []
    # ---- (a) conventional: encode every history slot per instance
    conv_raw = conventional_batch_from_log(cfg, log, store, lcfg)
    conv = _on(conv_raw, dev)
    params, opt = fresh()
    conv_step = make_conventional_step(cfg)
    t_conv = timed(lambda: conv_step(params, opt, conv))
    cost_conv = t_conv / B
    rows.append(("speedup/conventional_us_per_click", cost_conv * 1e6, 1.0))
    n_conv_news = conv["hist_tokens"].shape[0] * (
        conv["hist_tokens"].shape[1] + conv["cand_tokens"].shape[1])
    del conv, params, opt

    # ---- (b) + centralized encoding (dedup, no cache, one prediction)
    cen_raw = centralized_batch_from_log(cfg, log, store, lcfg)
    cen = _on(cen_raw, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    neg = core.sample_negatives(gen, cfg.merged_cap,
                                cen["hist_mask"][:, 1:].shape, cfg.n_neg)
    params, opt = fresh()
    central_step = optim.make_train_step(
        lambda p, b: central_loss(p, cfg, b, neg), SF_OPT)
    central_out = {}
    t_central = timed(lambda: central_out.update(
        m=central_step(params, opt, cen)[2]))
    cost_central = t_central / B
    rows.append(("speedup/central_batch_factor", t_central * 1e6,
                 cost_conv / cost_central))
    del params, opt

    # ---- (c) + cache (fixed encode budget; warm cache)
    params, opt = fresh()
    cache = core.init_cache(cfg.cache, dev)
    sf_step = make_sf_train_step(cfg)
    for i in range(4):   # warm the cache and p_t
        params, opt, cache, sf_m = sf_step(params, opt, cache, 100 + i,
                                           gen, cen)
    n_pred = int(sf_m["n_predictions"])
    t_speedy = timed(lambda: sf_step(params, opt, cache, 200, gen, cen))
    clicks_ar = B * (L - 1)
    cost_speedy = t_speedy / clicks_ar
    del opt, cache

    # cache factor in isolation: the encode budget vs the whole merged set
    def enc(p, c, t, f=None):
        with torch.inference_mode():
            return core.buslm_encode(p["plm"], c.plm, t, f)

    t_enc_full = timed(lambda: enc(params, cfg, cen["news_tokens"],
                                   cen["news_freq"]))
    E = cfg.cache.encode_budget
    t_enc_budget = timed(lambda: enc(params, cfg, cen["news_tokens"][:E],
                                     cen["news_freq"][:E]))
    rows.append(("speedup/cache_encode_factor", t_enc_budget * 1e6,
                 t_enc_full / t_enc_budget))

    # ---- (d) autoregressive factor: clicks per encode pass
    rows.append(("speedup/autoregressive_us_per_click", cost_speedy * 1e6,
                 cost_central / cost_speedy))

    # ---- (e) BusLM: K segments vs one sequence of K*S tokens, E news
    K, S = cfg.plm.n_segments, cfg.plm.seg_len
    cfg1 = dataclasses.replace(cfg, plm=dataclasses.replace(
        cfg.plm, n_segments=1, seg_len=K * S))
    p1, _ = fresh(cfg1)
    gen = torch.Generator(device=dev).manual_seed(0)
    toks1 = torch.randint(1, cfg.plm.vocab, (E, 1, K * S), generator=gen,
                          device=dev)
    toks3 = torch.randint(1, cfg.plm.vocab, (E, K, S), generator=gen,
                          device=dev)
    t_k1 = timed(lambda: enc(p1, cfg1, toks1))
    t_k3 = timed(lambda: enc(params, cfg, toks3))
    rows.append(("speedup/buslm_factor", t_k3 * 1e6, t_k1 / t_k3))

    overall = cost_conv / cost_speedy
    rows.append(("speedup/overall_vs_conventional", t_speedy * 1e6, overall))

    info = {
        "config": config, "device": str(dev), "warmup": warmup,
        "iters": iters, "cuts": cuts,
        # the synthetic corpus and log are numpy Generator draws, whose
        # streams numpy does not hold fixed from one version to the next
        "numpy": np.__version__,
        "shape": {"layers": cfg.plm.n_layers, "d_model": cfg.plm.d_model,
                  "heads": cfg.plm.n_heads, "K": K, "S": S,
                  "news_dim": cfg.plm.news_dim, "remat": cfg.plm.remat,
                  "users": B, "hist_len": L, "merged_cap": cfg.merged_cap,
                  "encode_budget": E, "n_unique":
                  cen_raw["_stats"]["n_unique"]},
        "s": {"conventional_step": t_conv, "central_step": t_central,
              "speedyfeed_step": t_speedy, "encode_merged": t_enc_full,
              "encode_budget": t_enc_budget, "encode_k1": t_k1,
              "encode_k3": t_k3},
        # E >= n_unique: every step re-encodes every unique news, so the
        # cache is never read and the cache factor compares E rows with
        # merged_cap rows, pads included
        "encode_covers_merged_set":
            E >= cen_raw["_stats"]["n_unique"],
        "conventional_news_per_step": n_conv_news,
        "conventional_data_efficiency":
            conv_raw["_stats"]["data_efficiency"],
        "central_data_efficiency": cen_raw["_stats"]["data_efficiency"],
        "central_n_predictions": int(central_out["m"]["n_predictions"]),
        # the AR row divides by B*(L-1), which assumes full histories; the
        # step's own count of valid predictions, and the cost of each
        "ar_clicks_assumed": clicks_ar,
        "ar_n_predictions": n_pred,
        "ar_us_per_valid_prediction": t_speedy / max(n_pred, 1) * 1e6,
    }
    if dev.type == "cuda":
        info["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        info["card"] = _card()
        info["kind"] = torch.cuda.get_device_name(dev)
    return rows, info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=CONFIGS, default="bench")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSONL of the printed lines")
    args = ap.parse_args(argv)
    rows, info = run(args.config, device=args.device, warmup=args.warmup,
                     iters=args.iters)
    lines = [json.dumps({"name": n, "us": us, "factor": f})
             for n, us, f in rows] + [json.dumps(info)]
    for ln in lines:
        print(ln, flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(lines) + "\n")
    return rows, info


if __name__ == "__main__":
    main()
