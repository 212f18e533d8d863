"""Train SpeedyFeed (Algorithm 1) end to end, and the configuration and
corpus helpers the launchers share.

  python -m repro_torch.launch.train --steps 20 [--seed 0] [--device cuda]

``train_speedyfeed`` runs the registry's ``"speedyfeed"`` Trainer over the
DynamicBatcher (two loader threads, work stealing) on a synthetic
Microsoft-News-like corpus, through the async device prefetcher. It runs
on the card unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import core, data, training
from repro_torch.device import check_device


def small_speedyfeed_config(**over):
    base = dict(vocab=5000, n_layers=2, d_model=64, n_heads=4, d_ff=128,
                n_segments=3, seg_len=16, news_dim=32, n_news=2001,
                gamma=20, beta=2e-2, encode_budget=96, batch_users=16,
                hist_len=30, merged_cap=256, n_neg=4)
    base.update(over)
    return core.make_config(**base)


def make_loader(cfg, *, n_news=2000, n_users=400, seed=0, buckets=None,
                token_budget=4000, corpus_kw=None, log_kw=None):
    """-> (corpus, click log, news store, loader config), all from ``seed``."""
    rng = np.random.default_rng(seed)
    corpus = data.make_corpus(rng, n_news=n_news, **(corpus_kw or {}))
    log = data.make_click_log(rng, corpus, n_users=n_users,
                              max_hist=cfg.hist_len, **(log_kw or {}))
    stats = data.build_corpus_stats(
        [corpus.text(i) for i in range(corpus.n_news)])
    lcfg = data.LoaderConfig(
        vocab=cfg.plm.vocab, n_segments=cfg.plm.n_segments,
        seg_len=cfg.plm.seg_len,
        buckets=buckets or data.default_buckets(cfg.plm.seg_len),
        token_budget=token_budget, b_cap=cfg.batch_users, m_cap=cfg.merged_cap,
        hist_len=cfg.hist_len)
    store = data.NewsStore(corpus, stats, lcfg)
    return corpus, log, store, lcfg


def first_batch_of_bucket(log, store, lcfg, bucket: int, *, seed: int = 0):
    """The first centralized batch (host arrays) that a one-thread
    DynamicBatcher builds at seg-length ``bucket``; raises if the epoch has
    none."""
    batcher = data.DynamicBatcher(log, store, lcfg, n_threads=1,
                                  seed=seed).start()
    try:
        while True:
            item = batcher.get(timeout=60)
            if item is None or item is data.EPOCH_END:
                raise RuntimeError(f"no batch of bucket {bucket}")
            if item["_bucket"] == bucket:
                return item
    finally:
        batcher.stop()


def train_speedyfeed(*, steps: int, seed: int = 0, cfg=None,
                     log_every: int = 20, prefetch_depth: int = 2,
                     device="cuda") -> training.TrainResult:
    """Train end to end at ``cfg`` (the small configuration unless given)
    on ``make_loader``'s corpus."""
    device = check_device(device)
    cfg = cfg or small_speedyfeed_config()
    _, log, store, lcfg = make_loader(cfg, seed=seed)
    trainer = training.get_trainer("speedyfeed", cfg=cfg, device=device)

    def make_batcher(epoch: int):
        return data.DynamicBatcher(log, store, lcfg, n_threads=2,
                                   seed=seed + 1_000_003 * epoch).start()

    return trainer.fit(make_batcher, steps=steps, seed=seed,
                       log_every=log_every, prefetch_depth=prefetch_depth)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for")
    args = ap.parse_args(argv)
    res = train_speedyfeed(steps=args.steps, seed=args.seed,
                           device=args.device)
    loss = (f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; "
            if res.losses else "no steps run; ")
    print(f"done: {res.steps_done} steps in {res.wall_seconds:.1f}s; " + loss
          + f"buckets {res.bucket_steps}; host stall "
          f"{res.host_stall_fraction:.1%}")
    return res


if __name__ == "__main__":
    main()
