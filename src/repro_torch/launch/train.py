"""Train SpeedyFeed (Algorithm 1) end to end, and the configuration and
corpus helpers the launchers share.

  python -m repro_torch.launch.train --steps 200 [--seed 0] [--device cuda]
      [--ckpt-dir ckpt --ckpt-every 50] [--max-restarts 2]
      [--chaos-crash-at STEP] [--metrics-out metrics.jsonl] [--mesh data=N]
  python -m repro_torch.launch.train --arch dimenet [--device cpu]

``--arch`` names an architecture of the registry (``configs.get_arch``;
``speedyfeed`` by default). Any other name runs that arch's reduced-config
smoke train on the device and prints its metrics.

``train_speedyfeed`` runs the registry's ``"speedyfeed"`` Trainer over the
DynamicBatcher (two loader threads, work stealing) on a synthetic
Microsoft-News-like corpus, through the async device prefetcher. It runs
on the card unless ``device="cpu"`` is asked for. With ``ckpt_dir`` it
checkpoints the state (the JAX package's format) and resumes from the
newest valid step on boot; ``max_restarts > 0`` runs it under
``resilience.fit_supervised``.

``--mesh data=N`` trains data-parallel on N ranks (``launch.mesh.
run_on_mesh``): one card each (``cuda:0`` .. ``cuda:N-1``, over NCCL;
fewer cards than N exit), or N gloo processes with ``--device cpu``.
Every rank runs the same fit; rank 0 loads, prints and checkpoints.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs, core, data, obs, training
from repro_torch.device import check_device
from repro_torch.launch.mesh import parse_mesh_arg, run_on_mesh
from repro_torch.resilience import FaultPlan, faults, fit_supervised


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


def train_speedyfeed(*, steps: int, ckpt_dir: str | None = None,
                     ckpt_every: int = 50, seed: int = 0, cfg=None,
                     fail_at: int | None = None, log_every: int = 20,
                     async_ckpt: bool = True, prefetch_depth: int = 2,
                     max_restarts: int = 0, backoff_s: float = 0.05,
                     device="cuda", mesh=None) -> training.TrainResult:
    """Train end to end at ``cfg`` (the small configuration unless given)
    on ``make_loader``'s corpus. ``fail_at`` injects a crash (restart
    tests). ``mesh``: this rank's mesh (every rank of ``run_on_mesh``
    calls this; the device is the rank's).

    ``max_restarts > 0`` runs the loop under ``fit_supervised``: a
    transient crash (injected fault, lost batch, non-finite-loss bailout)
    restarts from the latest valid checkpoint with backoff, up to
    ``max_restarts`` times."""
    device = check_device(device if mesh is None else mesh.device)
    cfg = cfg or small_speedyfeed_config()
    _, log, store, lcfg = make_loader(cfg, seed=seed)
    trainer = training.get_trainer("speedyfeed", cfg=cfg, device=device,
                                   mesh=mesh)

    def make_batcher(epoch: int):
        return data.DynamicBatcher(log, store, lcfg, n_threads=2,
                                   seed=seed + 1_000_003 * epoch).start()

    fit_kw = dict(seed=seed, ckpt_every=ckpt_every, async_ckpt=async_ckpt,
                  log_every=log_every, fail_at=fail_at,
                  prefetch_depth=prefetch_depth)
    if max_restarts > 0:
        return fit_supervised(trainer, make_batcher, steps=steps,
                              ckpt_dir=ckpt_dir, max_restarts=max_restarts,
                              backoff_s=backoff_s, **fit_kw)
    return trainer.fit(make_batcher, steps=steps, ckpt_dir=ckpt_dir,
                       **fit_kw)


def _summary(res: training.TrainResult) -> dict:
    return {"steps_done": res.steps_done, "losses": res.losses,
            "wall_seconds": res.wall_seconds,
            "bucket_steps": res.bucket_steps,
            "host_stall_fraction": res.host_stall_fraction,
            "restarts": res.restarts, "resumed_from": res.resumed_from}


def _train_rank(mesh, kw: dict, metrics_out, metrics_every: float,
                chaos_crash_at):
    """One rank of ``main``'s ``--mesh`` run: the same fit in every rank;
    rank 0 keeps the metrics file."""
    obs.reset()
    if metrics_out and mesh.rank == 0:
        obs.configure_reporter(path=metrics_out, every_s=metrics_every)
    if chaos_crash_at is not None:
        faults.arm(FaultPlan().fail("train.step", step=[chaos_crash_at]))
    try:
        res = train_speedyfeed(mesh=mesh, **kw)
    finally:
        faults.disarm()
    if metrics_out and mesh.rank == 0:
        obs.tick(force=True)
    return _summary(res)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="speedyfeed",
                    help="architecture id (configs.list_archs()); any "
                         "other than speedyfeed runs its reduced smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here, and resume from its newest "
                         "valid step on boot (a JAX run's too)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics-out", default=None,
                    help="append obs-registry JSONL snapshots here "
                         "(periodic + one final)")
    ap.add_argument("--metrics-every", type=float, default=10.0,
                    help="periodic snapshot cadence, seconds")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="supervise the run: restart from the latest valid "
                         "checkpoint up to N times on transient failures")
    ap.add_argument("--chaos-crash-at", type=int, default=None, metavar="STEP",
                    help="fault injection: crash the step loop ONCE at STEP "
                         "(fires through repro_torch.resilience.faults, so "
                         "the restarted attempt runs through); pair with "
                         "--max-restarts to smoke-test auto-resume")
    ap.add_argument("--mesh", default=None, metavar="data=N",
                    help="train data-parallel on N ranks: one card each "
                         "(cuda:0..N-1, NCCL), or N gloo processes with "
                         "--device cpu (data=1 / omitted: one process)")
    args = ap.parse_args(argv)
    if args.arch != "speedyfeed":
        arch = configs.get_arch(args.arch)
        print(f"running reduced-config smoke train for {args.arch}")
        metrics = arch.smoke(device=args.device)
        print(metrics)
        return metrics
    mesh = parse_mesh_arg(args.mesh, args.device)
    if mesh is not None:
        kw = dict(steps=args.steps, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, seed=args.seed,
                  max_restarts=args.max_restarts)
        res = run_on_mesh(_train_rank, mesh.world, mesh.devices, args=(
            kw, args.metrics_out, args.metrics_every,
            args.chaos_crash_at))[0]
        print(f"done on {mesh.world} ranks: {res['steps_done']} steps in "
              f"{res['wall_seconds']:.1f}s; losses {res['losses']}")
        return res
    obs.reset()      # this run's registry export is exactly this run
    if args.metrics_out:
        obs.configure_reporter(path=args.metrics_out,
                               every_s=args.metrics_every)
    if args.chaos_crash_at is not None:
        faults.arm(FaultPlan().fail("train.step", step=[args.chaos_crash_at]))
    try:
        res = train_speedyfeed(steps=args.steps, ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every, seed=args.seed,
                               max_restarts=args.max_restarts,
                               device=args.device)
    finally:
        faults.disarm()
    loss = (f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; "
            if res.losses else "no new steps (already trained); ")
    print(f"done: {res.steps_done} steps in {res.wall_seconds:.1f}s; " + loss
          + f"buckets {res.bucket_steps}; host stall "
          f"{res.host_stall_fraction:.1%}"
          + (f" (restarts {res.restarts})" if res.restarts else "")
          + (f" (resumed from {res.resumed_from})"
             if res.resumed_from is not None else ""))
    if args.metrics_out:
        obs.tick(force=True)
        print(f"metrics snapshot -> {args.metrics_out}")
    return res


if __name__ == "__main__":
    main()
