"""Where the serve and train slices' time goes on the card, and where
the serve slice's recall goes.

    python -m repro_torch.launch.profile [--news 16384] \
        [--out chiprun_out/profile_serve.json]
    python -m repro_torch.launch.profile --train [--out PATH]
    python -m repro_torch.launch.profile --lm [--out PATH]
    python -m repro_torch.launch.profile --lm-train [--out PATH]
    python -m repro_torch.launch.profile --recsys [--out PATH]

Builds the slice ``chip_smoke.py`` drives (the production PLM with seeded
random weights, a ``make_loader`` corpus, IVF-PQ with nlist from the
corpus size, nprobe 16, k' 64) on the GPU, then:

* ``torch.profiler`` over one encode chunk of 256 news and over four query
  batches of 16: device time by kernel name, and the device's busy share
  of the window's wall time;
* a recall@10 decomposition on 64 probe users against exact MIPS over the
  store: probe coverage (share of the exact top-10 whose cell is probed),
  ADC recall at k' in {64, 256, 1024} (share of the exact top-10 among the
  k' best ADC candidates), and the served recall@10 — for IVF-PQ and for
  IVF-Flat over the same embeddings.

With ``--train`` it instead profiles one Algorithm-1 step at PROD (the
``"speedyfeed"`` Trainer, E=4096, remat on) on the first batch of the top
seg-length bucket that the DynamicBatcher builds at the paper's token
budget: device time by kernel name and the device's busy share, printed
(and written to ``--out`` when it is given).

With ``--lm`` it instead profiles the LM family's serving path: Qwen3-14B
at full width and depth in bf16 with seeded random weights, one prefill
of B=1, S=32,768 and one decode step at B=16 against an 8,192-slot
bf16 KV cache (after one warm call each): device time by kernel name and
the device's busy share, printed and written to ``--out`` (default
``chiprun_out/profile_lm.json``).

With ``--lm-train`` it instead profiles the LM family's training path:
one train step of Qwen3-14B at full width and 8 of its 40 layers (bf16
parameters, f32 moments, seeded random weights, B=2 at train_4k's
S=4,096: ``chip_smoke.py``'s lm-train shape) through ``make_fn(cfg,
"train")``, after one warm step: device time by kernel name and the
device's busy share, with each flash kernel that ran (forward and
backward, Hopper and SIMT) named apart (calls, device ms, share of the
step), printed and written to ``--out`` (default
``chiprun_out/profile_lm_train.json``).

With ``--recsys`` it instead profiles the recsys family's serving path:
one DLRM-RM2 ``serve_bulk`` forward (B=262,144) at full width (the fused
32,710,656 x 64 f32 table, seeded random weights, a ``recsys_synth``
batch) after one warm call: device time by kernel name and the device's
busy share, printed and written to ``--out`` (default
``chiprun_out/profile_recsys.json``).

With ``--recall-repeat`` it instead studies where the spread of recall@10
between runs comes from (``recall_repeat``), and writes the corpus
embeddings and the probe users' vectors to ``--vectors-out`` (an .npz that
``tests/test_torch_serving.py`` reads from ``REPRO_RECALL_VECTORS`` to
hold the port's build against the JAX package's on the same vectors).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import time
import warnings

import numpy as np
import torch

from repro_torch import core, data, optim, serving, training
from repro_torch.configs import PROD, lm_family, recsys_family
from repro_torch.kernels import ops
from repro_torch.launch.serve import Recommender, _pad_histories
from repro_torch.launch.train import first_batch_of_bucket, make_loader
from repro_torch.data import recsys_synth
from repro_torch.models import lm
from repro_torch.models.recsys import ctr
from repro_torch.serving.index import _probe_cells, _search_pq_csr
from repro_torch.serving.pq import PQCodebook, pq_decode


# the flash kernels by the names their CUDA functions carry in a profile
# (each a template instance, so its name holds <D>): forward and backward,
# Hopper and SIMT routes
FLASH_NAMES = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
               "flash_bwd_dkv_wgmma_kernel", "flash_fwd_kernel",
               "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def _kernel_table(prof, wall_s: float, top: int = 16) -> dict:
    """Device time by kernel name from a profile, and the busy share;
    each flash kernel that ran (FLASH_NAMES) also apart, with its calls,
    device ms and share of the wall time, whether or not it is among the
    ``top``."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    out = {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / 1e6 / wall_s if wall_s else 0.0,
           "kernels": [{"name": k[:90], "calls": n, "device_ms": us / 1e3}
                       for us, n, k in rows[:top]]}
    out["named"] = {}
    for part in FLASH_NAMES:
        hit = [(us, n) for us, n, k in rows if f"{part}<" in k]
        if hit:
            ms = sum(us for us, _ in hit) / 1e3
            out["named"][part] = {
                "calls": sum(n for _, n in hit), "device_ms": ms,
                "share_of_wall": ms / 1e3 / wall_s if wall_s else 0.0}
    return out


def _profiled(fn, top: int = 16) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()                                       # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _kernel_table(prof, wall, top)


def profile_train_step(log, store, lcfg, dev) -> dict:
    """``torch.profiler`` over one PROD train step (after one warm step) on
    the first top-bucket batch at the paper's token budget."""
    lcfg = dataclasses.replace(lcfg,
                               token_budget=data.LoaderConfig.token_budget)
    top = max(lcfg.buckets)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             first_batch_of_bucket(log, store, lcfg, top).items()
             if not k.startswith("_")}
    trainer = training.get_trainer("speedyfeed", cfg=PROD, device=dev)
    state = [trainer.init_state(0)]

    def step():
        state[0], _ = trainer.step(state[0], batch, top)

    out = _profiled(step)
    out["bucket"] = top
    return out


def profile_lm(dev) -> dict:
    """``torch.profiler`` over one Qwen3-14B prefill of B=1 at
    ``prefill_32k``'s sequence and one decode step at B=16 against an
    8,192-slot bf16 cache (the smoke's shapes), each after one warm
    call."""
    cfg = lm_family.QWEN3_14B
    seq = lm_family.LM_SHAPES["prefill_32k"]["seq"]
    decode_batch, slots = 16, 8192
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    prefill = lm_family.make_fn(cfg, "prefill")
    decode = lm_family.make_fn(cfg, "decode")
    toks = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=dev)
    out = {"prefill": _profiled(lambda: prefill(params, toks))}
    out["prefill"].update(batch=1, seq=seq)
    del toks
    cache = lm.init_cache(cfg, decode_batch, slots, torch.bfloat16,
                          device=dev)
    tok = torch.randint(0, cfg.vocab, (decode_batch, 1), generator=gen,
                        device=dev)
    out["decode_step"] = _profiled(lambda: decode(params, tok, cache, 0))
    out["decode_step"].update(batch=decode_batch, slots=slots)
    return out


def profile_lm_train(dev) -> dict:
    """``torch.profiler`` over one Qwen3-14B train step at full width and
    ``lm_family.ONE_CARD_TRAIN``'s depth and batch at ``train_4k``'s
    sequence (the smoke's shape), after one warm step."""
    cut = lm_family.ONE_CARD_TRAIN
    cfg = dataclasses.replace(lm_family.QWEN3_14B, n_layers=cut["n_layers"])
    seq = lm_family.LM_SHAPES["train_4k"]["seq"]
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     torch.bfloat16)
    state = [params, optim.adam_init(params)]
    train_batch = lm_family.train_batch(
        cfg, cut["batch"], seq, torch.Generator(device=dev).manual_seed(4),
        dev)
    step = lm_family.make_fn(cfg, "train")

    def run():
        state[0], state[1], _ = step(state[0], state[1], train_batch)

    out = _profiled(run, top=24)
    out.update(layers=cfg.n_layers, batch=cut["batch"], seq=seq,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def profile_recsys(dev) -> dict:
    """``torch.profiler`` over one DLRM-RM2 forward at ``serve_bulk``'s
    batch (the smoke's shape), after one warm call."""
    cfg = recsys_family.DLRM_RM2
    B = recsys_family.RS_SHAPES["serve_bulk"]["batch"]
    params = ctr.init(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = recsys_synth.ctr_batch(
        np.random.default_rng(7), batch=B, n_dense=cfg.n_dense,
        vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz, device=dev)
    serve = recsys_family.make_fn(cfg, "serve", device=dev)
    out = _profiled(lambda: serve(params, batch))
    out.update(config=cfg.name, batch=B)
    return out


def _print_table(name: str, r: dict):
    print(f"{name}: wall {r['wall_ms']:.3f} ms, device busy "
          f"{r['device_busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%)")
    for kern in r["kernels"]:
        print(f"   {kern['device_ms']:9.3f} ms  x{kern['calls']:<5} "
              f"{kern['name']}")
    for part, kern in r["named"].items():
        print(f"   {part}: {kern['device_ms']:.3f} ms x{kern['calls']}, "
              f"{100 * kern['share_of_wall']:.1f}% of the wall time")


def _cells_of(snap, n_rows: int):
    """news id -> its IVF cell (-1 where absent), on the device."""
    cap = snap.list_ids.shape[1]
    live = torch.arange(cap, device=snap.device)[None] < snap.lens[:, None]
    cells = torch.arange(snap.list_ids.shape[0],
                         device=snap.device)[:, None].expand(-1, cap)
    out = torch.full((n_rows,), -1, dtype=torch.long, device=snap.device)
    out[snap.list_ids[live].long()] = cells[live]
    return out


def _hit_share(found, truth) -> float:
    """Mean share of each row of ``truth`` [B, k] present in ``found``."""
    return float((truth[:, :, None] == found[:, None, :]).any(-1)
                 .float().mean())


@torch.inference_mode()
def pq_distortion(snap, store) -> float:
    """Share of the residual energy an IVF-PQ snapshot's codes lose:
    sum ||r - decode(code)||^2 / sum ||r||^2 over its members, where
    r = x - mean[cell]. It is what PQ training minimises, averaged over
    every member, so it moves far less between builds than recall@10 on
    a few users does. ``store``: [n, d] vectors by id, on the snapshot's
    device."""
    cap = snap.list_ids.shape[1]
    live = torch.arange(cap, device=snap.device)[None] < snap.lens[:, None]
    cells = torch.arange(snap.list_ids.shape[0], device=snap.device)
    r = store[snap.list_ids[live].long()] \
        - snap.cent_raw[cells[:, None].expand(-1, cap)[live]]
    err = r - pq_decode(PQCodebook(snap.pq_centers, snap.pq_rot),
                        snap.payload[live])
    return float((err * err).sum() / (r * r).sum())


@torch.inference_mode()
def recall_breakdown(rec: Recommender, snap, user, k: int = 10) -> dict:
    store = rec.service.store.emb
    scores = user @ store.T
    live = (store != 0).any(dim=1)
    live[0] = False
    truth = torch.topk(scores.masked_fill(~live, float("-inf")), k).indices
    probes = _probe_cells(user, snap.cent_unit, snap.cent_raw, snap.nprobe,
                          snap.metric)
    cell = _cells_of(snap, store.shape[0])[truth]            # [B, k]
    out = {"kind": snap.kind, "nprobe": snap.nprobe,
           "nlist": int(snap.list_ids.shape[0]),
           "probe_coverage": float((cell[:, :, None] == probes[:, None, :])
                                   .any(-1).float().mean())}
    if snap.kind == "ivf-pq":
        for kp in (64, 256, 1024):
            _, cand = _search_pq_csr(
                user, snap.cent_unit, snap.cent_raw, snap.list_ids,
                snap.payload, snap.lens, snap.pq_centers, snap.pq_rot,
                nprobe=snap.nprobe, k=kp, metric=snap.metric)
            out[f"adc_recall_at_kprime_{kp}"] = _hit_share(cand, truth)
    _, served = snap.search(user, k)
    out["snapshot_recall_at_10"] = _hit_share(served, truth)
    return out


def _exact_top(store, user, k: int = 10):
    """Exact-MIPS top-k ids over the live store rows (measure_recall's
    oracle)."""
    live = (store != 0).any(dim=1)
    live[0] = False
    return torch.topk((user @ store.T).masked_fill(~live, float("-inf")),
                      k).indices


def recall_repeat(emb, user, *, seeds=range(8), repeats: int = 3,
                  small_probe: int = 16, device="cuda") -> dict:
    """Where the spread of recall@10 between runs comes from: IVF-PQ builds
    of the same embeddings (the serve slice's settings), served to the
    same users.

    * seed 0, ``repeats`` times on ``device`` with PyTorch's default
      ``index_add_`` (atomic adds, whose order varies), then ``repeats``
      times under ``torch.use_deterministic_algorithms``: does the
      snapshot, and with it the recall, repeat bit for bit?
    * seed 0, twice on the CPU (sums in a fixed order);
    * each of ``seeds`` once on the card: the spread of recall over
      quantizer draws, against which the run-to-run spread is read.

    Recall is given over all users and over the first ``small_probe``
    (the probe ``chip_smoke.py`` measures), beside ``pq_distortion``."""
    truth = _exact_top(emb, user).cpu().numpy()
    first = {}

    def build(tag, device, seed, deterministic):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rec = Recommender(PROD, {}, None, k=10, index_kind="ivf-pq",
                                  nprobe=16, k_prime=64, device=device)
                t0 = time.perf_counter()
                svc = rec.build_index_from(emb.to(device), seed=seed)
                build_s = time.perf_counter() - t0
                _, got = svc.query(user.to(device), 10)
        finally:
            torch.use_deterministic_algorithms(False)
        snap = svc.snapshot()
        arrays = [snap.cent_unit, snap.cent_raw, snap.list_ids, snap.payload,
                  snap.lens, snap.pq_centers]
        ref = first.setdefault((str(device), seed, deterministic), arrays)
        hits = np.array([len(set(g) & set(t)) / truth.shape[1]
                         for g, t in zip(got, truth)])
        return {"build": tag, "device": str(device), "seed": seed,
                "deterministic": deterministic, "build_s": build_s,
                "same_snapshot_as_first": all(
                    torch.equal(a.cpu(), b.cpu()) for a, b in zip(arrays, ref)),
                "recall_at_10": float(hits.mean()),
                f"recall_at_10_first_{small_probe}":
                    float(hits[:small_probe].mean()),
                "pq_distortion": pq_distortion(snap, svc.store.emb),
                "warnings": sorted({str(w.message)[:160] for w in caught})}

    rows = [build(f"default-{i}", device, 0, False) for i in range(repeats)]
    rows += [build(f"deterministic-{i}", device, 0, True)
             for i in range(repeats)]
    rows += [build(f"cpu-{i}", "cpu", 0, False) for i in range(2)]
    rows += [build(f"seed-{s}", device, s, False) for s in seeds if s]
    draws = [r["recall_at_10"] for r in rows
             if r["build"] == "default-0" or r["build"].startswith("seed-")]
    return {"users": int(user.shape[0]), "builds": rows,
            "seed_spread": {"min": min(draws), "max": max(draws),
                            "mean": float(np.mean(draws))}}


def _write(path: str, report: dict):
    out = pathlib.Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--news", type=int, default=16384)
    ap.add_argument("--out", default=None, help="report JSON (default "
                    "chiprun_out/profile_serve.json, or recall_repeat.json)")
    ap.add_argument("--train", action="store_true",
                    help="profile one PROD train step instead")
    ap.add_argument("--lm", action="store_true",
                    help="profile one Qwen3-14B prefill and decode step")
    ap.add_argument("--lm-train", action="store_true",
                    help="profile one Qwen3-14B train step (8 layers)")
    ap.add_argument("--recsys", action="store_true",
                    help="profile one DLRM-RM2 serve_bulk forward")
    ap.add_argument("--recall-repeat", action="store_true",
                    help="run only the recall-repeat study")
    ap.add_argument("--vectors-out", default="chiprun_out/recall_vectors.npz")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile measures the GPU; none is present")
    if args.recall_repeat:
        # cuBLAS repeats its sums only with a fixed workspace, which must be
        # set before its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ops.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.lm:
        report = {"card": card, **profile_lm(dev)}
        _write(args.out or "chiprun_out/profile_lm.json", report)
        for name in ("prefill", "decode_step"):
            _print_table(name, report[name])
        print(card)
        return report
    if args.lm_train:
        report = {"card": card, "train_step": profile_lm_train(dev)}
        _write(args.out or "chiprun_out/profile_lm_train.json", report)
        _print_table("lm train step", report["train_step"])
        print(card)
        return report
    if args.recsys:
        report = {"card": card, "serve_bulk": profile_recsys(dev)}
        _write(args.out or "chiprun_out/profile_recsys.json", report)
        _print_table("dlrm-rm2 serve_bulk", report["serve_bulk"])
        print(card)
        return report
    _, log, store, lcfg = make_loader(PROD, n_news=args.news, seed=0)
    if args.train:
        report = {"card": card, "train_step": profile_train_step(
            log, store, lcfg, dev)}
        if args.out:
            _write(args.out, report)
        _print_table("train step", report["train_step"])
        print(card)
        return report
    params = core.init_speedyfeed(
        torch.Generator(device=dev).manual_seed(0), PROD)
    rec = Recommender(PROD, params, store, k=10, index_kind="ivf-pq",
                      nprobe=16, k_prime=64, device=dev)
    emb = rec._encode_corpus()
    svc = rec.build_index_from(emb)
    report = {"card": card, "news": int(emb.shape[0])}
    hist, mask = _pad_histories(rec, log.histories[:64], 64)
    user = rec.encode_users(hist, mask)
    if args.recall_repeat:
        report["recall_repeat"] = recall_repeat(emb, user)
        vec = pathlib.Path(args.vectors_out)
        vec.parent.mkdir(parents=True, exist_ok=True)
        np.savez(vec, emb=emb.cpu().numpy(), user=user.cpu().numpy(),
                 nlist=svc.builder.ivf.nlist, nprobe=svc.builder.ivf.nprobe,
                 metric=svc.builder.ivf.metric, k_prime=svc.k_prime)
        _write(args.out or "chiprun_out/recall_repeat.json", report)
        for r in report["recall_repeat"]["builds"]:
            print("build: " + json.dumps(r))
        print("seed spread: "
              + json.dumps(report["recall_repeat"]["seed_spread"]))
        print(card)
        return report

    toks = torch.as_tensor(store.tokens[1:257], device=dev).long()
    freq = torch.as_tensor(store.freq[1:257], device=dev).long()
    with torch.inference_mode():
        report["encode_chunk_256"] = _profiled(
            lambda: core.buslm_encode(rec.params["plm"], PROD.plm, toks,
                                      freq))
    batches = [_pad_histories(rec, log.histories[i:i + 16], 16)
               for i in range(0, 64, 16)]
    report["query_4x16"] = _profiled(
        lambda: [rec.recommend(h, m) for h, m in batches])

    flat = serving.IndexBuilder(
        "ivf-flat", emb.shape[1], ivf=svc.builder.ivf, device=dev).build(
        torch.arange(1, emb.shape[0]).numpy(), emb[1:])
    report["recall"] = [recall_breakdown(rec, svc.snapshot(), user),
                        recall_breakdown(rec, flat, user)]
    _write(args.out or "chiprun_out/profile_serve.json", report)
    for name in ("encode_chunk_256", "query_4x16"):
        r = report[name]
        print(f"{name}: wall {r['wall_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms ({100 * r['busy_share']:.1f}%)")
        for kern in r["kernels"][:8]:
            print(f"   {kern['device_ms']:9.3f} ms  x{kern['calls']:<4} "
                  f"{kern['name']}")
    for r in report["recall"]:
        print("recall: " + json.dumps(r))
    print(card)
    return report


if __name__ == "__main__":
    main()
