#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100
and hold its hand-written CUDA kernels against their plain PyTorch
versions.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. setup    print the card (``nvidia-smi``), turn TF32 off, build both
              kernel libraries from ``src/repro_torch/kernels/csrc`` with
              nvcc, in parallel.
  2. slice    the serve path at full width: the production PLM (12
              layers, d 768, 12 heads, d_ff 3072, vocab 30720, K=3, S=32,
              news_dim 768, random weights from a seeded generator) over a
              16,384-news corpus: the two halves of
              ``Recommender.build_index`` timed apart (``_encode_corpus``,
              then ``build_index_from``: the IVF-PQ build), a warm-up
              batch, 128 requests in batches of 16 through
              ``micro_batch_loop``, and ``measure_recall`` on a probe of
              16. The kernels' launch counts are set to 0 just before and
              read just after; both serve kernels must have risen.
  3. index    the served IVF-PQ build against the same build of the same
              embeddings on the CPU: the share of residual energy the PQ
              codes lose (``launch.profile.pq_distortion``) within 0.01.
  4. plain    re-run the encode of 512 news with the plain bus attention
              on the card (embeddings within 5e-4), and redo one query
              batch's two stages with the plain LUT scan on the inputs the
              served IVF-PQ search gathers (equal top-k id sets).
  5. train    Algorithm 1 at PROD, full width and depth (E=4096 encoded
              news per step, remat on): ``Trainer.fit`` for 4 steps over
              the DynamicBatcher on the slice's store with the paper's
              token budget of 39,800. Finite losses, moved parameters,
              cache rows written = news encoded, and launch counts of
              exactly 2 x 12 x steps forward (remat runs it twice) and
              12 x steps backward bus kernels. Then 3 synchronised
              ``Trainer.step`` calls on one top-bucket batch: s/step,
              encoded rows/s, peak device memory.
  6. plain    one train step at PROD widths with E cut to 256, through the
     (train) kernels and through the plain path on the same parameters,
              batch and draws: loss within 1e-4, every gradient leaf
              within 1e-3 of that leaf's largest magnitude.
  7. kernels  each kernel against its plain version at the main paths'
              shapes, timed with CUDA events beside its bound and, for
              the bus kernels, ``F.scaled_dot_product_attention`` (its
              forward, its backward) as a yardstick.

The line before the last holds the card's name and power limit, the one
before it the per-kernel JSON; the last line is the ``{"ok": true, ...}``
object. Details also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12           # f32 outside the tensor cores
N_NEWS = 16384
N_REQUESTS = 128
BATCH = 16
TOL_BUS, TOL_PQ, TOL_ENCODE = 2e-4, 1e-5, 5e-4
TOL_DISTORTION = 0.01            # share of residual energy PQ codes lose
TOL_BWD = 1e-4                   # backward kernel vs plain, f32
TOL_LOSS, TOL_GRAD = 1e-4, 1e-3  # train step, kernel vs plain path
TRAIN_STEPS, TIMED_STEPS, PLAIN_E = 4, 3, 256


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events).

    A large matrix product is queued first, so that the timed launches
    are all enqueued while the device is still busy with it: the events
    then measure the device running them back to back, not the host's
    launch rate (which would dominate for a kernel of a few µs)."""
    for _ in range(warmup):
        fn()
    filler = torch.ones(8192, 8192, device="cuda")
    torch.cuda.synchronize()
    torch.mm(filler, filler)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import numpy as np
    from repro_torch import core, data, serving, training
    from repro_torch.configs import PROD
    from repro_torch.kernels import ops
    from repro_torch.kernels.bus_attention import (bus_attention_bwd_cuda,
                                                   bus_attention_bwd_plain,
                                                   bus_attention_cuda,
                                                   bus_attention_plain)
    from repro_torch.kernels.pq_scoring import (pq_lut_scores_cuda,
                                                pq_lut_scores_plain)
    from repro_torch.launch.profile import pq_distortion
    from repro_torch.launch.serve import (Recommender, _pad_histories,
                                          measure_recall, micro_batch_loop)
    from repro_torch.launch.train import first_batch_of_bucket, make_loader
    from repro_torch.optim.adam import leaves
    from repro_torch.serving.index import (_masked_topk, _pq_scan_inputs,
                                           _topk_padded)

    report = {}
    # ------------------------------------------------------------ setup
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    logs = ops.build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {name}: {regs}", flush=True)
    print(f"kernels built in {report['build_s']:.1f} s", flush=True)

    # ------------------------------------------------------------ slice
    cfg = PROD
    t0 = time.perf_counter()
    _, log, store, serve_lcfg = make_loader(cfg, n_news=N_NEWS, seed=0)
    report["corpus_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    params = core.init_speedyfeed(gen, cfg)
    rec = Recommender(cfg, params, store, k=10, index_kind="ivf-pq",
                      nprobe=16, k_prime=64, device=dev)
    reqs = list(log.histories[:N_REQUESTS + BATCH])
    print(f"corpus: {store.tokens.shape[0]} news rows in "
          f"{report['corpus_s']:.1f} s; {len(reqs)} requests", flush=True)

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = rec._encode_corpus()
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = rec.build_index_from(emb)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    micro_batch_loop(rec, reqs[:BATCH], max_batch=BATCH)      # warm-up
    _, n_batches, lat = micro_batch_loop(rec, reqs[BATCH:], max_batch=BATCH)
    recall = measure_recall(rec, reqs[BATCH:], k=10, probe=16)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    n_rows = emb.shape[0]
    chunks = -(-n_rows // 256)
    snap = svc.snapshot()
    report["slice"] = {
        "news": n_rows, "encode_s": encode_s,
        "encode_news_per_s": n_rows / encode_s, "index_build_s": index_s,
        "nlist": int(snap.list_ids.shape[0]), "cap": snap.cap,
        "ntotal": snap.ntotal, "requests": N_REQUESTS, "batch": BATCH,
        "n_batches": n_batches,
        "query_p50_ms": float(torch.tensor(lat).quantile(0.5)),
        "query_p99_ms": float(torch.tensor(lat).quantile(0.99)),
        "recall_at_10": recall, "launches": launches,
        "expected_bus_launches": cfg.plm.n_layers * chunks}
    print("slice: " + json.dumps(report["slice"]), flush=True)
    check(tuple(emb.shape) == (N_NEWS + 1, cfg.plm.news_dim),
          f"embeddings shape {tuple(emb.shape)}")
    check(bool(torch.isfinite(emb).all()), "non-finite corpus embeddings")
    check(snap.ntotal == N_NEWS, f"index holds {snap.ntotal} of {N_NEWS}")
    check(launches["bus_attention"] == cfg.plm.n_layers * chunks,
          f"bus_attention launched {launches['bus_attention']} times, "
          f"expected {cfg.plm.n_layers * chunks}")
    check(launches["pq_lut_scores"] > 0, "pq_lut_scores never launched")
    check(0.0 < recall <= 1.0, f"recall@10 {recall}")

    # ------------------------------------------------------------ index
    # the served IVF-PQ build against the same build on the CPU, where
    # sums run in a fixed order. recall@10 on 16 users moves severalfold
    # from one build to the next (the atomic adds of index_add_ reorder);
    # the share of residual energy the PQ codes lose, a mean over every
    # vector, does not
    bld = svc.builder
    t0 = time.perf_counter()
    cpu_snap = serving.IndexBuilder(
        bld.kind, bld.dim, ivf=bld.ivf, pq=bld.pq, seed=bld.seed,
        device="cpu").build(np.arange(1, n_rows), emb[1:].cpu())
    dist = {"card": pq_distortion(snap, svc.store.emb),
            "cpu": pq_distortion(cpu_snap, emb.cpu()),
            "cpu_build_s": time.perf_counter() - t0}
    report["index"] = {"pq_distortion": dist}
    print("index: " + json.dumps(report["index"]), flush=True)
    check(abs(dist["card"] - dist["cpu"]) <= TOL_DISTORTION,
          f"PQ distortion on the card {dist['card']} vs the CPU build "
          f"{dist['cpu']}")

    # ------------------------------------------------------------ plain
    with torch.inference_mode():
        toks = torch.as_tensor(store.tokens[:512], device=dev).long()
        freq = torch.as_tensor(store.freq[:512], device=dev).long()
        plain = core.buslm_encode(rec.params["plm"], cfg.plm, toks, freq,
                                  impl="plain")
        plain[0] = 0.0                       # as _encode_corpus pads row 0
    enc_err = float((plain - emb[:512]).abs().max())
    # one query batch: the served answer against RetrievalService.query's
    # two stages redone with the plain LUT scan, on the inputs the served
    # IVF-PQ search gathers off the same snapshot
    hist, mask = _pad_histories(rec, reqs[BATCH:2 * BATCH], BATCH)
    _, ids_k = rec.recommend(hist, mask)
    check(svc.n_pending == 0, "the delta tier is not empty")
    with torch.inference_mode():
        user = rec.encode_users(hist, mask)
        lut, codes, valid, cand, coarse = _pq_scan_inputs(
            user, snap.cent_unit, snap.cent_raw, snap.list_ids, snap.payload,
            snap.lens, snap.pq_centers, snap.pq_rot, nprobe=snap.nprobe,
            metric=snap.metric)
        k_eff = min(svc.k_prime, snap.nprobe * snap.cap)
        _, cand_p = _masked_topk(pq_lut_scores_plain(lut, codes, valid)
                                 + coarse, cand, valid, k_eff)
        cand_p = cand_p.long()
        exact = torch.einsum("bd,bcd->bc", user,
                             svc.store.emb[cand_p.clamp_min(0)])
        ids_p = _topk_padded(exact, cand_p, rec.k)[1].cpu().numpy()
    same = all(set(a) == set(b) for a, b in zip(ids_k, ids_p))
    report["plain"] = {"encode_max_abs_err": enc_err, "topk_sets_equal": same}
    print("plain: " + json.dumps(report["plain"]), flush=True)
    check(enc_err <= TOL_ENCODE, f"encode differs from plain by {enc_err}")
    check(same, "top-k id sets differ between kernel and plain scans")

    # ------------------------------------------------------------ train
    # the slice's store, read by the DynamicBatcher with the paper's token
    # budget; the PROD Trainer from the registry, as a user would call it
    lcfg = dataclasses.replace(serve_lcfg,
                               token_budget=data.LoaderConfig.token_budget)
    del rec, svc
    torch.cuda.empty_cache()
    trainer = training.get_trainer("speedyfeed", cfg=cfg, device=dev)
    state = trainer.init_state(seed=0)
    watch = {p: t.detach().clone() for p, t in leaves(state.params)
             if p in ("plm/layers/0/attn/q/w", "plm/out_proj/w",
                      "user/proj/w", "plm/tok_emb/table")}

    def make_batcher(epoch):
        return data.DynamicBatcher(log, store, lcfg, n_threads=2,
                                   seed=1_000_003 * epoch).start()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    res = trainer.fit(make_batcher, steps=TRAIN_STEPS, state=state,
                      log_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_launches = ops.launch_counts()
    state = res.state
    L = cfg.plm.n_layers
    encoded = [int(x) for x in res.history["encoded"]]
    written_last = int((state.cache.written_step == state.step - 1).sum())
    written_any = int((state.cache.written_step >= 0).sum())
    now = dict(leaves(state.params))
    moved = {p: float((t - now[p].detach()).abs().max())
             for p, t in watch.items()}
    report["train"] = {
        "steps": res.steps_done, "losses": res.losses,
        "buckets": res.bucket_steps, "fit_s": res.wall_seconds,
        "encoded_per_step": encoded, "rows_written_last_step":
        written_last, "rows_written": written_any, "param_moved": moved,
        "launches": train_launches,
        "host_stall_fraction": res.host_stall_fraction}
    check(res.steps_done == TRAIN_STEPS, f"fit ran {res.steps_done} steps")
    check(all(np.isfinite(res.losses)) and len(res.losses) == TRAIN_STEPS,
          f"train losses {res.losses}")
    check(all(v > 0 for v in moved.values()), f"params did not move {moved}")
    check(written_last == encoded[-1],
          f"last step wrote {written_last} cache rows, encoded "
          f"{encoded[-1]}")
    check(0 < written_any <= sum(encoded),
          f"{written_any} cache rows written, {sum(encoded)} encoded")
    check(train_launches["bus_attention"] == 2 * L * TRAIN_STEPS,
          f"bus_attention launched {train_launches['bus_attention']} "
          f"times in training, expected {2 * L * TRAIN_STEPS}")
    check(train_launches["bus_attention_bwd"] == L * TRAIN_STEPS,
          f"bus_attention_bwd launched {train_launches['bus_attention_bwd']}"
          f" times, expected {L * TRAIN_STEPS}")

    # steady state: synchronised steps on one top-bucket batch
    top = max(lcfg.buckets)
    top_batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 first_batch_of_bucket(log, store, lcfg, top).items()
                 if not k.startswith("_")}
    step_s, enc = [], []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, top_batch, top)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        enc.append(int(m["encoded"]))
        check(bool(torch.isfinite(m["loss"])), "non-finite timed step")
    E = cfg.cache.encode_budget
    report["train"].update({
        "timed_bucket": top, "step_s": step_s,
        "s_per_step": float(np.mean(step_s)),
        "encode_rows_per_s": E / float(np.mean(step_s)),
        "valid_encoded_per_step": enc,
        "valid_encoded_per_s": float(np.mean(enc)) / float(np.mean(step_s)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_tflop_per_step": 4 * core.plm_flops(cfg.plm, E) / 1e12})
    print("train: " + json.dumps(report["train"]), flush=True)

    # ------------------------------------------------------- plain (train)
    # one step's loss and gradients, kernels against the plain path, on the
    # trained parameters, the top-bucket batch and fixed draws; E cut to 256
    pcfg = dataclasses.replace(cfg, cache=dataclasses.replace(
        cfg.cache, encode_budget=PLAIN_E))
    flat = [p for _, p in leaves(state.params)]
    gen = torch.Generator(device=dev).manual_seed(5)
    neg = core.sample_negatives(gen, pcfg.merged_cap,
                                top_batch["hist_mask"][:, 1:].shape,
                                pcfg.n_neg)
    grads = {}
    for impl in ("kernel", "plain"):
        cold = core.init_cache(pcfg.cache, dev)
        out = core.speedyfeed_forward(state.params, pcfg, top_batch, cold, 0,
                                      u=1.0, neg_idx=neg, impl=impl)
        g = torch.autograd.grad(out.loss, flat, allow_unused=True)
        grads[impl] = (float(out.loss.detach()), g)
        del cold, out
    (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
    check(all((a is None) == (b is None) for a, b in zip(gk, gp)),
          "kernel and plain paths reach different gradient leaves")
    # each leaf's max-abs error over its own largest magnitude; the key
    # projection's bias is the exception: its gradient is 0 in exact
    # arithmetic (softmax ignores a shift shared by all keys), so both
    # paths must return ~0 there (within 1e-5 of the largest magnitude)
    names = [p for p, _ in leaves(state.params)]
    rows = [(n, a, b) for n, a, b in zip(names, gk, gp) if b is not None]
    top_mag = max(float(b.abs().max()) for _, _, b in rows)
    ratios, zero_leaves = {}, {}
    for n, a, b in rows:
        if n.endswith("attn/k/b"):
            zero_leaves[n] = max(float(a.abs().max()),
                                 float(b.abs().max())) / top_mag
        else:
            ratios[n] = float((a - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    report["plain_train"] = {"E": PLAIN_E, "loss_kernel": lk,
                             "loss_plain": lp, "loss_abs_err": abs(lk - lp),
                             "grad_worst_rel_err": worst[0][1],
                             "grad_worst_leaves": worst,
                             "key_bias_grad_over_top": max(
                                 zero_leaves.values()),
                             "n_grad_leaves": len(rows)}
    print("plain (train): " + json.dumps(report["plain_train"]), flush=True)
    check(abs(lk - lp) <= TOL_LOSS, f"train loss kernel {lk} vs plain {lp}")
    check(worst[0][1] <= TOL_GRAD,
          f"gradient leaf {worst[0][0]} differs by {worst[0][1]} of its "
          f"magnitude")
    check(max(zero_leaves.values()) <= 1e-5,
          f"key-bias gradients are not ~0: {zero_leaves}")
    del grads, gk, gp, flat

    # ---------------------------------------------------------- kernels
    kernels = []
    g = torch.Generator(device=dev).manual_seed(1)
    M, K, S, H, D = 256, cfg.plm.n_segments, cfg.plm.seg_len, \
        cfg.plm.n_heads, cfg.plm.d_model // cfg.plm.n_heads
    Sk = S + K
    q = torch.randn(M, K, S, H, D, generator=g, device=dev)
    k = torch.randn(M, K, Sk, H, D, generator=g, device=dev)
    v = torch.randn(M, K, Sk, H, D, generator=g, device=dev)
    kv_mask = torch.rand(M, K, Sk, generator=g, device=dev) < 0.75
    kv_mask[:, :, 0] = True
    kv_mask[::7, 2] = False                  # all-masked segments
    out = bus_attention_cuda(q, k, v, kv_mask)
    ref = bus_attention_plain(q, k, v, kv_mask)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(err <= TOL_BUS, f"bus_attention differs from plain by {err}")
    # yardstick: one SDPA call on the same data, additive -1e30 mask
    qs = q.permute(0, 1, 3, 2, 4).reshape(M * K, H, S, D).contiguous()
    ks = k.permute(0, 1, 3, 2, 4).reshape(M * K, H, Sk, D).contiguous()
    vs = v.permute(0, 1, 3, 2, 4).reshape(M * K, H, Sk, D).contiguous()
    add = torch.zeros(M * K, 1, 1, Sk, device=dev).masked_fill(
        ~kv_mask.reshape(M * K, 1, 1, Sk), -1e30)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b_ms, b_by = bound_ms(nbytes(q, k, v, kv_mask, out),
                          2 * 2 * M * K * H * S * Sk * D)
    kernels.append({
        "name": "bus_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bus_attention.cu",
        "replaces": "src/repro/kernels/bus_attention.py:92",
        "launches": launches["bus_attention"]
        + train_launches["bus_attention"],
        "launches_by_path": {"serve": launches["bus_attention"],
                             "train": train_launches["bus_attention"]},
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: bus_attention_cuda(q, k, v, kv_mask)),
        "plain_ms": time_ms(torch,
                            lambda: bus_attention_plain(q, k, v, kv_mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lambda: sdpa(qs, ks, vs, attn_mask=add)),
        "shape": [M, K, S, Sk, H, D], "dtype": "float32"})

    # the backward at the training step's shape: E=4096 news, S=32
    Mb = cfg.cache.encode_budget
    qb = torch.randn(Mb, K, S, H, D, generator=g, device=dev)
    kb = torch.randn(Mb, K, Sk, H, D, generator=g, device=dev)
    vb = torch.randn(Mb, K, Sk, H, D, generator=g, device=dev)
    dob = torch.randn(Mb, K, S, H, D, generator=g, device=dev)
    mb = torch.rand(Mb, K, Sk, generator=g, device=dev) < 0.75
    mb[:, :, 0] = True
    mb[::7, 2] = False                       # all-masked segments
    got = bus_attention_bwd_cuda(qb, kb, vb, mb, dob)
    ref = bus_attention_bwd_plain(qb, kb, vb, mb, dob)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    check(err <= TOL_BWD, f"bus_attention_bwd differs from plain by {err}")
    check(float(got[2][::7, 2].abs().max()) > 0,
          "dv is zero on an all-masked segment")
    del got, ref
    # yardstick: the backward alone of SDPA on the same data (-1e30 mask)
    qs, ks, vs = (t.permute(0, 1, 3, 2, 4).reshape(Mb * K, H, -1, D)
                  .contiguous().requires_grad_() for t in (qb, kb, vb))
    dos = dob.permute(0, 1, 3, 2, 4).reshape(Mb * K, H, S, D).contiguous()
    addb = torch.zeros(Mb * K, 1, 1, Sk, device=dev).masked_fill(
        ~mb.reshape(Mb * K, 1, 1, Sk), -1e30)
    o_sdpa = sdpa(qs, ks, vs, attn_mask=addb)
    b_ms, b_by = bound_ms(nbytes(qb, kb, vb, mb, dob) + nbytes(qb, kb, vb),
                          5 * 2 * Mb * K * H * S * Sk * D)
    kernels.append({
        "name": "bus_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bus_attention.cu",
        "replaces": "src/repro/kernels/bus_attention.py:115",
        "launches": train_launches["bus_attention_bwd"],
        "launches_by_path": {"serve": launches["bus_attention_bwd"],
                             "train": train_launches["bus_attention_bwd"]},
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: bus_attention_bwd_cuda(qb, kb, vb, mb,
                                                            dob), iters=10),
        "plain_ms": time_ms(torch, lambda: bus_attention_bwd_plain(
            qb, kb, vb, mb, dob), iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            o_sdpa, (qs, ks, vs), dos, retain_graph=True), iters=10),
        "shape": [Mb, K, S, Sk, H, D], "dtype": "float32"})
    # the bus kernels' share of a timed train step (24 forward launches
    # with remat, 12 backward) at the step's shape
    fwd_ms = time_ms(torch, lambda: bus_attention_cuda(qb, kb, vb, mb),
                     iters=10)
    report["train"]["bus_kernels_ms_per_step"] = (
        2 * L * fwd_ms + L * kernels[-1]["ms"])
    report["train"]["bus_fwd_ms_at_step_shape"] = fwd_ms
    report["train"]["bus_kernels_share_of_step"] = (
        report["train"]["bus_kernels_ms_per_step"] / 1e3
        / report["train"]["s_per_step"])
    del qb, kb, vb, dob, qs, ks, vs, dos, o_sdpa

    # the PQ scan on the main path's own inputs: the query batch's LUT and
    # codes gathered off the built snapshot above (N = nprobe * cap)
    n_sub, n_codes = snap.pq_centers.shape[:2]
    N = codes.shape[1]
    shared = torch.randint(0, n_codes, (1, N, n_sub), generator=g,
                           device=dev).to(torch.uint8)
    errs = []
    for c in (codes, shared):
        out = pq_lut_scores_cuda(lut, c, valid)
        ref = pq_lut_scores_plain(lut, c, valid)
        torch.cuda.synchronize()
        fin = torch.isfinite(ref)
        check(bool((torch.isfinite(out) == fin).all()),
              "pq_lut_scores -inf slots differ from plain")
        errs.append(float((out[fin] - ref[fin]).abs().max()))
    err = max(errs)
    check(err <= TOL_PQ, f"pq_lut_scores differs from plain by {err}")
    b_ms, b_by = bound_ms(nbytes(lut, codes, valid, out), BATCH * N * n_sub)
    kernels.append({
        "name": "pq_lut_scores", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pq_scoring.cu",
        "replaces": "src/repro/kernels/pq_scoring.py:99",
        "launches": launches["pq_lut_scores"]
        + train_launches["pq_lut_scores"],
        "launches_by_path": {"serve": launches["pq_lut_scores"],
                             "train": train_launches["pq_lut_scores"]},
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: pq_lut_scores_cuda(lut, codes, valid),
                      iters=100),
        "plain_ms": time_ms(torch,
                            lambda: pq_lut_scores_plain(lut, codes, valid),
                            iters=100),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": [BATCH, n_sub, n_codes, N], "dtype": "float32/uint8"})

    report["kernels"] = kernels
    report["card"] = card
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
