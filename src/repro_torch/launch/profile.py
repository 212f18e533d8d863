"""Where the serve and train slices' time goes on the card, and where
the serve slice's recall goes.

    python -m repro_torch.launch.profile [--news 16384] \
        [--out chiprun_out/profile_serve.json]
    python -m repro_torch.launch.profile --train [--out PATH]
    python -m repro_torch.launch.profile --lm [--lm-config NAME] [--out PATH]
    python -m repro_torch.launch.profile --lm-train [--out PATH]
    python -m repro_torch.launch.profile --recsys [--out PATH]
    python -m repro_torch.launch.profile --recsys-train [--out PATH]
    python -m repro_torch.launch.profile --gnn [--gnn-shape SHAPE] [--out PATH]

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

With ``--lm`` it instead profiles the LM family's serving path:
``--lm-config`` (default Qwen3-14B at full depth; DBRX-132B and
Llama-4-Scout at their one-card serving depths, ``ONE_CARD_SERVE``) at
full width in bf16 with seeded random weights, one prefill of B=1,
S=32,768 and one decode step at B=16 against an 8,192-slot bf16 KV
cache (after one warm call each): device time by kernel name and the
device's busy share, and the prefill's device time split into the MoE's
stages (``nn.moe``'s ranges: router and top-k, sort and dispatch,
grouped GEMMs, combine), the flash kernels and the head, printed and
written to ``--out`` (default ``chiprun_out/profile_lm.json``, or
``profile_lm_<config>.json``).

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

With ``--recsys-train`` it instead profiles the recsys family's training
path at ``train_batch``'s B=65,536, each step after one warm step: one
DLRM-RM2 step through ``make_fn(cfg, "train")`` (the fused 32,710,656 x
64 f32 table, its Adam moments, seeded random weights, a ``recsys_synth``
batch), then one BERT4Rec step as ``B4R_ONE_CARD_ACCUM`` microbatches of
4,096: device time by kernel name and the device's busy share, with the
EmbeddingBag's kernels (the forward, the backward's keys, chunk and
combine passes) named apart, printed and written to ``--out`` (default
``chiprun_out/profile_recsys_train.json``).

With ``--gnn`` it instead profiles the GNN family's training path: one
DimeNet train step at ``--gnn-shape`` (by default ``minibatch_lg``:
``DIMENET``'s width with Reddit's 602 features and 41 classes, f32,
seeded random weights, ``gnn_family.train_batch``'s fanout subgraph: N
169,984, E 168,960, T 262,144; or ``molecule``, ``full_graph_sm``)
through the registry cell's ``make_fn()``, after one warm step: device
time by kernel name, the device's busy share, the count of device ops
(kernels, copies, fills), and the step's device time split by part
(``gnn_breakdown``: gathers, scatter-adds, f32 GEMMs, the bilinear
einsum, Adam, and the elementwise rest), printed and written to
``--out`` (default ``chiprun_out/profile_gnn_<shape>.json``).

With ``--recall-repeat`` it instead studies where the spread of recall@10
between runs comes from (``recall_repeat``), and writes the corpus
embeddings and the probe users' vectors to ``--vectors-out`` (an .npz that
``tests/test_torch_serving.py`` reads from ``REPRO_RECALL_VECTORS`` to
hold the port's build against the JAX package's on the same vectors).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import time
import warnings

import numpy as np
import torch

from repro_torch import configs, core, data, optim, serving, training
from repro_torch.configs import PROD, gnn_family, lm_family, recsys_family
from repro_torch.kernels import ops
from repro_torch.launch.serve import Recommender, _pad_histories
from repro_torch.launch.train import first_batch_of_bucket, make_loader
from repro_torch.data import recsys_synth
from repro_torch.models import lm
from repro_torch.models.gnn import dimenet
from repro_torch.models.recsys import bert4rec, ctr
from repro_torch.optim import adam
from repro_torch.serving.index import _probe_cells, _search_pq_csr
from repro_torch.serving.pq import PQCodebook, pq_decode


# the flash kernels by the names their CUDA functions carry in a profile
# (each a template instance, so its name holds <D>): forward and backward,
# Hopper, 3xTF32 (each call's split and its main kernel) and SIMT routes
FLASH_NAMES = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
               "flash_bwd_dkv_wgmma_kernel", "split_kv_kernel",
               "flash_fwd_tf32_kernel", "split_planes_kernel",
               "flash_bwd_dq_tf32_kernel", "flash_bwd_dkv_tf32_kernel",
               "flash_fwd_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkv_kernel")
# the EmbeddingBag's: the forward, and the backward's three passes
EBAG_NAMES = ("embedding_bag_kernel", "ebag_bwd_keys_kernel",
              "ebag_bwd_chunk_kernel", "ebag_bwd_combine_kernel")
# the ranges the LM path opens with torch.profiler.record_function: the
# MoE's stages (nn/moe.py) and the head (models/lm.py). Their rows hold
# the device time of the kernels launched inside them; they are kept out
# of the by-kernel rows and the busy sum
SPLIT_RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
                "lm.head")
# the GNN step's: Adam, under the range ``_adam_range`` opens
GNN_RANGES = ("optim.adam",)
# the GNN step's parts by the aten op that launched each kernel (its own
# kernels' device time): DimeNet's gathers are index_select and its
# segment sums index_add_ (each the other's backward); its only batched
# product, and every matrix product with an nsbf * nb wide operand, is
# the bilinear einsum's (dimenet.bilinear)
GNN_GATHER_OPS = ("aten::index_select", "aten::index", "aten::gather")
GNN_SCATTER_OPS = ("aten::index_add_", "aten::index_add",
                   "aten::scatter_add_")
GNN_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm")


def _kernel_table(prof, wall_s: float, top: int = 16,
                  ranges=SPLIT_RANGES) -> dict:
    """Device time by kernel name from a profile, and the busy share;
    each flash or EmbeddingBag kernel that ran (FLASH_NAMES, EBAG_NAMES)
    also apart, with its calls, device ms and share of the wall time,
    whether or not it is among the ``top``."""
    rows, split = [], {}
    for e in prof.key_averages():
        if e.key in ranges:
            # by device type: the host range's row holds the device time
            # of the kernels launched inside it; the device lane's row
            # (where the profiler draws one) spans its first kernel's
            # start to its last one's end, gaps included
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            split.setdefault(e.key, {})[str(e.device_type).split(".")[-1]] \
                = {"calls": e.count, "device_ms": us / 1e3}
            continue
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
    out["split"] = split
    out["named"] = {}
    for part in FLASH_NAMES + EBAG_NAMES:
        hit = [(us, n) for us, n, k in rows
               if f"{part}<" in k or f"{part}(" in k]
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


def profile_lm(dev, cfg=lm_family.QWEN3_14B) -> dict:
    """``torch.profiler`` over one prefill of B=1 at ``prefill_32k``'s
    sequence and one decode step at B=16 against an 8,192-slot bf16 cache
    (the smoke's shapes), each after one warm call; an MoE config at its
    one-card serving depth."""
    if cfg.is_moe:
        cfg = lm_family.one_card_serve(cfg)
    seq = lm_family.LM_SHAPES["prefill_32k"]["seq"]
    decode_batch, slots = 16, 8192
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    prefill = lm_family.make_fn(cfg, "prefill")
    decode = lm_family.make_fn(cfg, "decode")
    toks = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=dev)
    out = {"config": cfg.name, "layers": cfg.n_layers,
           "prefill": _profiled(lambda: prefill(params, toks))}
    out["prefill"].update(batch=1, seq=seq)
    out["prefill"]["breakdown_ms"] = prefill_breakdown(out["prefill"])
    del toks
    cache = lm.init_cache(cfg, decode_batch, slots, torch.bfloat16,
                          device=dev)
    tok = torch.randint(0, cfg.vocab, (decode_batch, 1), generator=gen,
                        device=dev)
    out["decode_step"] = _profiled(lambda: decode(params, tok, cache, 0))
    out["decode_step"].update(batch=decode_batch, slots=slots)
    return out


def prefill_breakdown(table: dict) -> dict:
    """A prefill's device ms by part: the MoE's stages and the head (the
    device time of the kernels launched inside their ranges), the flash
    forward (its kernels), and the rest (attention projections, norms,
    rope, the shared expert or the dense FFN, the embedding). The parts
    sum to the device's busy time."""
    parts = {name: table["split"].get(name, {}).get("CPU", {}).get(
        "device_ms", 0.0) for name in SPLIT_RANGES}
    parts["flash"] = sum(table["named"].get(n, {}).get("device_ms", 0.0)
                         for n in FLASH_NAMES)
    parts["other"] = table["device_busy_ms"] - sum(parts.values())
    return parts


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


def profile_recsys_train(dev, cfg) -> dict:
    """``torch.profiler`` over one train step of ``cfg`` at
    ``train_batch``'s B=65,536 (the smoke's shape), after one warm step:
    a CTR config through ``make_fn(cfg, "train")``, BERT4Rec as
    ``B4R_ONE_CARD_ACCUM`` microbatches through ``optim.make_train_step``
    with ``RS_OPT`` and that ``accum_steps``."""
    B = recsys_family.RS_SHAPES["train_batch"]["batch"]
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(23)
    torch.cuda.reset_peak_memory_stats()
    if isinstance(cfg, ctr.CTRConfig):
        params = ctr.init(gen, cfg)
        batch = recsys_synth.ctr_batch(
            rng, batch=B, n_dense=cfg.n_dense,
            vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz,
            device=dev)
        step = recsys_family.make_fn(cfg, "train", device=dev)
        accum = 1
    else:
        params = bert4rec.init(gen, cfg)
        batch = recsys_synth.bert4rec_batch(
            rng, batch=B, seq_len=cfg.seq_len, n_items=cfg.n_items,
            n_mask=cfg.n_mask, n_neg=cfg.n_neg, mask_token=cfg.mask_token,
            device=dev)
        accum = recsys_family.B4R_ONE_CARD_ACCUM
        step = optim.make_train_step(
            lambda p, b: bert4rec.loss(p, cfg, b),
            dataclasses.replace(recsys_family.RS_OPT, accum_steps=accum))
    state = [params, optim.adam_init(params)]

    def run():
        state[0], state[1], _ = step(state[0], state[1], batch)

    out = _profiled(run, top=24)
    out.update(config=cfg.name, batch=B, accum_steps=accum,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def profile_gnn(dev, shape: str = "minibatch_lg") -> dict:
    """``torch.profiler`` (with the ops' input shapes) over one DimeNet
    train step at ``shape``, after one warm step; ``breakdown_ms`` from
    ``gnn_breakdown``."""
    cell = configs.get_arch("dimenet").cells[shape]
    shp = gnn_family.GNN_SHAPES[shape]
    cfg = gnn_family.cell_config(shape)
    batch = gnn_family.train_batch(shape, np.random.default_rng(0), dev)
    params = dimenet.init(torch.Generator(device=dev).manual_seed(0), cfg)
    state = [params, optim.adam_init(params)]
    step = cell.make_fn()

    def run():
        state[0], state[1], _ = step(state[0], state[1], batch)

    torch.cuda.reset_peak_memory_stats()
    run()                                      # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof, \
            _adam_range():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _kernel_table(prof, wall, top=24, ranges=GNN_RANGES)
    out["breakdown_ms"] = gnn_breakdown(prof, cfg, out)
    out.update(shape=shape, n=shp["n"], e=shp["e"], t=shp["t"],
               model_flops=cell.meta["model_flops"],
               device_ops=sum(e.count for e in prof.key_averages()
                              if "CUDA" in str(e.device_type)
                              and e.key not in GNN_RANGES),
               valid_edges=int(batch["edge_mask"].sum()),
               valid_triplets=int(batch["trip_mask"].sum()),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


@contextlib.contextmanager
def _adam_range():
    """While the block runs, ``optim.adam.adam_update`` runs under the
    profiler range ``optim.adam`` (a train step looks it up at each
    call)."""
    update = adam.adam_update

    def ranged(*args, **kw):
        with torch.profiler.record_function("optim.adam"):
            return update(*args, **kw)
    adam.adam_update = ranged
    try:
        yield
    finally:
        adam.adam_update = update


def gnn_breakdown(prof, cfg, table: dict) -> dict:
    """A DimeNet step's device ms by part: gathers, scatter-adds, the
    bilinear einsum (its ``bmm`` and its matrix products with an nsbf *
    nb wide operand, forward and backward), the other f32 GEMMs, Adam
    (the ``optim.adam`` range ``_adam_range`` opens: clip and update)
    and the rest (elementwise passes, the bases, reductions, fills and
    copies). The parts sum to the device's busy time."""
    wide = cfg.n_spherical * cfg.n_radial * cfg.n_bilinear
    parts = dict.fromkeys(("gather", "scatter_add", "einsum", "gemm_f32"),
                          0.0)
    for e in prof.key_averages(group_by_input_shape=True):
        if "CPU" not in str(e.device_type):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.key in GNN_GATHER_OPS:
            parts["gather"] += us / 1e3
        elif e.key in GNN_SCATTER_OPS:
            parts["scatter_add"] += us / 1e3
        elif e.key in GNN_GEMM_OPS:
            dims = {d for shape in (e.input_shapes or []) for d in shape}
            part = "einsum" if e.key == "aten::bmm" or wide in dims \
                else "gemm_f32"
            parts[part] += us / 1e3
    parts["adam"] = table["split"].get("optim.adam", {}).get(
        "CPU", {}).get("device_ms", 0.0)
    parts["elementwise_and_rest"] = table["device_busy_ms"] - sum(
        parts.values())
    return parts


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


def slice_recommender(params, store, n_news: int, device) -> Recommender:
    """The serve slice's Recommender (IVF-PQ, nprobe 16, k' 64) over a
    corpus of ``n_news`` rows. Its bootstrap publishes the whole corpus
    into the delta tier, so the delta hard cap holds the corpus: the
    default cap (8 x the compaction threshold of 512) holds 4,096 rows and
    refuses a larger bootstrap with ``BackpressureError``."""
    return Recommender(PROD, params, store, k=10, index_kind="ivf-pq",
                       nprobe=16, k_prime=64,
                       service_kw={"delta_hard_cap": n_news}, device=device)


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
                rec = slice_recommender({}, None, emb.shape[0], device)
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
                    help="profile one LM prefill and decode step")
    ap.add_argument("--lm-config", default=lm_family.QWEN3_14B.name,
                    choices=sorted(lm_family.CONFIGS),
                    help="the --lm config (MoE ones at their one-card "
                         "depth)")
    ap.add_argument("--lm-train", action="store_true",
                    help="profile one Qwen3-14B train step (8 layers)")
    ap.add_argument("--recsys", action="store_true",
                    help="profile one DLRM-RM2 serve_bulk forward")
    ap.add_argument("--recsys-train", action="store_true",
                    help="profile one DLRM-RM2 and one BERT4Rec train step "
                         "(B=65,536)")
    ap.add_argument("--gnn", action="store_true",
                    help="profile one DimeNet train step")
    ap.add_argument("--gnn-shape", default="minibatch_lg",
                    choices=("molecule", "full_graph_sm", "minibatch_lg"),
                    help="the DimeNet cell --gnn profiles")
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
        cfg = lm_family.CONFIGS[args.lm_config]
        report = {"card": card, **profile_lm(dev, cfg)}
        default = ("chiprun_out/profile_lm.json" if cfg is lm_family.QWEN3_14B
                   else f"chiprun_out/profile_lm_{cfg.name}.json")
        _write(args.out or default, report)
        for name in ("prefill", "decode_step"):
            _print_table(f"{cfg.name} {name}", report[name])
        print("prefill by part (device ms): "
              + json.dumps(report["prefill"]["breakdown_ms"]))
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
    if args.recsys_train:
        report = {"card": card}
        for cfg in (recsys_family.DLRM_RM2, recsys_family.BERT4REC):
            report[cfg.name] = profile_recsys_train(dev, cfg)
            _print_table(f"{cfg.name} train step", report[cfg.name])
            torch.cuda.empty_cache()
        _write(args.out or "chiprun_out/profile_recsys_train.json", report)
        print(card)
        return report
    if args.gnn:
        report = {"card": card,
                  "train_step": profile_gnn(dev, args.gnn_shape)}
        _write(args.out or f"chiprun_out/profile_gnn_{args.gnn_shape}.json",
               report)
        _print_table(f"dimenet {args.gnn_shape} train step",
                     report["train_step"])
        print("step by part (device ms): "
              + json.dumps(report["train_step"]["breakdown_ms"]))
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
    rec = slice_recommender(params, store, store.tokens.shape[0], dev)
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
