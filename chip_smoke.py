#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100
and hold its hand-written CUDA kernels against their plain PyTorch
versions.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. setup    print the card (``nvidia-smi``), turn TF32 off, build the
              kernel libraries from ``src/repro_torch/kernels/csrc`` with
              nvcc, one process per source, in parallel; each Hopper flash
              kernel (the forward, the backward's dq and dk/dv), at each
              head dim, must show no spills in ``ptxas -v`` and HGMMA
              (wgmma) in its SASS (``cuobjdump -sass``).
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
  7. lm       the LM family's serving path: Qwen3-14B at full width and
              depth (40 layers, d 5120, 40/8 heads of 128, d_ff 17,408,
              vocab 151,936, qk-norm) in bf16, random weights from a
              seeded generator. One warm-up and one timed prefill at B=1,
              S=32,768 (exactly 40 launches of the Hopper flash forward,
              none of the SIMT one; finite last-row logits); 32 greedy
              decode steps at B=16 against an 8,192-slot bf16 KV cache,
              then 8 against the int8 cache (no flash launch); prefill
              of B=4, T=64 against the logits of
              the T-th decode step from an empty cache, and a prefill at
              S=2,048 through the kernel against ``impl="plain"``: in
              bf16 (logits reported; every layer's attention output,
              kernel vs plain on the same input, within TOL_ATTN_BF16),
              then with the weights cast to f32 in place, each within
              TOL_LM_REL_F32 of the largest logit; bf16 goes through the
              Hopper flash forward, f32 through the SIMT one.
  8. lm-train the LM family's training path: Qwen3-14B at full width, 8
              of its 40 layers, bf16 parameters and f32 Adam moments
              (seeded), B=2 at train_4k's S=4,096 (labels the tokens
              shifted left, -100 last), through ``make_fn(cfg,
              "train")``: 1 warm-up and 3 synchronised timed steps
              (s/step, tokens/s, peak memory, model TFLOP/s as the JAX
              cell counts them), finite losses, every leaf's moments
              written and every matrix moved, ``count`` 4, and exactly 16
              Hopper flash forward (with the remat recompute), 8 Hopper dq
              and 8 Hopper dk/dv launches per step (the f32 check below:
              the SIMT forward and backward). One more bf16 step captures
              layer 0's attention inputs and the dO the loss sends back
              to them (a spy on ``ops.flash_attention`` and a hook on its
              output); the Hopper backward on them, with dO brought to
              unit RMS by a power of two (the gradients scale exactly in
              both versions), is held to plain as at the train shape
              below. Then at
              depth 2: one step with
              ``accum_steps=2`` (twice the launches), and, in f32 with
              TF32 off at B=1, the loss and every gradient leaf through
              the kernels against ``impl="plain"`` (TOL_LOSS, TOL_GRAD);
              then, on those gradients, the in-place Adam over each leaf
              it splits into row chunks (embed, head, FFN) against the
              same update of the whole leaf and against Adam in f64
              (TOL_ADAM).
  9. recsys   the recsys family's serving path at full width, f32,
              seeded random weights, batches from ``recsys_synth``:
              DLRM-RM2 (26 fields, criteo_like_vocab, d 64: a fused
              32,710,656 x 64 table, 8.37 GB), Wide&Deep (40 fields, d
              32, nnz 2, plus the d=1 wide table) and DCN-v2 (d 16, 3
              cross layers of 429), each through ``make_fn``: serve_p99
              (B=512, p50/p99 over RS_P99_CALLS synchronised calls after
              3 warm-ups) and serve_bulk (B=262,144, samples/s), the
              EmbeddingBag launches per forward (1, 2, 1) and per cell,
              peak memory; DLRM-RM2's retrieval_cand (1 query against
              10^6 x 128 candidates, top-100). Kernel vs plain: the p99
              logits within TOL_RS_LOGITS of the largest, the bulk
              lookups within TOL_RS_BULK; on the fused table the last
              row, negative indices and out-of-range -> NaN; a bf16 table
              within TOL_RS_BF16; the kernel's row timed at serve_bulk's
              shape. BERT4Rec (3M items, d 64, seq 200): serve_p99 (B=512
              against the whole catalogue) and retrieval_cand, 0 kernel
              launches, its first rows against the same serve on the CPU;
              its serve_bulk would need a 3.1 TB score matrix and is left
              out. Each config's tables are freed before the next.
  10. kernels each kernel against its plain version at the main paths'
              shapes, timed with CUDA events beside its bound and a
              PyTorch call as a yardstick (for the bus kernels
              ``F.scaled_dot_product_attention``'s forward and backward,
              for flash its causal forward and, for the flash backward,
              its causal GQA backward on the same data, for the
              EmbeddingBag ``F.embedding_bag``). The flash forward on
              both routes: the SIMT kernel in f32 at S=4,096, the Hopper
              kernel in bf16 at S=4,096 (Sq = Sk and Sq = S/4), at the
              prefill shape (the launch held to plain on its first, a
              middle and its last FLASH_ROWS rows) and timed at the train
              shape; its bf16 checks are element-wise, each beside a
              control that must fail them. Every flash forward launch is
              expected on the route ``forward_route`` picks. The main
              paths are bf16 at head dim 128, so the SIMT row's
              ``launches`` is 0; the f32 checks' launches, each counted
              from 0, stand under ``check_launches``. The flash
              backward at the train shape on each route
              (``backward_route``), on that dtype's forward o and lse:
              f32 on the SIMT pair (1e-4 of each gradient's largest);
              bf16 on the Hopper pair, whose f32 gradients before the
              wrapper's cast are held within the same 1e-4 of plain's f32
              ones and whose casts element-wise, beside controls that drop
              the last key tile and must miss both (the casts' flat
              difference and plain's own distance from the gradient in
              f64 are read beside them); each timed beside plain and
              SDPA's backward in its dtype; its SIMT row's ``launches`` is
              0 as the forward's.

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
BF16_FLOP_PER_S = 989e12         # bf16 on the tensor cores, dense
N_NEWS = 16384
N_REQUESTS = 128
BATCH = 16
TOL_BUS, TOL_PQ, TOL_ENCODE = 2e-4, 1e-5, 5e-4
TOL_DISTORTION = 0.01            # share of residual energy PQ codes lose
TOL_BWD = 1e-4                   # backward kernel vs plain, f32
TOL_LOSS, TOL_GRAD = 1e-4, 1e-3  # train step, kernel vs plain path
TRAIN_STEPS, TIMED_STEPS, PLAIN_E = 4, 3, 256
TOL_FLASH = {"float32": 2e-4, "bfloat16": 2e-2}   # the JAX tests' own
# bf16 flash output, element-wise, on top of the flat limit: both versions
# round an f32 result to bf16, so they differ by at most one bf16 ulp,
# which is at most 2^-7 of the value (the absolute term covers values
# near 0). A flat 2e-2 is close to a typical |o| (~0.03 at S=4,096), so
# a key tile's PV dropped would pass it; each check also runs such a
# control through the plain version and fails if the limit misses it.
RTOL_FLASH_BF16, ATOL_FLASH_BF16 = 2.0 ** -7, 1e-4
TOL_LSE = 1e-4                   # f32 in both versions, sums reordered
FLASH_ROWS = 512                 # rows of the S=32,768 launch held to plain
# the flash forward's two routes (kernels/flash_attention.py:forward_route):
# the SIMT kernel (f32, and bf16 at other head dims) and the Hopper kernel
# (bf16 at head dim 64 or 128); then the backward's, by the same rule
# (backward_route): the SIMT dq and dk/dv kernels, and the Hopper pair
FLASH_FWD = ("flash_attention", "flash_attention_wgmma")
FLASH_BWD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq_wgmma", "flash_attention_bwd_dkv_wgmma")
FLASH_KERNELS = FLASH_FWD + FLASH_BWD
# the Hopper kernels' libraries, whose ptxas and SASS the setup checks
HOPPER_LIBS = ("flash_attention_wgmma", "flash_attention_bwd_wgmma")
# LM logits, kernel path against decode or plain, relative to the largest
# |logit|. In bf16 the paths round at other places (the decode's einsums
# round to bf16, the kernel accumulates in f32), and at depth 40 with
# random weights that rounding moves the logits by several % of the
# largest: bf16 logits are reported, and the same comparisons with the
# weights cast to f32 are held to TOL_LM_REL_F32. What is held in bf16 is
# each layer's attention output, kernel against plain on the same input
# (the plain path's hidden state), relative to its largest value: one
# ulp of rounding before the output projection and one after it, within
# TOL_ATTN_BF16; the hidden-state gap the layers accumulate is reported
# beside it.
TOL_LM_REL_F32 = 1e-3
TOL_ATTN_BF16 = 2.0 ** -6
LM_PREFILL_SEQ = 32768           # prefill_32k's sequence; batch cut 32 -> 1
LM_DECODE_BATCH, LM_DECODE_SLOTS = 16, 8192   # decode_32k cut: 128, 32,768
LM_DECODE_STEPS, LM_Q8_STEPS = 32, 8
LM_CHECK_B, LM_CHECK_T, LM_PLAIN_SEQ, FLASH_CHECK_SEQ = 4, 64, 2048, 4096
# recsys: timed calls per cell; kernel vs plain forward logits within
# TOL_RS_LOGITS of the largest |logit| (f32 products and sums reordered);
# the bulk lookups (nnz <= 2, f32, products rounded then added in order
# as plain does) within TOL_RS_BULK; a bf16 table within the JAX tests'
# 2e-2 of the largest output; BERT4Rec's scores on the card against the
# CPU within TOL_RS_B4R_CPU (f32 GEMMs in other orders)
# LM training: train_4k's sequence at lm_family.ONE_CARD_TRAIN's depth
# and batch (8 of 40 layers, 2 of 256 rows); the kernel vs plain,
# accumulation and chunked-Adam checks at depth 2. The in-place Adam by
# row chunks, ADAM_CHECK_STEPS steps with the clip off, against the whole
# leaf and against Adam in f64: parameters and moments within TOL_ADAM
# of each one's largest magnitude (a few f32 roundings an element); the
# clip's norm, a sum of up to 2^26 f32 squares a chunk, within
# TOL_ADAM_NORM of the f64 norm (~u*sqrt(n)/3 = 1e-6 at n = 2^26)
LM_TRAIN_TIMED, LM_CHECK_LAYERS = 3, 2
ADAM_CHECK_STEPS, TOL_ADAM, TOL_ADAM_NORM = 2, 1e-6, 1e-5
# flash backward vs plain, relative to each gradient's largest magnitude
# at this length: f32 within the JAX tests' 1e-4. The bf16 route (the
# Hopper pair) writes f32 gradients, as the TPU kernel writes dk and dv,
# and the wrapper casts them: the f32 values before the cast are held to
# the same 1e-4 of plain's f32 gradients before its cast, and the casts
# element-wise as the forward (RTOL/ATOL_FLASH_BF16). The JAX tests' flat
# 2e-2 is not held on the casts here: at the train shape dk and dv reach
# ~12, where one bf16 ulp is 2^-5 or 2^-4, so a flat 2e-2 asks every value
# above 4 to round as plain's f32 happens to; its reading stays in the
# row (max_abs_err), beside plain f32's own distance from the gradient in
# f64 after the cast
TOL_FLASH_BWD = {"float32": 1e-4}
RS_P99_CALLS, RS_BULK_CALLS, RS_RETRIEVAL_CALLS, RS_B4R_CALLS = 100, 5, 20, 50
TOL_RS_LOGITS, TOL_RS_BULK, TOL_RS_BF16 = 1e-5, 1e-6, 2e-2
TOL_RS_B4R_CPU = 1e-4
RS_B4R_CPU_ROWS = 4


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


def bound_ms(n_bytes: float, n_flops: float,
             flop_per_s: float = F32_FLOP_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def flash_miss(o, o_p) -> float:
    """Largest |o - o_p| over the bf16 limit RTOL * |o_p| + ATOL: the
    check passes at <= 1."""
    o_p = o_p.float()
    lim = RTOL_FLASH_BF16 * o_p.abs() + ATOL_FLASH_BF16
    return float(((o.float() - o_p).abs() / lim).max())


def dropped_tile(v, start: int, width: int = 64):
    """v with one key tile's values zeroed: the control that the flash
    checks must catch (a kernel that lost that tile's PV)."""
    v = v.clone()
    v[:, start:start + width] = 0
    return v


def flash_fwd_launches(dtype, head_dim: int, n: int) -> dict:
    """``n`` flash forward launches at ``dtype`` and ``head_dim``, by
    route: all on the one ``kernels/flash_attention.py:forward_route``
    picks, none on the other."""
    from repro_torch.kernels.flash_attention import forward_route
    route = forward_route(dtype, head_dim)
    return {name: n if name == route else 0 for name in FLASH_FWD}


def flash_bwd_launches(dtype, head_dim: int, n: int) -> dict:
    """``n`` launches of each flash backward kernel (dq, dk/dv) at
    ``dtype`` and ``head_dim``, by route: all on the pair
    ``kernels/flash_attention.py:backward_route`` picks, none on the
    other."""
    from repro_torch.kernels.flash_attention import backward_route
    route = backward_route(dtype, head_dim)
    return {name: n if name in route else 0 for name in FLASH_BWD}


def hopper_library(name: str):
    """The built library's path of the Hopper kernel library ``name``."""
    from repro_torch.kernels import ops
    libs = {lib.name: lib for lib, _ in ops.KERNELS.values()}
    return libs[name].library_path()


def wgmma_kernel(symbol: str):
    """``flash_..._wgmma_kernel<D>`` for a mangled wgmma kernel symbol,
    else None."""
    import re
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)ILi(\d+)E",
                  symbol)
    return f"{m[1]}<{m[2]}>" if m else None


def sass_hgmma(lib) -> dict:
    """HGMMA instructions in the SASS (``cuobjdump -sass``) of each wgmma
    kernel instantiation in the built library, by kernel<D>."""
    from repro_torch.kernels._build import find_nvcc
    cuobjdump = pathlib.Path(find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return {wgmma_kernel(fn.split(None, 1)[0]): fn.count("HGMMA")
            for fn in sass.split("Function : ")[1:]
            if wgmma_kernel(fn.split(None, 1)[0])}


def ptxas_by_kernel(log: str) -> dict:
    """``ptxas -v``'s spill and register lines of each wgmma kernel
    instantiation in a build log, by kernel<D>."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = wgmma_kernel(ln)
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip().replace(
                "ptxas info    : ", ""))
    return out


def bwd_f64(q, k, v, o, lse, do):
    """Plain's causal flash backward (Sq = Sk) in f64, for batch 0's first
    kv head and its G q heads, on the same q/k/v/o/lse/dO: the function
    whose f32 evaluations the kernel and plain are. Returns (dq [S, G, D],
    dk [S, D], dv [S, D])."""
    import torch
    G, D = q.shape[2] // k.shape[2], q.shape[-1]
    scale = D ** -0.5
    qd, od, dod = (t[0, :, :G].double().transpose(0, 1) for t in (q, o, do))
    kd, vd = (t[0, :, 0].double() for t in (k, v))
    p = qd @ kd.T * scale                                    # [G, S, S]
    S = p.shape[-1]
    p.masked_fill_(torch.ones(S, S, dtype=torch.bool, device=q.device)
                   .triu(1), float("-inf"))
    p.sub_(lse[0, :G, :, None].double()).exp_()
    delta = (dod * od).sum(-1, keepdim=True)
    ds = p * (dod @ vd.T - delta)
    dq = (ds @ kd * scale).transpose(0, 1)
    dk = (ds.transpose(1, 2) @ qd).sum(0) * scale
    dv = (p.transpose(1, 2) @ dod).sum(0)
    return dq, dk, dv


def bwd_hopper_errors(q, k, v, o, lse, do, got, exp, label: str) -> dict:
    """The Hopper backward's f32 (dq, dk, dv) ``got`` against plain's f32
    ``exp`` (both before the cast) on causal bf16 q/k/v/o/lse/dO with Sq =
    Sk. Held: each f32 gradient within TOL_FLASH_BWD["float32"] of plain's
    largest magnitude (``_f32_over_limit`` <= 1), and each bf16 cast within
    the element-wise limit of plain's cast (``_over_limit`` <= 1). The
    controls, the plain gradients of a kernel that lost the last key tile
    (dk, dv of that tile zero; dq's last rows without that tile's ds k,
    which is plain on the last tile alone: row i of it sees keys up to i,
    as the global row does), must miss both. Read beside them: the casts'
    largest abs difference (the flat limit's reading), and how far plain's
    f32 and the kernel's, and their casts, lie from the gradient in f64
    (``bwd_f64``, one kv head)."""
    import torch

    from repro_torch.kernels.flash_attention import _bwd_plain_f32
    rel_tol = TOL_FLASH_BWD["float32"]
    e = {}
    for gname, a, b, t in zip(("dq", "dk", "dv"), got, exp, (q, k, v)):
        a16, b16 = a.to(t.dtype), b.to(t.dtype)
        e[gname] = float((a16.float() - b16.float()).abs().max())
        e[gname + "_f32_rel"] = float((a - b).abs().max() / b.abs().max())
        e[gname + "_f32_over_limit"] = e[gname + "_f32_rel"] / rel_tol
        e[gname + "_over_limit"] = flash_miss(a16, b16)
    t0 = q.shape[1] - 64
    last = _bwd_plain_f32(q[:, t0:], k[:, t0:], v[:, t0:], o[:, t0:],
                          lse[..., t0:], do[:, t0:], True)[0]
    dq_c = exp[0].clone()
    dq_c[:, t0:] -= last
    controls = (dq_c, dropped_tile(exp[1], t0), dropped_tile(exp[2], t0))
    for gname, c, b, t in zip(("dq", "dk", "dv"), controls, exp, (q, k, v)):
        e[gname + "_control_f32_over_limit"] = float(
            (c - b).abs().max() / b.abs().max()) / rel_tol
        e[gname + "_control_over_limit"] = flash_miss(c.to(t.dtype),
                                                      b.to(t.dtype))
        check(e[gname + "_control_f32_over_limit"] > 1
              and e[gname + "_control_over_limit"] > 1,
              f"flash_attention_bwd {label} {gname}: a limit misses a "
              f"dropped key tile: {e}")
    del last, dq_c, controls
    G = q.shape[2] // k.shape[2]
    f64 = bwd_f64(q, k, v, o, lse, do)
    e["vs_f64"] = {}
    for gname, x, a, b, t in zip(("dq", "dk", "dv"), f64, got, exp,
                                 (q, k, v)):
        a, b = (y[0, :, :G] if gname == "dq" else y[0, :, 0] for y in (a, b))
        x16 = x.to(t.dtype).double()
        r = {}
        for who, y in (("plain", b), ("kernel", a)):
            r[who + "_f32_rel"] = float((y - x).abs().max() / x.abs().max())
            y16 = y.to(t.dtype).double()
            r[who + "_bf16_max_abs"] = float((y16 - x16).abs().max())
            r[who + "_bf16_mismatch_share"] = float((y16 != x16).float()
                                                    .mean())
        e["vs_f64"][gname] = r
    del f64
    ok = all(e[n + "_f32_over_limit"] <= 1 and e[n + "_over_limit"] <= 1
             for n in ("dq", "dk", "dv"))
    check(ok, f"flash_attention_bwd {label} differs from plain: {e}")
    return e


def latencies_ms(torch, fn, n: int, warmup: int = 3) -> list:
    """Host-clock ms of ``n`` synchronised calls of ``fn`` after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def tree_to(tree, device):
    """A copy of a nested dict/list of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def distinct_rows(idx, V: int) -> int:
    """Distinct table rows an EmbeddingBag call reads: the in-range
    indices, a negative one naming row V + i. A row that several slots
    name needs one read from device memory; the repeats can come from
    L2."""
    i = idx[(idx >= -V) & (idx < V)].long()
    return int(i.remainder(V).unique().numel())


def gathered_bytes(idx, V: int, row_bytes: int) -> int:
    """Bytes an EmbeddingBag call must gather: each distinct in-range row
    once, a row below 32 B costing one 32 B sector."""
    return distinct_rows(idx, V) * max(row_bytes, 32)


def recsys_phase(torch, np, dev):
    """The recsys family's serving path at full width (see the module
    docstring, phase 8). Returns (report, the embedding_bag kernel row).
    Memory is reported above what was resident when a config began."""
    import gc

    from repro_torch.configs import recsys_family as rf
    from repro_torch.data import recsys_synth
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import (embedding_bag_cuda,
                                                   embedding_bag_plain)
    from repro_torch.models.recsys import bert4rec, common, ctr

    rep = {"tol_logits_rel": TOL_RS_LOGITS, "tol_bulk_lookup": TOL_RS_BULK}
    B_p99 = rf.RS_SHAPES["serve_p99"]["batch"]
    B_bulk = rf.RS_SHAPES["serve_bulk"]["batch"]
    n_cand = rf.RS_SHAPES["retrieval_cand"]["n_cand"]
    rng = np.random.default_rng(7)
    row = None

    def ctr_batch(cfg, B):
        return recsys_synth.ctr_batch(
            rng, batch=B, n_dense=cfg.n_dense,
            vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz,
            device=dev)

    def resident() -> int:
        """Free what the last config left, restart the peak; the bytes
        still allocated (earlier phases' leftovers), which each config's
        memory figures are counted above."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    for cfg, per_forward in ((rf.DLRM_RM2, 1), (rf.WIDE_DEEP, 2),
                             (rf.DCN_V2, 1)):
        base = resident()
        t0 = time.perf_counter()
        params = ctr.init(torch.Generator(device=dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        r = {"resident_before_gb": base / 1e9,
             "init_s": time.perf_counter() - t0,
             "params_gb": (torch.cuda.memory_allocated() - base) / 1e9,
             "table_rows": int(params["tables"]["fused"].shape[0]),
             "embed_dim": cfg.sparse.embed_dim, "nnz": cfg.sparse.nnz,
             "fields": cfg.sparse.n_fields}
        serve = rf.make_fn(cfg, "serve")
        small, bulk = ctr_batch(cfg, B_p99), ctr_batch(cfg, B_bulk)

        # serve_p99: the counts from 0 before the timed calls, read after
        ops.reset_launch_counts()
        serve(params, small)
        r["launches_per_forward"] = ops.launch_counts()["embedding_bag"]
        ops.reset_launch_counts()
        ms = latencies_ms(torch, lambda: serve(params, small), RS_P99_CALLS)
        r["serve_p99"] = {
            "batch": B_p99, "calls": RS_P99_CALLS,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "launches": ops.launch_counts()["embedding_bag"]}
        ops.reset_launch_counts()
        ms = latencies_ms(torch, lambda: serve(params, bulk), RS_BULK_CALLS,
                          warmup=1)
        r["serve_bulk"] = {
            "batch": B_bulk, "calls": RS_BULK_CALLS,
            "ms": float(np.mean(ms)),
            "samples_per_s": B_bulk / (float(np.mean(ms)) / 1e3),
            "launches": ops.launch_counts()["embedding_bag"]}
        logits = serve(params, small)
        bulk_logits = serve(params, bulk)
        check(tuple(logits.shape) == (B_p99,)
              and tuple(bulk_logits.shape) == (B_bulk,),
              f"{cfg.name} logits {tuple(logits.shape)}, "
              f"{tuple(bulk_logits.shape)}")
        check(bool(torch.isfinite(logits).all()
                   and torch.isfinite(bulk_logits).all()),
              f"non-finite {cfg.name} logits")
        check(r["launches_per_forward"] == per_forward,
              f"{cfg.name}: {r['launches_per_forward']} embedding_bag "
              f"launches per forward, expected {per_forward}")
        for cell, n in (("serve_p99", RS_P99_CALLS + 3),
                        ("serve_bulk", RS_BULK_CALLS + 1)):
            check(r[cell]["launches"] == n * per_forward,
                  f"{cfg.name} {cell}: {r[cell]['launches']} embedding_bag "
                  f"launches, expected {n * per_forward}")

        # kernel vs plain: the p99 forward's logits, the bulk lookups
        with torch.no_grad():
            plain = ctr.forward(params, cfg, small, impl="plain")
            top = float(plain.abs().max())
            r["logits_max_rel_err"] = float((logits - plain).abs().max()) / top
            errs = []
            tables = [(params["tables"], cfg.sparse)]
            if cfg.wide:
                tables.append((params["wide"], cfg.wide_spec))
            for t, spec in tables:
                got = common.lookup(t, spec, bulk["sparse_idx"],
                                    bulk["sparse_w"])
                exp = common.lookup(t, spec, bulk["sparse_idx"],
                                    bulk["sparse_w"], impl="plain")
                errs.append(float((got - exp).abs().max()))
                del got, exp
            del tables, t
        r["bulk_lookup_max_abs_err"] = errs
        check(r["logits_max_rel_err"] <= TOL_RS_LOGITS,
              f"{cfg.name} logits, kernel vs plain, differ by "
              f"{r['logits_max_rel_err']} of the largest")
        check(max(errs) <= TOL_RS_BULK,
              f"{cfg.name} bulk lookups, kernel vs plain, differ by {errs}")

        if cfg is rf.DLRM_RM2:
            # retrieval_cand: one query against 10^6 precomputed candidates
            retrieve = rf.make_fn(cfg, "retrieval")
            cand = torch.randn(n_cand, rf.ctr_repr_dim(cfg), device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(3))
            one = ctr_batch(cfg, 1)
            ops.reset_launch_counts()
            ms = latencies_ms(torch, lambda: retrieve(params, one, cand),
                              RS_RETRIEVAL_CALLS)
            scores, rows = retrieve(params, one, cand)
            with torch.no_grad():
                u = ctr.user_repr(params, cfg, one)
            re = float((scores - (cand[rows[0]] @ u[0])[None]).abs().max())
            r["retrieval_cand"] = {
                "candidates": n_cand, "dim": rf.ctr_repr_dim(cfg),
                "calls": RS_RETRIEVAL_CALLS, "ms": float(np.mean(ms)),
                "p99_ms": float(np.percentile(ms, 99)),
                "launches": ops.launch_counts()["embedding_bag"],
                "rescore_max_abs_err": re}
            check(tuple(scores.shape) == (1, 100)
                  and bool((scores[0, :-1] >= scores[0, 1:]).all()),
                  "retrieval scores are not a sorted top-100")
            check(re <= 1e-4, f"retrieval scores differ from a rescore by "
                  f"{re}")
            del cand

            # the kernel at serve_bulk's shape, on the fused table
            table = params["tables"]["fused"]
            V, d = table.shape
            idx = (bulk["sparse_idx"] + common.field_offsets(
                cfg.sparse, dev)[None, :, None]).contiguous()
            w = bulk["sparse_w"]
            out = embedding_bag_cuda(table, idx, w)
            exp = embedding_bag_plain(table, idx, w)
            torch.cuda.synchronize()
            err = float((out - exp).abs().max())
            check(err <= TOL_RS_BULK, f"embedding_bag at the bulk shape "
                  f"differs from plain by {err}")
            del exp
            Bk, Fk, nnz = idx.shape
            flat_idx, flat_w = idx.view(Bk * Fk, nnz), w.view(Bk * Fk, nnz)
            lib = torch.nn.functional.embedding_bag
            b_ms, b_by = bound_ms(
                gathered_bytes(idx, V, d * table.element_size())
                + nbytes(idx, w, out), 2 * Bk * Fk * nnz * d)
            row = {
                "name": "embedding_bag", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
                "replaces": "src/repro/kernels/embedding_bag.py:37",
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: embedding_bag_cuda(table, idx,
                                                                w)),
                "plain_ms": time_ms(torch, lambda: embedding_bag_plain(
                    table, idx, w), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(torch, lambda: lib(
                    flat_idx, table, per_sample_weights=flat_w,
                    mode="sum")),
                "shape": [Bk, Fk, nnz, V, d], "dtype": "float32",
                "index_slots": idx.numel(),
                "distinct_rows": distinct_rows(idx, V)}
            del out

            # the table's last row, negative indices, out-of-range -> NaN
            edge = torch.tensor([[[V - 1, 0], [-1, 5], [V, 1], [-V - 1, 2],
                                  [-V, V - 2]]], dtype=torch.int32,
                                device=dev)
            ew = torch.ones(edge.shape, device=dev)
            ew[0, 2, 0] = 0.0                  # weight 0 does not hide it
            got = embedding_bag_cuda(table, edge, ew)
            exp = torch.stack([table[V - 1] + table[0], table[V - 1]
                               + table[5], table[1], table[2],
                               table[0] + table[V - 2]])
            nan = torch.isnan(got[0]).all(dim=-1).tolist()
            fin = [0, 1, 4]
            e_err = float((got[0, fin] - exp[fin]).abs().max())
            r["edge_indices"] = {"nan_bags": nan, "max_abs_err": e_err,
                                 "last_row": V - 1}
            check(nan == [False, False, True, True, False],
                  f"out-of-range bags are not NaN (only): {nan}")
            check(e_err == 0.0, f"edge-index bags differ by {e_err}")

            # a bf16 table against plain
            nb = min(V, 1_000_000)
            tb = table[:nb].to(torch.bfloat16)
            bi = torch.randint(0, nb, (4096, 26, 2), device=dev,
                               dtype=torch.int32)
            bw = torch.rand(bi.shape, device=dev)
            got = embedding_bag_cuda(tb, bi, bw).float()
            exp = embedding_bag_plain(tb, bi, bw).float()
            r["bf16_max_rel_err"] = float((got - exp).abs().max()
                                          / exp.abs().max())
            check(r["bf16_max_rel_err"] <= TOL_RS_BF16,
                  f"bf16 embedding_bag differs from plain by "
                  f"{r['bf16_max_rel_err']} of the largest")
            del tb, bi, bw, got, exp, idx, w, flat_idx, flat_w, table
        r["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        rep[cfg.name] = r
        print(f"recsys {cfg.name}: " + json.dumps(r), flush=True)
        del params, small, bulk, logits, bulk_logits, plain

    # BERT4Rec: masked attention takes the plain path, so 0 launches
    base = resident()
    cfg = rf.BERT4REC
    params = bert4rec.init(torch.Generator(device=dev).manual_seed(0), cfg)
    r = {"resident_before_gb": base / 1e9,
         "params_gb": (torch.cuda.memory_allocated() - base) / 1e9,
         "items": cfg.n_items, "serve_bulk": "left out: a [262144, 3M] "
         "f32 score matrix is 3.1 TB"}
    toks = recsys_synth.bert4rec_batch(
        rng, batch=B_p99, seq_len=cfg.seq_len, n_items=cfg.n_items,
        n_mask=cfg.n_mask, n_neg=cfg.n_neg, mask_token=cfg.mask_token,
        device=dev)["tokens"]
    batch = {"tokens": toks}
    serve = rf.make_fn(cfg, "serve")
    ops.reset_launch_counts()
    ms = latencies_ms(torch, lambda: serve(params, batch), RS_B4R_CALLS)
    scores, ids = serve(params, batch)
    r["serve_p99"] = {"batch": B_p99, "calls": RS_B4R_CALLS,
                      "p50_ms": float(np.percentile(ms, 50)),
                      "p99_ms": float(np.percentile(ms, 99)),
                      "launches": ops.launch_counts()["embedding_bag"]}
    retrieve = rf.make_fn(cfg, "retrieval")
    cand_ids = torch.randint(1, cfg.n_items, (n_cand,), device=dev,
                             dtype=torch.int32)
    one = {"tokens": toks[:1]}
    ops.reset_launch_counts()
    ms = latencies_ms(torch, lambda: retrieve(params, one, cand_ids),
                      RS_RETRIEVAL_CALLS)
    r["retrieval_cand"] = {"candidates": n_cand, "calls": RS_RETRIEVAL_CALLS,
                           "ms": float(np.mean(ms)),
                           "p99_ms": float(np.percentile(ms, 99)),
                           "launches": ops.launch_counts()["embedding_bag"]}
    r["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    # the first rows against the same serve on the CPU
    cpu_params = tree_to(params, "cpu")
    with torch.no_grad():
        n = RS_B4R_CPU_ROWS
        s_cpu, i_cpu = bert4rec.serve(cpu_params, cfg,
                                      {"tokens": toks[:n].cpu()})
    r["cpu_check"] = {
        "rows": n,
        "scores_max_abs_err": float((scores[:n].cpu() - s_cpu).abs().max()),
        "top10_sets_equal": all(
            set(a[:10]) == set(b[:10]) for a, b in
            zip(ids[:n].cpu().tolist(), i_cpu.tolist()))}
    rep[cfg.name] = r
    print(f"recsys {cfg.name}: " + json.dumps(r), flush=True)
    check(tuple(scores.shape) == (B_p99, 100)
          and bool(torch.isfinite(scores).all()), "BERT4Rec serve scores")
    check(r["serve_p99"]["launches"] == 0
          and r["retrieval_cand"]["launches"] == 0,
          "BERT4Rec launched embedding_bag")
    check(r["cpu_check"]["scores_max_abs_err"] <= TOL_RS_B4R_CPU
          and r["cpu_check"]["top10_sets_equal"],
          f"BERT4Rec serve on the card vs the CPU: {r['cpu_check']}")
    del params, cpu_params, scores, ids, cand_ids
    gc.collect()
    torch.cuda.empty_cache()
    return rep, row


def adam_by_chunks(torch, names, params, grads) -> dict:
    """Each leaf of ``params`` the in-place Adam splits into row chunks
    takes ADAM_CHECK_STEPS steps of the LM's TRAIN_OPT, at its full lr (no
    warm-up: every element moves by ~lr) and with the clip off, over its
    gradient: once by ``adam.CHUNK`` and once with CHUNK above the leaf.
    Returns, per leaf, the errors of p, m and v chunked against whole and
    whole against Adam in f64, each relative to the largest magnitude,
    and the clip's global norm (summed by chunks) against the f64 norm."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import lm_family
    from repro_torch.optim import adam

    acfg = dataclasses.replace(lm_family.TRAIN_OPT, grad_clip=0.0)
    chunk0 = adam.CHUNK

    def rel(a, b) -> float:
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    out = {"chunk": chunk0, "steps": ADAM_CHECK_STEPS, "lr": acfg.lr,
           "leaves": {}}
    for n, p, g in zip(names, params, grads):
        if p.numel() <= chunk0:
            continue
        runs = []
        for chunk in (chunk0, p.numel()):
            adam.CHUNK = chunk
            try:
                tree = {"w": p.detach().clone()}
                st = optim.adam_init(tree)
                for _ in range(ADAM_CHECK_STEPS):
                    tree, st, _ = optim.adam_update(tree, {"w": g}, st,
                                                    acfg)
            finally:
                adam.CHUNK = chunk0
            runs.append((tree["w"], st["m"]["w"], st["v"]["w"]))
            del tree, st
        (pc, mc, vc), (pw, mw, vw) = runs
        leaf = {"shape": list(p.shape),
                "chunk_rows": chunk0 // p[0].numel(),
                "chunked_vs_whole": {"p": rel(pc, pw), "m": rel(mc, mw),
                                     "v": rel(vc, vw)}}
        # Adam in f64 over the whole leaf, a chunk of rows at a time
        err = {k: [0.0, 0.0] for k in "pmv"}
        sq, moved = 0.0, 0.0
        for rows in zip(*(t.split(leaf["chunk_rows"])
                          for t in (p.detach(), g, pw, mw, vw))):
            p0, gs = rows[0].double(), rows[1].double()
            sq += float(gs.square().sum())
            pr, mr, vr = p0, 0.0, 0.0
            for t in range(1, ADAM_CHECK_STEPS + 1):
                mr = acfg.b1 * mr + (1 - acfg.b1) * gs
                vr = acfg.b2 * vr + (1 - acfg.b2) * gs * gs
                upd = (mr / (1 - acfg.b1 ** t)) / (
                    (vr / (1 - acfg.b2 ** t)).sqrt() + acfg.eps)
                pr = pr - acfg.lr * (upd + acfg.weight_decay * pr)
            for k, got, ref in zip("pmv", rows[2:], (pr, mr, vr)):
                err[k][0] = max(err[k][0],
                                float((got.double() - ref).abs().max()))
                err[k][1] = max(err[k][1], float(ref.abs().max()))
            moved = max(moved, float((rows[2].double() - p0).abs().max()))
        leaf["whole_vs_f64"] = {k: e / max(m, 1e-30)
                                for k, (e, m) in err.items()}
        leaf["moved"] = moved
        norm = float(optim.clip_by_global_norm([g.clone()], 1.0))
        leaf["norm"] = {"chunked": norm, "f64": sq ** 0.5,
                        "rel_err": abs(norm / sq ** 0.5 - 1)}
        out["leaves"][n] = leaf
        del runs, pc, mc, vc, pw, mw, vw
    return out


def lm_train_phase(torch, np, dev):
    """The LM family's training path (see the module docstring, phase 8).
    Returns (report, the launch counts of the timed run's four steps)."""
    import dataclasses
    import gc

    from repro_torch import optim
    from repro_torch.configs import lm_family
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        _bwd_cuda_as_written, _bwd_plain_f32, flash_attention_cuda)
    from repro_torch.models import lm
    from repro_torch.optim.adam import leaves

    S = lm_family.LM_SHAPES["train_4k"]["seq"]
    B = lm_family.ONE_CARD_TRAIN["batch"]
    bf16 = torch.bfloat16
    gt = torch.Generator(device=dev).manual_seed(4)

    def batch_of(cfg, B):
        return lm_family.train_batch(cfg, B, S, gt, dev)

    def resident() -> int:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def launches_since(before):
        now = ops.launch_counts()
        return {k: now[k] - before[k] for k in FLASH_KERNELS}

    # ---- the timed run: depth 8, B=2, S=4,096, bf16
    base = resident()
    cfg = dataclasses.replace(lm_family.QWEN3_14B,
                              n_layers=lm_family.ONE_CARD_TRAIN["n_layers"])
    L = cfg.n_layers
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, bf16)
    opt = optim.adam_init(params)
    state_gb = (torch.cuda.memory_allocated() - base) / 1e9
    before = {p: t.detach().to("cpu", copy=True) for p, t in leaves(params)}
    step = lm_family.make_fn(cfg, "train")
    batch = batch_of(cfg, B)
    tokens = B * S
    losses, step_s, per_step = [], [], []
    ops.reset_launch_counts()
    for _ in range(1 + LM_TRAIN_TIMED):
        b0 = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        per_step.append(launches_since(b0))
    launches = ops.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    s_step = float(np.mean(step_s[1:]))
    changed = {p: int((t != before[p].to(dev)).sum())
               for p, t in leaves(params)}
    m_zero = [p for p, t in leaves(opt["m"]) if not bool(t.ne(0).any())]
    rep = {"config": cfg.name, "layers": L, "batch": B,
           "seq": S, "params": cfg.param_count(), "state_gb": state_gb,
           "losses": losses, "step_s": step_s, "s_per_step": s_step,
           "tokens_per_s": tokens / s_step,
           "model_tflop_per_s": 6 * cfg.active_param_count() * tokens
           / s_step / 1e12,
           "peak_gb": peak_gb, "resident_before_gb": base / 1e9,
           "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
           "count": int(opt["count"]), "launches_per_step": per_step,
           "launches": {k: launches[k] for k in per_step[0]},
           "elements_changed": changed}
    print("lm-train: " + json.dumps({k: v for k, v in rep.items()
                                     if k != "elements_changed"}),
          flush=True)
    check(all(np.isfinite(losses)), f"LM train losses {losses}")
    check(rep["count"] == 1 + LM_TRAIN_TIMED, f"opt count {rep['count']}")
    # the forward and its remat recompute on the route forward_route picks,
    # the backward on backward_route's (bf16 at head dim 128: the Hopper
    # kernels)
    want = {**flash_fwd_launches(bf16, cfg.hd, 2 * L),
            **flash_bwd_launches(bf16, cfg.hd, L)}
    check(all(c == want for c in per_step),
          f"LM train launches per step {per_step}, expected {want}")
    # every leaf got a gradient and an update of its moments; every matrix
    # moved. A norm scale (1.0 in bf16, an ulp of 2^-7) cannot move by an
    # Adam step of lr ~1e-5: its count is reported, not held
    check(not m_zero, f"leaves whose first moment is still 0: {m_zero}")
    still = [p for p, t in leaves(params) if t.dim() >= 2 and changed[p] == 0]
    check(not still, f"matrices that did not move: {still}")

    # ---- the Hopper backward on layer 0's own attention inputs in a bf16
    # step: q, k, v as that layer's projections give them and dO as the
    # loss sends it back (the output's gradient, by a hook), o and lse
    # from the Hopper forward on them; held to plain as at the train shape
    # below (bwd_hopper_errors: f32 before the cast, element-wise after
    # it, the dropped-key-tile controls)
    acts = {}
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True):
        out = real(q, k, v, causal=causal)
        if not acts and out.requires_grad:         # layer 0's first call
            acts.update(q=q.detach().clone(), k=k.detach().clone(),
                        v=v.detach().clone())
            out.register_hook(
                lambda g: acts.setdefault("do", g.detach().clone()))
        return out

    ops.flash_attention = spy
    try:
        params, opt, m = step(params, opt, batch)
    finally:
        ops.flash_attention = real
    del params, opt, before, batch, step, m
    resident()
    q, k, v, do = (acts[n] for n in ("q", "k", "v", "do"))
    # the gradients are linear in dO, and a power of two scales bf16 and
    # every f32 product exactly, in both versions: dO is brought to an RMS
    # in [0.5, 1) so that the element-wise limit's absolute term (1e-4, for
    # unit-scale gradients) stays below them, as on the random inputs
    # (layer 0's own dO is ~1e-4, where the absolute term alone would pass
    # a dropped key tile; the f32 limit, relative, is unmoved by the scale)
    do_rms = float(do.float().square().mean().sqrt())
    do_scale = 2.0 ** -torch.frexp(torch.tensor(do_rms)).exponent.item()
    do = do * do_scale
    o, lse = flash_attention_cuda(q, k, v, True)
    # a check's launches, counted from 0 (the kernels line's
    # check_launches)
    ops.reset_launch_counts()
    got = _bwd_cuda_as_written(q, k, v, o, lse, do, True)
    act_launches = {n: ops.launch_counts()[n] for n in FLASH_KERNELS}
    exp = _bwd_plain_f32(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    check(act_launches == {**flash_fwd_launches(bf16, cfg.hd, 0),
                           **flash_bwd_launches(bf16, cfg.hd, 1)},
          f"layer-0 backward launches {act_launches}")
    rep["layer0_bwd"] = {
        "shape": list(q.shape) + [k.shape[2]], "launches": act_launches,
        "do_rms": do_rms, "do_scale": do_scale,
        **bwd_hopper_errors(q, k, v, o, lse, do, got, exp, "layer 0")}
    print("lm-train layer-0 backward: " + json.dumps(rep["layer0_bwd"]),
          flush=True)
    del acts, q, k, v, do, o, lse, got, exp

    # ---- accumulation over two microbatches of 1 x 4,096: depth 2
    base = resident()
    cfg2 = dataclasses.replace(lm_family.QWEN3_14B, n_layers=LM_CHECK_LAYERS)
    L2 = cfg2.n_layers
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg2, bf16)
    opt = optim.adam_init(params)
    step = optim.make_train_step(
        lambda p, b: lm.lm_loss(p, cfg2, b),
        dataclasses.replace(lm_family.TRAIN_OPT, accum_steps=2),
        lm_family.TRAIN_SCHEDULE)
    b0 = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch_of(cfg2, 2))
    torch.cuda.synchronize()
    rep["accum"] = {"layers": L2, "accum_steps": 2, "microbatch": [1, S],
                    "s": time.perf_counter() - t0, "loss": float(m["loss"]),
                    "launches": launches_since(b0),
                    "peak_gb": (torch.cuda.max_memory_allocated() - base)
                    / 1e9}
    print("lm-train accum: " + json.dumps(rep["accum"]), flush=True)
    want = {**flash_fwd_launches(bf16, cfg2.hd, 4 * L2),
            **flash_bwd_launches(bf16, cfg2.hd, 2 * L2)}
    check(np.isfinite(rep["accum"]["loss"]), "non-finite accumulated loss")
    check(rep["accum"]["launches"] == want, f"accumulated step launches "
          f"{rep['accum']['launches']}, expected {want}")
    del params, opt, step, m

    # ---- kernel vs plain: loss and gradients, depth 2, f32, B=1
    base = resident()
    cfgf = dataclasses.replace(cfg2, dtype="float32")
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfgf,
                     torch.float32)
    names = [p for p, _ in leaves(params)]
    flat = [t.requires_grad_() for _, t in leaves(params)]
    batch = batch_of(cfgf, 1)
    res = {}
    for impl in ("kernel", "plain"):
        ops.reset_launch_counts()
        b0 = ops.launch_counts()
        loss, _ = lm.lm_loss(params, cfgf, batch, impl=impl)
        res[impl] = (float(loss.detach()),
                     torch.autograd.grad(loss, flat), launches_since(b0))
        del loss
    (lk, gk, ck), (lp, gp, cp) = res["kernel"], res["plain"]
    ratios = {n: float((a - b).abs().max()) / max(float(b.abs().max()),
                                                  1e-30)
              for n, a, b in zip(names, gk, gp)}
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    rep["plain"] = {"layers": L2, "batch": 1, "seq": S, "dtype": "float32",
                    "loss_kernel": lk, "loss_plain": lp,
                    "loss_abs_err": abs(lk - lp),
                    "grad_worst_rel_err": worst[0][1],
                    "grad_worst_leaves": worst, "n_grad_leaves": len(names),
                    "launches_kernel": ck, "launches_plain": cp,
                    "peak_gb": (torch.cuda.max_memory_allocated() - base)
                    / 1e9}
    print("lm-train plain: " + json.dumps(rep["plain"]), flush=True)
    check(abs(lk - lp) <= TOL_LOSS, f"LM train loss kernel {lk} vs plain "
          f"{lp}")
    check(worst[0][1] <= TOL_GRAD, f"LM gradient leaf {worst[0][0]} "
          f"differs by {worst[0][1]} of its magnitude")
    # f32: the forward and the backward on the SIMT kernels
    check(sum(cp.values()) == 0 and ck == {
        **flash_fwd_launches(torch.float32, cfgf.hd, 2 * L2),
        **flash_bwd_launches(torch.float32, cfgf.hd, L2)},
        f"launches kernel {ck}, plain {cp}")
    del res, gp, batch

    # ---- the in-place Adam by row chunks, on the card, over the f32
    # kernel gradients
    rep["adam"] = adam_by_chunks(torch, names, flat, gk)
    print("lm-train adam: " + json.dumps(rep["adam"]), flush=True)
    split = rep["adam"]["leaves"]
    check(len(split) == 2 + 3 * L2,
          f"Adam split {sorted(split)}, expected embed, head and "
          f"{3 * L2} FFN matrices")
    bad = {n: e for n, e in split.items()
           if max(*e["chunked_vs_whole"].values(),
                  *e["whole_vs_f64"].values()) > TOL_ADAM
           or e["norm"]["rel_err"] > TOL_ADAM_NORM}
    check(not bad, f"Adam by row chunks: {bad}")
    del params, flat, gk
    resident()
    return rep, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import gc

    import numpy as np
    from repro_torch import core, data, serving, training
    from repro_torch.configs import PROD, lm_family
    from repro_torch.kernels import ops
    from repro_torch.kernels.bus_attention import (bus_attention_bwd_cuda,
                                                   bus_attention_bwd_plain,
                                                   bus_attention_cuda,
                                                   bus_attention_plain)
    from repro_torch.kernels.flash_attention import (
        _bwd_cuda_as_written, _bwd_plain_f32, flash_attention_bwd_cuda,
        flash_attention_bwd_plain, flash_attention_cuda,
        flash_attention_fwd_plain)
    from repro_torch.kernels.pq_scoring import (pq_lut_scores_cuda,
                                                pq_lut_scores_plain)
    from repro_torch.launch.profile import pq_distortion
    from repro_torch.launch.serve import (Recommender, _pad_histories,
                                          measure_recall, micro_batch_loop)
    from repro_torch.launch.train import first_batch_of_bucket, make_loader
    from repro_torch.models import lm
    from repro_torch.nn import attention, embed, rmsnorm
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
    # a library already under build/ is loaded as it is, with the .log its
    # build left (the same source and flags, by the file name's hash)
    built_now = {name: not hopper_library(name).exists()
                 for name in HOPPER_LIBS}
    t0 = time.perf_counter()
    logs = ops.build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {name}: {regs}", flush=True)
    print(f"kernels built in {report['build_s']:.1f} s", flush=True)
    # the Hopper flash kernels (forward; backward dq and dk/dv): no spills
    # (ptxas -v), and tensor-core products in each instantiation's machine
    # code (wgmma is HGMMA in SASS)
    report["hopper"] = {}
    for name in HOPPER_LIBS:
        ptxas = ptxas_by_kernel(logs[name])
        lines = [ln for kern in ptxas.values() for ln in kern]
        spills = [ln for ln in lines if "spill" in ln
                  and ln != "0 bytes stack frame, 0 bytes spill stores, "
                            "0 bytes spill loads"]
        check(sum("spill" in ln for ln in lines) == len(ptxas) > 0
              and not spills, f"{name}: ptxas reports spills: {ptxas}")
        hgmma = sass_hgmma(hopper_library(name))
        report["hopper"][name] = {"ptxas": ptxas, "sass_hgmma": hgmma,
                                  "ptxas_built_this_run": built_now[name]}
        print(f"{name}: ptxas {ptxas}; HGMMA per function {hgmma}",
              flush=True)
        check(set(hgmma) == set(ptxas) and all(hgmma.values()),
              f"{name}: a wgmma kernel's SASS has no HGMMA: {hgmma}")

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

    # --------------------------------------------------------------- lm
    # the trainer's memory goes first; the peak counts from here
    del trainer, state, res, top_batch, watch, now, neg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qcfg = lm_family.QWEN3_14B
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    lm_params = lm.init(torch.Generator(device=dev).manual_seed(0), qcfg,
                        bf16)
    torch.cuda.synchronize()
    lm_rep = {"config": dataclasses.asdict(qcfg),
              "params": qcfg.param_count(),
              "params_gb": torch.cuda.memory_allocated() / 1e9,
              "init_s": time.perf_counter() - t0}
    prefill = lm_family.make_fn(qcfg, "prefill")
    decode = lm_family.make_fn(qcfg, "decode")
    gl = torch.Generator(device=dev).manual_seed(2)
    V = qcfg.vocab

    def greedy(tok, cache, steps):
        """``steps`` synchronised greedy decode steps from slot 0; returns
        (per-step ms, the flash forward launches they made by route,
        last logits)."""
        ops.reset_launch_counts()
        ms = []
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode(lm_params, tok, cache, t)
            tok = logits.argmax(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        now = ops.launch_counts()
        return ms, {n: now[n] for n in FLASH_FWD}, logits

    toks = torch.randint(0, V, (1, LM_PREFILL_SEQ), generator=gl, device=dev)
    t0 = time.perf_counter()
    prefill(lm_params, toks)                             # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    last = prefill(lm_params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.launch_counts()
    lm_rep["prefill"] = {
        "batch": 1, "seq": LM_PREFILL_SEQ, "warmup_s": warm_s,
        "s": prefill_s, "tokens_per_s": LM_PREFILL_SEQ / prefill_s,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": prefill_launches}
    print("lm prefill: " + json.dumps(lm_rep["prefill"]), flush=True)
    check(tuple(last.shape) == (1, V), f"prefill logits {tuple(last.shape)}")
    check(bool(torch.isfinite(last).all()), "non-finite prefill logits")
    want = flash_fwd_launches(bf16, qcfg.hd, qcfg.n_layers)
    check({n: prefill_launches[n] for n in FLASH_FWD} == want,
          f"flash forward launches in one bf16 prefill: "
          f"{ {n: prefill_launches[n] for n in FLASH_FWD} }, expected "
          f"{want}")
    del toks, last
    torch.cuda.empty_cache()

    for name, quant, steps in (("decode", False, LM_DECODE_STEPS),
                               ("decode_q8", True, LM_Q8_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        cache = lm.init_cache(qcfg, LM_DECODE_BATCH, LM_DECODE_SLOTS, bf16,
                              quant=quant, device=dev)
        tok = torch.randint(0, V, (LM_DECODE_BATCH, 1), generator=gl,
                            device=dev)
        ms, flash_n, logits = greedy(tok, cache, steps)
        steady = ms[1:]
        lm_rep[name] = {
            "batch": LM_DECODE_BATCH, "slots": LM_DECODE_SLOTS,
            "steps": steps, "cache_gb": sum(nbytes(t) for t in
                                            cache.values()) / 1e9,
            "first_step_ms": ms[0],
            "ms_per_step": float(np.mean(steady)),
            "ms_per_step_median": float(np.median(steady)),
            "tokens_per_s": LM_DECODE_BATCH * 1e3 / float(np.mean(steady)),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flash_launches": flash_n}
        print(f"lm {name}: " + json.dumps(lm_rep[name]), flush=True)
        check(bool(torch.isfinite(logits).all()), f"non-finite {name} logits")
        check(not any(flash_n.values()), f"{name} launched the flash "
              f"forward {flash_n} times, expected 0")
        del cache, logits
        torch.cuda.empty_cache()

    def cast_(tree, dtype):
        """Cast every tensor of a nested dict/list in place, one at a time
        (the peak is the new tree plus one old leaf)."""
        keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
        for key in list(keys):
            if torch.is_tensor(tree[key]):
                tree[key] = tree[key].to(dtype)
            else:
                cast_(tree[key], dtype)

    def by_layer(ccfg, toks):
        """Layer by layer at S=toks' length, in ccfg's dtype: each layer's
        attention output through the kernel against plain on the plain
        path's hidden state (``local``), and the gap between the hidden
        states the two paths carry to the next layer (``carried``), each
        relative to the plain value's largest magnitude."""
        acfg = ccfg.attn_cfg(local=True)
        local, carried = [], []
        with torch.no_grad():
            x = embed(lm_params["embed"], toks, dtype=ccfg.torch_dtype)
            x_k = x
            for layer in lm_params["layers"]:
                h = rmsnorm(layer["ln1"], x)
                a_k = attention(layer["attn"], h, acfg, impl="kernel").float()
                a_p = attention(layer["attn"], h, acfg, impl="plain").float()
                local.append(float((a_k - a_p).abs().max()
                                   / a_p.abs().max()))
                x_k = lm._block(layer, x_k, ccfg, "kernel")
                x = lm._block(layer, x, ccfg, "plain")
                carried.append(float((x_k.float() - x.float()).abs().max()
                                     / x.float().abs().max()))
        return {"seq": toks.shape[1], "attn_local_max_rel_err": local,
                "hidden_carried_max_rel_err": carried}

    # prefill through the kernel against the T-th decode step's logits,
    # and the prefill through the kernel against its plain version; in
    # bf16 (with the layer-by-layer reading), then with the weights cast
    # to f32
    dec_toks = torch.randint(0, V, (LM_CHECK_B, LM_CHECK_T), generator=gl,
                             device=dev)
    plain_toks = torch.randint(0, V, (1, LM_PLAIN_SEQ), generator=gl,
                               device=dev)
    lm_rep["check"] = {"tol_rel_f32": TOL_LM_REL_F32,
                       "tol_attn_bf16": TOL_ATTN_BF16}
    for dt in ("bfloat16", "float32"):
        ccfg = dataclasses.replace(qcfg, dtype=dt)
        cast_(lm_params, ccfg.torch_dtype)
        ops.reset_launch_counts()
        ref = lm_family.make_fn(ccfg, "prefill")(lm_params, dec_toks).float()
        step = lm_family.make_fn(ccfg, "decode")
        cache = lm.init_cache(ccfg, LM_CHECK_B, LM_CHECK_T,
                              ccfg.torch_dtype, device=dev)
        for t in range(LM_CHECK_T):
            logits, cache = step(lm_params, dec_toks[:, t:t + 1], cache, t)
        logits = logits.float()
        with torch.no_grad():
            kern = lm.prefill(lm_params, ccfg, plain_toks).float()
            plain_l = lm.prefill(lm_params, ccfg, plain_toks,
                                 impl="plain").float()
        lm_rep["check"][dt] = {
            "prefill_vs_decode": {
                "batch": LM_CHECK_B, "T": LM_CHECK_T,
                "max_rel_err": float((logits - ref).abs().max()
                                     / ref.abs().max()),
                "argmax_agree": float((logits.argmax(-1) == ref.argmax(-1))
                                      .float().mean()),
                "max_abs_logit": float(ref.abs().max())},
            "kernel_vs_plain": {
                "seq": LM_PLAIN_SEQ,
                "max_rel_err": float((kern - plain_l).abs().max()
                                     / plain_l.abs().max())}}
        check(bool(torch.isfinite(logits).all() and torch.isfinite(kern).all()),
              f"non-finite {dt} check logits")
        del ref, cache, logits, kern, plain_l
        if dt == "bfloat16":
            lm_rep["check"][dt]["by_layer"] = by_layer(ccfg, plain_toks)
        now = ops.launch_counts()
        lm_rep["check"][dt]["flash_launches"] = {n: now[n]
                                                 for n in FLASH_FWD}
        torch.cuda.empty_cache()
    report["lm"] = lm_rep
    print("lm check: " + json.dumps(lm_rep["check"]), flush=True)
    # two kernel prefills a dtype (at T=64 and at LM_PLAIN_SEQ), and in bf16
    # the layer-by-layer reading's attention and block (two a layer), each
    # on its dtype's route: bf16 on the Hopper kernel, f32 on the SIMT one
    nl = qcfg.n_layers
    for dt, n in (("bfloat16", 4 * nl), ("float32", 2 * nl)):
        want = flash_fwd_launches(getattr(torch, dt), qcfg.hd, n)
        got = lm_rep["check"][dt]["flash_launches"]
        check(got == want, f"{dt} LM check flash launches {got}, expected "
              f"{want}")
    f32 = lm_rep["check"]["float32"]
    for name in ("prefill_vs_decode", "kernel_vs_plain"):
        check(f32[name]["max_rel_err"] <= TOL_LM_REL_F32,
              f"f32 {name} logits differ by {f32[name]['max_rel_err']} of "
              f"the largest")
    local = lm_rep["check"]["bfloat16"]["by_layer"]["attn_local_max_rel_err"]
    worst = int(np.argmax(local))
    check(local[worst] <= TOL_ATTN_BF16,
          f"bf16 attention of layer {worst}, kernel vs plain on the same "
          f"input, differs by {local[worst]} of its largest value")
    del lm_params
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------- lm-train
    report["lm_train"], lm_train_launches = lm_train_phase(torch, np, dev)

    # ----------------------------------------------------------- recsys
    report["recsys"], ebag_row = recsys_phase(torch, np, dev)

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

    # flash attention at Qwen3-14B's heads, on both routes of the forward
    # (kernels/flash_attention.py:forward_route): the Hopper kernel for
    # bf16, the SIMT kernel for f32. Each against plain at S=4,096 (f32 on
    # SIMT, bf16 on Hopper, and a bf16 Sq = S/4 causal shape); the Hopper
    # kernel timed at the prefill shape, S=32,768, whose launch is also held
    # to plain by row windows (an unsliced plain call there would need 172
    # GB of scores; plain's time is taken at S=4,096), and, below, at the
    # train shape; the SIMT kernel timed at S=4,096 in f32
    Hq, Hkv, Dh = qcfg.n_heads, qcfg.n_kv, qcfg.hd
    G = Hq // Hkv

    def qkv(B, Sq, Sk, dtype):
        return tuple(torch.randn(B, n, h, Dh, generator=g, device=dev)
                     .to(dtype) for n, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))

    def hold(label, o, lse, q, k, v, dtype):
        """Hold (o, lse) of a kernel launch against the plain version on
        q/k/v; in bf16 also element-wise, with a control: the plain
        version with the last key tile's PV dropped must miss (under the
        flat limit alone it would pass: that tile carries ~1/64 of the
        weight of the rows that see it)."""
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, True)
        e = {"o": float((o.float() - o_p.float()).abs().max()),
             "lse": float((lse - lse_p).abs().max())}
        ok = e["o"] <= TOL_FLASH[str(dtype)[6:]] and e["lse"] <= TOL_LSE
        if dtype == bf16:
            e["o_over_limit"] = flash_miss(o, o_p)
            o_c = flash_attention_fwd_plain(
                q, k, dropped_tile(v, k.shape[1] - 64), True)[0]
            e["control_o_over_limit"] = flash_miss(o_c, o_p)
            e["control_o"] = float((o_c.float() - o_p.float()).abs().max())
            ok = ok and e["o_over_limit"] <= 1
            check(e["control_o_over_limit"] > 1,
                  f"flash_attention {label}: the bf16 limit misses a dropped "
                  f"key tile: {e}")
        flash_err[label] = e
        check(ok, f"flash_attention {label} differs from plain: {e}")

    def launch_on(q, k, v):
        """flash_attention_cuda(q, k, v, causal), checked to have launched
        one kernel, on the route forward_route picks."""
        b0 = ops.launch_counts()
        out = flash_attention_cuda(q, k, v, True)
        now = ops.launch_counts()
        got = {n: now[n] - b0[n] for n in FLASH_FWD}
        want = flash_fwd_launches(q.dtype, q.shape[-1], 1)
        check(got == want,
              f"flash forward on {q.dtype} went {got}, expected {want}")
        return out

    def sdpa_fwd_ms(q, k, v, **kw):
        """SDPA's causal forward on the same data, kv heads repeated for
        the groups ([B, H, S, D] copies made outside the timing)."""
        qs = q.transpose(1, 2).contiguous()
        ks = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vs = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        return time_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=True),
                       **kw)

    def fwd_flop(B, Sq):
        return 4 * Dh * Hq * B * Sq * (Sq + 1) // 2   # 4 D a visible pair

    flash_err = {}
    for label, Sq, dtype in (("float32", FLASH_CHECK_SEQ, torch.float32),
                             ("bfloat16", FLASH_CHECK_SEQ, bf16),
                             ("bfloat16_sq_quarter", FLASH_CHECK_SEQ // 4,
                              bf16)):
        q, k, v = qkv(1, Sq, FLASH_CHECK_SEQ, dtype)
        o, lse = launch_on(q, k, v)
        hold(label, o, lse, q, k, v, dtype)
        if label == "float32":
            # the SIMT route's row: f32 at S=4,096, bound at the f32 rate
            simt = {
                "ms": time_ms(torch, lambda: flash_attention_cuda(q, k, v,
                                                                  True),
                              iters=3, warmup=1),
                "plain_ms": time_ms(
                    torch, lambda: flash_attention_fwd_plain(q, k, v, True),
                    iters=3, warmup=1),
                "library_ms": sdpa_fwd_ms(q, k, v, iters=3, warmup=1)}
            simt["bound_ms"], simt["bound_by"] = bound_ms(
                nbytes(q, k, v, o, lse), fwd_flop(1, Sq))
            simt["tflop_per_s"] = fwd_flop(1, Sq) / simt["ms"] / 1e9
        if label == "bfloat16":
            plain_ms = time_ms(
                torch, lambda: flash_attention_fwd_plain(q, k, v, True),
                iters=3, warmup=1)
        del o, lse
    S, R = LM_PREFILL_SEQ, FLASH_ROWS
    q, k, v = qkv(1, S, S, bf16)
    o, lse = launch_on(q, k, v)
    # the first, a middle and the last R rows: row i of a window starting
    # at r0 sees keys [0, r0 + i], so plain on k/v[:, :r0 + R] computes
    # exactly those rows (q_off = r0)
    for name, r0 in (("first", 0), ("middle", S // 2), ("last", S - R)):
        hold(f"prefill_shape_rows_{name}", o[:, r0:r0 + R],
             lse[:, :, r0:r0 + R], q[:, r0:r0 + R], k[:, :r0 + R],
             v[:, :r0 + R], bf16)
    flash_ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, True),
                       iters=10, warmup=2)
    sdpa_ms = sdpa_fwd_ms(q, k, v, iters=5, warmup=2)
    b_ms, b_by = bound_ms(nbytes(q, k, v, o, lse), fwd_flop(1, S),
                          BF16_FLOP_PER_S)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:146",
        # the main paths run bf16 at head dim 128, the Hopper kernel's
        # route, so this is 0; the f32 checks' launches, each counted from
        # 0, are apart under check_launches
        "launches": prefill_launches["flash_attention"]
        + lm_train_launches["flash_attention"],
        "check_launches": {
            "lm_check_float32":
            lm_rep["check"]["float32"]["flash_launches"]["flash_attention"],
            "lm_train_float32_depth2": report["lm_train"]["plain"]
            ["launches_kernel"]["flash_attention"]},
        "launches_by_path": {
            "prefill": prefill_launches["flash_attention"],
            "decode": lm_rep["decode"]["flash_launches"]["flash_attention"],
            "lm_train": lm_train_launches["flash_attention"],
            "serve": launches["flash_attention"],
            "train": train_launches["flash_attention"]},
        "max_abs_err": flash_err["float32"]["o"],
        "errors": {"float32": flash_err["float32"]},
        **simt,
        "shape": [1, FLASH_CHECK_SEQ, FLASH_CHECK_SEQ, Hq, Hkv, Dh],
        "dtype": "float32", "causal": True})
    kernels.append({
        "name": "flash_attention_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:146",
        "launches": prefill_launches["flash_attention_wgmma"]
        + lm_train_launches["flash_attention_wgmma"],
        "launches_by_path": {
            "prefill": prefill_launches["flash_attention_wgmma"],
            "lm_train": lm_train_launches["flash_attention_wgmma"],
            "decode":
            lm_rep["decode"]["flash_launches"]["flash_attention_wgmma"],
            "serve": launches["flash_attention_wgmma"],
            "train": train_launches["flash_attention_wgmma"]},
        "max_abs_err": max(e["o"] for n, e in flash_err.items()
                           if n != "float32"),
        "errors": {n: e for n, e in flash_err.items() if n != "float32"},
        "ms": flash_ms, "plain_ms": plain_ms,
        "plain_shape": [1, FLASH_CHECK_SEQ, FLASH_CHECK_SEQ, Hq, Hkv, Dh],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": sdpa_ms,
        "tflop_per_s": fwd_flop(1, S) / flash_ms / 1e9,
        "shape": [1, S, S, Hq, Hkv, Dh], "dtype": "bfloat16",
        "causal": True,
        **report["hopper"]["flash_attention_wgmma"]})
    flash_row = kernels[-1]
    report["lm"]["flash_ms_per_prefill"] = qcfg.n_layers * flash_ms
    report["lm"]["flash_share_of_prefill"] = (
        qcfg.n_layers * flash_ms / 1e3 / report["lm"]["prefill"]["s"])
    del q, k, v, o, lse

    # the flash backward at the LM training shape (B=2, S=4,096), against
    # plain on the same saved o/lse, on each route (backward_route): f32 on
    # the SIMT pair; bf16 on the Hopper pair, its f32 gradients before the
    # cast and their casts, beside the dropped-key-tile controls
    # (bwd_hopper_errors). Each route is timed, with the wrapper's cast,
    # beside plain and SDPA's causal GQA backward in the same dtype
    Bt, St = lm_family.ONE_CARD_TRAIN["batch"], \
        lm_family.LM_SHAPES["train_4k"]["seq"]
    pairs_t = Bt * Hq * St * (St + 1) // 2
    bwd = {}
    for dtype in (torch.float32, bf16):
        name = str(dtype)[6:]
        q, do = (torch.randn(Bt, St, Hq, Dh, generator=g, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(Bt, St, Hkv, Dh, generator=g, device=dev)
                .to(dtype) for _ in range(2))
        # o and lse from the forward's own route: bf16 from the Hopper
        # kernel, f32 from the SIMT one
        o, lse = launch_on(q, k, v)
        ops.reset_launch_counts()
        got = _bwd_cuda_as_written(q, k, v, o, lse, do, True)
        went = {n: ops.launch_counts()[n] for n in FLASH_BWD}
        exp = _bwd_plain_f32(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        check(went == flash_bwd_launches(dtype, Dh, 1),
              f"flash backward on {dtype} went {went}")
        if dtype == bf16:
            e = bwd_hopper_errors(q, k, v, o, lse, do, got, exp, name)
        else:
            e = {}
            for gname, a, b in zip(("dq", "dk", "dv"), got, exp):
                e[gname] = float((a - b).abs().max())
                e[gname + "_rel"] = e[gname] / float(b.abs().max())
            check(all(e[n + "_rel"] <= TOL_FLASH_BWD[name]
                      for n in ("dq", "dk", "dv")),
                  f"flash_attention_bwd {name} differs from plain: {e}")
        del got, exp
        # yardstick: the backward alone of SDPA's causal GQA attention on
        # the same data ([B, H, S, D] copies made outside the timing)
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dos = do.transpose(1, 2).contiguous()
        o_sdpa = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
        r = {"errors": e,
             "ms": time_ms(torch, lambda: flash_attention_bwd_cuda(
                 q, k, v, o, lse, do, True), iters=5, warmup=1),
             "plain_ms": time_ms(torch, lambda: flash_attention_bwd_plain(
                 q, k, v, o, lse, do, True), iters=2, warmup=1),
             "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                 o_sdpa, (qs, ks, vs), dos, retain_graph=True), iters=5,
                 warmup=2)}
        # the function's five products, 10 D FLOP a visible pair, at the
        # dtype's rate: bf16 on the tensor cores, f32 outside them
        r["bound_ms"], r["bound_by"] = bound_ms(
            nbytes(q, k, v, o, lse, do) + nbytes(q, k, v), 10 * Dh * pairs_t,
            BF16_FLOP_PER_S if dtype == bf16 else F32_FLOP_PER_S)
        r["tflop_per_s"] = 10 * Dh * pairs_t / r["ms"] / 1e9
        bwd[name] = r
        del qs, ks, vs, dos, o_sdpa
        if dtype != bf16:
            del q, k, v, o, lse, do

    def by_path(sym):
        return {"lm_train": lm_train_launches[sym],
                "prefill": prefill_launches[sym], "serve": launches[sym],
                "train": train_launches[sym]}

    shape = {"shape": [Bt, St, St, Hq, Hkv, Dh], "causal": True}
    lt = report["lm_train"]
    kernels.append({
        "name": "flash_attention_bwd_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:281",
        "launches": lm_train_launches["flash_attention_bwd_dq_wgmma"]
        + lm_train_launches["flash_attention_bwd_dkv_wgmma"],
        # the layer-0 check's launches, counted from 0, are apart
        "check_launches": {"lm_train_layer0": {
            n: lt["layer0_bwd"]["launches"][n]
            for n in ("flash_attention_bwd_dq_wgmma",
                      "flash_attention_bwd_dkv_wgmma")}},
        "launches_by_path": {
            "dq": by_path("flash_attention_bwd_dq_wgmma"),
            "dkv": by_path("flash_attention_bwd_dkv_wgmma")},
        "max_abs_err": max(bwd["bfloat16"]["errors"][n]
                           for n in ("dq", "dk", "dv")),
        "layer0_errors": {n: x for n, x in lt["layer0_bwd"].items()
                          if n not in ("launches", "shape")},
        **bwd["bfloat16"], **shape, "dtype": "bfloat16",
        **report["hopper"]["flash_attention_bwd_wgmma"]})
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:281",
        # the main paths run bf16 at head dim 128, the Hopper pair's route,
        # so this is 0; the f32 gradient check's launches, counted from 0,
        # are apart under check_launches
        "launches": lm_train_launches["flash_attention_bwd_dq"]
        + lm_train_launches["flash_attention_bwd_dkv"],
        "check_launches": {"lm_train_float32_depth2": {
            n: lt["plain"]["launches_kernel"][n]
            for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")}},
        "launches_by_path": {"dq": by_path("flash_attention_bwd_dq"),
                             "dkv": by_path("flash_attention_bwd_dkv")},
        "max_abs_err": max(bwd["float32"]["errors"][n]
                           for n in ("dq", "dk", "dv")),
        **bwd["float32"], **shape, "dtype": "float32"})
    bwd_ms = bwd["bfloat16"]["ms"]
    layers_t = lt["layers"]
    lt["flash_bwd_ms_per_step"] = layers_t * bwd_ms
    lt["flash_bwd_share_of_step"] = (layers_t * bwd_ms / 1e3
                                     / lt["s_per_step"])
    # the Hopper forward at the train shape, on the bf16 q/k/v above; a
    # step launches it twice a layer (forward and remat recompute)
    tr = {"ms": time_ms(torch, lambda: flash_attention_cuda(q, k, v, True),
                        iters=10, warmup=2),
          "library_ms": sdpa_fwd_ms(q, k, v, iters=10, warmup=2),
          "shape": [Bt, St, St, Hq, Hkv, Dh]}
    tr["bound_ms"], tr["bound_by"] = bound_ms(
        nbytes(q, k, v, o, lse), fwd_flop(Bt, St), BF16_FLOP_PER_S)
    tr["tflop_per_s"] = fwd_flop(Bt, St) / tr["ms"] / 1e9
    flash_row["train_shape"] = tr
    lt["flash_fwd_ms_per_step"] = 2 * layers_t * tr["ms"]
    lt["flash_fwd_share_of_step"] = (2 * layers_t * tr["ms"] / 1e3
                                     / lt["s_per_step"])
    del q, k, v, o, lse, do

    # the EmbeddingBag row, timed in the recsys phase at serve_bulk's shape
    rs = report["recsys"]
    rs_launches = {f"{name} {cell}": rs[name][cell]["launches"]
                   for name in ("dlrm-rm2", "wide-deep", "dcn-v2", "bert4rec")
                   for cell in ("serve_p99", "serve_bulk", "retrieval_cand")
                   if isinstance(rs[name].get(cell), dict)
                   and "launches" in rs[name][cell]}
    ebag_row["launches"] = sum(rs_launches.values())
    ebag_row["launches_by_path"] = {
        "recsys": rs_launches, "serve": launches["embedding_bag"],
        "train": train_launches["embedding_bag"],
        "lm_prefill": prefill_launches["embedding_bag"]}
    kernels.append(ebag_row)

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
