"""CPU models of the f32 flash kernels' 3xTF32 arithmetic, the forward
(``csrc/flash_attention_tf32.cu``) and the backward
(``csrc/flash_attention_bwd_tf32.cu``), each held against the plain
version and the JAX package's Pallas kernel; and the flash kernels'
routes.

The forward runs both products on the tensor cores (wgmma with tf32
operands and f32 accumulators) in 3xTF32: an f32 operand x is split into
hi = tf32(x) (``cvt.rna.tf32.f32``: the mantissa rounded to 10 bits, ties
away from zero) and lo = x - hi, which the tensor core reads as tf32 by
dropping its low 13 bits; a product is hi*lo + lo*hi + hi*hi into one f32
accumulator, one 8-wide k step at a time. Keys come in tiles of 32 (past
Sk: K and V zero, scores -1e30); the softmax runs online over the tiles
in log2 units, p is split again as the A operand of P V, and o = acc /
max(l, 1e-30), lse = m ln 2 + log(max(l, 1e-30)). The model below does
the same on the CPU, tile by tile. It is held to the card's limits (2e-4
on o, 1e-4 on lse, ``chip_smoke.py``'s TOL_FLASH["float32"] and TOL_LSE)
at D = 64 and 128, causal with Sq < Sk, non-causal and G = 2, beside the
control that must miss them: both products in 1xTF32 (hi*hi alone) on
the same inputs.

The backward's model (``_tf32_bwd_model``) follows its kernels' tiles and
operand orientations: the dq kernel takes 64 query rows and streams key
tiles of 32 (S = Q K^T and dP = dO V^T with Q and dO as A, then dQ^T =
K^T dS^T with K^T as A and the staged dS as B), the dk/dv kernel takes 64
keys and streams the query tiles of 32 of each q head of the group
(S^T = K Q^T, dP^T = V dO^T, then dV^T = dO^T P and dK^T = Q^T dS); p =
exp2(s scale log2(e) - lse log2(e)), 0 where masked; every product in
3xTF32 and each tile's output product added to an f32 running sum. It
is held within 1e-4 of each gradient's largest magnitude (the card's
TOL_FLASH_BWD["float32"]) against plain's f32 gradients and the Pallas
backward, with its 1xTF32 control missing that limit. The CUDA kernels
themselves run only on the card (``tests/test_torch_gpu.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd as flash_bwd_pallas,
    flash_attention_fwd as flash_pallas)
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL_O, TOL_LSE = 2e-4, 1e-4
BWD_F32_REL = 1e-4     # of each gradient's largest magnitude
KEY_TILE = flash_mod.TF32_KEY_TILE
BWD_TILE, BWD_OWN = flash_mod.TF32_BWD_TILE, 64   # streamed rows, owned
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def tf32(x):
    """``cvt.rna.tf32.f32``: the f32 mantissa rounded to its top 10 bits,
    ties away from zero (the sign-magnitude bits take the carry)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """A raw f32 operand as the tensor core reads it: its low 13 mantissa
    bits dropped."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the kernel accumulates it: 8-wide k steps, each adding
    hi*lo, lo*hi, then hi*hi (``passes=3``) or hi*hi alone (1) into f32."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ah, bh = tf32(ak), tf32(bk)
        if passes == 3:
            acc = acc + ah @ tf32_read(bk - bh)
            acc = acc + tf32_read(ak - ah) @ bh
        acc = acc + ah @ bh
    return acc


def _tf32_model(q, k, v, causal, passes=3):
    """(o, lse) of the kernel's arithmetic for f32 q [B, Sq, Hq, D], k/v
    [B, Sk, Hkv, D]."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qh = q.permute(0, 2, 1, 3)                                 # [B, Hq, Sq, D]
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    pad = -Sk % KEY_TILE
    kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))
    vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    scale2 = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    pos = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, Hq, Sq), NEG_INF)
    l = torch.zeros(B, Hq, Sq)
    acc = torch.zeros(B, Hq, Sq, D)
    for k0 in range(0, Sk + pad, KEY_TILE):
        s = _mm(qh, kh[:, :, k0:k0 + KEY_TILE].transpose(-1, -2), passes)
        s = s * scale2
        col = torch.arange(k0, k0 + KEY_TILE)[None, :]
        masked = (col >= Sk) | ((col > pos) if causal else False)
        s = s.masked_fill(masked, NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mm(p, vh[:, :, k0:k0 + KEY_TILE],
                                          passes)
        m = mx
    lc = l.clamp_min(1e-30)
    o = (acc / lc[..., None]).permute(0, 2, 1, 3)
    return o, m * math.log(2.0) + torch.log(lc)


def _inputs(Sq, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(1, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(1, Sk, Hkv, D)).astype(np.float32)
    return q, k, v


CASES = [
    (64, 192, 4, 2, 64, True),      # causal, Sq < Sk (q_off = 128), G = 2
    (128, 128, 4, 2, 64, False),    # non-causal
    (64, 192, 4, 2, 128, True),
    (128, 128, 4, 2, 128, False),
    (128, 128, 4, 4, 128, True),    # MHA, causal, Sq = Sk
]


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,D,causal", CASES)
def test_tf32_model_matches_plain_and_pallas(Sq, Sk, Hq, Hkv, D, causal):
    q, k, v = _inputs(Sq, Sk, Hq, Hkv, D, seed=D + Sq)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    o, lse = _tf32_model(tq, tk, tv, causal)
    o_p, lse_p = flash_mod.flash_attention_fwd_plain(tq, tk, tv, causal)
    assert float((o - o_p).abs().max()) <= TOL_O
    assert float((lse - lse_p).abs().max()) <= TOL_LSE
    o_j, lse_j = flash_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=64, block_k=64,
                              interpret=True)
    assert float(np.abs(o.numpy() - np.asarray(o_j)).max()) <= TOL_O
    assert float(np.abs(lse.numpy() - np.asarray(lse_j)).max()) <= TOL_LSE


@pytest.mark.parametrize("D", [64, 128])
def test_one_tf32_product_misses_the_f32_limit(D):
    # the control, on q, k and v standard normal (seed 7), 128 queries
    # against 128 keys, 4 q heads on 2 kv heads, causal: 1xTF32 puts o
    # ~1e-3 off (five times the 2e-4 limit) and lse ~4e-4 off (four times
    # 1e-4), where 3xTF32 stays near 1e-6 on both
    q, k, v = (torch.tensor(x) for x in _inputs(128, 128, 4, 2, D, seed=7))
    o_p, lse_p = flash_mod.flash_attention_fwd_plain(q, k, v, True)
    o3, lse3 = _tf32_model(q, k, v, True)
    o1, lse1 = _tf32_model(q, k, v, True, passes=1)
    assert float((o3 - o_p).abs().max()) <= TOL_O / 20
    assert float((lse3 - lse_p).abs().max()) <= TOL_LSE / 20
    assert float((o1 - o_p).abs().max()) > 3 * TOL_O
    assert float((lse1 - lse_p).abs().max()) > 3 * TOL_LSE


@pytest.mark.parametrize("dtype,head_dim,fwd,bwd", [
    (torch.float32, 64, "flash_attention_tf32", "tf32"),
    (torch.float32, 80, "flash_attention", "simt"),
    (torch.float32, 96, "flash_attention", "simt"),
    (torch.float32, 128, "flash_attention_tf32", "tf32"),
    (torch.bfloat16, 64, "flash_attention_wgmma", "wgmma"),
    (torch.bfloat16, 80, "flash_attention", "simt"),
    (torch.bfloat16, 96, "flash_attention", "simt"),
    (torch.bfloat16, 128, "flash_attention_wgmma", "wgmma"),
])
def test_forward_and_backward_routes(dtype, head_dim, fwd, bwd):
    # the backward takes the forward's rule: f32 at 64 and 128 runs the
    # 3xTF32 forward and the 3xTF32 backward; each route's name is the
    # counter it launches under
    assert flash_mod.forward_route(dtype, head_dim) == fwd
    assert fwd in ops.KERNELS and fwd in flash_mod.FORWARD_ROUTES
    pair = {"simt": ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
            "wgmma": ("flash_attention_bwd_dq_wgmma",
                      "flash_attention_bwd_dkv_wgmma"),
            "tf32": ("flash_attention_bwd_dq_tf32",
                     "flash_attention_bwd_dkv_tf32")}[bwd]
    assert flash_mod.backward_route(dtype, head_dim) == pair
    assert pair in flash_mod.BACKWARD_ROUTES
    assert all(name in ops.KERNELS for name in pair)


@pytest.mark.parametrize("D", [64, 128])
def test_backward_meta_route_reports_the_tf32_pair(D):
    # the dry-run's route at f32 64/128 is the card's, beside the
    # function's work: five products of 2 D FLOP a visible pair
    B, S, Hq, Hkv = 2, 4096, 40, 8
    q, do, o = (torch.empty(B, S, Hq, D, device="meta") for _ in range(3))
    k, v = (torch.empty(B, S, Hkv, D, device="meta") for _ in range(2))
    lse = torch.empty(B, Hq, S, device="meta")
    grads, route, w = flash_mod.flash_attention_bwd_meta(q, k, v, o, lse,
                                                         do, True)
    assert route == ("flash_attention_bwd_dq_tf32",
                     "flash_attention_bwd_dkv_tf32")
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert all(g.dtype == torch.float32 for g in grads)
    assert w == flash_mod.work(B, S, S, Hq, Hkv, D, torch.float32, True,
                               backward=True)
    assert w["flops"] == 10 * D * B * Hq * S * (S + 1) // 2
    # 671,252,480 visible pairs at D=128: the 8.59e11 FLOP of the bounds
    if D == 128:
        assert B * Hq * S * (S + 1) // 2 == 671_252_480


@pytest.mark.parametrize("B,Sk,Hkv,D,tiles", [(1, 4096, 8, 128, 128),
                                              (2, 333, 2, 64, 11)])
def test_tf32_planes_bytes(B, Sk, Hkv, D, tiles):
    # K and V^T as hi and lo planes, per (b, kv head, tile of 32 keys)
    assert flash_mod.tf32_planes_bytes(B, Sk, Hkv, D) == \
        B * Hkv * tiles * 4 * KEY_TILE * D * 4


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [(2, 4096, 4096, 40, 8, 128),
                                              (1, 100, 150, 4, 2, 64)])
def test_tf32_bwd_planes_bytes(B, Sq, Sk, Hq, Hkv, D):
    # four planes (two tensors' hi and lo) per (b, head, tile of 32 rows):
    # K and V for the dq call, Q and dO for the dk/dv call
    kv, qd = flash_mod.tf32_bwd_planes_bytes(B, Sq, Sk, Hq, Hkv, D)
    assert kv == B * Hkv * -(-Sk // BWD_TILE) * 4 * BWD_TILE * D * 4
    assert qd == B * Hq * -(-Sq // BWD_TILE) * 4 * BWD_TILE * D * 4
    if Sq == 4096:            # 134 MB and 671 MB at the LM training shape
        assert (kv, qd) == (134_217_728, 671_088_640)


# ------------------------------------------------------------ backward

def _pad_rows(x, n):
    """x [..., R, D] with zero rows up to n."""
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]))


def _tf32_bwd_model(q, k, v, o, lse, do, causal, passes=3):
    """(dq, dk, dv) of the 3xTF32 backward's arithmetic for f32 q/o/dO
    [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], lse [B, Hq, Sq], tile by tile as
    its two kernels run it, each product as ``_mm`` (``passes=1``: tf32
    alone, the control)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, q_off = Hq // Hkv, Sk - Sq
    f32 = torch.float32
    scale = torch.tensor(D ** -0.5, dtype=f32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=f32)
    # the wrapper's delta, and both stats by q head: [B, Hq, Sq]
    delta = (do * o).sum(-1).transpose(1, 2)
    lse2 = lse * torch.tensor(LOG2E, dtype=f32)
    qh, doh = (t.permute(0, 2, 1, 3) for t in (q, do))    # [B, Hq, Sq, D]
    kh, vh = (t.permute(0, 2, 1, 3) for t in (k, v))      # [B, Hkv, Sk, D]

    def p_and_ds(s, dp, rows, cols, lse2_r, delta_r):
        """p and ds for scores s and dp with query index rows and key
        index cols (broadcast to s's last two axes)."""
        masked = (rows >= Sq) | (cols >= Sk)
        if causal:
            masked = masked | (cols > rows + q_off)
        p = torch.exp2(s * scale_log2 - lse2_r).masked_fill(masked, 0.0)
        return p, p * (dp - delta_r)

    def pad_stat(x, r0, n):
        """x[..., r0:r0 + n] with 0 past Sq."""
        return torch.nn.functional.pad(x[..., r0:r0 + n],
                                       (0, n - x[..., r0:r0 + n].shape[-1]))

    # the dq kernel: 64 query rows, key tiles of 32 up to the diagonal
    kq, vq = (t.repeat_interleave(G, dim=1) for t in (kh, vh))
    dq = torch.zeros(B, Hq, Sq, D)
    for q0 in range(0, Sq, BWD_OWN):
        rows = torch.arange(q0, q0 + BWD_OWN)[:, None]
        qt, dot = (_pad_rows(t[:, :, q0:q0 + BWD_OWN], BWD_OWN)
                   for t in (qh, doh))
        l2, dl = (pad_stat(t, q0, BWD_OWN)[..., None] for t in (lse2, delta))
        k_end = min(Sk, q0 + BWD_OWN + q_off) if causal else Sk
        acc = torch.zeros(B, Hq, D, BWD_OWN)
        for k0 in range(0, k_end, BWD_TILE):
            kt, vt = (_pad_rows(t[:, :, k0:k0 + BWD_TILE], BWD_TILE)
                      for t in (kq, vq))
            cols = torch.arange(k0, k0 + BWD_TILE)[None, :]
            s = _mm(qt, kt.transpose(-1, -2), passes)
            dp = _mm(dot, vt.transpose(-1, -2), passes)
            _, ds = p_and_ds(s, dp, rows, cols, l2, dl)
            acc = acc + _mm(kt.transpose(-1, -2), ds.transpose(-1, -2),
                            passes)                   # dQ^T = K^T dS^T
        n = min(BWD_OWN, Sq - q0)
        dq[:, :, q0:q0 + n] = (acc * scale).transpose(-1, -2)[:, :, :n]
    # the dk/dv kernel: 64 keys; each q head of the group, its query
    # tiles of 32 from the one that holds the block's diagonal
    dk, dv = torch.zeros(B, Hkv, Sk, D), torch.zeros(B, Hkv, Sk, D)
    for k0 in range(0, Sk, BWD_OWN):
        cols = torch.arange(k0, k0 + BWD_OWN)[:, None]    # keys: rows here
        kb, vb = (_pad_rows(t[:, :, k0:k0 + BWD_OWN], BWD_OWN)
                  for t in (kh, vh))
        q_first = max(0, k0 - q_off) // BWD_TILE * BWD_TILE if causal else 0
        acc_k = torch.zeros(B, Hkv, D, BWD_OWN)
        acc_v = torch.zeros(B, Hkv, D, BWD_OWN)
        for g in range(G):
            heads = torch.arange(Hkv) * G + g
            for q0 in range(q_first, Sq, BWD_TILE):
                rows = torch.arange(q0, q0 + BWD_TILE)[None, :]
                qt, dot = (_pad_rows(t[:, heads, q0:q0 + BWD_TILE], BWD_TILE)
                           for t in (qh, doh))
                l2, dl = (pad_stat(t[:, heads], q0, BWD_TILE)[..., None, :]
                          for t in (lse2, delta))
                st = _mm(kb, qt.transpose(-1, -2), passes)     # S^T
                dpt = _mm(vb, dot.transpose(-1, -2), passes)   # dP^T
                pt, dst = p_and_ds(st, dpt, rows, cols, l2, dl)
                acc_v = acc_v + _mm(dot.transpose(-1, -2),
                                    pt.transpose(-1, -2), passes)
                acc_k = acc_k + _mm(qt.transpose(-1, -2),
                                    dst.transpose(-1, -2), passes)
        n = min(BWD_OWN, Sk - k0)
        dk[:, :, k0:k0 + n] = (acc_k * scale).transpose(-1, -2)[:, :, :n]
        dv[:, :, k0:k0 + n] = acc_v.transpose(-1, -2)[:, :, :n]
    return (dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3),
            dv.permute(0, 2, 1, 3))


def _bwd_case(Sq, Sk, Hq, Hkv, D, causal, seed):
    """q, k, v, dO standard normal from numpy, o and lse from the plain
    forward (the saved residuals both backwards take)."""
    q, k, v = (torch.tensor(x) for x in _inputs(Sq, Sk, Hq, Hkv, D, seed))
    do = torch.tensor(np.random.default_rng(seed + 1).normal(
        size=q.shape).astype(np.float32))
    o, lse = flash_mod.flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, o, lse, do


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


BWD_CASES = [
    (64, 192, 4, 2, 64, True),      # causal, Sq < Sk (q_off = 128), G = 2
    (128, 128, 4, 2, 64, False),    # non-causal
    (64, 192, 4, 2, 128, True),
    (128, 128, 4, 2, 128, False),
]


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,D,causal", BWD_CASES)
def test_tf32_bwd_model_matches_plain_and_pallas(Sq, Sk, Hq, Hkv, D,
                                                 causal):
    args = _bwd_case(Sq, Sk, Hq, Hkv, D, causal, seed=D + Sq + 1)
    got = _tf32_bwd_model(*args, causal)
    exp = flash_mod._bwd_plain_f32(*args, causal)
    jax_got = flash_bwd_pallas(*(jnp.asarray(t.numpy()) for t in args),
                               causal=causal, block_q=64, block_k=64,
                               interpret=True)
    for name, a, b, j in zip(("dq", "dk", "dv"), got, exp, jax_got):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= BWD_F32_REL, name
        assert _rel(a, torch.tensor(np.asarray(j))) <= BWD_F32_REL, name


@pytest.mark.parametrize("causal", [True, False])
def test_tf32_bwd_model_on_ragged_tiles_matches_plain(causal):
    # Sq and Sk no multiples of the 32- and 64-row tiles (q_off = 50): the
    # padded rows, keys and the diagonal's tiles masked as the kernels do
    args = _bwd_case(100, 150, 6, 2, 64, causal, seed=11)
    got = _tf32_bwd_model(*args, causal)
    exp = flash_mod._bwd_plain_f32(*args, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert _rel(a, b) <= BWD_F32_REL, name


@pytest.mark.parametrize("D", [64, 128])
def test_one_tf32_product_misses_the_f32_bwd_limit(D):
    # the control on the inputs of the causal case above: every product in
    # tf32 alone (hi*hi) misses 1e-4 of each gradient's largest magnitude,
    # where 3xTF32 stays well inside it
    args = _bwd_case(64, 192, 4, 2, D, True, seed=D + 65)
    exp = flash_mod._bwd_plain_f32(*args, True)
    got3 = _tf32_bwd_model(*args, True)
    got1 = _tf32_bwd_model(*args, True, passes=1)
    for name, a3, a1, b in zip(("dq", "dk", "dv"), got3, got1, exp):
        assert _rel(a3, b) <= BWD_F32_REL / 10, name
        assert _rel(a1, b) > BWD_F32_REL, name
