"""A CPU model of the f32 flash forward's 3xTF32 arithmetic
(``csrc/flash_attention_tf32.cu``), held against the plain version and
the JAX package's Pallas kernel; and the flash kernels' routes.

The kernel runs both products on the tensor cores (wgmma with tf32
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
the same inputs. The CUDA kernel itself runs only on the card
(``tests/test_torch_gpu.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd as flash_pallas)
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL_O, TOL_LSE = 2e-4, 1e-4
KEY_TILE = flash_mod.TF32_KEY_TILE
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
    (torch.float32, 64, "flash_attention_tf32", "simt"),
    (torch.float32, 80, "flash_attention", "simt"),
    (torch.float32, 96, "flash_attention", "simt"),
    (torch.float32, 128, "flash_attention_tf32", "simt"),
    (torch.bfloat16, 64, "flash_attention_wgmma", "wgmma"),
    (torch.bfloat16, 80, "flash_attention", "simt"),
    (torch.bfloat16, 96, "flash_attention", "simt"),
    (torch.bfloat16, 128, "flash_attention_wgmma", "wgmma"),
])
def test_forward_and_backward_routes(dtype, head_dim, fwd, bwd):
    # f32 at 64 and 128 runs the 3xTF32 forward but the SIMT backward (on
    # that forward's lse); each route's name is the counter it launches
    # under
    assert flash_mod.forward_route(dtype, head_dim) == fwd
    assert fwd in ops.KERNELS and fwd in flash_mod.FORWARD_ROUTES
    pair = {"simt": ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
            "wgmma": ("flash_attention_bwd_dq_wgmma",
                      "flash_attention_bwd_dkv_wgmma")}[bwd]
    assert flash_mod.backward_route(dtype, head_dim) == pair
    assert all(name in ops.KERNELS for name in pair)


@pytest.mark.parametrize("B,Sk,Hkv,D,tiles", [(1, 4096, 8, 128, 128),
                                              (2, 333, 2, 64, 11)])
def test_tf32_planes_bytes(B, Sk, Hkv, D, tiles):
    # K and V^T as hi and lo planes, per (b, kv head, tile of 32 keys)
    assert flash_mod.tf32_planes_bytes(B, Sk, Hkv, D) == \
        B * Hkv * tiles * 4 * KEY_TILE * D * 4
