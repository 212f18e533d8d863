"""A CPU model of the Hopper bus-attention kernels' arithmetic
(``csrc/bus_attention.cu``), held against the plain versions and the
JAX package's Pallas kernels.

The kernels run every product on the tensor cores (mma.sync m16n8k8, tf32
operands, f32 accumulators) in 3xTF32: an f32 operand x is split into
hi = tf32(x) (``cvt.rna.tf32.f32``) and lo = x - hi, which the tensor core
reads as tf32 by dropping its low 13 bits, and a product is hi*lo + lo*hi
+ hi*hi into one accumulator; bf16 and fp16 inputs are exact in tf32, so
only p and ds are split there. Keys are padded to a multiple of 8 (p = 0 on the
padded columns, never a -1e30 score) and queries to 16 rows (p and ds 0
on the padded rows). The model below does the same tile by tile on the
CPU: tf32 rounding as ``cvt.rna.tf32.f32`` does it (the f32 mantissa
rounded to 10 bits, ties away from zero) for hi, the low 13 bits dropped
for lo, each product added into its f32 accumulator one 8-wide k step at
a time, three terms a step.

It is held at the kernels' limits (2e-4 forward, 1e-4 backward, as
``chip_smoke.py`` holds the kernels) at K=3, D=64 and the DynamicBatcher's
S buckets, beside the controls that must miss them: products in 1xTF32,
and padded key columns scored -1e30 (on an all-masked segment they join
the uniform average). The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bus_attention import (  # noqa: E402
    bus_attention as bus_pallas, bus_attention_bwd as bus_bwd_pallas)
from repro_torch.kernels import bus_attention as bus_mod  # noqa: E402

TOL_FWD, TOL_BWD = 2e-4, 1e-4     # chip_smoke.py's TOL_BUS and TOL_BWD
# tests/test_torch_gpu.py's forward limits in the narrow dtypes
TOL_NARROW = {torch.bfloat16: 2e-2, torch.float16: 2e-3}
BUCKETS = (8, 16, 24, 32)         # the DynamicBatcher's S buckets


def tf32(x):
    """``cvt.rna.tf32.f32``: the f32 mantissa rounded to its top 10 bits,
    ties away from zero (the sign-magnitude bits take the carry)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """A raw f32 operand as the tensor core reads it: tf32 with the low 13
    bits of the mantissa dropped."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _split(x, exact):
    """(hi, lo) with x = hi + lo in tf32; an exact operand has no lo."""
    if exact:
        return x, None
    hi = tf32(x)
    return hi, tf32_read(x - hi)


def _mm(a, b, a_exact=False, b_exact=False, passes=3):
    """a @ b over the last axis of a, as the kernels accumulate it: one
    8-wide k step at a time, hi*lo + lo*hi + hi*hi (``passes=3``) or
    hi*hi alone (``passes=1``, the 1xTF32 control) into an f32 sum."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ah, al = _split(a[..., k0:k0 + 8], a_exact)
        bh, bl = _split(b[..., k0:k0 + 8, :], b_exact)
        if passes == 3 and bl is not None:
            acc = acc + ah @ bl
        if passes == 3 and al is not None:
            acc = acc + al @ bh
        acc = acc + ah @ bh
    return acc


def _tiles(q, k, v, do=None):
    """[M, K, S|Sk, H, D] -> f32 tiles [M, K, H, rows, D], queries padded
    to 16 rows a block, keys to a multiple of 8, with zeros."""
    S, Sk = q.shape[2], k.shape[2]
    pad_q, pad_k = -S % 16, -Sk % 8

    def tile(x, pad):
        x = x.float().permute(0, 1, 3, 2, 4)
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    out = [tile(q, pad_q), tile(k, pad_k), tile(v, pad_k)]
    return out + ([tile(do, pad_q)] if do is not None else [])


def _probs(s, mask, S, Sk, scale, pad="zero"):
    """The kernels' softmax of padded score tiles [.., rows, cols]: scaled,
    masked to -1e30, max-subtracted, times 1 / max(sum, 1e-30). ``pad="zero"``
    gives the padded columns p = 0 (the kernels); ``pad="scored"`` scores
    them -1e30 like a masked key (the control)."""
    cols = torch.arange(s.shape[-1])
    real = cols < Sk
    keep = torch.nn.functional.pad(mask, (0, s.shape[-1] - Sk))
    keep = keep[:, :, None, None, :]                   # [M, K, 1, 1, cols]
    s = torch.where(keep, s * scale, torch.tensor(-1e30))
    if pad == "zero":
        s = s.masked_fill(~real, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p * (1 / p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    rows = torch.arange(s.shape[-2])[:, None] < S
    return p * rows, keep & real


def model_fwd(q, k, v, mask, passes=3, pad="zero"):
    """The forward kernel's arithmetic -> o [M, K, S, H, D] in q's dtype."""
    M, K, S, H, D = q.shape
    Sk = k.shape[2]
    exact = q.dtype != torch.float32
    qt, kt, vt = _tiles(q, k, v)
    s = _mm(qt, kt.transpose(-1, -2), exact, exact, passes)
    p, _ = _probs(s, mask, S, Sk, np.float32(D ** -0.5), pad)
    o = _mm(p, vt, False, exact, passes)
    return o[..., :S, :].permute(0, 1, 3, 2, 4).to(q.dtype)


def model_bwd(q, k, v, mask, do, passes=3):
    """The backward kernel's arithmetic -> (dq, dk, dv) in q's dtype: p and
    dp = dO V^T per row block, ds = (mask ? p (dp - delta) : 0) * scale,
    dQ = dS K, then dV^T = dO^T P and dK^T = Q^T dS over the query rows."""
    M, K, S, H, D = q.shape
    Sk = k.shape[2]
    exact = q.dtype != torch.float32
    scale = np.float32(D ** -0.5)
    qt, kt, vt, dot = _tiles(q, k, v, do)
    s = _mm(qt, kt.transpose(-1, -2), exact, exact, passes)
    dp = _mm(dot, vt.transpose(-1, -2), exact, exact, passes)
    p, keep = _probs(s, mask, S, Sk, scale)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = torch.where(keep, p * (dp - delta) * scale, torch.tensor(0.0))
    dq = _mm(ds, kt, False, exact, passes)
    rows = -(-S // 8) * 8              # the query k steps the kernel takes
    dv = _mm(dot[..., :rows, :].transpose(-1, -2), p[..., :rows, :], exact,
             False, passes).transpose(-1, -2)
    dk = _mm(qt[..., :rows, :].transpose(-1, -2), ds[..., :rows, :], exact,
             False, passes).transpose(-1, -2)

    def back(x, n):
        return x[..., :n, :].permute(0, 1, 3, 2, 4).to(q.dtype)

    return back(dq, S), back(dk, Sk), back(dv, Sk)


def _inputs(S, M=4, K=3, H=2, D=64, seed=0, dtype=torch.float32):
    """numpy normals, a 75% mask with [CLS] kept, one all-masked segment
    (news 1, segment 2) and an output gradient."""
    rng = np.random.default_rng(seed)
    Sk = S + K
    q = rng.normal(size=(M, K, S, H, D)).astype(np.float32)
    k = rng.normal(size=(M, K, Sk, H, D)).astype(np.float32)
    v = rng.normal(size=(M, K, Sk, H, D)).astype(np.float32)
    do = rng.normal(size=(M, K, S, H, D)).astype(np.float32)
    mask = rng.random((M, K, Sk)) < 0.75
    mask[:, :, 0] = True
    mask[1, 2] = False
    t = [torch.tensor(x).to(dtype) for x in (q, k, v, do)]
    return t[0], t[1], t[2], torch.tensor(mask), t[3]


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def test_tf32_rounds_to_nearest_ties_away_and_reads_by_truncation():
    ulp = 2.0 ** -10                   # tf32's spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 1 + ulp + ulp / 2, 3.0])
    exp = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + 2 * ulp,
                        3.0])
    assert torch.equal(tf32(x), exp)
    assert torch.equal(tf32_read(x), torch.tensor(
        [1.0, -1.0, 1.0, 1.0, 1 + ulp, 3.0]))
    # hi + lo carries x to within 2^-21 of it: the 3xTF32 premise
    y = torch.tensor(np.random.default_rng(0).normal(size=4096)
                     .astype(np.float32))
    hi, lo = _split(y, False)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32_read(lo), lo)
    assert bool(((hi + lo - y).abs() <= 2.0 ** -21 * y.abs()).all())


@pytest.mark.parametrize("S", BUCKETS)
def test_model_forward_meets_the_limit(S):
    q, k, v, mask, _ = _inputs(S)
    got = model_fwd(q, k, v, mask)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert _err(got, bus_mod.bus_attention_plain(q, k, v, mask)) <= TOL_FWD


@pytest.mark.parametrize("S", BUCKETS)
def test_model_backward_meets_the_limit(S):
    q, k, v, mask, do = _inputs(S)
    got = model_bwd(q, k, v, mask, do)
    exp = bus_mod.bus_attention_bwd_plain(q, k, v, mask, do)
    for a, b in zip(got, exp):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _err(a, b) <= TOL_BWD


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_model_in_the_narrow_dtypes_meets_the_gpu_limits(dtype):
    # inputs exact in tf32: one pass for Q K^T and dO V^T, two for p and ds
    q, k, v, mask, do = _inputs(32, dtype=dtype)
    got = model_fwd(q, k, v, mask)
    assert got.dtype == dtype
    assert _err(got, bus_mod.bus_attention_plain(q, k, v, mask)) \
        <= TOL_NARROW[dtype]


@pytest.mark.parametrize("S", [8, 32])
def test_model_averages_an_all_masked_segment_over_exactly_sk_keys(S):
    q, k, v, mask, do = _inputs(S)
    o = model_fwd(q, k, v, mask)
    uniform = v[1, 2].mean(dim=0)                        # [H, D] over Sk
    assert _err(o[1, 2], uniform.expand_as(o[1, 2])) <= TOL_FWD
    dq, dk, dv = model_bwd(q, k, v, mask, do)
    # p is uniform there, so dv is not 0; ds is 0 on every masked key
    assert float(dv[1, 2].abs().max()) > 0
    assert float(dq[1, 2].abs().max()) == 0
    assert float(dk[1, 2].abs().max()) == 0


@pytest.mark.parametrize("S", [8, 32])
def test_one_pass_tf32_misses_the_limits(S):
    # the control: 1xTF32 products compute another function
    q, k, v, mask, do = _inputs(S)
    o = model_fwd(q, k, v, mask, passes=1)
    assert _err(o, bus_mod.bus_attention_plain(q, k, v, mask)) > TOL_FWD
    got = model_bwd(q, k, v, mask, do, passes=1)
    exp = bus_mod.bus_attention_bwd_plain(q, k, v, mask, do)
    assert max(_err(a, b) for a, b in zip(got, exp)) > TOL_BWD


@pytest.mark.parametrize("S", BUCKETS)
def test_padded_columns_scored_minus_1e30_move_the_all_masked_row(S):
    # the control: Sk = S + 3 pads to a multiple of 8; a padded column
    # scored like a masked key spreads the all-masked segment's average
    # over the padded keys (whose v is 0) and misses the limit there
    q, k, v, mask, _ = _inputs(S)
    assert (S + 3) % 8
    exp = bus_mod.bus_attention_plain(q, k, v, mask)
    scored = model_fwd(q, k, v, mask, pad="scored")
    assert _err(scored[1, 2], exp[1, 2]) > TOL_FWD
    assert _err(model_fwd(q, k, v, mask)[1, 2], exp[1, 2]) <= TOL_FWD


def test_model_matches_the_pallas_kernels():
    q, k, v, mask, do = _inputs(32, M=4)
    j = [jnp.asarray(x.numpy()) for x in (q, k, v, mask, do)]
    o = np.asarray(bus_pallas(*j[:4], block_m=4, interpret=True))
    assert _err(model_fwd(q, k, v, mask), torch.tensor(o)) <= TOL_FWD
    grads = bus_bwd_pallas(*j, block_m=4, interpret=True)
    for a, b in zip(model_bwd(q, k, v, mask, do), grads):
        assert _err(a, torch.tensor(np.asarray(b))) <= TOL_BWD


TENSOR_CORE = ("bus_attention", "bus_attention_bwd")
SIMT = ("bus_attention_simt", "bus_attention_bwd_simt")


@pytest.mark.parametrize("S", BUCKETS)
@pytest.mark.parametrize("D", bus_mod.KERNEL_HEAD_DIMS)
def test_kernel_shape_takes_every_bucket(S, D):
    # every bucket at Sk = S + 3 goes to the tensor-core kernels
    assert bus_mod.bus_route(S, S + 3, D) == TENSOR_CORE


@pytest.mark.parametrize("S,Sk,D,what", [
    (32, 35, 48, "head dims"), (32, 35, 80, "head dims"),
    (33, 36, 64, "S <= 32"), (32, 41, 64, "Sk <= 40"), (0, 3, 64, "S <= 32"),
])
def test_kernel_shape_refuses_the_rest(S, Sk, D, what):
    # the tensor-core kernels refuse these (``what`` they exceed): they go
    # to the SIMT kernels
    assert bus_mod.bus_route(S, Sk, D) == SIMT


def test_every_route_counts_its_own_launches():
    from repro_torch.kernels import ops
    for fwd, bwd in (TENSOR_CORE, SIMT):
        for name in (fwd, bwd):
            lib, sym = ops.KERNELS[name]
            assert (lib, sym) == bus_mod.ROUTES[name]
            assert sym in lib.functions
    syms = {bus_mod.ROUTES[n] for n in TENSOR_CORE + SIMT}
    assert len(syms) == 4


@pytest.mark.parametrize("S,Sk,D,backward,fits", [
    (64, 67, 64, False, True), (64, 67, 64, True, True),
    (128, 131, 64, False, True), (128, 131, 64, True, False),
    (32, 35, 1024, False, False),
])
def test_simt_tile_must_fit_in_shared_memory(S, Sk, D, backward, fits):
    # q (and do), k, v and the probabilities (and ds) in f32, the k (and,
    # backward, v) rows padded by one, and the mask's bytes
    n = 2 if backward else 1
    want = 4 * (n * S * D + Sk * (D + 1) + Sk * (D + backward)
                + n * S * Sk) + Sk
    assert bus_mod.simt_smem_bytes(S, Sk, D, backward) == want
    assert (want <= bus_mod.SMEM_BYTES) == fits
