"""The port's flash attention forward against the JAX package's Pallas
kernel.

On the CPU ``ops.flash_attention`` takes the kernel's plain PyTorch
version, held here against the Pallas ``flash_attention_fwd`` run in
interpret mode (as tests/test_kernels.py runs it), ``o`` and ``lse``, on
the same numpy inputs. The CUDA kernels run only on the card:
tests/test_torch_gpu.py holds them against the plain version there.

The bf16 Hopper kernels are modelled here tile by tile, to show on the
CPU that their arithmetic meets the limits the card's checks hold them
to. The forward (``csrc/flash_attention_wgmma.cu``, p split into hi and
lo bf16 halves for the P V product) meets the element-wise bf16 limit,
where p rounded to bf16 alone does not. The backward
(``csrc/flash_attention_bwd_wgmma.cu``, p and ds split for the dv, dq and
dk products) writes f32 gradients: they are within 1e-4 of each plain f32
gradient's largest magnitude and their bf16 casts meet the element-wise
limit, where p and ds rounded to bf16 alone miss one of the two.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd as flash_pallas)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_cuda,
    flash_attention_fwd_plain)

# tests/test_kernels.py's forward tolerances
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# the card's element-wise bf16 limit (tests/test_torch_gpu.py, chip_smoke.py)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
LSE_TOL = 1e-4
# the f32 backward's limit, of each gradient's largest magnitude
# (tests/test_kernels.py's f32 gradient tolerance; chip_smoke.py's
# TOL_FLASH_BWD["float32"])
BWD_F32_REL = 1e-4
KEY_TILE = 128        # kBK in csrc/flash_attention_wgmma.cu, kKeysDq in
                      # csrc/flash_attention_bwd_wgmma.cu
LOG2E = math.log2(math.e)


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,dtype", [
    (1, 128, 128, 4, 4, 64, True, "float32"),      # MHA
    (1, 128, 128, 4, 4, 64, False, "bfloat16"),
    (2, 256, 256, 8, 2, 64, True, "bfloat16"),     # GQA 4:1
    (1, 128, 128, 8, 1, 32, False, "float32"),     # MQA
    (1, 64, 128, 4, 4, 32, True, "float32"),       # Sq != Sk: q_off = 64
    (1, 64, 128, 4, 4, 32, True, "bfloat16"),
])
def test_plain_flash_matches_pallas(B, Sq, Sk, Hq, Hkv, D, causal, dtype):
    q, k, v = _inputs(B, Sq, Sk, Hq, Hkv, D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    o_j, lse_j = flash_pallas(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), causal=causal, block_q=64,
                              block_k=64, interpret=True)
    o_t, lse_t = flash_attention_fwd_plain(
        torch.tensor(q).to(td), torch.tensor(k).to(td),
        torch.tensor(v).to(td), causal)
    assert o_t.dtype == td and lse_t.dtype == torch.float32
    assert lse_t.shape == (B, Hq, Sq)
    err_o = np.abs(o_t.float().numpy() - np.asarray(o_j, np.float32)).max()
    err_lse = np.abs(lse_t.numpy() - np.asarray(lse_j)).max()
    assert err_o <= TOL[dtype], err_o
    assert err_lse <= TOL[dtype], err_lse


def test_ops_flash_attention_on_the_cpu_is_the_plain_version():
    q, k, v = (torch.tensor(a) for a in _inputs(2, 64, 64, 4, 2, 16))
    got = ops.flash_attention(q, k, v, causal=True)
    exp = flash_attention_fwd_plain(q, k, v, True)[0]
    assert torch.equal(got, exp)
    # the plain version is differentiable, so training on the CPU works
    q.requires_grad_()
    assert ops.flash_attention(q, k, v).grad_fn is not None


def test_causal_call_with_more_queries_than_keys_raises():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 64, 32, 2, 2, 16))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention(q, k, v, causal=False).shape == q.shape


def test_flash_routing_rule_matches_jax():
    for s in range(1, 1100):
        assert ops.flash_attention_supported(s) == \
            jax_ops.flash_attention_supported(s), s
    assert ops.FLASH_BLOCK == jax_ops.FLASH_BLOCK


def test_the_cuda_wrapper_refuses_a_cpu_tensor():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 64, 64, 2, 2, 16))
    with pytest.raises(RuntimeError, match="cpu"):
        flash_attention_cuda(q, k, v, True)
    assert "flash_attention" in ops.launch_counts()


def _hopper_model(q, k, v, causal, split_p=True):
    """The Hopper kernel's arithmetic, tile by tile on the CPU: scores in
    f32 from the bf16 inputs, scaled to log2 units, masked to -1e30; per
    key tile of KEY_TILE an online max and sum (l summed from the f32 p)
    with the accumulator rescaled by exp2(m_old - m_new); P V as P_hi V +
    P_lo V in f32 (``split_p``), or with p rounded to bf16 alone (the
    usual flash kernel, the control); o = acc / max(l, 1e-30) in bf16,
    lse = m ln 2 + log(max(l, 1e-30))."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    kf, vf = k.float(), v.float()
    scale_log2 = torch.tensor(D ** -0.5 * math.log2(math.e))
    m = torch.full((B, Hkv, Hq // Hkv, Sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(*m.shape, D)
    pos = torch.arange(Sq)[:, None] + (Sk - Sq)
    for k0 in range(0, Sk, KEY_TILE):
        kt, vt = kf[:, k0:k0 + KEY_TILE], vf[:, k0:k0 + KEY_TILE]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kt) * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[1]) > pos,
                              -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        hi = p.bfloat16().float()
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", hi,
                                                   vt)
        if split_p:
            lo = (p - hi).bfloat16().float()
            acc = acc + torch.einsum("bkgqs,bskd->bkgqd", lo, vt)
    lc = l.clamp_min(1e-30)
    o = (acc / lc[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return o.to(q.dtype), (m * math.log(2) + torch.log(lc)).reshape(B, Hq,
                                                                    Sq)


def _over_limit(o, o_p):
    """Largest |o - o_p| over the element-wise bf16 limit (passes at <= 1)."""
    o_p = o_p.float()
    return float(((o.float() - o_p).abs()
                  / (BF16_RTOL * o_p.abs() + BF16_ATOL)).max())


def _bf16_inputs(Sq, Sk, seed=0):
    """Qwen3-14B's head dim and GQA group of 4 (8 q heads over 2 kv)."""
    return [torch.tensor(a).bfloat16()
            for a in _inputs(1, Sq, Sk, 8, 2, 128, seed)]


# causal and not, Sq == Sk and Sq != Sk (q_off = Sk - Sq), Sk a multiple
# of the key tile and not
HOPPER_CASES = [(1024, 1024, True), (1024, 1024, False), (256, 1024, True),
                (300, 1000, False)]


@pytest.mark.parametrize("Sq,Sk,causal", HOPPER_CASES)
def test_hopper_kernel_model_meets_the_bf16_limit(Sq, Sk, causal):
    q, k, v = _bf16_inputs(Sq, Sk)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal)
    o, lse = _hopper_model(q, k, v, causal)
    assert o.dtype == torch.bfloat16 and o.shape == o_p.shape
    assert float((o.float() - o_p.float()).abs().max()) <= TOL["bfloat16"]
    assert _over_limit(o, o_p) <= 1
    assert float((lse - lse_p).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("Sq,Sk,causal", HOPPER_CASES)
def test_hopper_kernel_model_with_p_in_bf16_misses_the_limit(Sq, Sk,
                                                             causal):
    # the control: rounding p to bf16 before P V (the usual flash kernel)
    # computes another function, which the element-wise limit catches
    q, k, v = _bf16_inputs(Sq, Sk)
    o_p = flash_attention_fwd_plain(q, k, v, causal)[0]
    o = _hopper_model(q, k, v, causal, split_p=False)[0]
    assert _over_limit(o, o_p) > 1


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 48, "simt"), (torch.bfloat16, 80, "simt"),
    (torch.bfloat16, 96, "simt"), (torch.bfloat16, 112, "simt"),
    (torch.float32, 64, "tf32"), (torch.float32, 128, "tf32"),
    (torch.float32, 96, "simt"),
])
def test_forward_route_by_dtype_and_head_dim(dtype, head_dim, route):
    # the route is named by the counter its launches go to
    name = {"wgmma": "flash_attention_wgmma", "simt": "flash_attention",
            "tf32": "flash_attention_tf32"}
    assert flash_mod.forward_route(dtype, head_dim) == name[route]
    assert name[route] in ops.KERNELS


def test_tma_checks_refuse_misaligned_views():
    base = torch.zeros(2 * 64 * 4 * 128 + 8, dtype=torch.bfloat16)
    q = base[:-8].view(2, 64, 4, 128)
    flash_mod._check_tma("q", q)                       # aligned: passes
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_mod._check_tma("q", base[1:-7].view(2, 64, 4, 128))
    # a head stride of 132 elements (264 bytes) is no multiple of 16 bytes
    wide = torch.zeros(2, 64, 4, 132, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        flash_mod._check_tma("q", wide)
    # ...but a dim of size 1 is never stepped over, so its stride is free
    flash_mod._check_tma("q", _odd_size_one_strides())


def _odd_size_one_strides():
    """[1, 64, 1, 128] bf16 whose batch and head strides (3, 5) are no
    multiples of 8 elements."""
    return torch.zeros(64 * 128, dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 128), (3, 128, 5, 1))


def test_tma_strides_fill_size_one_dims():
    q = _odd_size_one_strides()
    st = flash_mod._tma_strides(q)
    assert st[1] == q.stride(1)
    assert all(s > 0 and s % 8 == 0 for s in st)
    k = torch.zeros(2, 64, 12, 128)[:, :, 8:10]       # a fused qkv slice
    assert flash_mod._tma_strides(k) == list(k.stride()[:3])


def _hopper_bwd_model(q, k, v, o, lse, do, causal, split=True):
    """The Hopper backward's arithmetic, tile by tile on the CPU, in f32
    as its kernels write it: per key tile of KEY_TILE, scores in f32 from
    the bf16 inputs, p = exp2(s * scale log2(e) - lse log2(e)) with masked
    positions at 0, dP = dO v^T in f32, ds = p (dP - delta); then that
    tile's dq = ds k, dk = ds^T q and dv = p^T dO (summed over each kv
    head's group), each product with p or ds as hi + lo bf16 (``split``)
    or with p and ds rounded to bf16 alone (the control), added to f32
    running sums; dq and dk times scale. The dk/dv kernel's 128-row q
    tiles only order its f32 sums, so the model takes all rows at once."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    dog = do.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    delta = (dog * o.float().reshape(B, Sq, Hkv, G, D)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]          # [B, Hkv, G, Sq, 1]
    lse2 = lse.reshape(B, Hkv, G, Sq, 1) * LOG2E
    scale = D ** -0.5
    scale_log2 = torch.tensor(scale * LOG2E)
    pos = torch.arange(Sq)[:, None] + (Sk - Sq)
    dq = torch.zeros(B, Hkv, G, Sq, D)
    dk, dv = torch.zeros(B, Sk, Hkv, D), torch.zeros(B, Sk, Hkv, D)

    def parts(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if split else (hi,)

    for k0 in range(0, Sk, KEY_TILE):
        kt, vt = kf[:, k0:k0 + KEY_TILE], vf[:, k0:k0 + KEY_TILE]
        keys = slice(k0, k0 + kt.shape[1])
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kt)
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[1]) > pos,
                              -1e30)
        p = torch.exp2(s * scale_log2 - lse2)
        ds = p * (torch.einsum("bqkgd,bskd->bkgqs", dog, vt) - delta)
        dq += sum(torch.einsum("bkgqs,bskd->bkgqd", x, kt) for x in parts(ds))
        dk[:, keys] += sum(torch.einsum("bkgqs,bqkgd->bskd", x, qg)
                           for x in parts(ds))
        dv[:, keys] += sum(torch.einsum("bkgqs,bqkgd->bskd", x, dog)
                           for x in parts(p))
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return dq, dk * scale, dv


def _bf16_bwd_case(Sq, Sk, causal, seed=0):
    """q, k, v (``_bf16_inputs``), the plain forward's o and lse, and a
    bf16 cotangent dO, from numpy."""
    q, k, v = _bf16_inputs(Sq, Sk, seed)
    o, lse = flash_attention_fwd_plain(q, k, v, causal)
    do = torch.tensor(np.random.default_rng(seed + 1).normal(
        size=q.shape).astype(np.float32)).bfloat16()
    return q, k, v, o, lse, do


def _f32_rel(a, b):
    """Largest |a - b| over b's largest magnitude, both f32 (passes at <=
    BWD_F32_REL)."""
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("Sq,Sk,causal", HOPPER_CASES)
def test_hopper_bwd_model_meets_the_f32_and_bf16_limits(Sq, Sk, causal):
    args = _bf16_bwd_case(Sq, Sk, causal)
    exp = flash_mod._bwd_plain_f32(*args, causal)
    got = _hopper_bwd_model(*args, causal)
    for name, a, b, t in zip(("dq", "dk", "dv"), got, exp, args):
        assert a.dtype == b.dtype == torch.float32, name
        assert a.shape == b.shape, name
        assert _f32_rel(a, b) <= BWD_F32_REL, name
        # the bf16 gradients the wrapper returns, against plain's
        assert _over_limit(a.to(t.dtype), b.to(t.dtype)) <= 1, name


@pytest.mark.parametrize("Sq,Sk,causal", HOPPER_CASES)
def test_hopper_bwd_model_with_p_and_ds_in_bf16_misses_a_limit(Sq, Sk,
                                                               causal):
    # the control: p and ds rounded to bf16 before their products compute
    # another function, which the f32 or the element-wise limit catches on
    # at least one gradient
    args = _bf16_bwd_case(Sq, Sk, causal)
    exp = flash_mod._bwd_plain_f32(*args, causal)
    got = _hopper_bwd_model(*args, causal, split=False)
    assert any(_f32_rel(a, b) > BWD_F32_REL
               or _over_limit(a.bfloat16(), b.bfloat16()) > 1
               for a, b in zip(got, exp))


def test_plain_backward_returns_f32_before_its_cast():
    args = _bf16_bwd_case(256, 256, True)
    cast = flash_attention_bwd_plain(*args, True)
    f32 = flash_mod._bwd_plain_f32(*args, True)
    for a, b in zip(cast, f32):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.float32
        assert torch.equal(a, b.bfloat16())


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 48, "simt"), (torch.bfloat16, 80, "simt"),
    (torch.bfloat16, 96, "simt"), (torch.bfloat16, 112, "simt"),
    (torch.float32, 64, "tf32"), (torch.float32, 128, "tf32"),
])
def test_backward_route_by_dtype_and_head_dim(dtype, head_dim, route):
    # the route is named by the counters its dq and dk/dv launches go to
    # (f32 at 64 and 128 on the 3xTF32 pair)
    names = {"wgmma": ("flash_attention_bwd_dq_wgmma",
                       "flash_attention_bwd_dkv_wgmma"),
             "tf32": ("flash_attention_bwd_dq_tf32",
                      "flash_attention_bwd_dkv_tf32"),
             "simt": ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    assert flash_mod.backward_route(dtype, head_dim) == names[route]
    assert all(name in ops.KERNELS for name in names[route])


def test_tma_checks_refuse_a_misaligned_do():
    base = torch.zeros(64 * 4 * 128 + 8, dtype=torch.bfloat16)
    flash_mod._check_tma("do", base[:-8].view(1, 64, 4, 128))
    with pytest.raises(ValueError, match="do is not 16-byte aligned"):
        flash_mod._check_tma("do", base[1:-7].view(1, 64, 4, 128))
    # dO as a slice of a wider tensor: a head stride of 136 elements (272
    # bytes) passes, one of 132 (264 bytes) does not
    flash_mod._check_tma("do", torch.zeros(1, 64, 4, 136,
                                           dtype=torch.bfloat16)[..., :128])
    with pytest.raises(ValueError, match="do's stride 132"):
        flash_mod._check_tma("do", torch.zeros(1, 64, 4, 132,
                                               dtype=torch.bfloat16)[..., :128])


@pytest.mark.parametrize("fn", [flash_attention_bwd_cuda,
                                flash_mod._bwd_cuda_as_written],
                         ids=["cast", "as_written"])
def test_the_cuda_backward_refuses_a_cpu_tensor(fn):
    args = _bf16_bwd_case(64, 64, True)
    with pytest.raises(RuntimeError, match="cpu"):
        fn(*args, True)
