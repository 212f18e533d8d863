"""The CUDA kernels on the card, against their plain PyTorch versions,
and the serving, training, LM serving, LM training and recsys serving
slices on the card at a small size.

Every test here is marked ``gpu`` and skips where no GPU is present (the
kernels have no CPU mode). The file imports only torch, numpy and the
port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import bus_attention as bus_mod  # noqa: E402
from repro_torch.kernels import embedding_bag as ebag_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import pq_scoring as pq_mod  # noqa: E402

pytestmark = pytest.mark.gpu

BUS_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the Hopper backward writes f32 gradients, held before the wrapper's cast
# within 1e-4 of each plain f32 gradient's largest magnitude (the f32
# limit above), beside the element-wise bf16 limit on the casts
BWD_F32_REL = 1e-4
PQ_TOL = 1e-5
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # JAX tests' own
# bf16 also element-wise: both versions round an f32 result to bf16, so
# they differ by at most one ulp, at most 2^-7 of the value
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 1e-4
LSE_TOL = 1e-4        # f32 either way: sums of exp in another order
# EmbeddingBag, kernel vs plain: f32 sums of up to 16 products in another
# order (exact for nnz <= 2); bf16 rounds those f32 sums once, so one ulp
# (2^-7 of the value) apart at most, plus the f32 gap near 0
EBAG_TOL_F32, EBAG_BF16_RTOL = 2e-5, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bus(M, K, S, H, D, dev, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    Sk = S + K
    q = torch.randn(M, K, S, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(M, K, Sk, H, D, generator=g, device=dev).to(dtype)
    v = torch.randn(M, K, Sk, H, D, generator=g, device=dev).to(dtype)
    mask = torch.rand(M, K, Sk, generator=g, device=dev) < 0.75
    mask[:, :, 0] = True
    mask[::3, K - 1] = False                   # segments with no valid key
    return q, k, v, mask


def _pq(B, M, K, N, Bc, Bv, code_dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.randn(B, M, K, generator=g, device=dev)
    codes = torch.randint(0, K, (Bc, N, M), generator=g,
                          device=dev).to(code_dtype)
    valid = None if Bv is None else \
        torch.rand(Bv, N, generator=g, device=dev) < 0.7
    return lut, codes, valid


@pytest.mark.parametrize("shape", [(256, 3, 32, 12, 64), (7, 3, 32, 12, 64),
                                   (5, 2, 8, 4, 16), (3, 5, 16, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bus_attention_cuda_matches_plain(cuda, shape, dtype):
    q, k, v, mask = _bus(*shape, cuda, dtype)
    got = bus_mod.bus_attention_cuda(q, k, v, mask)
    exp = bus_mod.bus_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - exp.float()).abs().max()) <= BUS_TOL[dtype]


def test_bus_attention_cuda_uniform_mean_on_an_all_masked_segment(cuda):
    q, k, v, mask = _bus(4, 3, 32, 12, 64, cuda)
    mask[1, 2] = False
    got = bus_mod.bus_attention_cuda(q, k, v, mask)
    exp = v[1, 2].mean(dim=0)                              # over Sk keys
    assert float((got[1, 2] - exp[None]).abs().max()) <= BUS_TOL[q.dtype]


@pytest.mark.parametrize("shape", [
    (256, 3, 32, 12, 64), (7, 3, 32, 12, 64),          # odd M
    (9, 3, 8, 12, 64), (9, 3, 16, 12, 64), (9, 3, 24, 12, 64),   # buckets
    (3, 5, 16, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bus_attention_bwd_cuda_matches_plain(cuda, shape, dtype):
    q, k, v, mask = _bus(*shape, cuda, dtype)          # all-masked segments
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(9), device=cuda).to(dtype)
    got = bus_mod.bus_attention_bwd_cuda(q, k, v, mask, do)
    exp = bus_mod.bus_attention_bwd_plain(q, k, v, mask, do)
    torch.cuda.synchronize()
    for a, b in zip(got, exp):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= BWD_TOL[dtype]
    dv = got[2].float()
    assert float(dv[::3, shape[1] - 1].abs().max()) > 0     # uniform p


def test_bus_attention_grad_on_cuda_goes_through_both_kernels(cuda,
                                                             monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    q, k, v, mask = _bus(5, 3, 16, 4, 32, cuda)
    do = torch.randn_like(q)
    exp = bus_mod.bus_attention_bwd_plain(q, k, v, mask, do)
    monkeypatch.setattr(bus_mod, "bus_attention_plain", refuse)
    monkeypatch.setattr(bus_mod, "bus_attention_bwd_plain", refuse)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    before = ops.launch_counts()
    o = ops.bus_attention(q, k, v, mask)
    assert o.grad_fn is not None
    o.backward(do)
    after = ops.launch_counts()
    assert after["bus_attention"] == before["bus_attention"] + 1
    assert after["bus_attention_bwd"] == before["bus_attention_bwd"] + 1
    for t, e in zip((q, k, v), exp):
        assert float((t.grad - e).abs().max()) <= BWD_TOL[torch.float32]


def test_train_step_on_the_card_matches_the_plain_path(cuda):
    """One Algorithm-1 step at the small configuration with remat: loss
    and every gradient through the kernels against the plain path."""
    import dataclasses
    from repro_torch import core, data
    from repro_torch.launch import train
    from repro_torch.optim.adam import leaves
    cfg = train.small_speedyfeed_config()
    cfg = dataclasses.replace(cfg, plm=dataclasses.replace(cfg.plm,
                                                           remat=True))
    b = data.synth_centralized_batch(
        m_cap=cfg.merged_cap, n_segments=3, seg_len=cfg.plm.seg_len,
        b_cap=cfg.batch_users, hist_len=cfg.hist_len, vocab=cfg.plm.vocab)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in b.items()}
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = core.init_speedyfeed(gen, cfg)
    flat = [p.requires_grad_() for _, p in leaves(params)]
    neg = core.sample_negatives(gen, cfg.merged_cap,
                                (cfg.batch_users, cfg.hist_len - 1),
                                cfg.n_neg)
    out = {}
    for impl in ("kernel", "plain"):
        cache = core.init_cache(cfg.cache, cuda)
        ops.reset_launch_counts()
        res = core.speedyfeed_forward(params, cfg, batch, cache, 0, u=1.0,
                                      neg_idx=neg, impl=impl)
        grads = torch.autograd.grad(res.loss, flat, allow_unused=True)
        out[impl] = (res.loss, grads, ops.launch_counts())
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    L = cfg.plm.n_layers
    assert ck["bus_attention"] == 2 * L and ck["bus_attention_bwd"] == L
    assert cp["bus_attention"] == 0 and cp["bus_attention_bwd"] == 0
    assert abs(float(lk.detach()) - float(lp.detach())) <= 1e-4
    assert all((a is None) == (b is None) for a, b in zip(gk, gp))
    rows = [(n, a, b) for (n, _), a, b in zip(leaves(params), gk, gp)
            if b is not None]
    top_mag = max(float(b.abs().max()) for _, _, b in rows)
    for n, a, b in rows:
        if n.endswith("attn/k/b"):    # 0 in exact arithmetic on both paths
            assert float(a.abs().max()) <= 1e-5 * top_mag, n
            assert float(b.abs().max()) <= 1e-5 * top_mag, n
        else:
            assert float((a - b).abs().max()) <= 1e-3 * float(
                b.abs().max()), n


def test_trainer_fit_on_the_card(cuda):
    from repro_torch.launch import train
    ops.reset_launch_counts()
    res = train.train_speedyfeed(steps=3, device=cuda, log_every=1)
    assert res.steps_done == 3 and all(np.isfinite(res.losses))
    counts = ops.launch_counts()
    assert counts["bus_attention_bwd"] == 3 * 2     # 2 layers, no remat
    assert counts["bus_attention"] == 3 * 2


@pytest.mark.parametrize("M,K,Bc,Bv,code_dtype", [
    (8, 32, 16, 16, torch.uint8),     # the serve path (8-byte code loads)
    (8, 32, 1, 1, torch.uint8),       # shared codes and validity
    (8, 32, 16, None, torch.uint8),
    (5, 256, 16, 1, torch.uint8),     # M not a multiple of 8
    (8, 32, 1, 16, torch.int32),
])
def test_pq_lut_scores_cuda_matches_plain(cuda, M, K, Bc, Bv, code_dtype):
    lut, codes, valid = _pq(16, M, K, 5003, Bc, Bv, code_dtype, cuda)
    got = pq_mod.pq_lut_scores_cuda(lut, codes, valid)
    exp = pq_mod.pq_lut_scores_plain(lut, codes, valid)
    torch.cuda.synchronize()
    fin = torch.isfinite(exp)
    assert torch.equal(torch.isfinite(got), fin)
    assert float((got[fin] - exp[fin]).abs().max()) <= PQ_TOL


@pytest.mark.parametrize("code_dtype,lo,hi", [
    (torch.uint8, 0, 20),      # 8-byte loads, codes at and past K=16
    (torch.int32, -20, 20),
])
def test_pq_lut_scores_cuda_out_of_range_codes_match_plain(cuda, code_dtype,
                                                           lo, hi):
    """Codes outside the table score NaN on both versions, at the same
    slots; negative int32 codes count from the end on both."""
    g = torch.Generator(device=cuda).manual_seed(2)
    lut = torch.randn(16, 8, 16, generator=g, device=cuda)
    codes = torch.randint(lo, hi, (16, 999, 8), generator=g,
                          device=cuda).to(code_dtype)
    valid = torch.rand(16, 999, generator=g, device=cuda) < 0.7
    got = pq_mod.pq_lut_scores_cuda(lut, codes, valid)
    exp = pq_mod.pq_lut_scores_plain(lut, codes, valid)
    torch.cuda.synchronize()
    assert bool(exp.isnan().any()) and bool(exp.isfinite().any())
    torch.testing.assert_close(got, exp, rtol=0, atol=PQ_TOL, equal_nan=True)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v, mask = _bus(2, 3, 8, 2, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bus_mod.bus_attention_cuda(q.transpose(2, 3).contiguous()
                                   .transpose(2, 3), k, v, mask)
    with pytest.raises(ValueError, match="bool"):
        bus_mod.bus_attention_cuda(q, k, v, mask.to(torch.uint8))
    lut, codes, valid = _pq(2, 8, 32, 40, 2, 2, torch.uint8, cuda)
    with pytest.raises(TypeError):
        pq_mod.pq_lut_scores_cuda(lut.double(), codes, valid)
    with pytest.raises(TypeError):
        pq_mod.pq_lut_scores_cuda(lut, codes.long(), valid)


def test_ops_never_take_the_plain_version_on_cuda(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(bus_mod, "bus_attention_plain", refuse)
    monkeypatch.setattr(pq_mod, "pq_lut_scores_plain", refuse)
    q, k, v, mask = _bus(2, 3, 8, 2, 16, cuda)
    lut, codes, valid = _pq(2, 8, 32, 40, 2, 2, torch.uint8, cuda)
    before = ops.launch_counts()
    ops.bus_attention(q, k, v, mask)
    ops.pq_lut_scores(lut, codes, valid)
    after = ops.launch_counts()
    assert after["bus_attention"] == before["bus_attention"] + 1
    assert after["pq_lut_scores"] == before["pq_lut_scores"] + 1


def test_serving_slice_on_the_card_goes_through_both_kernels(cuda):
    from repro_torch import core
    from repro_torch.launch import serve, train
    cfg = train.small_speedyfeed_config()
    _, log, store, _ = train.make_loader(cfg, n_news=600, n_users=64)
    params = core.init_speedyfeed(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    rec = serve.Recommender(cfg, params, store, k=10, index_kind="ivf-pq",
                            nprobe=4, k_prime=32, device=cuda)
    ops.reset_launch_counts()
    emb = rec._encode_corpus()
    rec.build_index_from(emb)
    results, n_batches, _ = serve.micro_batch_loop(rec, log.histories[:32],
                                                   max_batch=16)
    counts = ops.launch_counts()
    assert counts["bus_attention"] == cfg.plm.n_layers * 3    # 601 rows
    assert counts["pq_lut_scores"] == n_batches == 2
    assert all((r > 0).all() for r in results)
    with torch.inference_mode():
        toks = torch.as_tensor(store.tokens[1:257], device=cuda).long()
        freq = torch.as_tensor(store.freq[1:257], device=cuda).long()
        plain = core.buslm_encode(rec.params["plm"], cfg.plm, toks, freq,
                                  impl="plain")
    assert float((plain - emb[1:257]).abs().max()) <= 5e-4
    # the query batch's stage-1 scan: kernel and plain on the inputs the
    # served search gathers, ranked the same way
    from repro_torch.serving.index import _masked_topk, _pq_scan_inputs
    hist, mask = serve._pad_histories(rec, log.histories[:16], 16)
    user = rec.encode_users(hist, mask)
    snap = rec.service.snapshot()
    lut, codes, valid, cand, coarse = _pq_scan_inputs(
        user, snap.cent_unit, snap.cent_raw, snap.list_ids, snap.payload,
        snap.lens, snap.pq_centers, snap.pq_rot, nprobe=snap.nprobe,
        metric=snap.metric)
    k_eff = min(rec.service.k_prime, snap.nprobe * snap.cap)
    s_k, _ = _masked_topk(ops.pq_lut_scores(lut, codes, valid) + coarse,
                          cand, valid, k_eff)
    s_p, _ = _masked_topk(pq_mod.pq_lut_scores_plain(lut, codes, valid)
                          + coarse, cand, valid, k_eff)
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-4)
    assert np.isfinite(emb.cpu().numpy()).all()


def test_background_rebuild_on_the_card_while_queries_run(cuda):
    """A compaction on the rebuild thread (same device) while the request
    thread keeps querying; every query sees one whole snapshot."""
    from repro_torch import serving
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    ids = np.arange(1, 3001)
    q = rng.normal(size=(8, 32)).astype(np.float32)
    svc = serving.RetrievalService(
        serving.IndexBuilder("ivf-pq", 32, device=cuda,
                             ivf=serving.IVFConfig(nlist=16, nprobe=16)),
        np.zeros((1, 32), np.float32), k=10, auto_compact=False,
        device=cuda)
    svc.publish(ids[:2500], x[:2500])
    svc.rebuild(mode="full", block=True)
    svc.publish(ids[2500:], x[2500:])
    thread = svc.rebuild(mode="compact", block=False)
    n_queries = 0
    while thread.is_alive() or n_queries == 0:
        _, got = svc.query(q)
        assert got.shape == (8, 10) and (got > 0).all()
        n_queries += 1
    svc.wait_for_build()
    assert svc.version == 2 and svc.ntotal == 3000 and svc.n_pending == 0
    exact = ids[np.argsort(-(q @ x.T), axis=1)[:, :10]]
    _, got = svc.query(q)
    hits = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, exact)])
    assert hits >= 0.5


def _flash(B, Sq, Sk, Hq, Hkv, D, dev, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, Hq, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device=dev).to(dtype)
    return q, k, v


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (1, 128, 128, 4, 4, 64),      # MHA
    (2, 256, 256, 8, 2, 64),      # GQA 4:1
    (1, 128, 128, 8, 1, 32),      # MQA
    (2, 512, 512, 4, 4, 128),     # head dim 128
    (1, 64, 128, 4, 4, 32),       # Sq != Sk: causal offset q_off = 64
    (2, 100, 300, 4, 2, 16),      # ragged tiles, q_off = 200
    (1, 1024, 1024, 40, 8, 128),  # Qwen3-14B's heads
    (2, 200, 333, 8, 2, 128),     # Sk no multiple of the 128-key tile
    (1, 1, 300, 8, 2, 128),       # one query row over 300 keys
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D,
                                            causal, dtype):
    q, k, v = _flash(B, Sq, Sk, Hq, Hkv, D, cuda, dtype)
    o, lse = flash_mod.flash_attention_cuda(q, k, v, causal)
    o_p, lse_p = flash_mod.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    assert float((o.float() - o_p.float()).abs().max()) <= FLASH_TOL[dtype]
    assert float((lse - lse_p).abs().max()) <= LSE_TOL
    if dtype == torch.bfloat16:
        torch.testing.assert_close(o.float(), o_p.float(),
                                   rtol=FLASH_BF16_RTOL,
                                   atol=FLASH_BF16_ATOL)


def test_flash_attention_cuda_reads_strided_views(cuda):
    # q/k/v as slices of one fused [B, S, Hq + 2 Hkv, D] projection: the
    # kernel reads them through their strides, with no copy
    B, S, Hq, Hkv, D = 2, 192, 8, 2, 64
    qkv = torch.randn(B, S, Hq + 2 * Hkv, D, device=cuda)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    assert not q.is_contiguous()
    o, lse = flash_mod.flash_attention_cuda(q, k, v, True)
    o_p, lse_p = flash_mod.flash_attention_fwd_plain(q, k, v, True)
    assert float((o - o_p).abs().max()) <= FLASH_TOL[torch.float32]
    assert float((lse - lse_p).abs().max()) <= LSE_TOL


def test_flash_attention_wgmma_reads_strided_views(cuda):
    # bf16 at head dim 128 (the Hopper kernel's route): q/k/v as slices of
    # one fused [B, S, Hq + 2 Hkv, D] projection, read through their
    # strides by TMA
    B, S, Hq, Hkv, D = 2, 320, 8, 2, 128
    qkv = torch.randn(B, S, Hq + 2 * Hkv, D, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    assert not q.is_contiguous()
    assert flash_mod.forward_route(q.dtype, D) == "flash_attention_wgmma"
    before = ops.launch_counts()["flash_attention_wgmma"]
    o, lse = flash_mod.flash_attention_cuda(q, k, v, True)
    o_p, lse_p = flash_mod.flash_attention_fwd_plain(q, k, v, True)
    assert ops.launch_counts()["flash_attention_wgmma"] == before + 1
    assert float((o.float() - o_p.float()).abs().max()) <= \
        FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o_p.float(), rtol=FLASH_BF16_RTOL,
                               atol=FLASH_BF16_ATOL)
    assert float((lse - lse_p).abs().max()) <= LSE_TOL


def test_flash_wgmma_refuses_a_misaligned_view(cuda):
    q, k, v = _flash(1, 64, 64, 4, 2, 128, cuda, torch.bfloat16)
    # a base 2 bytes past a 16-byte boundary
    flat = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:q.numel() + 1].view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_mod.flash_attention_cuda(shifted, k, v, True)
    # a head stride of 132 elements: 264 bytes, no multiple of 16
    wide = torch.zeros(1, 64, 4, 132, dtype=torch.bfloat16,
                       device=cuda)[..., :128].copy_(q)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        flash_mod.flash_attention_cuda(wide, k, v, True)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 64, "flash_attention_wgmma"),
    (torch.bfloat16, 32, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
])
def test_flash_forward_launches_count_by_route(cuda, dtype, D, route):
    assert flash_mod.forward_route(dtype, D) == route
    q, k, v = _flash(1, 128, 128, 4, 2, D, cuda, dtype)
    names = ("flash_attention", "flash_attention_wgmma")
    before = ops.launch_counts()
    flash_mod.flash_attention_cuda(q, k, v, True)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in names} == \
        {n: int(n == route) for n in names}


def test_flash_bwd_on_the_wgmma_forward_matches_plain(cuda):
    # the backward (backward_route: the Hopper pair) on o and lse from the
    # Hopper forward, at the LM training shape's heads (40/8 of 128), bf16
    q, k, v, _, _, do = _flash_bwd_inputs(2, 512, 512, 40, 8, 128, cuda,
                                          torch.bfloat16, True)
    before = ops.launch_counts()["flash_attention_wgmma"]
    o, lse = flash_mod.flash_attention_cuda(q, k, v, True)
    assert ops.launch_counts()["flash_attention_wgmma"] == before + 1
    _, lse_p = flash_mod.flash_attention_fwd_plain(q, k, v, True)
    assert float((lse - lse_p).abs().max()) <= LSE_TOL
    got = flash_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    exp = flash_mod.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    _hold_bwd(got, exp, torch.bfloat16)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash(1, 64, 64, 4, 2, 32, cuda)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_mod.flash_attention_cuda(q, k[:, :32], v[:, :32], True)
    with pytest.raises(TypeError):
        flash_mod.flash_attention_cuda(q.half(), k.half(), v.half(), True)
    q24, k24, v24 = _flash(1, 64, 64, 4, 2, 24, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_mod.flash_attention_cuda(q24, k24, v24, True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_mod.flash_attention_cuda(q.transpose(2, 3).contiguous()
                                       .transpose(2, 3), k, v, True)


def _flash_bwd_inputs(B, Sq, Sk, Hq, Hkv, D, dev, dtype, causal, seed=0):
    q, k, v = _flash(B, Sq, Sk, Hq, Hkv, D, dev, dtype, seed)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(seed + 1), device=dev).to(dtype)
    o, lse = flash_mod.flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, o, lse, do


def _hold_bwd(got, exp, dtype):
    """f32: within the JAX tests' 1e-4; bf16: within their 2e-2 and
    element-wise within one bf16 ulp (both versions round an f32 result
    once) plus the f32 gap near 0."""
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert float((a.float() - b.float()).abs().max()) <= BWD_TOL[dtype], \
            name
        if dtype == torch.bfloat16:
            torch.testing.assert_close(a.float(), b.float(),
                                       rtol=FLASH_BF16_RTOL,
                                       atol=FLASH_BF16_ATOL, msg=name)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (1, 128, 128, 4, 4, 64),      # MHA (tests/test_kernels.py's shapes)
    (2, 128, 128, 8, 2, 32),      # GQA 4:1
    (1, 64, 128, 4, 4, 32),       # Sq != Sk: q_off = 64
    (2, 100, 300, 4, 2, 16),      # ragged tiles, q_off = 200
    (1, 512, 512, 10, 2, 128),    # Qwen3-14B's head dim and GQA 5:1
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_cuda_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D,
                                                causal, dtype):
    args = _flash_bwd_inputs(B, Sq, Sk, Hq, Hkv, D, cuda, dtype, causal)
    route = flash_mod.backward_route(dtype, D)
    before = ops.launch_counts()
    got = flash_mod.flash_attention_bwd_cuda(*args, causal)
    after = ops.launch_counts()
    exp = flash_mod.flash_attention_bwd_plain(*args, causal)
    torch.cuda.synchronize()
    assert all(after[n] == before[n] + 1 for n in route), route
    _hold_bwd(got, exp, dtype)


def _over_limit(a, b):
    """Largest |a - b| over the element-wise bf16 limit (passes at <= 1)."""
    b = b.float()
    return float(((a.float() - b).abs()
                  / (FLASH_BF16_RTOL * b.abs() + FLASH_BF16_ATOL)).max())


def _f32_rel(a, b):
    """Largest |a - b| over b's largest magnitude (passes at <=
    BWD_F32_REL)."""
    return float((a - b).abs().max() / b.abs().max())


def _without_last_key_tile(q, k, v, o, lse, do, causal, exp, width=64):
    """Plain's f32 gradients ``exp`` as a kernel that lost the last
    ``width`` keys would give them: dk and dv zero there, dq without those
    keys' ds k (plain's formula on them alone, with the same lse and
    delta)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, t0 = Hq // Hkv, max(Sk - width, 0)
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    dog = do.float().reshape(B, Sq, Hkv, G, D)
    kt, vt = k[:, t0:].float(), v[:, t0:].float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kt) * D ** -0.5
    if causal:
        pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        s = s.masked_fill(torch.arange(t0, Sk, device=q.device) > pos, -1e30)
    p = (s - lse.reshape(B, Hkv, G, Sq, 1)).exp()
    delta = (dog * o.float().reshape(B, Sq, Hkv, G, D)).sum(-1)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", dog, vt)
              - delta.permute(0, 2, 3, 1)[..., None])
    dq_last = torch.einsum("bkgqs,bskd->bqkgd", ds, kt) * D ** -0.5
    dk, dv = exp[1].clone(), exp[2].clone()
    dk[:, t0:] = 0
    dv[:, t0:] = 0
    return exp[0] - dq_last.reshape(B, Sq, Hq, D), dk, dv


def _hold_hopper_bwd(args, causal):
    """The Hopper pair on ``args`` (q, k, v, o, lse, dO; bf16) against
    plain: each f32 gradient before the cast within BWD_F32_REL of plain's
    f32 largest, each bf16 cast within the element-wise limit of plain's
    cast, and a kernel that lost the last key tile missing both limits.
    Returns the f32 gradients."""
    got = flash_mod._bwd_cuda_as_written(*args, causal)
    exp = flash_mod._bwd_plain_f32(*args, causal)
    controls = _without_last_key_tile(*args, causal, exp)
    torch.cuda.synchronize()
    for name, a, b, c, t in zip(("dq", "dk", "dv"), got, exp, controls,
                                args):
        assert a.dtype == b.dtype == torch.float32, name
        assert a.shape == b.shape, name
        assert _f32_rel(a, b) <= BWD_F32_REL, name
        assert _over_limit(a.to(t.dtype), b.to(t.dtype)) <= 1, name
        assert _f32_rel(c, b) > BWD_F32_REL, name
        assert _over_limit(c.to(t.dtype), b.to(t.dtype)) > 1, name
    return got


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 256, 256, 8, 2, 64),      # GQA 4:1
    (2, 100, 300, 4, 2, 64),      # ragged tiles, q_off = 200
    (2, 200, 333, 8, 2, 128),     # Sk no multiple of the key tiles
    (1, 1, 300, 8, 2, 128),       # one query row over 300 keys
    (1, 1024, 1024, 40, 8, 128),  # Qwen3-14B's heads
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_wgmma_matches_plain(cuda, B, Sq, Sk, Hq, Hkv,
                                                 D, causal):
    args = _flash_bwd_inputs(B, Sq, Sk, Hq, Hkv, D, cuda, torch.bfloat16,
                             causal)
    route = flash_mod.backward_route(torch.bfloat16, D)
    assert route == ("flash_attention_bwd_dq_wgmma",
                     "flash_attention_bwd_dkv_wgmma")
    before = ops.launch_counts()
    _hold_hopper_bwd(args, causal)
    after = ops.launch_counts()
    assert all(after[n] == before[n] + 1 for n in route), route


def test_flash_attention_bwd_cuda_reads_strided_views(cuda):
    # q/k/v as slices of one fused projection, dO a slice of a wider
    # tensor: the kernels read them through their strides
    B, S, Hq, Hkv, D = 2, 192, 8, 2, 64
    qkv = torch.randn(B, S, Hq + 2 * Hkv, D, device=cuda)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    do = torch.randn(B, S, 2 * Hq, D, device=cuda)[:, :, :Hq]
    assert not (q.is_contiguous() or do.is_contiguous())
    o, lse = flash_mod.flash_attention_fwd_plain(q, k, v, True)
    got = flash_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    exp = flash_mod.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    _hold_bwd(got, exp, torch.float32)


def test_flash_attention_grads_on_cuda_go_through_both_kernels(
        cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    q, k, v, _, _, do = _flash_bwd_inputs(2, 128, 128, 8, 2, 32, cuda,
                                          torch.float32, True)
    o, lse = flash_mod.flash_attention_fwd_plain(q, k, v, True)
    exp = flash_mod.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    monkeypatch.setattr(flash_mod, "flash_attention_fwd_plain", refuse)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_plain", refuse)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    before = ops.launch_counts()
    out = ops.flash_attention(q, k, v)
    out.backward(do)
    after = ops.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    _hold_bwd((q.grad, k.grad, v.grad), exp, torch.float32)



def test_flash_attention_bwd_wgmma_reads_strided_views(cuda):
    # q/k/v as slices of one fused bf16 projection and dO a slice of a
    # wider tensor, read through their strides by TMA
    B, S, Hq, Hkv, D = 2, 320, 8, 2, 128
    qkv = torch.randn(B, S, Hq + 2 * Hkv, D, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    do = torch.randn(B, S, 2 * Hq, D, device=cuda).to(torch.bfloat16)[:, :,
                                                                      :Hq]
    assert not (q.is_contiguous() or do.is_contiguous())
    o, lse = flash_mod.flash_attention_cuda(q, k, v, True)
    before = ops.launch_counts()["flash_attention_bwd_dq_wgmma"]
    _hold_hopper_bwd((q, k, v, o, lse, do), True)
    assert ops.launch_counts()["flash_attention_bwd_dq_wgmma"] == before + 1


def test_flash_bwd_wgmma_refuses_a_misaligned_view(cuda):
    q, k, v, o, lse, do = _flash_bwd_inputs(1, 64, 64, 4, 2, 128, cuda,
                                            torch.bfloat16, True)
    bwd = flash_mod.flash_attention_bwd_cuda
    before = ops.launch_counts()
    # a dO base 2 bytes past a 16-byte boundary
    flat = torch.empty(do.numel() + 8, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:do.numel() + 1].view(do.shape).copy_(do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bwd(q, k, v, o, lse, shifted, True)
    # a head stride of 132 elements: 264 bytes, no multiple of 16
    wide = torch.zeros(1, 64, 4, 132, dtype=torch.bfloat16,
                       device=cuda)[..., :128].copy_(do)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        bwd(q, k, v, o, lse, wide, True)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        bwd(wide, k, v, o, lse, do, True)
    # refused before any launch, on either route: nothing falls back
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 128)])
def test_flash_backward_launches_count_by_route(cuda, dtype, D):
    route = flash_mod.backward_route(dtype, D)
    args = _flash_bwd_inputs(1, 128, 128, 4, 2, D, cuda, dtype, True)
    names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq_wgmma", "flash_attention_bwd_dkv_wgmma")
    before = ops.launch_counts()
    flash_mod.flash_attention_bwd_cuda(*args, True)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in names} == \
        {n: int(n in route) for n in names}


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_wgmma_is_bitwise_deterministic(cuda, causal):
    # each gradient has one owner and fixed sums: two runs agree bit for
    # bit, in f32 before the cast
    args = _flash_bwd_inputs(2, 640, 640, 40, 8, 128, cuda, torch.bfloat16,
                             causal)
    first = flash_mod._bwd_cuda_as_written(*args, causal)
    second = flash_mod._bwd_cuda_as_written(*args, causal)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert a.dtype == torch.float32 and torch.equal(a, b), name


def test_flash_attention_grads_on_cuda_go_through_the_hopper_kernels(
        cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    q, k, v, _, _, do = _flash_bwd_inputs(2, 256, 256, 8, 2, 128, cuda,
                                          torch.bfloat16, True)
    o, lse = flash_mod.flash_attention_cuda(q, k, v, True)
    exp = flash_mod.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    got32 = flash_mod._bwd_cuda_as_written(q, k, v, o, lse, do, True)
    monkeypatch.setattr(flash_mod, "flash_attention_fwd_plain", refuse)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_plain", refuse)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    names = ("flash_attention_wgmma", "flash_attention_bwd_dq_wgmma",
             "flash_attention_bwd_dkv_wgmma", "flash_attention",
             "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    before = ops.launch_counts()
    out = ops.flash_attention(q, k, v)
    out.backward(do)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in names} == \
        {n: int("wgmma" in n) for n in names}
    # autograd hands back the wrapper's casts of the f32 gradients
    for name, g, a, e in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                             got32, exp):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a.bfloat16()), \
            name
        assert _over_limit(g, e) <= 1, name

def test_flash_bwd_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v, o, lse, do = _flash_bwd_inputs(1, 64, 64, 4, 2, 32, cuda,
                                            torch.float32, True)
    bwd = flash_mod.flash_attention_bwd_cuda
    with pytest.raises(TypeError):
        bwd(q, k, v, o, lse, do.to(torch.bfloat16), True)
    with pytest.raises(ValueError, match="lse"):
        bwd(q, k, v, o, lse.to(torch.bfloat16), do, True)
    with pytest.raises(ValueError, match="do shape"):
        bwd(q, k, v, o, lse, do[:, :32], True)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q, k, v, o, lse, do.transpose(2, 3).contiguous()
            .transpose(2, 3), True)
    with pytest.raises(RuntimeError, match="cpu"):
        bwd(*(t.cpu() for t in (q, k, v, o, lse, do)), True)


def test_lm_train_steps_on_the_card_match_the_cpu(cuda):
    """Two train steps of a reduced Qwen3-14B with remat and the chunked
    loss, on the card and on the CPU from the same parameters, with
    accumulation over two microbatches: losses and parameters within
    1e-4, and the flash kernels' launches per step."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.configs import lm_family
    from repro_torch.models import lm
    from repro_torch.optim.adam import leaves
    cfg = dataclasses.replace(lm_family.reduced_lm(lm_family.QWEN3_14B),
                              remat=True, loss_chunk=16)
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    params_d = _to(params, cuda)
    opt, opt_d = optim.adam_init(params), optim.adam_init(params_d)
    step = optim.make_train_step(
        lambda p, b: lm.lm_loss(p, cfg, b),
        dataclasses.replace(lm_family.TRAIN_OPT, accum_steps=2),
        lm_family.TRAIN_SCHEDULE)
    toks = torch.randint(0, cfg.vocab, (4, 64),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    L = cfg.n_layers
    for _ in range(2):
        before = ops.launch_counts()
        params_d, opt_d, m_d = step(params_d, opt_d, _to(batch, cuda))
        after = ops.launch_counts()
        # two microbatches: forward and remat recompute, then backward
        assert after["flash_attention"] - before["flash_attention"] == 4 * L
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            assert after[name] - before[name] == 2 * L, name
        params, opt, m = step(params, opt, batch)
        assert abs(float(m_d["loss"]) - float(m["loss"])) <= 1e-4
    for (path, a), (_, b) in zip(leaves(params_d), leaves(params)):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-4, \
            path


def test_attention_on_cuda_launches_the_flash_kernel_only_unmasked(
        cuda, monkeypatch):
    import dataclasses
    from repro_torch import nn
    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(flash_mod, "flash_attention_fwd_plain", refuse)
    cfg = nn.AttnConfig(d_model=64, n_heads=4, n_kv=2, head_dim=16,
                        qk_norm=True, qkv_bias=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = nn.init_attention(gen, cfg)
    x = torch.randn(2, 32, 64, generator=gen, device=cuda)

    def flash_launches(**kw):
        before = ops.launch_counts()["flash_attention"]
        with torch.no_grad():
            nn.attention(params, x, kw.pop("cfg", cfg), **kw)
        return ops.launch_counts()["flash_attention"] - before

    assert flash_launches() == 1
    assert flash_launches(mask=torch.ones(2, 32, dtype=torch.bool,
                                          device=cuda)) == 0
    assert flash_launches(cfg=dataclasses.replace(cfg, chunk_size=8)) == 0


def _to(node, dev):
    """A copy of a nested dict/list of tensors on ``dev``."""
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dev) for v in node]
    return node.to(dev)


def test_lm_prefill_and_decode_on_cuda_match_the_cpu(cuda):
    from repro_torch.configs import lm_family
    from repro_torch.models import lm
    cfg = lm_family.reduced_lm(lm_family.QWEN3_14B)
    params = lm.init(torch.Generator().manual_seed(0), cfg)

    def to_card(node):
        if isinstance(node, dict):
            return {k: to_card(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_card(v) for v in node]
        return node.to(cuda)

    params_d = to_card(params)
    toks = torch.randint(0, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    prefill = lm_family.make_fn(cfg, "prefill")
    decode = lm_family.make_fn(cfg, "decode")
    before = ops.launch_counts()["flash_attention"]
    got = prefill(params_d, toks.to(cuda))
    assert ops.launch_counts()["flash_attention"] == before + cfg.n_layers
    exp = prefill(params, toks)
    assert float((got.cpu() - exp).abs().max()) <= 1e-4
    cache_d = lm.init_cache(cfg, 2, 16, torch.float32, device=cuda)
    cache = lm.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    for t in range(8):
        got, cache_d = decode(params_d, toks[:, t:t + 1].to(cuda), cache_d, t)
        exp, cache = decode(params, toks[:, t:t + 1], cache, t)
        assert float((got.cpu() - exp).abs().max()) <= 1e-4
    assert ops.launch_counts()["flash_attention"] == before + cfg.n_layers


def _ebag(V, d, B, F, nnz, dev, dtype=torch.float32, seed=0, lo=0, hi=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(V, d, generator=g, device=dev).to(dtype)
    idx = torch.randint(lo, V if hi is None else hi, (B, F, nnz),
                        generator=g, device=dev, dtype=torch.int32)
    w = torch.rand(B, F, nnz, generator=g, device=dev)
    return table, idx, w


@pytest.mark.parametrize("d", [1, 7, 16, 32, 64, 128])
@pytest.mark.parametrize("nnz", [1, 2, 16])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_cuda_matches_plain(cuda, d, nnz, weighted, dtype):
    table, idx, w = _ebag(1000, d, 67, 13, nnz, cuda, dtype)
    w = w if weighted else None
    got = ebag_mod.embedding_bag_cuda(table, idx, w)
    exp = ebag_mod.embedding_bag_plain(table, idx, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (67, 13, d)
    if dtype == torch.float32 and nnz <= 2:
        assert torch.equal(got, exp)
    elif dtype == torch.float32:
        assert float((got - exp).abs().max()) <= EBAG_TOL_F32
    else:
        lim = EBAG_BF16_RTOL * exp.float().abs() + EBAG_TOL_F32
        assert bool(((got.float() - exp.float()).abs() <= lim).all())


@pytest.mark.parametrize("d", [1, 64])
def test_embedding_bag_cuda_out_of_range_and_negative_indices(cuda, d):
    V = 50
    table, idx, w = _ebag(V, d, 40, 3, 2, cuda, lo=-2 * V, hi=2 * V)
    w[0, 0, 1] = 0.0
    idx[0, 0] = torch.tensor([3, V], device=cuda)   # NaN despite weight 0
    idx[0, 1] = torch.tensor([-1, -V], device=cuda)  # rows V-1 and 0
    got = ebag_mod.embedding_bag_cuda(table, idx, w)
    exp = ebag_mod.embedding_bag_plain(table, idx, w)
    torch.cuda.synchronize()
    nan = torch.isnan(exp)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(nan[0, 0].all()) and not bool(nan[0, 1].any())
    assert bool(nan.any()) and not bool(nan.all())
    assert torch.equal(got[~nan], exp[~nan])
    row = w[0, 1, 0] * table[V - 1] + w[0, 1, 1] * table[0]
    assert float((got[0, 1] - row).abs().max()) <= EBAG_TOL_F32


def test_embedding_bag_cuda_gathers_past_2_31_bytes(cuda):
    # 8,389,632 rows x 64 f32 = 2.15e9 bytes: the last rows sit past 2^31
    V, d = 2 ** 23 + 1024, 64
    table = torch.empty(V, d, device=cuda)
    table[:8] = 1.0
    tail = torch.randn(1024, d, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    table[-1024:] = tail
    idx = torch.tensor([[[V - 1], [V - 1024], [0], [-1]]], device=cuda,
                       dtype=torch.int32)
    got = ebag_mod.embedding_bag_cuda(table, idx)
    torch.cuda.synchronize()
    exp = torch.stack([tail[-1], tail[0], torch.ones(d, device=cuda),
                       tail[-1]])[None]
    assert torch.equal(got, exp)


def test_embedding_bag_wrapper_refuses_what_the_kernel_does_not_take(
        cuda, monkeypatch):
    table, idx, w = _ebag(100, 16, 4, 3, 2, cuda)
    with pytest.raises(TypeError, match="int32"):
        ebag_mod.embedding_bag_cuda(table, idx.long(), w)
    with pytest.raises(TypeError, match="weights"):
        ebag_mod.embedding_bag_cuda(table, idx, w.double())
    with pytest.raises(TypeError, match="weights"):
        ebag_mod.embedding_bag_cuda(table, idx, w[:, :, :1].contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ebag_mod.embedding_bag_cuda(table.half(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        ebag_mod.embedding_bag_cuda(table.t().contiguous().t(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        ebag_mod.embedding_bag_cuda(table, idx.transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        ebag_mod.embedding_bag_cuda(table, idx, w.transpose(1, 2)
                                    .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="table on"):
        ebag_mod.embedding_bag_cuda(table, idx.cpu(), w)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.embedding_bag(table.clone().requires_grad_(), idx, w)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.embedding_bag(table, idx, w.clone().requires_grad_())
    with torch.no_grad():                          # no graph: forward only
        assert ops.embedding_bag(table.clone().requires_grad_(), idx,
                                 w).shape == (4, 3, 16)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a, **kw: (8, 0))
    with pytest.raises(RuntimeError, match="sm_90a"):
        ops.embedding_bag(table, idx, w)


def test_recsys_forward_on_cuda_goes_through_the_kernel(cuda, monkeypatch):
    from repro_torch.configs import recsys_family
    from repro_torch.data import recsys_synth
    from repro_torch.models.recsys import common, ctr

    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    def to_card(node):
        if isinstance(node, dict):
            return {k: to_card(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_card(v) for v in node]
        return node.to(cuda)

    for name, per_forward in (("DLRM_RM2", 1), ("WIDE_DEEP", 2),
                              ("DCN_V2", 1)):
        cfg = recsys_family.reduced_ctr(getattr(recsys_family, name))
        params = ctr.init(torch.Generator().manual_seed(0), cfg)
        batch = recsys_synth.ctr_batch(
            np.random.default_rng(0), batch=64, n_dense=cfg.n_dense,
            vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz,
            device="cpu")
        exp = ctr.forward(params, cfg, batch)
        with monkeypatch.context() as m:
            m.setattr(ebag_mod, "embedding_bag_plain", refuse)
            m.setattr(common, "embedding_bag_plain", refuse)
            serve = recsys_family.make_fn(cfg, "serve")
            before = ops.launch_counts()["embedding_bag"]
            got = serve(to_card(params), batch)
            assert ops.launch_counts()["embedding_bag"] == \
                before + per_forward, name
        assert float((got.cpu() - exp).abs().max()) <= 1e-5, name
