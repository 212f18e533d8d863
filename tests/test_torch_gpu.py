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
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}
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
# its backward vs plain: f32 sums of a row's slots in another order,
# within 1e-5 of the largest |g|; bf16 rounds those sums once (one ulp)
EBAG_BWD_REL = 1e-5


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


@pytest.mark.parametrize("S", [8, 16, 24, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bus_kernels_at_every_bucket_match_plain(cuda, S, dtype):
    # the DynamicBatcher's buckets at the production head dim, each on the
    # tensor-core kernels (one launch of each), an all-masked segment in
    q, k, v, mask = _bus(33, 3, S, 12, 64, cuda, dtype, seed=S)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(S + 1), device=cuda).to(dtype)
    before = ops.launch_counts()
    o = bus_mod.bus_attention_cuda(q, k, v, mask)
    got = bus_mod.bus_attention_bwd_cuda(q, k, v, mask, do)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["bus_attention"] == before["bus_attention"] + 1
    assert after["bus_attention_bwd"] == before["bus_attention_bwd"] + 1
    exp = bus_mod.bus_attention_plain(q, k, v, mask)
    assert o.dtype == dtype
    assert float((o.float() - exp.float()).abs().max()) <= BUS_TOL[dtype]
    for a, b in zip(got, bus_mod.bus_attention_bwd_plain(q, k, v, mask, do)):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= BWD_TOL[dtype]
    assert float(got[2][::3, 2].float().abs().max()) > 0    # uniform p


@pytest.mark.parametrize("K,S", [(3, 8), (3, 16),             # bench buckets
                                 (2, 24), (4, 12), (6, 8)])   # fig9's splits
def test_bus_kernels_at_the_tables_shapes_match_plain(cuda, K, S):
    # launch.tables at bench: 4 heads of 16, f32, 256 news (fig9's encode);
    # each shape on the tensor-core pair, one launch of each
    q, k, v, mask = _bus(256, K, S, 4, 16, cuda, seed=K * 100 + S)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(S), device=cuda)
    assert bus_mod.bus_route(S, S + K, 16) == ("bus_attention",
                                               "bus_attention_bwd")
    before = ops.launch_counts()
    o = bus_mod.bus_attention_cuda(q, k, v, mask)
    got = bus_mod.bus_attention_bwd_cuda(q, k, v, mask, do)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["bus_attention"] == before["bus_attention"] + 1
    assert after["bus_attention_bwd"] == before["bus_attention_bwd"] + 1
    exp = bus_mod.bus_attention_plain(q, k, v, mask)
    assert float((o - exp).abs().max()) <= BUS_TOL[torch.float32]
    for a, b in zip(got, bus_mod.bus_attention_bwd_plain(q, k, v, mask, do)):
        assert float((a - b).abs().max()) <= BWD_TOL[torch.float32]
    assert float(got[2][::3, K - 1].abs().max()) > 0        # uniform p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bus_kernels_are_bitwise_deterministic(cuda, dtype):
    # no atomics: each tile owns its outputs, so two launches agree
    q, k, v, mask = _bus(64, 3, 32, 12, 64, cuda, dtype)
    do = torch.randn_like(q)
    assert torch.equal(bus_mod.bus_attention_cuda(q, k, v, mask),
                       bus_mod.bus_attention_cuda(q, k, v, mask))
    for a, b in zip(bus_mod.bus_attention_bwd_cuda(q, k, v, mask, do),
                    bus_mod.bus_attention_bwd_cuda(q, k, v, mask, do)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [8, 32])
def test_bus_checks_catch_zeroed_bus_columns(cuda, S):
    # the control: plain with the bus columns' v zeroed (a kernel that lost
    # the bus keys' values) misses both limits against the kernels
    q, k, v, mask = _bus(64, 3, S, 12, 64, cuda)
    do = torch.randn_like(q)
    v0 = v.clone()
    v0[:, :, S:] = 0
    o = bus_mod.bus_attention_cuda(q, k, v, mask)
    assert float((o - bus_mod.bus_attention_plain(q, k, v0, mask))
                 .abs().max()) > BUS_TOL[torch.float32]
    got = bus_mod.bus_attention_bwd_cuda(q, k, v, mask, do)
    ctl = bus_mod.bus_attention_bwd_plain(q, k, v0, mask, do)
    assert max(float((a - b).abs().max()) for a, b in zip(got, ctl)) \
        > BWD_TOL[torch.float32]


def test_bus_wrappers_refuse_what_the_tensor_core_kernels_do_not_take(
        cuda):
    # a head dim or S the tensor-core kernels do not take goes to the SIMT
    # pair; a misaligned base on the tensor-core route, or a SIMT tile
    # too large for shared memory, raises
    for shape in ((2, 3, 8, 2, 48), (2, 3, 40, 2, 64)):     # D=48, S=40
        q, k, v, mask = _bus(*shape, cuda)
        before = ops.launch_counts()
        bus_mod.bus_attention_cuda(q, k, v, mask)
        bus_mod.bus_attention_bwd_cuda(q, k, v, mask, q)
        after = ops.launch_counts()
        assert after["bus_attention_simt"] == before["bus_attention_simt"] + 1
        assert after["bus_attention_bwd_simt"] == \
            before["bus_attention_bwd_simt"] + 1
        assert after["bus_attention"] == before["bus_attention"]
    q, k, v, mask = _bus(2, 3, 8, 2, 64, cuda)
    q1 = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    q1.copy_(q)                                          # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        bus_mod.bus_attention_cuda(q1, k, v, mask)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bus_mod.bus_attention_bwd_cuda(q, k, v, mask, q1)
    q, k, v, mask = _bus(1, 3, 128, 1, 64, cuda)         # S = 128
    bus_mod.bus_attention_cuda(q, k, v, mask)            # 168 KB: fits
    with pytest.raises(ValueError, match="shared memory"):
        bus_mod.bus_attention_bwd_cuda(q, k, v, mask, q)


@pytest.mark.parametrize("shape", [(5, 3, 8, 4, 48), (3, 3, 40, 4, 64),
                                   (4, 9, 32, 4, 64), (2, 3, 64, 2, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bus_simt_route_matches_plain(cuda, shape, dtype):
    # shapes outside the tensor-core kernels' (D=48, S=40, Sk=41, D=96)
    # run on the SIMT pair, one launch each, an all-masked segment in
    S, D = shape[2], shape[4]
    assert bus_mod.bus_route(S, S + shape[1], D) == (
        "bus_attention_simt", "bus_attention_bwd_simt")
    q, k, v, mask = _bus(*shape, cuda, dtype)
    do = torch.randn_like(q)
    before = ops.launch_counts()
    o = bus_mod.bus_attention_cuda(q, k, v, mask)
    got = bus_mod.bus_attention_bwd_cuda(q, k, v, mask, do)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["bus_attention_simt"] == before["bus_attention_simt"] + 1
    assert after["bus_attention_bwd_simt"] == \
        before["bus_attention_bwd_simt"] + 1
    exp = bus_mod.bus_attention_plain(q, k, v, mask)
    assert float((o.float() - exp.float()).abs().max()) <= BUS_TOL[dtype]
    for a, b in zip(got, bus_mod.bus_attention_bwd_plain(q, k, v, mask, do)):
        assert a.dtype == dtype
        assert float((a.float() - b.float()).abs().max()) <= BWD_TOL[dtype]


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


def test_mesh_step_on_the_card_matches_one_process(cuda):
    """2 gloo ranks on cuda:0 (each encoding half of E through the bus
    kernels) against the one-process step from the same seeded state,
    batch and draws: losses within 1e-4, parameters within 1e-4 of each
    leaf's largest magnitude (those that start at 0 of the largest of any
    leaf), the cache blocks joined the one-process cache."""
    import _torch_mesh_ranks as ranks
    from repro_torch import data, training
    from repro_torch.configs.speedyfeed_arch import make_sf_train_step
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.optim.adam import leaves
    over = dict(n_news=2004, encode_budget=32)
    cfg = train.small_speedyfeed_config(**over)
    batches = [data.synth_centralized_batch(
        m_cap=cfg.merged_cap, n_segments=cfg.plm.n_segments,
        seg_len=cfg.plm.seg_len, b_cap=cfg.batch_users,
        hist_len=cfg.hist_len, vocab=cfg.plm.vocab, seed=i)
        for i in range(3)]
    g = np.random.default_rng(0)
    draws = [(float(g.random()), g.integers(
        1, cfg.merged_cap, (cfg.batch_users, cfg.hist_len - 1, cfg.n_neg)))
        for _ in batches]
    out = run_on_mesh(ranks.port_steps, 2, ["cuda:0"] * 2,
                      args=(over, 3, batches, draws), timeout=300)
    state = training.get_trainer("speedyfeed", cfg=cfg,
                                 device=cuda).init_state(3)
    step_fn = make_sf_train_step(cfg)
    p, o, c = state.params, state.opt, state.cache
    for i, (batch, (u, neg)) in enumerate(zip(batches, draws)):
        b = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()}
        p, o, c, m = step_fn(p, o, c, 100 + i, None, b, u=u,
                             neg_idx=torch.as_tensor(neg, device=cuda))
        for r in out:
            assert abs(r["losses"][i] - float(m["loss"])) <= 1e-4, i
    for r in out:
        assert r["launches"]["bus_attention"] == 3 * cfg.plm.n_layers
        assert r["launches"]["bus_attention_bwd"] == 3 * cfg.plm.n_layers
    # leaves that start at 0 (the biases) against the largest of any leaf:
    # Adam's steps on near-eps gradient entries amplify the sum's order
    zero_init = {n for n, t in leaves(training.get_trainer(
        "speedyfeed", cfg=cfg, device=cuda).init_state(3).params)
        if not bool(t.any())}
    got = [(n, a, b.detach().cpu().numpy())
           for a, (n, b) in zip(out[0]["params"], leaves(p))]
    top = max(np.abs(b).max() for _, _, b in got)
    for n, a, b in got:
        scale = top if n in zero_init else max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= 1e-4 * scale, n
    emb = np.concatenate([r["emb"] for r in out])
    assert np.abs(emb - c.emb.cpu().numpy()).max() <= 1e-4
    np.testing.assert_array_equal(
        np.concatenate([r["written_step"] for r in out]),
        c.written_step.cpu().numpy())


def test_sharded_pq_snapshot_on_the_card_matches_unsharded(cuda):
    """The IVF-PQ snapshot in 4 shards on the one card: the unsharded
    top-k id for id, scores within 1e-4, one PQ scan launch a shard."""
    from repro_torch import serving
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    snap = serving.IndexBuilder(
        "ivf-pq", 32, ivf=serving.IVFConfig(nlist=37, nprobe=8),
        pq=serving.PQConfig(n_subvec=8, n_codes=32), device=cuda).build(
        np.arange(1, 3001), x)
    ssnap = serving.shard_snapshot(snap, ["cuda"] * 4)
    s_ref, i_ref = snap.search(q, 10)
    ops.reset_launch_counts()
    s_got, i_got = ssnap.search(q, 10)
    assert ops.launch_counts()["pq_lut_scores"] == 4
    assert torch.equal(i_got, i_ref)
    assert float((s_got - s_ref).abs().max()) <= 1e-4


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


def _hold_pq(got, exp):
    """-inf and NaN slots exactly where plain has them, the rest within
    PQ_TOL."""
    assert torch.equal(got.isnan(), exp.isnan())
    assert torch.equal(got == float("-inf"), exp == float("-inf"))
    fin = torch.isfinite(exp)
    assert torch.equal(torch.isfinite(got), fin)
    if bool(fin.any()):
        assert float((got[fin] - exp[fin]).abs().max()) <= PQ_TOL


@pytest.mark.parametrize("B,M,K,N,Bc,Bv", [
    (16, 8, 32, 16384, 16, 16),   # the serve path's IVF scan
    (64, 8, 32, 20003, 64, 64),   # N % 4 != 0 (scalar width)
    (64, 8, 32, 20004, 64, 1),    # float4 stores, shared validity
    (16, 8, 32, 600004, 1, None), # flat, 16 queries a group
    (16, 8, 32, 5003, 16, 16),    # ragged tail, N % 4 != 0
    (16, 8, 32, 5004, 1, None),   # flat: one code tile for all 16 queries
    (16, 8, 32, 5004, 1, 16),     # shared codes, per-query validity
    (16, 8, 32, 5004, 16, 1),     # per-query codes, shared validity
    (40, 8, 256, 3001, 1, 1),     # K=256: 8 KB tables
    (3, 16, 64, 2052, 3, 3),      # M=16
    (1, 8, 32, 100, 1, 1),
])
def test_pq_tiled_scan_matches_plain(cuda, B, M, K, N, Bc, Bv):
    lut, codes, valid = _pq(B, M, K, N, Bc, Bv, torch.uint8, cuda)
    assert pq_mod.pq_route(M, K, codes.dtype, codes.data_ptr()) == \
        "pq_lut_scores"
    before = ops.launch_counts()
    got = pq_mod.pq_lut_scores_cuda(lut, codes, valid)
    again = pq_mod.pq_lut_scores_cuda(lut, codes, valid)
    after = ops.launch_counts()
    exp = pq_mod.pq_lut_scores_plain(lut, codes, valid)
    torch.cuda.synchronize()
    assert after["pq_lut_scores"] - before["pq_lut_scores"] == 2
    assert after["pq_lut_scores_general"] == before["pq_lut_scores_general"]
    _hold_pq(got, exp)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("K,hi", [(32, 40), (16, 256), (256, 256)])
def test_pq_tiled_scan_out_of_range_codes_score_nan(cuda, K, hi):
    """uint8 codes at and past K score NaN on the tiled scan, at the slots
    plain puts them (none can be past K=256)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    lut = torch.randn(16, 8, K, generator=g, device=cuda)
    codes = torch.randint(0, K, (16, 4096, 8), generator=g,
                          device=cuda).to(torch.uint8)
    codes[:, ::97, 5] = hi - 1
    valid = torch.rand(16, 4096, generator=g, device=cuda) < 0.7
    got = pq_mod.pq_lut_scores_cuda(lut, codes, valid)
    exp = pq_mod.pq_lut_scores_plain(lut, codes, valid)
    torch.cuda.synchronize()
    assert bool(exp.isnan().any()) == (hi > K)
    _hold_pq(got, exp)


def test_pq_routes_count_apart_and_refuse(cuda):
    # the general scan takes int32 codes, M off the tiled list, K not a
    # power of two and a codes base off 16 bytes; the tiled one refuses
    # them when named, and nothing launches then
    lut, codes, valid = _pq(4, 8, 32, 1000, 4, 4, torch.uint8, cuda)
    flat = torch.zeros(codes.numel() + 16, dtype=torch.uint8, device=cuda)
    shifted = flat[8:8 + codes.numel()].view(codes.shape).copy_(codes)
    lut24, codes24, _ = _pq(4, 24, 32, 1000, 4, 4, torch.uint8, cuda)
    lut20, codes20, _ = _pq(4, 8, 20, 1000, 4, 4, torch.uint8, cuda)
    cases = [(lut, codes.int()), (lut, shifted), (lut24, codes24),
             (lut20, codes20)]
    for lt, cd in cases:
        assert pq_mod.pq_route(lt.shape[1], lt.shape[2], cd.dtype,
                               cd.data_ptr()) == "pq_lut_scores_general"
        before = ops.launch_counts()
        got = ops.pq_lut_scores(lt, cd, valid)
        after = ops.launch_counts()
        assert after["pq_lut_scores_general"] == \
            before["pq_lut_scores_general"] + 1
        assert after["pq_lut_scores"] == before["pq_lut_scores"]
        _hold_pq(got, pq_mod.pq_lut_scores_plain(lt, cd, valid))
        with pytest.raises(ValueError, match="tiled scan does not take"):
            pq_mod.pq_lut_scores_cuda(lt, cd, valid, route="pq_lut_scores")
        assert ops.launch_counts() == after
    # the general scan named on a tiled shape runs it (a timing yardstick)
    got = pq_mod.pq_lut_scores_cuda(lut, codes, valid,
                                    route="pq_lut_scores_general")
    _hold_pq(got, pq_mod.pq_lut_scores_plain(lut, codes, valid))


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
    # a 50 ms flush window: the 32 submissions gather into 2 batches
    results, n_batches = serve.micro_batch_loop(rec, log.histories[:32],
                                                max_batch=16, max_wait_ms=50)
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


def test_scheduler_serves_on_the_card_while_a_rebuild_runs(cuda):
    """The request scheduler's worker thread answers from the card (a bare
    "cuda", resolved on that thread) while a full rebuild runs on the
    service's rebuild thread; every scan on the tiled PQ kernel."""
    from repro_torch import serving
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    ids = np.arange(1, 3001)
    svc = serving.RetrievalService(
        serving.IndexBuilder("ivf-pq", 32, device="cuda",
                             ivf=serving.IVFConfig(nlist=16, nprobe=16)),
        np.zeros((1, 32), np.float32), k=10, auto_compact=False,
        device="cuda")
    svc.publish(ids, x)
    svc.rebuild(mode="full", block=True)
    devices = []

    def execute(payloads, pad_to):
        q = np.zeros((pad_to, 32), np.float32)
        q[:len(payloads)] = np.stack(payloads)
        devices.append(torch.cuda.current_device())
        _, got = svc.query(q)            # host ids: the launches are done
        return [got[i] for i in range(len(payloads))]

    sched = serving.RequestScheduler(execute, max_batch=8, max_wait_ms=1.0)
    ops.reset_launch_counts()
    try:
        sched.warmup(x[0])
        svc.publish(ids[:64], x[:64] + 0.01)
        thread = svc.rebuild(mode="full", block=False)
        handles = []
        while thread.is_alive() or len(handles) < 64:
            handles += [sched.submit(x[i]) for i in rng.integers(0, 3000, 8)]
            handles[-1].wait(10.0)
        got = [h.result(timeout=30.0) for h in handles]
        svc.wait_for_build()
    finally:
        sched.stop()
    assert svc.version == 2 and svc.n_pending == 0
    assert all(g.shape == (10,) and (g > 0).all() for g in got)
    assert set(devices) == {torch.cuda.current_device()}
    counts = ops.launch_counts()
    assert counts["pq_lut_scores"] >= sched.n_batches + len(sched.buckets)
    assert counts["pq_lut_scores_general"] == 0
    exact = ids[np.argsort(-(x[:8] @ x.T), axis=1)[:, :10]]
    _, got = svc.query(x[:8])
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
    (torch.float32, 128, "flash_attention_tf32"),
    (torch.float32, 64, "flash_attention_tf32"),
    (torch.float32, 96, "flash_attention"),
])
def test_flash_forward_launches_count_by_route(cuda, dtype, D, route):
    assert flash_mod.forward_route(dtype, D) == route
    q, k, v = _flash(1, 128, 128, 4, 2, D, cuda, dtype)
    names = flash_mod.FORWARD_ROUTES
    before = ops.launch_counts()
    flash_mod.flash_attention_cuda(q, k, v, True)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in names} == \
        {n: int(n == route) for n in names}


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
    (1, 4096, 4096, 40, 8, 128, True),    # the f32 LM check's heads
    (2, 200, 333, 8, 2, 128, True),       # ragged q and key tiles
    (2, 200, 333, 8, 2, 128, False),
    (1, 64, 4096, 4, 4, 64, True),        # q_off = 4032
    (2, 300, 300, 6, 2, 64, False),
    (1, 1, 77, 8, 8, 64, True),           # one query row
])
def test_flash_tf32_matches_plain_and_repeats(cuda, B, Sq, Sk, Hq, Hkv, D,
                                              causal):
    q, k, v = _flash(B, Sq, Sk, Hq, Hkv, D, cuda)
    before = ops.launch_counts()["flash_attention_tf32"]
    o, lse = flash_mod.flash_attention_cuda(q, k, v, causal)
    o2, lse2 = flash_mod.flash_attention_cuda(q, k, v, causal)
    assert ops.launch_counts()["flash_attention_tf32"] == before + 2
    o_p, lse_p = flash_mod.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert float((o - o_p).abs().max()) <= FLASH_TOL[torch.float32]
    assert float((lse - lse_p).abs().max()) <= LSE_TOL
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_tf32_reads_strided_and_misaligned_views(cuda):
    # q/k/v as slices of one fused projection, and k and v at bases 4
    # bytes off 16 with a head stride of 130: the split reads them element
    # by element, so any view with a contiguous last axis is taken
    B, S, Hq, Hkv, D = 2, 320, 8, 2, 128
    qkv = torch.randn(B, S, Hq + 2 * Hkv, D, device=cuda)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    flat = torch.empty(k.numel() + 4, device=cuda)
    shifted = flat[1:k.numel() + 1].view(k.shape).copy_(k)
    wide = torch.zeros(B, S, Hkv, 130, device=cuda)[..., :128].copy_(v)
    o_p, lse_p = flash_mod.flash_attention_fwd_plain(q, k, v, True)
    for kk, vv in ((k, v), (shifted, wide)):
        before = ops.launch_counts()["flash_attention_tf32"]
        o, lse = flash_mod.flash_attention_cuda(q, kk, vv, True)
        assert ops.launch_counts()["flash_attention_tf32"] == before + 1
        assert float((o - o_p).abs().max()) <= FLASH_TOL[torch.float32]
        assert float((lse - lse_p).abs().max()) <= LSE_TOL
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="does not take"):
        flash_mod.flash_attention_cuda(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16(), True,
                                       route="flash_attention_tf32")
    with pytest.raises(ValueError, match="does not take"):
        flash_mod.flash_attention_cuda(q[..., :96], k[..., :96],
                                       v[..., :96], True,
                                       route="flash_attention_tf32")
    assert ops.launch_counts() == before


def test_flash_simt_named_on_the_tf32_route_matches_plain(cuda):
    # the SIMT forward on an f32 call the 3xTF32 kernel takes (the timing
    # yardstick chip_smoke.py uses), and the f32 backward (the 3xTF32
    # pair) on the 3xTF32 forward's lse
    q, k, v, _, _, do = _flash_bwd_inputs(1, 512, 512, 8, 2, 128, cuda,
                                          torch.float32, True)
    before = ops.launch_counts()
    o_s, lse_s = flash_mod.flash_attention_cuda(q, k, v, True,
                                                route="flash_attention")
    o, lse = flash_mod.flash_attention_cuda(q, k, v, True)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_tf32"] == \
        before["flash_attention_tf32"] + 1
    o_p, lse_p = flash_mod.flash_attention_fwd_plain(q, k, v, True)
    for a, b in ((o_s, o_p), (o, o_p), (lse_s, lse_p), (lse, lse_p)):
        assert float((a - b).abs().max()) <= FLASH_TOL[torch.float32]
    got = flash_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    exp = flash_mod.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    _hold_bwd(got, exp, torch.float32)


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
                                     (torch.float32, 128),
                                     (torch.float32, 64),
                                     (torch.float32, 96)])
def test_flash_backward_launches_count_by_route(cuda, dtype, D):
    # f32 at 64 and 128 on the 3xTF32 pair, at 96 on the SIMT pair
    route = flash_mod.backward_route(dtype, D)
    assert (route == flash_mod.BWD_TF32) == (dtype == torch.float32
                                             and D in (64, 128))
    args = _flash_bwd_inputs(1, 128, 128, 4, 2, D, cuda, dtype, True)
    names = [n for pair in flash_mod.BACKWARD_ROUTES for n in pair]
    before = ops.launch_counts()
    flash_mod.flash_attention_bwd_cuda(*args, True)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in names} == \
        {n: int(n in route) for n in names}


def _hold_tf32_bwd(args, causal):
    """The 3xTF32 pair on ``args`` (q, k, v, o, lse, dO; f32) against
    plain: each gradient within BWD_F32_REL of plain's largest, and a
    kernel that lost the last key tile missing that limit; launched once
    each. Returns the gradients."""
    before = ops.launch_counts()
    got = flash_mod._bwd_cuda_as_written(*args, causal)
    after = ops.launch_counts()
    exp = flash_mod._bwd_plain_f32(*args, causal)
    controls = _without_last_key_tile(*args, causal, exp)
    torch.cuda.synchronize()
    assert {n: after[n] - before[n] for n in flash_mod.BWD_TF32} == \
        dict.fromkeys(flash_mod.BWD_TF32, 1)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, exp, controls):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _f32_rel(a, b) <= BWD_F32_REL, name
        assert _f32_rel(c, b) > BWD_F32_REL, name
    return got


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 256, 256, 8, 2, 64),      # GQA 4:1
    (2, 100, 300, 4, 2, 64),      # ragged tiles, q_off = 200
    (2, 200, 333, 8, 2, 128),     # Sk no multiple of the 32- or 64-row tiles
    (1, 1, 300, 8, 2, 128),       # one query row over 300 keys
    (1, 1024, 1024, 40, 8, 128),  # Qwen3-14B's heads
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_tf32_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D,
                                                causal):
    args = _flash_bwd_inputs(B, Sq, Sk, Hq, Hkv, D, cuda, torch.float32,
                             causal)
    _hold_tf32_bwd(args, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_tf32_is_bitwise_deterministic(cuda, causal):
    # each gradient has one owner and fixed sums: two runs agree bit for
    # bit
    args = _flash_bwd_inputs(2, 640, 640, 40, 8, 128, cuda, torch.float32,
                             causal)
    first = flash_mod._bwd_cuda_as_written(*args, causal)
    second = flash_mod._bwd_cuda_as_written(*args, causal)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_bwd_tf32_reads_strided_views(cuda):
    # q/k/v as slices of one fused projection and dO a slice of a wider
    # tensor, read through their strides (16-byte aligned: the splits'
    # float4 loads)
    B, S, Hq, Hkv, D = 2, 320, 8, 2, 128
    qkv = torch.randn(B, S, Hq + 2 * Hkv, D, device=cuda)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    do = torch.randn(B, S, 2 * Hq, D, device=cuda)[:, :, :Hq]
    assert not (q.is_contiguous() or do.is_contiguous())
    o, lse = flash_mod.flash_attention_cuda(q, k, v, True)
    _hold_tf32_bwd((q, k, v, o, lse, do), True)


def test_flash_bwd_tf32_refuses_a_misaligned_view(cuda):
    q, k, v, o, lse, do = _flash_bwd_inputs(1, 64, 64, 4, 2, 128, cuda,
                                            torch.float32, True)
    bwd = flash_mod.flash_attention_bwd_cuda
    before = ops.launch_counts()
    # a dO base 4 bytes past a 16-byte boundary
    flat = torch.empty(do.numel() + 4, device=cuda)
    shifted = flat[1:do.numel() + 1].view(do.shape).copy_(do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bwd(q, k, v, o, lse, shifted, True)
    # a head stride of 130 elements: 520 bytes, no multiple of 16
    wide = torch.zeros(1, 64, 2, 130, device=cuda)[..., :128].copy_(k)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        bwd(q, wide, v, o, lse, do, True)
    # refused before any launch: nothing falls back to SIMT or plain
    assert ops.launch_counts() == before


def test_flash_bwd_named_routes(cuda):
    # naming the SIMT pair on an f32 call at head dim 128 runs it (the
    # smoke's yardstick), within the same limit of plain; naming the
    # 3xTF32 pair where it is not the pick raises before any launch
    args = _flash_bwd_inputs(1, 256, 256, 8, 2, 128, cuda, torch.float32,
                             True)
    before = ops.launch_counts()
    got = flash_mod.flash_attention_bwd_cuda(*args, True,
                                             route=flash_mod.BWD_SIMT)
    after = ops.launch_counts()
    names = [n for pair in flash_mod.BACKWARD_ROUTES for n in pair]
    assert {n: after[n] - before[n] for n in names} == \
        {n: int(n in flash_mod.BWD_SIMT) for n in names}
    exp = flash_mod._bwd_plain_f32(*args, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert _f32_rel(a, b) <= BWD_F32_REL, name
    bf16 = _flash_bwd_inputs(1, 64, 64, 4, 2, 128, cuda, torch.bfloat16,
                             True)
    d96 = _flash_bwd_inputs(1, 64, 64, 4, 2, 96, cuda, torch.float32, True)
    before = ops.launch_counts()
    for call in (bf16, d96):
        with pytest.raises(ValueError, match="does not take"):
            flash_mod.flash_attention_bwd_cuda(*call, True,
                                               route=flash_mod.BWD_TF32)
    with pytest.raises(ValueError, match="does not take"):
        flash_mod.flash_attention_bwd_cuda(*args, True,
                                           route=flash_mod.BWD_WGMMA)
    with pytest.raises(ValueError, match="unknown"):
        flash_mod.flash_attention_bwd_cuda(*args, True, route=("x", "y"))
    assert ops.launch_counts() == before


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
    # a chunked-local layer: the flash kernel once over the S/chunk hard
    # chunks (a batch of causal sequences), plain attention when masked
    local = dataclasses.replace(cfg, chunk_size=8)
    assert flash_launches(cfg=local) == 1
    assert flash_launches(cfg=local, mask=torch.ones(
        2, 32, dtype=torch.bool, device=cuda)) == 0


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


@pytest.mark.parametrize("name", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_moe_lm_prefill_and_decode_on_cuda_match_the_cpu(cuda, name):
    """The reduced MoE configs (4 experts; Scout's chunk 8) on the card
    against the CPU: a prefill at S=64 through the flash kernel (Scout's
    three local layers chunk by chunk) and 8 decode steps, f32."""
    from repro_torch.configs import lm_family
    from repro_torch.models import lm
    cfg = lm_family.reduced_lm(lm_family.CONFIGS[name])
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    params_d = _to(params, cuda)
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
    # a table that requires grad has its backward kernel; weights do not
    out = ops.embedding_bag(table.clone().requires_grad_(), idx, w)
    assert out.shape == (4, 3, 16) and out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="backward"):
        ops.embedding_bag(table, idx, w.clone().requires_grad_())
    with torch.no_grad():                          # no graph: forward only
        assert ops.embedding_bag(table, idx, w.clone().requires_grad_()
                                 ).shape == (4, 3, 16)
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


def _ebag_bwd(V, d, B, F, nnz, dev, dtype=torch.float32, seed=0, lo=0,
              hi=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    dout = torch.randn(B, F, d, generator=g, device=dev).to(dtype)
    idx = torch.randint(lo, V if hi is None else hi, (B, F, nnz),
                        generator=g, device=dev, dtype=torch.int32)
    w = torch.rand(B, F, nnz, generator=g, device=dev)
    return dout, idx, w


def _hold_ebag_bwd(got, dout, idx, w, V):
    """The kernel's gradient against plain's in f64: within EBAG_BWD_REL of
    the largest |g| (f32), or one bf16 ulp plus that (bf16)."""
    exp = ebag_mod.embedding_bag_bwd_plain(dout.double(), idx, w, V)
    assert got.dtype == dout.dtype and got.shape == exp.shape
    top = float(exp.abs().max())
    err = (got.double() - exp).abs()
    if dout.dtype == torch.float32:
        assert float(err.max()) <= EBAG_BWD_REL * max(top, 1e-30)
    else:
        lim = EBAG_BF16_RTOL * exp.abs() + EBAG_BWD_REL * top
        assert bool((err <= lim).all())
    return exp


@pytest.mark.parametrize("d", [1, 7, 16, 32, 64, 160])
@pytest.mark.parametrize("nnz", [1, 2, 16])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_bwd_cuda_matches_plain(cuda, d, nnz, weighted, dtype):
    V = 1000
    dout, idx, w = _ebag_bwd(V, d, 67, 13, nnz, cuda, dtype)
    w = w if weighted else None
    got = ebag_mod.embedding_bag_bwd_cuda(dout, idx, w, V)
    torch.cuda.synchronize()
    _hold_ebag_bwd(got, dout, idx, w, V)
    plain = ebag_mod.embedding_bag_bwd_plain(dout, idx, w, V)
    assert torch.equal(got == 0, plain == 0)    # untouched rows stay 0


@pytest.mark.parametrize("d", [1, 16, 64])
@pytest.mark.parametrize("hot", ["one_row", "few_rows", "runs_across"])
def test_embedding_bag_bwd_cuda_hot_rows(cuda, d, hot):
    """Every slot on one row; a handful of rows over 65,536 slots (the
    Criteo 4-row fields); runs that end on, before and past chunk edges."""
    V, B, F = 5000, 4096, 16
    dout, idx, w = _ebag_bwd(V, d, B, F, 1, cuda)
    if hot == "one_row":
        idx.fill_(17)
    elif hot == "few_rows":
        idx.remainder_(4)
    else:
        # run lengths 1..97 over consecutive rows: ends fall everywhere
        lens = torch.arange(1, 98, device=cuda).repeat(40)
        rows = torch.repeat_interleave(torch.arange(lens.numel(),
                                                    device=cuda), lens)
        idx = rows[:B * F].to(torch.int32).view(B, F, 1).contiguous()
    got = ebag_mod.embedding_bag_bwd_cuda(dout, idx, w, V)
    torch.cuda.synchronize()
    _hold_ebag_bwd(got, dout, idx, w, V)
    again = ebag_mod.embedding_bag_bwd_cuda(dout, idx, w, V)
    assert torch.equal(got, again)


@pytest.mark.parametrize("d", [1, 64])
def test_embedding_bag_bwd_cuda_negative_and_out_of_range(cuda, d):
    V = 50
    dout, idx, w = _ebag_bwd(V, d, 300, 3, 2, cuda, lo=-2 * V, hi=2 * V)
    idx[0, 0] = torch.tensor([-1, V], device=cuda)     # row V-1; dropped
    got = ebag_mod.embedding_bag_bwd_cuda(dout, idx, w, V)
    torch.cuda.synchronize()
    _hold_ebag_bwd(got, dout, idx, w, V)
    assert bool(torch.isfinite(got).all())
    # every slot out of range: nothing added anywhere
    far = torch.where(idx >= 0, idx + 2 * V, idx - 2 * V).to(torch.int32)
    assert not bool(ebag_mod.embedding_bag_bwd_cuda(dout, far, w, V).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_bwd_cuda_is_bitwise_deterministic(cuda, dtype):
    V = 200                       # many slots a row, over many chunks
    dout, idx, w = _ebag_bwd(V, 64, 2048, 26, 1, cuda, dtype)
    runs = [ebag_mod.embedding_bag_bwd_cuda(dout, idx, w, V)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_embedding_bag_bwd_wrapper_refuses_what_the_kernel_does_not_take(
        cuda):
    V = 100
    dout, idx, w = _ebag_bwd(V, 16, 4, 3, 2, cuda)
    bwd = ebag_mod.embedding_bag_bwd_cuda
    with pytest.raises(TypeError, match="int32"):
        bwd(dout, idx.long(), w, V)
    with pytest.raises(TypeError, match="weights"):
        bwd(dout, idx, w.double(), V)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bwd(dout.half(), idx, w, V)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(dout.transpose(0, 1).contiguous().transpose(0, 1), idx, w, V)
    with pytest.raises(ValueError, match="dout on"):
        bwd(dout, idx.cpu(), w, V)
    with pytest.raises(ValueError, match=r"\[B, F, d\]"):
        bwd(dout[:2], idx, w, V)
    with pytest.raises(ValueError, match="rows"):
        bwd(dout, idx, w, 2 ** 31)
    with pytest.raises(RuntimeError, match="on a cpu tensor"):
        bwd(dout.cpu(), idx.cpu(), w.cpu(), V)


def test_embedding_bag_grad_on_cuda_goes_through_both_kernels(cuda,
                                                              monkeypatch):
    """Under autograd the forward launches ``embedding_bag`` and the
    backward ``embedding_bag_bwd``, once each; no plain version runs."""
    V = 300
    table = torch.randn(V, 32, device=cuda, requires_grad=True)
    _, idx, w = _ebag_bwd(V, 32, 64, 5, 2, cuda)
    dout = torch.randn(64, 5, 32, device=cuda)

    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ebag_mod, "embedding_bag_plain", refuse)
    monkeypatch.setattr(ebag_mod, "embedding_bag_bwd_plain", refuse)
    before = ops.launch_counts()
    out = ops.embedding_bag(table, idx, w)
    (g,) = torch.autograd.grad(out, table, dout)
    after = ops.launch_counts()
    assert after["embedding_bag"] == before["embedding_bag"] + 1
    assert after["embedding_bag_bwd"] == before["embedding_bag_bwd"] + 1
    monkeypatch.undo()
    exp = ebag_mod.embedding_bag_bwd_plain(dout, idx, w, V)
    assert float((g - exp).abs().max()) <= EBAG_BWD_REL * float(
        exp.abs().max())


def test_recsys_train_steps_on_the_card_match_the_cpu(cuda):
    """Two train steps of each recsys config at its reduced size, on the
    card and on the CPU from the same state: losses and parameters within
    1e-4; the CTR steps launch the EmbeddingBag and its backward once a
    table, BERT4Rec neither."""
    from repro_torch import optim
    from repro_torch.configs import recsys_family as rf
    from repro_torch.data import recsys_synth
    from repro_torch.models.recsys import bert4rec, ctr
    from repro_torch.optim.adam import leaves

    for name, tables in (("DLRM_RM2", 1), ("WIDE_DEEP", 2), ("DCN_V2", 1),
                         ("BERT4REC", 0)):
        if name == "BERT4REC":
            cfg = rf.reduced_b4r(rf.BERT4REC)
            params = bert4rec.init(torch.Generator().manual_seed(0), cfg)
            batches = [recsys_synth.bert4rec_batch(
                np.random.default_rng(i), batch=16, seq_len=cfg.seq_len,
                n_items=cfg.n_items, n_mask=cfg.n_mask, n_neg=cfg.n_neg,
                mask_token=cfg.mask_token, device="cpu") for i in range(2)]
        else:
            cfg = rf.reduced_ctr(getattr(rf, name))
            params = ctr.init(torch.Generator().manual_seed(0), cfg)
            batches = [recsys_synth.ctr_batch(
                np.random.default_rng(i), batch=64, n_dense=cfg.n_dense,
                vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz,
                device="cpu") for i in range(2)]
        p_d = _to(params, cuda)
        o_d, o_c = optim.adam_init(p_d), optim.adam_init(params)
        step_d, step_c = rf.make_fn(cfg, "train"), rf.make_fn(
            cfg, "train", device="cpu")
        before = ops.launch_counts()
        for b in batches:
            p_d, o_d, m_d = step_d(p_d, o_d, b)
            params, o_c, m_c = step_c(params, o_c, b)
            assert abs(float(m_d["loss"]) - float(m_c["loss"])) <= 1e-4, \
                name
        after = ops.launch_counts()
        for k in ("embedding_bag", "embedding_bag_bwd"):
            assert after[k] - before[k] == 2 * tables, (name, k)
        for (path, a), (_, b) in zip(leaves(p_d), leaves(params)):
            assert float((a.detach().cpu() - b.detach()).abs().max()) \
                <= 1e-4, (name, path)


def _same_topk(vals, ids, e_vals, e_ids, tol):
    """Scores within ``tol`` of the largest; ids equal where the scores
    are apart, as sets over each run of scores tied within ``tol``."""
    limit = tol * np.abs(e_vals).max()
    assert np.abs(vals - e_vals).max() <= limit
    for r in range(e_ids.shape[0]):
        start = 0
        for c in range(1, e_ids.shape[1] + 1):
            if c == e_ids.shape[1] or e_vals[r, c - 1] - e_vals[r, c] > limit:
                assert set(ids[r, start:c]) == set(e_ids[r, start:c]), r
                start = c


def test_recsys_mesh_on_the_card_matches_one_process(cuda):
    """The CPU tests' recsys mesh cases (``_torch_recsys_mesh_ranks``: the
    four reduced configs on (1, 2) and (2, 2)) in 4 gloo ranks sharing
    cuda:0, against one process on the card from the same inputs: CTR
    logits within 1e-5 of the largest (NaN where an index is past the
    table, as one process); BERT4Rec's ``serve_sharded`` and both
    families' two-stage retrieval, ids equal, scores within 1e-5; the
    gradient, both moments and the parameters after 2 steps within 1e-4
    of each leaf's largest (BERT4Rec's key biases, whose gradient is 0 in
    exact arithmetic, against the largest leaf; their parameters not
    held). Each CTR rank launches the EmbeddingBag forward on its table
    block once a table per forward (serve, the gradient, 2 steps;
    retrieval once, on the fused table) and its backward once a table
    per backward; BERT4Rec neither."""
    import _torch_recsys_mesh_ranks as ranks
    from repro_torch.launch.mesh import run_on_mesh
    inp = ranks.inputs()
    out = run_on_mesh(ranks.recsys_mesh_cases, 4, ["cuda:0"] * 4, model=2,
                      args=(inp, "cuda"), timeout=900)
    tables = {"wide-deep": 2, "dlrm-rm2": 1, "dcn-v2": 1, "bert4rec": 0}
    noise = "attn/k/b"
    for name in ranks.NAMES:
        one = ranks.one_process(inp, name, "cuda")
        for r in out:
            for mname, (D, _) in ranks.MESHES.items():
                res, i = r[mname][name], r[mname]["index"]["data"]
                n = ranks.B // D

                def blk(a):
                    return a[i * n:(i + 1) * n]

                if name == "bert4rec":
                    for kind in ("serve", "chunked"):
                        _same_topk(res[f"{kind}_vals"], res[f"{kind}_ids"],
                                   blk(one["serve_vals"]),
                                   blk(one["serve_ids"]), 1e-5)
                else:
                    exp = blk(one["logits"])
                    assert np.abs(res["logits"] - exp).max() <= \
                        1e-5 * np.abs(exp).max(), (name, mname)
                    exp = blk(one["edge_logits"])
                    fin = np.isfinite(exp)
                    assert np.array_equal(np.isnan(res["edge_logits"]),
                                          ~fin), (name, mname)
                    assert np.abs(res["edge_logits"][fin] - exp[fin]).max() \
                        <= 1e-5 * np.abs(exp[fin]).max(), (name, mname)
                _same_topk(res["retr_vals"], res["retr_ids"],
                           one["retr_vals"], one["retr_ids"], 1e-5)
                assert abs(res["losses"][0] - one["losses"][0]) <= 1e-5
                for k in ("grad", "m", "v", "params"):
                    top = max(np.abs(a).max() for a in one[k].values())
                    for path, exp in one[k].items():
                        if noise in path and k == "params":
                            continue
                        scale = top if noise in path else np.abs(exp).max()
                        assert np.abs(res[k][path] - exp).max() <= \
                            1e-4 * scale, (name, mname, k, path)
                # serve, the gradient and 2 steps a table; retrieval's
                # user_repr reads the fused table only
                t = tables[name]
                assert res["launches"]["embedding_bag"] == 4 * t + (t > 0)
                assert res["launches"]["embedding_bag_bwd"] == 3 * t, name


@pytest.mark.parametrize("name", ["npa", "naml", "lstur", "nrms"])
def test_news_baseline_grads_on_the_card_match_the_cpu(cuda, name):
    # the Table-3 baselines at a small size: the loss and its gradients on
    # the card and on the CPU from the same parameters, no kernel launched
    # (NRMS's attention is masked: plain, never flash). Each leaf within
    # 1e-4 of its own largest magnitude; the biases that shift every
    # logit of one softmax alike (an attention's keys, an additive pool's
    # scores) have gradients of cancellation noise, held against the
    # largest magnitude of any leaf
    from repro_torch.models import news
    from repro_torch.optim.adam import leaves
    torch.backends.cudnn.allow_tf32 = False      # the CNNs' conv1d in f32
    cfg = news.NewsBaselineConfig(name=name, vocab=500, n_users=16,
                                  d_word=16, d_news=16)
    params = news.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    ht = rng.integers(0, 500, (4, 6, 3, 8)).astype(np.int32)
    hm = rng.random((4, 6)) < 0.7
    hm[:, 0] = True
    ht[~hm] = 0
    batch = {"hist_tokens": ht, "hist_mask": hm,
             "cand_tokens": rng.integers(0, 500, (4, 3, 3, 8)).astype(
                 np.int32),
             "label": rng.integers(0, 3, 4).astype(np.int32),
             "cand_mask": np.ones((4, 3), bool),
             "user_id": rng.integers(0, 16, 4).astype(np.int32)}
    out = {}
    before = ops.launch_counts()
    for dev in (cuda, torch.device("cpu")):
        p = _to(params, dev)
        flat = [t.requires_grad_() for _, t in leaves(p)]
        loss, _ = news.loss(p, cfg, {k: torch.as_tensor(v, device=dev)
                                     for k, v in batch.items()})
        out[dev.type] = (float(loss), [g.cpu() for g in torch.autograd.grad(
            loss, flat)])
    assert ops.launch_counts() == before
    (ld, gd), (lc, gc) = out["cuda"], out["cpu"]
    assert abs(ld - lc) <= 1e-5, name
    top = max(float(g.abs().max()) for g in gc)
    for (path, _), a, b in zip(leaves(params), gd, gc):
        scale = top if path.endswith(("attn/k/b", "_pool/proj/b")) else \
            float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale, (name, path)
