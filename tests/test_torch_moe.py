"""The port's MoE layers, chunked-local attention and the MoE members of
the LM family (DBRX-132B, Llama-4-Scout) against the JAX package.

Weights are drawn by the JAX package and carried over with
``bridge.params_from_jax``; inputs are made with numpy. Routing must be
the reference's exactly (the same experts for every token, the same
assignments dropped past capacity), so the experts are compared as
integers and the outputs within f32 rounding (1e-5 for a layer, 2e-4 for
a reduced LM) or the JAX tests' bf16 tolerance (2e-2).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import lm_family as jax_family  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import bridge, nn  # noqa: E402
from repro_torch.configs import lm_family  # noqa: E402
from repro_torch.models import lm  # noqa: E402

jax_moe = importlib.import_module("repro.nn.moe")
jax_attn = importlib.import_module("repro.nn.attention")
port_moe = importlib.import_module("repro_torch.nn.moe")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_LM = 2e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(got, exp) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(exp, np.float32)).max())


def _pair(cfg_kw, dtype, seed=0, shape=(2, 12)):
    """A JAX MoE layer and its input, and the port's copies."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jax_moe.MoEConfig(**cfg_kw)
    p = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, param_dtype=jd)
    x = np.random.default_rng(seed).normal(
        size=shape + (jcfg.d_model,)).astype(np.float32)
    return (jcfg, p, jnp.asarray(x, jd), nn.MoEConfig(**cfg_kw),
            bridge.params_from_jax(_np(p), "cpu"),
            torch.tensor(x).to(td))


_CASES = {
    "top2_of_4": dict(d_model=32, d_ff=64, n_experts=4, top_k=2),
    "top1_of_4": dict(d_model=32, d_ff=64, n_experts=4, top_k=1),
    "top4_of_4": dict(d_model=16, d_ff=32, n_experts=4, top_k=4),
    "gelu_unnormed": dict(d_model=16, d_ff=32, n_experts=4, top_k=2,
                          gated=False, norm_topk=False),
}


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_jax(case, dtype):
    jcfg, p, x, pcfg, pt, xt = _pair(_CASES[case], dtype)
    g_j, e_j, a_j = jax.jit(lambda p, x: jax_moe._route(p, x, jcfg))(
        p, x.reshape(-1, jcfg.d_model))
    g_t, e_t, a_t = port_moe._route(pt, xt.reshape(-1, pcfg.d_model), pcfg)
    assert np.array_equal(e_t.numpy(), np.asarray(e_j))
    assert g_t.dtype == a_t.dtype == torch.float32
    assert _err(g_t, g_j) <= TOL[dtype]
    # in bf16 the router logits round where the two compilers put the
    # rounding, so the balance loss is held to the bf16 tolerance
    assert abs(float(a_t) - float(a_j)) <= TOL[dtype] * max(1.0,
                                                            abs(float(a_j)))


@pytest.mark.parametrize("case,impl", [
    *((c, i) for c in _CASES for i in ("gather", "dense")),
    ("drops", "gather"), ("expert_slice", "gather")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_jax(case, impl, dtype):
    """moe_gather and moe_dense against JAX's: the default capacity; a
    capacity that drops assignments (``tests/test_nn.py``'s
    capacity_factor 0.25: 32 tokens, 2 experts of 8 slots); a local expert
    slice (``expert_start``/``n_local``, the expert-parallel path's
    call)."""
    if case == "drops":
        kw, shape = dict(d_model=8, d_ff=16, n_experts=2, top_k=1,
                         capacity_factor=0.25), (1, 32)
    elif case == "expert_slice":
        kw, shape = dict(d_model=16, d_ff=32, n_experts=4, top_k=2), (2, 8)
    else:
        kw, shape = _CASES[case], (2, 12)
    jcfg, p, x, pcfg, pt, xt = _pair(kw, dtype, seed=3, shape=shape)
    if impl == "dense":
        y_j, a_j = jax.jit(lambda p, x: jax_moe.moe_dense(p, x, jcfg))(p, x)
        y_t, a_t = port_moe.moe_dense(pt, xt, pcfg)
    elif case == "expert_slice":
        sl = {k: (v if k == "router" else v[1:3]) for k, v in p.items()}
        slt = {k: (v if k == "router" else v[1:3]) for k, v in pt.items()}
        y_j, a_j = jax.jit(lambda p, x: jax_moe.moe_gather(
            p, x, jcfg, expert_start=1, n_local=2))(sl, x)
        y_t, a_t = port_moe.moe_gather(slt, xt, pcfg, expert_start=1,
                                       n_local=2)
        full = port_moe.moe_gather(pt, xt, pcfg)[0]
        assert _err(y_t, np.asarray(full.float())) > 0   # only 2 of 4 ran
    else:
        y_j, a_j = jax.jit(lambda p, x: jax_moe.moe_gather(p, x, jcfg))(p, x)
        y_t, a_t = port_moe.moe_gather(pt, xt, pcfg)
    assert y_t.dtype == xt.dtype and y_t.shape == xt.shape
    scale = max(1.0, float(np.abs(np.asarray(y_j, np.float32)).max()))
    assert _err(y_t, y_j) <= TOL[dtype] * scale
    assert abs(float(a_t) - float(a_j)) <= TOL[dtype] * max(1.0,
                                                            abs(float(a_j)))
    if case == "drops":
        # capacity 8 an expert against 32 assignments: dropped tokens
        # add exactly 0, on the same rows as JAX's
        zero_t = (y_t[0].float().norm(dim=-1) == 0).numpy()
        zero_j = np.linalg.norm(np.asarray(y_j[0], np.float32), axis=-1) == 0
        assert zero_t.sum() >= 8 and np.array_equal(zero_t, zero_j)


@pytest.mark.parametrize("seed,top_k,n_experts", [
    (2, 1, 2), (3, 2, 4), (4, 4, 4), (5, 3, 8), (6, 1, 8), (7, 2, 8)])
def test_moe_dense_equals_gather_with_ample_capacity(seed, top_k, n_experts):
    cfg = nn.MoEConfig(d_model=16, d_ff=32, n_experts=n_experts,
                       top_k=top_k, capacity_factor=16.0)
    gen = torch.Generator().manual_seed(seed)
    p = nn.init_moe(gen, cfg)
    x = torch.randn(2, 6, 16, generator=gen)
    yd, ad = nn.moe_dense(p, x, cfg)
    yg, ag = nn.moe_gather(p, x, cfg)
    assert float((yd - yg).abs().max()) <= 3e-6
    assert float(ad) == float(ag)


def test_tied_bf16_router_logits_pick_jax_experts():
    """Router logits that tie exactly (small integers, exact in bf16)
    pick the lower expert index among equals, as ``jax.lax.top_k``
    does, and the layer then matches JAX's."""
    kw = dict(d_model=16, d_ff=32, n_experts=4, top_k=2)
    jcfg, p, _, pcfg, pt, _ = _pair(kw, "bfloat16", seed=5)
    rng = np.random.default_rng(5)
    router = rng.integers(-1, 2, size=(16, 4)).astype(np.float32)
    router[:, 2] = router[:, 0]                 # experts 0 and 2 always tie
    x = rng.integers(-2, 3, size=(2, 16, 16)).astype(np.float32)
    p = dict(p, router=jnp.asarray(router, jnp.bfloat16))
    pt = dict(pt, router=torch.tensor(router).to(torch.bfloat16))
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    _, e_j, _ = jax.jit(lambda p, x: jax_moe._route(p, x, jcfg))(
        p, xj.reshape(-1, 16))
    _, e_t, _ = port_moe._route(pt, xt.reshape(-1, 16), pcfg)
    e_j = np.asarray(e_j)
    assert np.array_equal(e_t.numpy(), e_j)
    logits = x.reshape(-1, 16) @ router
    top = np.sort(logits, axis=-1)[:, ::-1]
    assert (top[:, 0] == top[:, 1]).sum() >= 4    # ties do occur
    # among tied experts the lower index comes first
    for row, (a, b) in zip(logits, e_j):
        assert row[a] > row[b] or (row[a] == row[b] and a < b)
    y_j, _ = jax.jit(lambda p, x: jax_moe.moe_gather(p, x, jcfg))(p, xj)
    y_t, _ = port_moe.moe_gather(pt, xt, pcfg)
    scale = max(1.0, float(np.abs(np.asarray(y_j, np.float32)).max()))
    assert _err(y_t, y_j) <= TOL["bfloat16"] * scale


def test_capacity_for_matches_jax():
    cfg = nn.MoEConfig(d_model=8, d_ff=8, n_experts=16, top_k=4)
    jcfg = jax_moe.MoEConfig(d_model=8, d_ff=8, n_experts=16, top_k=4)
    for T in (1, 7, 8, 16, 100, 32768):
        assert port_moe.capacity_for(T, cfg) == jax_moe.capacity_for(T, jcfg)
    assert port_moe.capacity_for(32768, cfg) == 10240


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_jax(impl, dtype):
    """A chunked-local layer (chunk 8, S=32, rope): ``impl="kernel"``
    through the flash kernel chunk by chunk (its plain version on the
    CPU), ``impl="plain"`` through ``chunked_sdpa``, both against JAX's
    XLA ``chunked_sdpa``."""
    cfg = jax_attn.AttnConfig(d_model=64, n_heads=4, n_kv=2, head_dim=16,
                              chunk_size=8, rope_theta=5e5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    p = jax_attn.init_attention(jax.random.PRNGKey(0), cfg, param_dtype=jd)
    x = np.random.default_rng(2).normal(size=(2, 32, 64)).astype(np.float32)
    exp = jax.jit(lambda p, x: jax_attn.attention(p, x, cfg, impl="xla"))(
        p, jnp.asarray(x, jd))
    got = nn.attention(bridge.params_from_jax(_np(p), "cpu"),
                       torch.tensor(x).to(td),
                       nn.AttnConfig(**dataclasses.asdict(cfg)), impl=impl)
    assert got.dtype == td
    assert _err(got, exp) <= TOL[dtype]
    # the layer with no window agrees on the first chunk and differs past
    # it: the chunks are really cut
    full = nn.attention(bridge.params_from_jax(_np(p), "cpu"),
                        torch.tensor(x).to(td),
                        nn.AttnConfig(**dict(dataclasses.asdict(cfg),
                                             chunk_size=None)), impl=impl)
    assert _err(full[:, :8], np.asarray(got[:, :8].float())) <= TOL[dtype]
    assert _err(full[:, 8:], np.asarray(got[:, 8:].float())) > 1e-2


_MOE_LM = {"dbrx-132b": (jax_family.DBRX_132B, lm_family.DBRX_132B),
           "llama4-scout": (jax_family.LLAMA4_SCOUT, lm_family.LLAMA4_SCOUT)}


@pytest.mark.parametrize("name", list(_MOE_LM))
def test_moe_lm_matches_jax(name):
    """Reduced DBRX and Scout (``reduced_lm``: 2 layers, or one
    super-block of 3 chunked-local + 1 global; 4 experts; chunk 8) in f32:
    ``forward`` (logits and aux), ``prefill``, ``lm_loss`` (value and
    ``moe_aux``) and 24 decode steps from an empty cache, against JAX.
    S=24 runs past the first chunk, so prefill's hard chunks and decode's
    trailing window (different functions there) are each held to their
    own reference."""
    jcfg = jax_family.reduced_lm(_MOE_LM[name][0])
    pcfg = lm_family.reduced_lm(_MOE_LM[name][1])
    params = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    pt = bridge.params_from_jax(_np(params), "cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 24))
    tj, tt = jnp.asarray(toks, jnp.int32), torch.tensor(toks)

    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100)], 1)
    batch_j = {"tokens": tj, "labels": jnp.asarray(labels, jnp.int32)}
    (logits_j, aux_j), (loss_j, m_j) = jax.jit(lambda p, b: (
        jax_lm.forward(p, jcfg, b["tokens"]), jax_lm.lm_loss(p, jcfg, b)))(
            params, batch_j)
    logits_t, aux_t = lm.forward(pt, pcfg, tt)
    assert _err(logits_t, logits_j) <= TOL_LM
    assert float(aux_j) > 0 and abs(float(aux_t) - float(aux_j)) <= 1e-5
    got = lm_family.make_fn(pcfg, "prefill")(pt, tt)
    assert got.shape == (2, jcfg.vocab)
    assert _err(got, logits_j[:, -1]) <= TOL_LM

    loss_t, m_t = lm.lm_loss(pt, pcfg, {"tokens": tt,
                                        "labels": torch.tensor(labels)})
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5
    assert abs(float(m_t["moe_aux"]) - float(m_j["moe_aux"])) <= 1e-5
    assert abs(float(m_t["lm_loss"]) - float(m_j["lm_loss"])) <= 1e-5

    step = jax.jit(lambda p, t, c, i: jax_lm.decode_step(p, jcfg, t, c, i))
    cache_j = jax_lm.init_cache(jcfg, 2, 24, jnp.float32)
    cache_t = bridge.lm_cache_from_jax(_np(cache_j), "cpu")
    decode = lm_family.make_fn(pcfg, "decode")
    for i in range(24):
        exp, cache_j = step(params, tj[:, i:i + 1], cache_j, jnp.int32(i))
        got, cache_t = decode(pt, tt[:, i:i + 1], cache_t, i)
        assert _err(got, exp) <= TOL_LM, i
    for k in ("k", "v"):
        assert _err(cache_t[k], cache_j[k]) <= TOL_LM
    if jcfg.global_every:
        # past the first chunk the prefill's hard chunks and the decode's
        # trailing window are different functions, in both packages
        assert _err(got, np.asarray(logits_t[:, -1])) > 1e-3


def test_layer_kinds_follow_the_super_blocks():
    scout = lm_family.one_card_serve(lm_family.LLAMA4_SCOUT)
    assert scout.n_layers == 8
    assert [scout.is_local(i) for i in range(8)] == [True] * 3 + [False] + \
        [True] * 3 + [False]
    glob, loc = scout.attn_cfg(local=False), scout.attn_cfg(local=True)
    assert glob.chunk_size is None and glob.rope_fraction == 0.0
    assert loc.chunk_size == 8192 and loc.rope_fraction == 1.0
    dbrx = lm_family.one_card_serve(lm_family.DBRX_132B)
    assert dbrx.n_layers == 6 and all(dbrx.is_local(i) for i in range(6))
    assert dbrx.attn_cfg(local=True).chunk_size is None


def test_bridge_carries_a_bf16_moe_tree_exactly():
    """A bf16 MoE tree (stacked ``moe.{router, w1, w2, w3}`` [L, E, ...]
    and the shared expert) comes over bit for bit, layer by layer."""
    cfg = dataclasses.replace(jax_family.reduced_lm(jax_family.LLAMA4_SCOUT),
                              dtype="bfloat16")
    params = _np(jax_lm.init(jax.random.PRNGKey(1), cfg,
                             param_dtype=jnp.bfloat16))
    got = bridge.params_from_jax(params, "cpu")
    assert len(got["layers"]) == cfg.n_layers
    n = 0
    for i, layer in enumerate(got["layers"]):
        assert set(layer) == {"attn", "ln1", "ln2", "moe", "shared"}
        for group in ("moe", "shared"):
            for path, t in _leaves(layer[group]):
                a = params["layers"][group]
                for key in path:
                    a = a[key]
                a = np.asarray(a[i], np.float32)
                assert t.dtype == torch.bfloat16 and t.shape == a.shape
                assert np.array_equal(t.float().numpy(), a), (group, path)
                n += 1
    assert n == cfg.n_layers * (4 + 3)
    assert tuple(got["layers"][0]["moe"]["w1"].shape) == (4, 64, 128)


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node
