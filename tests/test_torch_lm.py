"""The port's LM serving path against the JAX package.

Weights are drawn by the JAX package and carried over with
``bridge.params_from_jax``; inputs are made with numpy. The port's
attention takes the flash kernel's plain version on the CPU, the JAX
package its XLA ``sdpa``: the same function, so f32 agrees to rounding,
while in bf16 the JAX einsums round their products to bf16 and the
kernel accumulates in f32, which the JAX tests' bf16 tolerance (2e-2)
covers.
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
from repro.nn import core as jax_core  # noqa: E402
from repro.nn import rope as jax_rope  # noqa: E402
from repro_torch import bridge, nn  # noqa: E402
from repro_torch.configs import lm_family  # noqa: E402
from repro_torch.models import lm  # noqa: E402

# the attention modules (each package's ``nn.attention`` is the function)
jax_attn = importlib.import_module("repro.nn.attention")
port_attn = importlib.import_module("repro_torch.nn.attention")

TOL_NORM = 1e-6                     # rmsnorm, rope: f32 elementwise
TOL_F32 = {"attn": 1e-5, "lm": 1e-4}
TOL_BF16 = 2e-2                     # tests/test_kernels.py's bf16 tolerance


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _err(got, exp) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(exp, np.float32)).max())


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=64).astype(np.float32)
    exp = jax_core.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = nn.rmsnorm({"scale": _t(scale)}, _t(x))
    assert got.dtype == torch.float32
    assert _err(got, exp) <= TOL_NORM
    # bf16 in, f32 math, bf16 out
    got = nn.rmsnorm({"scale": _t(scale)}, _t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_jax(fraction):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = np.arange(12)[None, :] + np.array([[0], [40]])      # [B, S]
    d_rot = int(16 * fraction)
    cos_j, sin_j = jax_rope.rope_cos_sin(jnp.asarray(pos), d_rot, theta=1e4)
    exp = jax_rope.apply_rope(jnp.asarray(x), cos_j, sin_j,
                              fraction=fraction)
    cos_t, sin_t = nn.rope_cos_sin(torch.tensor(pos), d_rot, theta=1e4)
    assert _err(cos_t, cos_j) <= TOL_NORM and _err(sin_t, sin_j) <= TOL_NORM
    got = nn.apply_rope(_t(x), cos_t, sin_t, fraction=fraction)
    assert _err(got, exp) <= TOL_NORM
    if fraction < 1.0:              # the tail of the head dim passes through
        assert torch.equal(got[..., d_rot:], _t(x)[..., d_rot:])
    dec = nn.positions_for_decode(7, 3)
    assert dec.shape == (3, 1) and bool((dec == 7).all())
    assert np.array_equal(dec.numpy(),
                          np.asarray(jax_rope.positions_for_decode(7, 3)))


_ATTN = {
    "qk_norm": jax_attn.AttnConfig(d_model=64, n_heads=4, n_kv=2,
                                   head_dim=16, qk_norm=True,
                                   rope_theta=1e6),
    "qkv_bias_mqa": jax_attn.AttnConfig(d_model=64, n_heads=4, n_kv=1,
                                        head_dim=16, qkv_bias=True,
                                        rope_fraction=0.5),
    "chunked": jax_attn.AttnConfig(d_model=64, n_heads=4, n_kv=2,
                                   head_dim=16, chunk_size=8),
}


def _port_attn_cfg(cfg):
    return nn.AttnConfig(**dataclasses.asdict(cfg))


def _attn_params(cfg, dtype, seed=0):
    p = jax_attn.init_attention(jax.random.PRNGKey(seed), cfg,
                                param_dtype=dtype)
    rng = np.random.default_rng(seed)
    if cfg.qkv_bias:                # zeros at init: make them count
        for name in ("q", "k", "v"):
            b = p[name]["b"]
            p[name]["b"] = jnp.asarray(rng.normal(size=b.shape) * 0.1, dtype)
    return p


@pytest.mark.parametrize("name", list(_ATTN))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax(name, dtype):
    cfg = _ATTN[name]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    p = _attn_params(cfg, jd)
    x = np.random.default_rng(2).normal(size=(2, 32, 64)).astype(np.float32)
    exp = jax_attn.attention(p, jnp.asarray(x, jd), cfg, impl="xla")
    got = nn.attention(bridge.params_from_jax(_np(p), "cpu"), _t(x, td),
                       _port_attn_cfg(cfg))
    assert got.dtype == td
    tol = TOL_F32["attn"] if dtype == "float32" else TOL_BF16
    assert _err(got, exp) <= tol


def test_masked_attention_matches_jax():
    cfg = _ATTN["qk_norm"]
    p = _attn_params(cfg, jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    mask = rng.random((2, 16)) < 0.7
    exp = jax_attn.attention(p, jnp.asarray(x), cfg, mask=jnp.asarray(mask))
    got = nn.attention(bridge.params_from_jax(_np(p), "cpu"), _t(x),
                       _port_attn_cfg(cfg), mask=torch.tensor(mask))
    assert _err(got, exp) <= TOL_F32["attn"]


def _rand_cache(quant, B, S_max, cfg, rng):
    shape = (B, S_max, cfg.n_kv, cfg.head_dim)
    if quant:
        return {"k_q": rng.integers(-127, 128, shape).astype(np.int8),
                "k_s": rng.random(shape[:3]).astype(np.float32) * 0.05,
                "v_q": rng.integers(-127, 128, shape).astype(np.int8),
                "v_s": rng.random(shape[:3]).astype(np.float32) * 0.05}
    return {"k": rng.normal(size=shape).astype(np.float32),
            "v": rng.normal(size=shape).astype(np.float32)}


@pytest.mark.parametrize("case,quant,S_max,index", [
    ("plain", False, 12, 5),
    ("int8", True, 12, 5),
    ("chunked", False, 16, 9),        # trailing window of 8 ending at 9
    ("chunked_int8", True, 16, 3),    # window clipped at slot 0
    ("clamped", False, 8, 11),        # cache_index >= S_max: writes slot 7
    ("clamped_int8", True, 8, 8),
])
def test_decode_attention_matches_jax(case, quant, S_max, index):
    cfg = _ATTN["chunked" if case.startswith("chunked") else "qk_norm"]
    p = _attn_params(cfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 1, 64)).astype(np.float32)
    cache = _rand_cache(quant, 3, S_max, cfg, rng)
    exp, exp_cache = jax_attn.decode_attention(
        p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.int32(index), cfg)
    port_cache = {k: torch.tensor(v) for k, v in cache.items()}
    got, got_cache = nn.decode_attention(
        bridge.params_from_jax(_np(p), "cpu"), _t(x), port_cache, index,
        _port_attn_cfg(cfg))
    assert _err(got, exp) <= TOL_F32["attn"]
    for name, t in got_cache.items():
        assert t is port_cache[name]              # written in place
        e = np.asarray(exp_cache[name])
        if e.dtype == np.int8:
            assert np.array_equal(t.numpy(), e), name
        else:
            assert _err(t, e) <= TOL_F32["attn"], name
    if case.startswith("clamped"):
        slot = "k_q" if quant else "k"
        assert not np.array_equal(got_cache[slot][:, S_max - 1].numpy(),
                                  cache[slot][:, S_max - 1])


def test_q8_rounds_half_to_even_like_jax():
    x = np.array([[[[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.0, -127.0]]]],
                 np.float32)
    q_j, s_j = jax_attn._q8(jnp.asarray(x))
    q_t, s_t = port_attn._q8(_t(x))
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))


_LM = {"qwen3-14b": (jax_family.QWEN3_14B, lm_family.QWEN3_14B),
       "chatglm3-6b": (jax_family.CHATGLM3_6B, lm_family.CHATGLM3_6B),
       "qwen2-72b": (jax_family.QWEN2_72B, lm_family.QWEN2_72B)}


@pytest.mark.parametrize("name", list(_LM))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(name, dtype):
    jcfg = dataclasses.replace(jax_family.reduced_lm(_LM[name][0]),
                               dtype=dtype)
    pcfg = dataclasses.replace(lm_family.reduced_lm(_LM[name][1]),
                               dtype=dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    params = jax_lm.init(jax.random.PRNGKey(0), jcfg, param_dtype=jd)
    if jcfg.qkv_bias:               # zeros at init: make them count
        rng = np.random.default_rng(5)
        b = params["layers"]["attn"]["k"]["b"]
        params["layers"]["attn"]["k"]["b"] = jnp.asarray(
            rng.normal(size=b.shape) * 0.1, jd)
    p_t = bridge.params_from_jax(_np(params), "cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 16))
    tol = TOL_F32["lm"] if dtype == "float32" else TOL_BF16

    exp = jax.jit(lambda p, t: jax_lm.prefill(p, jcfg, t))(
        params, jnp.asarray(toks, jnp.int32))
    got = lm.prefill(p_t, pcfg, torch.tensor(toks))
    assert got.dtype == td and got.shape == (2, jcfg.vocab)
    assert _err(got, exp) <= tol

    step = jax.jit(lambda p, t, c, i: jax_lm.decode_step(p, jcfg, t, c, i))
    cache_j = jax_lm.init_cache(jcfg, 2, 12, jd)
    cache_t = bridge.lm_cache_from_jax(_np(cache_j), "cpu")
    for i in range(8):
        exp, cache_j = step(params, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                            cache_j, jnp.int32(i))
        got, cache_t = lm.decode_step(p_t, pcfg, torch.tensor(toks[:, i:i + 1]),
                                      cache_t, i)
        assert _err(got, exp) <= tol, i
    for k in ("k", "v"):
        assert _err(cache_t[k], cache_j[k]) <= tol


def test_bridge_carries_a_bf16_lm_tree_exactly():
    cfg = dataclasses.replace(jax_family.reduced_lm(jax_family.QWEN3_14B),
                              dtype="bfloat16")
    params = _np(jax_lm.init(jax.random.PRNGKey(1), cfg,
                             param_dtype=jnp.bfloat16))
    got = bridge.params_from_jax(params, "cpu")
    assert len(got["layers"]) == cfg.n_layers
    pairs = [(got["embed"]["table"], params["embed"]["table"]),
             (got["head"]["w"], params["head"]["w"])]
    for i, layer in enumerate(got["layers"]):
        for a, b in (("q", "w"), ("o", "w"), ("q_norm", "scale")):
            pairs.append((layer["attn"][a][b],
                          params["layers"]["attn"][a][b][i]))
        pairs.append((layer["ffn"]["down"]["w"],
                      params["layers"]["ffn"]["down"]["w"][i]))
    for t, a in pairs:
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.float().numpy(), np.asarray(a, np.float32))
    # both cache layouts, bf16 and int8 leaves
    for cache in (jax_lm.init_cache(cfg, 2, 4, jnp.bfloat16),
                  jax_lm.init_cache(cfg, 2, 4, quant=True)):
        t = bridge.lm_cache_from_jax(_np(cache), "cpu")
        assert set(t) == set(cache)
        for k, v in t.items():
            assert v.shape == cache[k].shape
            assert np.array_equal(v.float().numpy(),
                                  np.asarray(cache[k], np.float32))
    with pytest.raises(ValueError):
        bridge.lm_cache_from_jax({"k": np.zeros(1)}, "cpu")


def test_configs_carry_the_jax_widths():
    for j, p in [(jax_family.QWEN3_14B, lm_family.QWEN3_14B),
                 (jax_family.CHATGLM3_6B, lm_family.CHATGLM3_6B),
                 (jax_family.QWEN2_72B, lm_family.QWEN2_72B),
                 (jax_family.DBRX_132B, lm_family.DBRX_132B),
                 (jax_family.LLAMA4_SCOUT, lm_family.LLAMA4_SCOUT)]:
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert dataclasses.asdict(lm_family.reduced_lm(p)) == \
            dataclasses.asdict(jax_family.reduced_lm(j))
        assert p.param_count() == j.param_count()
        assert p.active_param_count() == j.active_param_count()
        assert dataclasses.asdict(p.attn_cfg()) == \
            dataclasses.asdict(j.attn_cfg())
    assert lm_family.LM_SHAPES == jax_family.LM_SHAPES
    assert lm_family.QWEN3_14B.param_count() == 14_768_296_960


def test_moe_configs_and_lm_training_raise():
    gen = torch.Generator().manual_seed(0)
    for cfg in (lm_family.DBRX_132B, lm_family.LLAMA4_SCOUT):
        with pytest.raises(NotImplementedError, match="MoE"):
            lm.init(gen, lm_family.reduced_lm(cfg))
    assert callable(lm_family.make_fn(lm_family.QWEN3_14B, "train"))
    with pytest.raises(ValueError):
        lm_family.make_fn(lm_family.QWEN3_14B, "serve")


def test_init_cache_gives_every_layer_its_own_storage():
    cfg = lm_family.reduced_lm(lm_family.QWEN3_14B)
    for quant in (False, True):
        cache = lm.init_cache(cfg, 2, 8, torch.float32, quant=quant,
                              device="cpu")
        for t in cache.values():
            assert t.shape[0] == cfg.n_layers and t.is_contiguous()
            t[0].fill_(1)
            assert bool((t[1] == 0).all())


def test_decode_writes_the_cache_in_place():
    cfg = lm_family.reduced_lm(lm_family.QWEN3_14B)
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    cache = lm.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    before = {k: v.data_ptr() for k, v in cache.items()}
    _, out = lm.decode_step(params, cfg, torch.zeros(2, 1, dtype=torch.long),
                            cache, 3)
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == before
    assert bool((cache["k"][:, :, 3] != 0).any())
    assert bool((cache["k"][:, :, 4:] == 0).all())
