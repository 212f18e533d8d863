"""The port's BusLM encoder and attentive user model against the JAX
package, on parameters bridged from a JAX init and the same numpy inputs."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.plm import init_plm as jinit_plm  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402

ENCODE_TOL = 5e-4      # tests/test_kernels.py's full-encoder tolerance
USER_TOL = 1e-5        # one dense + softmax pooling in f32


def _configs(n_segments=3, use_bus=True):
    kw = dict(vocab=300, n_layers=2, d_model=32, n_heads=4, d_ff=64,
              n_segments=n_segments, seg_len=8, news_dim=16, use_bus=use_bus)
    return jcore.PLMConfig(**kw), core.PLMConfig(**kw)


def _tokens(M, K, S, *, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 300, (M, K, S)).astype(np.int32)
    lengths = rng.integers(0, S + 1, (M, K))
    toks[np.arange(S)[None, None] >= lengths[..., None]] = 0   # pad tails
    toks[0] = 0                                # a pad news (nothing valid)
    if K > 1:
        toks[1, K - 1] = 0                     # an empty segment
    freq = rng.integers(0, 40, (M, K, S)).astype(np.int32)
    return toks, freq


def _encode_both(n_segments=3, use_bus=True, impls=("xla",)):
    jcfg, tcfg = _configs(n_segments, use_bus)
    jparams = jax.tree.map(np.asarray, jinit_plm(jax.random.PRNGKey(5), jcfg))
    tparams = params_from_jax(jparams, device="cpu")
    toks, freq = _tokens(6, n_segments, 8)
    got = core.buslm_encode(tparams, tcfg, torch.tensor(toks).long(),
                            torch.tensor(freq).long()).numpy()
    exps = [np.asarray(jcore.buslm_encode(jparams, jcfg, toks, freq,
                                          impl=impl)) for impl in impls]
    return got, exps


def test_buslm_encode_matches_jax_xla_and_pallas():
    got, exps = _encode_both(impls=("xla", "pallas"))
    assert got.shape == (6, 16) and np.isfinite(got).all()
    for exp in exps:
        np.testing.assert_allclose(got, exp, rtol=ENCODE_TOL, atol=ENCODE_TOL)


@pytest.mark.parametrize("n_segments,use_bus", [(1, True), (3, False)])
def test_buslm_encode_sdpa_branch_matches_jax(n_segments, use_bus):
    """K == 1 (or use_bus=False) takes plain SDPA in both packages."""
    got, (exp,) = _encode_both(n_segments, use_bus)
    np.testing.assert_allclose(got, exp, rtol=ENCODE_TOL, atol=ENCODE_TOL)


def test_buslm_plain_impl_equals_kernel_dispatch_on_cpu():
    _, tcfg = _configs()
    gen = torch.Generator().manual_seed(0)
    params = core.init_plm(gen, tcfg)
    toks, freq = (torch.tensor(x).long() for x in _tokens(4, 3, 8, seed=1))
    a = core.buslm_encode(params, tcfg, toks, freq, impl="kernel")
    b = core.buslm_encode(params, tcfg, toks, freq, impl="plain")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        core.buslm_encode(params, tcfg, toks, freq, impl="pallas")


def test_bridge_splits_stacked_layers_and_keeps_dense_layout():
    jcfg, tcfg = _configs()
    jparams = jax.tree.map(np.asarray, jinit_plm(jax.random.PRNGKey(1), jcfg))
    tparams = params_from_jax(jparams, device="cpu")
    assert len(tparams["layers"]) == jcfg.n_layers
    for i, layer in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(
            layer["attn"]["q"]["w"].numpy(),
            jparams["layers"]["attn"]["q"]["w"][i])
        np.testing.assert_array_equal(
            layer["ffn_up"]["w"].numpy(), jparams["layers"]["ffn_up"]["w"][i])
        assert tuple(layer["ffn_up"]["w"].shape) == (32, 64)   # [in, out]
    np.testing.assert_array_equal(tparams["tok_emb"]["table"].numpy(),
                                  jparams["tok_emb"]["table"])
    # the port's own init produces the same tree structure
    own = core.init_plm(torch.Generator().manual_seed(0), tcfg)
    assert own.keys() == tparams.keys()
    assert own["layers"][0].keys() == tparams["layers"][0].keys()


def test_attentive_user_matches_jax_with_an_empty_history():
    d, B, L = 16, 4, 12
    ucfg = jcore.UserModelConfig(news_dim=d, kind="attentive", causal=False)
    jp = jax.tree.map(np.asarray,
                      jcore.init_user_model(jax.random.PRNGKey(2), ucfg))
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(B, L, d)).astype(np.float32)
    mask = rng.random((B, L)) < 0.6
    mask[2] = False                            # an empty history
    exp = np.asarray(jcore.attentive_user(jp, theta, mask))
    got = core.attentive_user(tp, torch.tensor(theta),
                              torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, exp, rtol=USER_TOL, atol=USER_TOL)
    np.testing.assert_allclose(got[2], theta[2].mean(axis=0), rtol=USER_TOL,
                               atol=USER_TOL)


@pytest.mark.parametrize("causal,mask_kind", [(False, "keys"),
                                              (True, None),
                                              (False, "rows")])
def test_sdpa_matches_jax_with_fully_masked_rows(causal, mask_kind):
    """GQA 4:2, key or [Sq, Sk] masks with a fully-masked row (which
    averages V, where F.scaled_dot_product_attention would give 0)."""
    from repro.nn import sdpa as jsdpa
    from repro_torch.nn import sdpa
    rng = np.random.default_rng(6)
    B, Sq, Sk, Hq, Hkv, D = 2, 5, 7, 4, 2, 8
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    mask = None
    if mask_kind == "keys":
        mask = rng.random((B, Sk)) < 0.7
        mask[1] = False
    elif mask_kind == "rows":
        mask = rng.random((B, Sq, Sk)) < 0.7
        mask[0, 2] = False
    exp = np.asarray(jsdpa(q, k, v, causal=causal, mask=mask))
    got = sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v),
               causal=causal,
               mask=None if mask is None else torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, exp, rtol=USER_TOL, atol=USER_TOL)
