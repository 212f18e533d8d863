"""The port's news baselines (NPA, NAML, LSTUR, NRMS), its NRMS user
encoder and ``click_share_topk`` against the JAX package.

Both packages see the same numpy inputs, and the port's parameters are
JAX's ``init`` carried over by ``bridge.params_from_jax``. The batch has
the edge cases each method has to get right: histories with masked gaps
and a padded tail (LSTUR's GRU keeps h where the mask is False), an
empty history, an all-pad NAML view, an all-pad news row (NRMS's
attention then averages uniformly over -1e30 logits), a masked
candidate, and L > 1, C > 1 (NPA's per-user word query repeated over a
user's news).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore, data as jdata, optim as joptim  # noqa: E402
from repro.models import news as jnews  # noqa: E402
from repro_torch import core, data, optim  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import news  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

LOSS_TOL = 1e-5        # the encoders, the user encoder and the loss in f32
GRAD_TOL = 1e-4        # every gradient leaf
STEP_TOL = 1e-4        # three Adam steps
STEP_DELTA_TOL = 1e-3  # a leaf's change over three steps, relative to JAX's
USER_TOL = 1e-5        # the NRMS user encoder
NAMES = ("npa", "naml", "lstur", "nrms")
B, L, C, K, S, V, N_USERS, D = 4, 6, 3, 3, 4, 300, 12, 16
ADAM = dict(lr=1e-3)   # benchmarks/tables.py's for the NRMS baseline
# biases that shift every logit of one softmax alike (see the step test)
SHIFT_BIASES = ("attn/k/b", "_pool/proj/b")


def _t(x):
    return torch.as_tensor(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ht = rng.integers(1, V, (B, L, K, S)).astype(np.int32)
    ht[..., -1] = 0                                   # padded token tails
    hm = np.ones((B, L), bool)
    hm[0, 4:] = False                                 # a padded tail
    hm[1, [1, 3]] = False                             # gaps
    hm[1, 5] = False                                  # and a tail
    hm[2] = False                                     # an empty history
    ht[~hm] = 0                                       # pad news in slots
    ht[3, 2, 1] = 0                                   # an all-pad view
    ct = rng.integers(1, V, (B, C, K, S)).astype(np.int32)
    ct[0, 1, 2] = 0                                   # an all-pad view
    ct[1, 2] = 0                                      # an all-pad news
    cm = np.ones((B, C), bool)
    cm[1, 2] = False                                  # a masked candidate
    return {"hist_tokens": ht, "hist_mask": hm, "cand_tokens": ct,
            "label": np.array([0, 1, 2, 1], np.int32), "cand_mask": cm,
            "user_id": np.array([3, 7, 0, 11], np.int32)}


def _configs(name):
    kw = dict(name=name, vocab=V, n_users=N_USERS, d_word=D, d_news=D,
              n_heads=4, cnn_width=3, n_views=K)
    return jnews.NewsBaselineConfig(**kw), news.NewsBaselineConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg, seed=1):
    """JAX's init as numpy leaves (cached: the tests only read it)."""
    return _np_tree(jnews.init(jax.random.PRNGKey(seed), jcfg))


def _shapes(tree):
    return [(path, tuple(t.shape), t.dtype) for path, t in leaves(tree)]


def _close(got, exp, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(exp, np.float64), rtol=0,
                               atol=tol, err_msg=what)


# ----------------------------------------------------------------- tree

@pytest.mark.parametrize("name", NAMES)
def test_init_gives_the_jax_tree(name):
    jcfg, tcfg = _configs(name)
    exp = params_from_jax(_np_tree(_jax_init(jcfg)), device="cpu")
    got = news.init(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(got) == _shapes(exp)
    if name == "naml":
        assert isinstance(got["view_cnn"], list)
        assert len(got["view_cnn"]) == K
        assert tuple(got["view_cnn"][0]["w"].shape) == (3, D, D)   # WIO


def test_init_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown news baseline"):
        news.init(torch.Generator(), news.NewsBaselineConfig(name="dkn"))


# ----------------------------------------------------- forward, gradients

@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_jax(name):
    jcfg, tcfg = _configs(name)
    b = _batch()
    jp = _jax_init(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jnews.loss(p, jcfg, b), has_aux=True))(jp)
    params = params_from_jax(_np_tree(jp), device="cpu")
    flat = [p.requires_grad_() for _, p in leaves(params)]
    tl, tm = news.loss(params, tcfg, {k: _t(v) for k, v in b.items()})
    grads = torch.autograd.grad(tl, flat, allow_unused=True)
    _close(tl.detach(), jl, LOSS_TOL, "loss")
    assert float(tm["click_acc"]) == float(jm["click_acc"])
    exp = dict(leaves(params_from_jax(_np_tree(jg), device="cpu")))
    n_nonzero = 0
    for (path, p), g in zip(leaves(params), grads):
        g = torch.zeros_like(p) if g is None else g
        _close(g, exp[path], GRAD_TOL, f"{name} grad {path}")
        n_nonzero += float(exp[path].abs().max()) > 0
    assert n_nonzero >= len(grads) - 2      # the key biases may be ~0


@pytest.mark.parametrize("name", ("npa", "lstur", "nrms", "naml"))
def test_encode_news_matches_jax_on_histories_and_candidates(name):
    """History and candidate rows (NPA: n_rep = L, then n_rep = C)."""
    jcfg, tcfg = _configs(name)
    b = _batch(seed=2)
    jp = _jax_init(jcfg)
    params = params_from_jax(_np_tree(jp), device="cpu")
    uvec = juvec = None
    if name in ("npa", "lstur"):
        juvec = jnp.asarray(jp["user_emb"]["table"])[b["user_id"]]
        uvec = params["user_emb"]["table"][_t(b["user_id"]).long()]
    for key, lead in (("hist_tokens", (B, L)), ("cand_tokens", (B, C))):
        exp = jax.jit(lambda p, t, u: jnews.encode_news(p, jcfg, t, u))(
            jp, jnp.asarray(b[key]), juvec)
        got = news.encode_news(params, tcfg, _t(b[key]), uvec)
        assert tuple(got.shape) == lead + (D,)
        _close(got, exp, LOSS_TOL, f"{name} {key}")


def test_npa_repeats_each_users_query_over_that_users_news():
    """repeat_interleave, not repeat: swapping two users' ids moves their
    news embeddings with them."""
    jcfg, tcfg = _configs("npa")
    b = _batch()
    params = params_from_jax(_np_tree(_jax_init(jcfg)), device="cpu")
    uvec = params["user_emb"]["table"][_t(b["user_id"]).long()]
    toks = _t(b["hist_tokens"])
    a = news.encode_news(params, tcfg, toks, uvec)
    swapped = news.encode_news(params, tcfg, toks, uvec.flip(0))
    one = news.encode_news(params, tcfg, toks[:1], uvec[-1:])
    torch.testing.assert_close(swapped[0], one[0], rtol=0, atol=0)
    assert float((a[0] - swapped[0]).abs().max()) > 0


def test_lstur_gru_keeps_h_where_the_mask_is_false():
    """A history with gaps and a padded tail ends where the same history
    with those slots removed ends."""
    jcfg, tcfg = _configs("lstur")
    params = params_from_jax(_np_tree(_jax_init(jcfg)), device="cpu")
    rng = np.random.default_rng(4)
    xs = _t(rng.normal(size=(1, L, D)).astype(np.float32))
    h0 = _t(rng.normal(size=(1, D)).astype(np.float32))
    mask = _t(np.array([[True, False, True, True, False, False]]))
    got = news._gru_scan(params["gru"], xs, h0, mask)
    kept = xs[:, mask[0]]
    exp = news._gru_scan(params["gru"], kept, h0,
                         torch.ones(1, kept.shape[1], dtype=torch.bool))
    torch.testing.assert_close(got, exp, rtol=0, atol=0)
    jexp = jax.jit(jnews._gru_scan)(_np_tree(_jax_init(jcfg))["gru"],
                                    np.asarray(xs), np.asarray(h0),
                                    np.asarray(mask))
    _close(got, jexp, LOSS_TOL, "gru vs JAX")


# -------------------------------------------------------------- steps

@pytest.mark.parametrize("name", NAMES)
def test_three_train_steps_match_jax(name):
    jcfg, tcfg = _configs(name)
    batches = [_batch(seed=s) for s in (0, 1, 2)]
    jinit = _jax_init(jcfg)
    jparams, jopt = jinit, joptim.adam_init(jinit)
    jstep = jax.jit(joptim.make_train_step(
        lambda p, b: jnews.loss(p, jcfg, b), joptim.AdamConfig(**ADAM)))
    params = params_from_jax(_np_tree(jinit), device="cpu")
    opt = optim.adam_init(params)
    tstep = optim.make_train_step(lambda p, b: news.loss(p, tcfg, b),
                                  optim.AdamConfig(**ADAM))
    for i, b in enumerate(batches):
        jparams, jopt, jm = jstep(jparams, jopt, b)
        params, opt, tm = tstep(params, opt, {k: _t(v) for k, v in b.items()})
        _close(tm["loss"], jm["loss"], STEP_TOL, f"{name} loss at step {i}")
    exp = params_from_jax(_np_tree(jparams), device="cpu")
    worst = max(float((a.detach() - e).abs().max())
                for (_, a), (_, e) in zip(leaves(params), leaves(exp)))
    assert worst <= STEP_TOL, worst
    assert int(opt["count"]) == int(jopt["count"]) == 3
    # lr 1e-3 moves a leaf by ~3e-3 in three steps: hold each leaf's own
    # change to JAX's, relative to it, so an unmoved leaf cannot pass.
    # Two kinds of bias shift every score of a softmax by nearly the same
    # amount, which the softmax ignores: the key biases (exactly) and the
    # additive pools' score biases (to first order: tanh' ~ 1 at init).
    # Their gradients are cancellation noise (1e-18 to 1e-9, against 1e-5
    # to 1e-3 for the other leaves), whose relative error between two
    # summation orders is large; they are held by STEP_TOL above only
    start = dict(leaves(params_from_jax(_np_tree(jinit), device="cpu")))
    n_held = 0
    for (path, a), (_, e) in zip(leaves(params), leaves(exp)):
        if path.endswith(SHIFT_BIASES):
            continue
        got, want = a.detach() - start[path], e - start[path]
        size = float(want.norm())
        assert size > 0, f"{path} did not move in JAX"
        rel = float((got - want).norm()) / size
        assert rel <= STEP_DELTA_TOL, f"{name} {path}: change off by {rel:.2e}"
        n_held += 1
    assert n_held == sum(not p.endswith(SHIFT_BIASES) for p in start) >= 4


# ------------------------------------------------------ NRMS user encoder

def _user_inputs(Bu=4, Lu=7, d=16, seed=3):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(Bu, Lu, d)).astype(np.float32)
    mask = rng.random((Bu, Lu)) < 0.8
    mask[1] = False                       # an empty history
    mask[2, :3] = False                   # an empty prefix
    mask[3, 0] = True
    return theta, mask


@pytest.mark.parametrize("causal", [True, False])
def test_nrms_user_encoder_matches_jax(causal):
    d = 16
    theta, mask = _user_inputs(d=d)
    jcfg = jcore.UserModelConfig(news_dim=d, kind="nrms", causal=causal)
    tcfg = core.UserModelConfig(news_dim=d, kind="nrms", causal=causal)
    jp = jcore.init_user_model(jax.random.PRNGKey(4), jcfg)
    got_init = core.init_user_model(torch.Generator().manual_seed(0), tcfg)
    params = params_from_jax(_np_tree(jp), device="cpu")
    assert _shapes(got_init) == _shapes(params)
    assert "self_attn" in params and "b" in params["self_attn"]["k"]
    exp = jax.jit(lambda p, t, m: jcore.user_embeddings(p, jcfg, t, m))(
        jp, jnp.asarray(theta), jnp.asarray(mask))
    th = _t(theta).requires_grad_()
    got = core.user_embeddings(params, tcfg, th, _t(mask))
    assert tuple(got.shape) == ((4, 7, d) if causal else (4, d))
    _close(got.detach(), exp, USER_TOL, f"causal={causal}")
    # the attention really ran: the attentive pooling alone differs
    alone = (core.attentive_user_causal if causal else core.attentive_user)(
        params, _t(theta), _t(mask))
    assert float((alone - got.detach()).abs().max()) > 1e-4
    # and its gradient w.r.t. theta, through the self-attention
    w = np.random.default_rng(9).normal(size=exp.shape).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda t: jnp.sum(jcore.user_embeddings(
        jp, jcfg, t, jnp.asarray(mask)) * w)))(jnp.asarray(theta))
    (tgrad,) = torch.autograd.grad((got * _t(w)).sum(), th)
    _close(tgrad, jgrad, GRAD_TOL, "dtheta")


# ------------------------------------------------------------- Table 1

@pytest.mark.parametrize("n_news,n_users", [(500, 200), (2000, 300)])
def test_click_share_topk_is_exactly_jax(n_news, n_users):
    fracs = [0.0001, 0.01, 0.03, 0.05, 0.10, 0.20, 0.30, 1.0]
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    jc = jdata.make_corpus(jrng, n_news=n_news, zipf_a=1.6)
    jl = jdata.make_click_log(jrng, jc, n_users=n_users)
    tc = data.make_corpus(trng, n_news=n_news, zipf_a=1.6)
    tl = data.make_click_log(trng, tc, n_users=n_users)
    exp = jdata.click_share_topk(jl, jc, fracs)
    got = data.click_share_topk(tl, tc, fracs)
    assert list(got) == list(exp) == fracs
    for f in fracs:
        assert got[f] == exp[f], f
    assert got[1.0] == 1.0 and 0 < got[0.0001] < got[0.30]
