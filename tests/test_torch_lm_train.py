"""The port's LM training path against the JAX package.

The flash backward's plain version is held to JAX's XLA reference VJP
(``kernels/ref.py``) and to the Pallas backward kernels in interpret
mode; ``lm_loss`` and its gradients, and whole train steps of
``make_fn(cfg, "train")`` from a bridged JAX state, to the JAX package's
``lm_loss`` and ``optim.make_train_step``. Weights are drawn by the JAX
package and carried over with ``bridge``; inputs are made with numpy. The
JAX side runs attention through XLA (its default on the CPU), the port
through ``ops.flash_attention``'s plain versions: the same function.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import lm_family as jax_family  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd as pallas_bwd, flash_attention_fwd as pallas_fwd)
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import bridge, nn, optim  # noqa: E402
from repro_torch.configs import lm_family  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_fwd_plain)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

# tests/test_kernels.py's gradient tolerances
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LM = 1e-4                        # loss, gradients, parameters; f32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(got, exp) -> float:
    return float(np.abs(got.detach().float().numpy()
                        - np.asarray(exp, np.float32)).max())


def _qkvdo(B, Sq, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
             (B, Sq, Hq, D))]


# ------------------------------------------------------- flash backward

@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (1, 128, 128, 4, 4, 64),      # MHA
    (2, 128, 128, 8, 2, 32),      # GQA 4:1 (dk/dv summed over the group)
    (1, 64, 128, 4, 4, 32),       # Sq != Sk (q_off causal offset)
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_plain_matches_ref_vjp(B, Sq, Sk, Hq, Hkv, D, causal,
                                         dtype):
    q, k, v, do = _qkvdo(B, Sq, Sk, Hq, Hkv, D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    exp = ref.flash_attention_vjp(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                  jnp.asarray(do, jd), causal=causal)
    qt, kt, vt, dot = (torch.tensor(a).to(td) for a in (q, k, v, do))
    o, lse = flash_attention_fwd_plain(qt, kt, vt, causal)
    got = flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, causal)
    for name, a, b, like in zip(("dq", "dk", "dv"), got, exp,
                                (qt, kt, vt)):
        assert a.dtype == td and a.shape == like.shape, name
        assert _err(a, b) <= TOL_GRAD[dtype], name


def test_flash_bwd_plain_matches_the_pallas_kernels():
    """One GQA causal shape against the Pallas backward in interpret mode
    (each package's own forward residuals)."""
    q, k, v, do = _qkvdo(2, 128, 128, 4, 2, 32, seed=1)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o_j, lse_j = pallas_fwd(jq, jk, jv, causal=True, block_q=64, block_k=64,
                            interpret=True)
    exp = pallas_bwd(jq, jk, jv, o_j, lse_j, jdo, causal=True, block_q=64,
                     block_k=64, interpret=True)
    qt, kt, vt, dot = (torch.tensor(a) for a in (q, k, v, do))
    o, lse = flash_attention_fwd_plain(qt, kt, vt, True)
    got = flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert _err(a, b) <= TOL_GRAD["float32"], name


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_grads_on_the_cpu_go_through_the_function(
        causal):
    q, k, v, do = (torch.tensor(a) for a in _qkvdo(2, 48, 64, 6, 2, 16,
                                                   seed=2))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    o, lse = flash_attention_fwd_plain(q.detach(), k.detach(), v.detach(),
                                       causal)
    assert torch.equal(out.detach(), o)
    exp = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o,
                                    lse, do, causal)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    # autograd over the plain forward: the function the kernels implement
    ref_grads = torch.autograd.grad(
        flash_attention_fwd_plain(q, k, v, causal)[0], (q, k, v), do)
    for a, b in zip(got, ref_grads):
        assert float((a - b).abs().max()) <= 1e-5
    assert set(ops.launch_counts().values()) == {0}


def test_attention_grads_kernel_and_plain_impls_agree_on_the_cpu():
    cfg = nn.AttnConfig(d_model=64, n_heads=4, n_kv=2, head_dim=16,
                        qk_norm=True, qkv_bias=True)
    params = nn.init_attention(torch.Generator().manual_seed(0), cfg)
    flat = [p.requires_grad_() for _, p in leaves(params)]
    x = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(1))
    grads = {}
    for impl in ("kernel", "plain"):
        out = nn.attention(params, x, cfg, impl=impl)
        grads[impl] = torch.autograd.grad(out.square().sum(), flat)
    for a, b in zip(grads["kernel"], grads["plain"]):
        assert float((a - b).abs().max()) <= 1e-5


# ------------------------------------------------------------- lm_loss

_LM = {"qwen3-14b": (jax_family.QWEN3_14B, lm_family.QWEN3_14B),
       "chatglm3-6b": (jax_family.CHATGLM3_6B, lm_family.CHATGLM3_6B),
       "qwen2-72b": (jax_family.QWEN2_72B, lm_family.QWEN2_72B)}
SEQ, CHUNK = 32, 8


def _cfgs(name, **over):
    """The JAX and port reduced configs with remat and the chunked loss
    on, as the full configs have them."""
    over = dict(remat=True, loss_chunk=CHUNK, **over)
    return (dataclasses.replace(jax_family.reduced_lm(_LM[name][0]), **over),
            dataclasses.replace(lm_family.reduced_lm(_LM[name][1]), **over))


def _jax_params(cfg, seed=0):
    params = jax_lm.init(jax.random.PRNGKey(seed), cfg)
    if cfg.qkv_bias:                # zeros at init: make them count
        rng = np.random.default_rng(seed + 5)
        for name in ("q", "k", "v"):
            b = params["layers"]["attn"][name]["b"]
            params["layers"]["attn"][name]["b"] = jnp.asarray(
                rng.normal(size=b.shape) * 0.1, b.dtype)
    return params


def _batch(vocab, B, seed=3):
    """tokens, and labels = tokens shifted left by one with -100 at the
    last position and at a few ignored positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, SEQ)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100)], 1)
    labels[rng.random(labels.shape) < 0.2] = -100
    return {"tokens": toks, "labels": labels.astype(np.int32)}


def _port_batch(b):
    return {k: torch.tensor(v).long() for k, v in b.items()}


@pytest.mark.parametrize("name", list(_LM))
def test_lm_loss_and_grads_match_jax(name):
    jcfg, pcfg = _cfgs(name)
    params = _jax_params(jcfg)
    batch = _batch(jcfg.vocab, 2)
    (exp_loss, exp_m), exp_g = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.lm_loss(p, jcfg, b), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    p_t = bridge.params_from_jax(_np(params), "cpu")
    flat = [p.requires_grad_() for _, p in leaves(p_t)]
    grads = {}
    for cfg in (pcfg, dataclasses.replace(pcfg, remat=False, loss_chunk=0)):
        loss, metrics = lm.lm_loss(p_t, cfg, _port_batch(batch))
        grads[cfg.remat] = torch.autograd.grad(loss, flat)
        assert _err(loss, exp_loss) <= TOL_LM, cfg
        assert _err(metrics["lm_loss"], exp_m["lm_loss"]) <= TOL_LM
        assert float(metrics["moe_aux"]) == float(exp_m["moe_aux"]) == 0.0
    exp = bridge.params_from_jax(_np(exp_g), "cpu")
    for (path, e), a, b in zip(leaves(exp), grads[True], grads[False]):
        assert _err(a, e) <= TOL_LM, path
        # remat and the chunked loss change what is stored, not the math
        assert float((a - b).abs().max()) <= 1e-6, path


def test_lm_loss_ignores_negative_labels_and_matches_a_direct_sum():
    _, pcfg = _cfgs("qwen3-14b")
    params = lm.init(torch.Generator().manual_seed(0), pcfg)
    batch = _port_batch(_batch(pcfg.vocab, 2, seed=4))
    with torch.no_grad():
        loss, metrics = lm.lm_loss(params, pcfg, batch)
        logits, _ = lm.forward(params, pcfg, batch["tokens"])
    lab = batch["labels"]
    valid = lab >= 0
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
    assert abs(float(loss) - float(nll[valid].mean())) <= 1e-5
    assert float(loss) == float(metrics["lm_loss"])
    lab_all = torch.full_like(lab, -100)
    with torch.no_grad():
        zero, _ = lm.lm_loss(params, pcfg, {"tokens": batch["tokens"],
                                            "labels": lab_all})
    assert float(zero) == 0.0


# --------------------------------------------------------- train steps

def _run_steps(name, accum_steps, B, count, n_steps=3):
    """``n_steps`` steps of both packages from one bridged state whose
    step count starts at ``count``: 0 is a fresh state, in the schedule's
    warm-up (lr 1.5e-6 at step 1, parameters move by ~1e-5); 1000 is past
    it (lr ~2.9e-4, parameters move by ~3e-3, 30x the tolerance)."""
    jcfg, pcfg = _cfgs(name)
    jopt_cfg = dataclasses.replace(jax_family.TRAIN_OPT,
                                   accum_steps=accum_steps)
    topt_cfg = dataclasses.replace(lm_family.TRAIN_OPT,
                                   accum_steps=accum_steps)
    params = _jax_params(jcfg, seed=1)
    jopt = dict(joptim.adam_init(params), count=jnp.int32(count))
    p_t = bridge.params_from_jax(_np(params), "cpu")
    o_t = bridge.lm_opt_from_jax(_np(jopt), "cpu")
    jstep = jax.jit(joptim.make_train_step(
        lambda p, b: jax_lm.lm_loss(p, jcfg, b), jopt_cfg,
        joptim.linear_warmup_cosine(3e-4, 200, 10000)))
    tstep = lm_family.make_fn(pcfg, "train") if accum_steps == 1 else \
        optim.make_train_step(lambda p, b: lm.lm_loss(p, pcfg, b), topt_cfg,
                              lm_family.TRAIN_SCHEDULE)
    for i in range(n_steps):
        batch = _batch(jcfg.vocab, B, seed=10 + i)
        params, jopt, jm = jstep(params, jopt,
                                 jax.tree.map(jnp.asarray, batch))
        p_t, o_t, tm = tstep(p_t, o_t, _port_batch(batch))
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            assert _err(torch.as_tensor(tm[key]), jm[key]) <= TOL_LM, \
                (i, key)
    assert int(o_t["count"]) == int(jopt["count"]) == count + n_steps
    trees = {"params": (p_t, params), "m": (o_t["m"], jopt["m"]),
             "v": (o_t["v"], jopt["v"])}
    for what, (got, exp) in trees.items():
        exp = bridge.params_from_jax(_np(exp), "cpu")
        for (path, a), (_, b) in zip(leaves(got), leaves(exp)):
            assert _err(a, b.numpy()) <= TOL_LM, (what, path)


@pytest.mark.parametrize("count", [0, 1000])
@pytest.mark.parametrize("name", list(_LM))
def test_three_train_steps_from_a_bridged_state_match_jax(name, count):
    _run_steps(name, accum_steps=1, B=2, count=count)


@pytest.mark.parametrize("count", [0, 1000])
@pytest.mark.parametrize("name", list(_LM))
def test_three_accumulated_train_steps_match_jax(name, count):
    _run_steps(name, accum_steps=2, B=4, count=count)


def test_train_batch_schedule_and_one_card_cut():
    cfg = lm_family.reduced_lm(lm_family.QWEN3_14B)
    b = lm_family.train_batch(cfg, 2, 16, torch.Generator().manual_seed(0),
                              "cpu")
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < cfg.vocab
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert bool((b["labels"][:, -1] == -100).all())
    jsched = joptim.linear_warmup_cosine(3e-4, 200, 10000)
    for c in (1, 199, 200, 5000, 10000):
        got = float(lm_family.TRAIN_SCHEDULE(torch.tensor(c,
                                                          dtype=torch.int32)))
        assert abs(got - float(jsched(jnp.int32(c)))) <= 1e-10, c
    cut = dataclasses.replace(lm_family.QWEN3_14B,
                              n_layers=lm_family.ONE_CARD_TRAIN["n_layers"])
    assert cut.param_count() == 4_198_323_200


def test_train_step_refuses_a_batch_that_does_not_split():
    _, pcfg = _cfgs("qwen3-14b")
    params = lm.init(torch.Generator().manual_seed(0), pcfg)
    step = optim.make_train_step(
        lambda p, b: lm.lm_loss(p, pcfg, b),
        dataclasses.replace(lm_family.TRAIN_OPT, accum_steps=2),
        lm_family.TRAIN_SCHEDULE)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, optim.adam_init(params),
             _port_batch(_batch(pcfg.vocab, 3)))


def test_lm_opt_from_jax_splits_the_stacked_moments():
    jcfg, _ = _cfgs("chatglm3-6b")
    params = _jax_params(jcfg)
    opt = joptim.adam_init(params)
    opt = {"m": jax.tree.map(lambda a: a + 1.5, opt["m"]),
           "v": jax.tree.map(lambda a: a + 0.25, opt["v"]),
           "count": jnp.int32(7)}
    got = bridge.lm_opt_from_jax(_np(opt), "cpu")
    assert len(got["m"]["layers"]) == jcfg.n_layers
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 7
    for tree, value in ((got["m"], 1.5), (got["v"], 0.25)):
        for path, t in leaves(tree):
            assert t.dtype == torch.float32, path
            assert bool((t == value).all()), path
    exp = bridge.params_from_jax(_np(params), "cpu")
    assert [p for p, _ in leaves(got["m"])] == [p for p, _ in leaves(exp)]
    assert all(a.shape == b.shape for (_, a), (_, b) in
               zip(leaves(got["v"]), leaves(exp)))


# --------------------------------------------------------------- Adam

def _adam_case(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(37, 5, generator=g),
              "e": torch.randn(11, 3, generator=g).to(torch.bfloat16),
              "s": torch.randn(6, generator=g), "n": torch.randn(4, 2,
                                                                generator=g)}
    grads = {k: torch.randn(v.shape, generator=g).to(v.dtype) * 3
             for k, v in params.items()}
    grads["n"] = None
    return params, grads


@pytest.mark.parametrize("commit", [None, True])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adam_update_by_row_chunks_matches_whole_leaves(monkeypatch,
                                                        commit, clip):
    """The in-place update of a leaf split into row chunks gives the same
    bits as the whole leaf at once (chunks of 7 elements: 1-2 rows).
    With the clip on, the norm's sum of squares runs by chunks too, in
    another order: then within f32 rounding."""
    cfg = optim.AdamConfig(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    commit = None if commit is None else torch.tensor(commit)
    out = []
    for chunk in (adam.CHUNK, 7):
        monkeypatch.setattr(adam, "CHUNK", chunk)
        params, grads = _adam_case()
        state = optim.adam_init(params)
        for _ in range(3):
            g = {k: None if v is None else v.clone()
                 for k, v in grads.items()}
            params, state, m = optim.adam_update(
                params, g, state, cfg,
                optim.linear_warmup_cosine(1e-2, 2, 10), commit=commit)
        out.append((params, state, m))
    (p1, s1, m1), (p2, s2, m2) = out
    tol = 0.0 if clip == 0 else 1e-6
    for a, b in ((p1, p2), (s1["m"], s2["m"]), (s1["v"], s2["v"]),
                 ({"norm": m1["grad_norm"]}, {"norm": m2["grad_norm"]})):
        for (path, x), (_, y) in zip(leaves(a), leaves(b)):
            torch.testing.assert_close(x, y, rtol=tol, atol=tol, msg=path)
    assert int(s1["count"]) == int(s2["count"]) == 3


def test_clip_scales_in_place_and_a_shared_gradient_once():
    # autograd hands the one gradient of a + b to both leaves
    a, b = (torch.zeros(4, 3, requires_grad=True) for _ in range(2))
    ga, gb = torch.autograd.grad(((a + b) * 2.0).sum(), [a, b])
    assert ga.data_ptr() == gb.data_ptr()
    g2 = torch.full((5,), 1.0, dtype=torch.bfloat16)
    norm = optim.clip_by_global_norm([ga, g2, gb], 1.0)
    exp = float(np.sqrt(2 * 12 * 4.0 + 5 * 1.0))
    assert abs(float(norm) - exp) <= 1e-5
    scale = 1.0 / exp
    assert torch.allclose(ga, torch.full((4, 3), 2.0 * scale))
    assert torch.equal(g2, torch.full((5,), 1.0, dtype=torch.bfloat16)
                       * torch.tensor(scale).to(torch.bfloat16))


def test_adam_takes_a_broadcast_gradient_view():
    """The gradient of a plain sum comes back from autograd as a
    zero-stride view; the in-place clip must not write through it."""
    params = {"a": torch.ones(4, 3), "b": torch.ones(5)}
    flat = [p.requires_grad_() for _, p in leaves(params)]
    grads = torch.autograd.grad(params["a"].sum() * 3 + params["b"].sum(),
                                flat)
    assert 0 in grads[0].stride()
    state = optim.adam_init(params)
    params, state, m = optim.adam_update(
        params, adam.unflatten(params, grads), state,
        optim.AdamConfig(lr=0.1, grad_clip=1.0))
    exp = float(np.sqrt(12 * 9.0 + 5 * 1.0))
    assert abs(float(m["grad_norm"]) - exp) <= 1e-5
    # Adam's first step moves every element by lr against its sign
    assert torch.allclose(params["a"].detach(), torch.full((4, 3), 0.9))
    assert torch.allclose(params["b"].detach(), torch.full((5,), 0.9))
