"""The port's training slice (Algorithm 1) against the JAX package.

Each module is held to its JAX counterpart on the same numpy inputs, with
the random draws injected: the cache gate's uniform and the negatives
come from the JAX keys, so the two packages see the same numbers. The
train step runs the JAX side with ``attn_impl="xla"``; the port's bus
attention on the CPU is its plain forward and backward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore, data as jdata, optim as joptim  # noqa: E402
from repro.configs.speedyfeed_arch import (  # noqa: E402
    make_sf_train_step as jmake_step)
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import core, data, optim, training  # noqa: E402
from repro_torch.bridge import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.configs.speedyfeed_arch import make_sf_train_step  # noqa
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

FLOAT_TOL = 1e-6       # gathers, selects and one scatter: exact up to f32
USER_TOL = 1e-5        # one dense, tanh, exp and two prefix sums in f32
OPT_TOL = 1e-6         # Adam's elementwise arithmetic in f32
STEP_TOL = 1e-4        # five full train steps (ROADMAP Queue 1 item 4)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, exp, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(exp, np.float64), rtol=0,
                               atol=tol, err_msg=what)


# ------------------------------------------------------------------ cache

def _cache_case(kind, gate_key):
    ccfg = dict(n_news=500, news_dim=8, gamma=20, beta=2e-2,
                encode_budget=24)
    rng = np.random.default_rng(1)
    M, step = 64, 100
    ids = np.zeros(M, np.int32)
    ids[1:50] = rng.choice(np.arange(1, 500), 49, replace=False)
    emb = rng.normal(size=(500, 8)).astype(np.float32)
    written = np.full(500, -(2 ** 30), np.int32)
    if kind in ("warm", "expired"):
        written[ids[1:40]] = step - rng.integers(0, 21, 39)       # fresh
    if kind == "expired":
        written[ids[20:35]] = step - rng.integers(21, 60, 15)     # stale
    new_emb = rng.normal(size=(24, 8)).astype(np.float32)
    return ccfg, ids, emb, written, new_emb, step, jax.random.PRNGKey(
        gate_key)


@pytest.mark.parametrize("kind,gate_key", [
    ("cold", 0), ("warm", 0), ("warm", 5), ("expired", 0)])
def test_cache_plan_assemble_refresh_match_jax(kind, gate_key):
    ccfg, ids, emb, written, new_emb, step, key = _cache_case(kind, gate_key)
    jcfg, tcfg = jcore.CacheConfig(**ccfg), core.CacheConfig(**ccfg)
    jstate = jcore.CacheState(jnp.asarray(emb), jnp.asarray(written))
    jplan = jcore.cache_plan(jstate, jnp.asarray(ids), jnp.int32(step), key,
                             jcfg)
    u = float(jax.random.uniform(key))
    tstate = core.CacheState(_t(emb).clone(), _t(written).clone())
    tplan = core.cache_plan(tstate, _t(ids), step, u, tcfg)

    for name in ("enc_pos", "enc_valid", "reuse", "overflow", "expired",
                 "missing"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)), name)
    _close(tplan.p_t, jplan.p_t, FLOAT_TOL, "p_t")
    assert int(tplan.reuse.sum()) > 0 or kind == "cold" or u >= tplan.p_t

    got = core.assemble_embeddings(tstate, tplan, _t(ids), _t(new_emb))
    exp = jcore.assemble_embeddings(jstate, jplan, jnp.asarray(ids),
                                    jnp.asarray(new_emb))
    _close(got, exp, FLOAT_TOL, "assembled")

    jnew = jcore.cache_refresh(jstate, jplan, jnp.asarray(ids),
                               jnp.asarray(new_emb), jnp.int32(step))
    tnew = core.cache_refresh(tstate, tplan, _t(ids), _t(new_emb), step)
    _close(tnew.emb, jnew.emb, FLOAT_TOL, "refreshed emb")
    np.testing.assert_array_equal(tnew.written_step.numpy(),
                                  np.asarray(jnew.written_step))


def test_assembled_rows_pass_gradients_only_to_encoded_slots():
    ccfg, ids, emb, written, new_emb, step, key = _cache_case("warm", 0)
    state = core.CacheState(_t(emb), _t(written))
    plan = core.cache_plan(state, _t(ids), step, 0.0,
                           core.CacheConfig(**ccfg))
    new = _t(new_emb).requires_grad_()
    core.assemble_embeddings(state, plan, _t(ids), new).sum().backward()
    expect = plan.enc_valid[:, None].float().expand_as(new)
    assert torch.equal(new.grad, expect)


def test_cache_refresh_commit_false_writes_nothing():
    ccfg, ids, emb, written, new_emb, step, _ = _cache_case("cold", 0)
    state = core.CacheState(_t(emb).clone(), _t(written).clone())
    plan = core.cache_plan(state, _t(ids), step, 1.0,
                           core.CacheConfig(**ccfg))
    core.cache_refresh(state, plan, _t(ids), _t(new_emb), step,
                       commit=torch.tensor(False))
    assert torch.equal(state.emb, _t(emb))
    assert torch.equal(state.written_step, _t(written))


# ------------------------------------------------------- centralized set

@pytest.mark.parametrize("m_cap,with_cand", [(64, True), (16, True),
                                             (40, False)])
def test_gather_dedup_and_dispatch_match_jax(m_cap, with_cand):
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 60, (4, 9)).astype(np.int32)
    hist[:, -3:] = 0                                  # pads
    cand = rng.integers(1, 80, (4, 2)).astype(np.int32) if with_cand \
        else None
    exp = jcore.gather_dedup(jnp.asarray(hist), None if cand is None
                             else jnp.asarray(cand), m_cap=m_cap)
    got = core.gather_dedup(_t(hist), None if cand is None else _t(cand),
                            m_cap=m_cap)
    for name in ("ids", "inv_hist", "inv_cand", "overflow"):
        e, g = getattr(exp, name), getattr(got, name)
        if e is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), name)
    assert (m_cap < 40) == (int(got.overflow) > 0)
    emb = rng.normal(size=(m_cap, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        core.dispatch(_t(emb), got.inv_hist).numpy(),
        np.asarray(jcore.dispatch(jnp.asarray(emb), exp.inv_hist)))


# ------------------------------------------------------ user model, loss

def _user_inputs(B=4, L=7, d=16, seed=3):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(B, L, d)).astype(np.float32)
    mask = rng.random((B, L)) < 0.8
    mask[1] = False                       # an empty history
    mask[2, :3] = False                   # an empty prefix
    jp = jax.tree.map(np.asarray, jcore.init_user_model(
        jax.random.PRNGKey(4), jcore.UserModelConfig(news_dim=d)))
    return theta, mask, jp


def test_attentive_user_causal_matches_jax():
    theta, mask, jp = _user_inputs()
    exp = jcore.user_model.attentive_user_causal(jp, theta, mask)
    got = core.attentive_user_causal(params_from_jax(jp, device="cpu"),
                                     _t(theta), _t(mask))
    _close(got, exp, USER_TOL)
    assert float(got[1].abs().max()) == 0.0       # empty history -> zeros


@pytest.mark.parametrize("with_inv", [True, False])
def test_ar_loss_matches_jax(with_inv):
    rng = np.random.default_rng(5)
    B, L, d, M, N = 4, 9, 16, 30, 4
    mu = rng.normal(size=(B, L, d)).astype(np.float32)
    emb_m = rng.normal(size=(M, d)).astype(np.float32)
    ids_m = np.concatenate([[0], rng.choice(np.arange(1, 99), M - 1,
                                            replace=False)]).astype(np.int32)
    inv = rng.integers(0, M, (B, L)).astype(np.int32)
    theta = emb_m[inv]
    mask = rng.random((B, L)) < 0.85
    neg = np.array(jcore.sample_negatives(jax.random.PRNGKey(6), M,
                                          (B, L - 1), N))
    hi = inv if with_inv else None
    if with_inv:
        neg[0, 0, 0] = inv[0, 1]   # an accidental positive, masked
    else:
        # an unmasked accidental positive ties the positive's score, and
        # argmax then follows the rounding of two different einsums
        while (hit := neg == inv[:, 1:, None]).any():
            neg[hit] = neg[hit] % (M - 1) + 1
    eloss, em = jcore.ar_loss(mu, theta, mask, emb_m, ids_m, neg,
                              hist_inv=hi)
    gloss, gm = core.ar_loss(_t(mu), _t(theta), _t(mask), _t(emb_m),
                             _t(ids_m), _t(neg),
                             hist_inv=None if hi is None else _t(hi))
    _close(gloss, eloss, USER_TOL, "loss")
    _close(gm["ar_acc"], em["ar_acc"], USER_TOL, "acc")
    assert int(gm["n_predictions"]) == int(em["n_predictions"])


def test_sample_negatives_range_and_shape():
    gen = torch.Generator().manual_seed(0)
    neg = core.sample_negatives(gen, 50, (3, 4), 5)
    assert neg.shape == (3, 4, 5) and neg.min() >= 1 and neg.max() < 50


# ------------------------------------------------------------- optimizer

def _opt_tree(rng):
    return {"plm": {"layers": {"w": rng.normal(size=(2, 4, 3))},
                    "emb": rng.normal(size=(6, 3))},
            "user": {"q": rng.normal(size=(5,)), "b": np.zeros(3)}}


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, grad_clip=1.0, group_lr_scales=(("plm", 0.08),)),
    dict(lr=1e-2, grad_clip=0.0, weight_decay=0.01),
])
def test_adam_update_matches_jax(kw):
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          _opt_tree(rng))
    jcfg, tcfg = joptim.AdamConfig(**kw), optim.AdamConfig(**kw)
    jp, jst = params, joptim.adam_init(params)
    tp = params_from_jax(params, device="cpu")
    tst = optim.adam_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3)
                         .astype(np.float32), params)
        g["user"]["b"] = np.zeros(3, np.float32)     # a leaf with no grad
        jp, jst, jm = joptim.adam_update(jp, g, jst, jcfg)
        tg = params_from_jax(g, device="cpu")
        tg["user"]["b"] = None
        tp, tst, tm = optim.adam_update(tp, tg, tst, tcfg)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-4, "grad norm")
    exp_p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for tree, etree in ((tp, exp_p), (tst["m"], params_from_jax(
            jax.tree.map(np.asarray, jst["m"]), device="cpu")),
            (tst["v"], params_from_jax(jax.tree.map(np.asarray, jst["v"]),
                                       device="cpu"))):
        for (path, a), (_, b) in zip(leaves(tree), leaves(etree)):
            _close(a.detach(), b, OPT_TOL, path)
    assert int(tst["count"]) == int(jst["count"]) == 3


def test_adam_update_commit_false_holds_everything():
    tp = params_from_jax(_opt_tree(np.random.default_rng(8)), device="cpu")
    tp = {k: {n: v.float() for n, v in leaves(sub)} for k, sub in tp.items()}
    st = optim.adam_init(tp)
    before = [p.clone() for _, p in leaves(tp)]
    g = {k: {n: torch.full_like(v, float("nan")) for n, v in sub.items()}
         for k, sub in tp.items()}
    tp, st, _ = optim.adam_update(tp, g, st, optim.AdamConfig(),
                                  commit=torch.tensor(False))
    assert all(torch.equal(a, b) for a, (_, b) in zip(before, leaves(tp)))
    assert int(st["count"]) == 0
    assert all(float(v.abs().max()) == 0 for _, v in leaves(st["m"]))


def test_adam_refuses_what_is_not_ported():
    p = {"w": torch.zeros(2)}
    with pytest.raises(NotImplementedError):
        optim.adam_update(p, p, optim.adam_init(p),
                          optim.AdamConfig(dp_compression="int8"))


@pytest.mark.parametrize("name,args", [
    ("constant", (1e-3,)), ("cosine_decay", (1e-3, 10)),
    ("linear_warmup_cosine", (1e-3, 3, 10))])
def test_schedules_match_jax(name, args):
    from repro.optim import schedules as jsched
    from repro_torch.optim import schedules as tsched
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for s in (0, 1, 3, 7, 12):
        _close(tf(torch.tensor(s, dtype=torch.int32)),
               jf(jnp.int32(s)), 1e-9, f"step {s}")


# --------------------------------------------------------- train steps

def _loader_batches(n=1, seed=3, **over):
    jcfg = jtrain.small_speedyfeed_config(**over)
    _, log, store, lcfg = jtrain.make_loader(jcfg, n_news=400, n_users=80)
    b = jdata.DynamicBatcher(log, store, lcfg, n_threads=1, seed=seed)
    b.start()
    out = []
    try:
        while True:
            item = b.get(timeout=10)
            if item is jdata.EPOCH_END:
                return out
            out.append(item)
    finally:
        b.stop()


def test_five_train_steps_from_bridged_state_match_jax():
    over = dict(encode_budget=32)          # overflow: encode and reuse mix
    jcfg = jtrain.small_speedyfeed_config(attn_impl="xla", **over)
    tcfg = train.small_speedyfeed_config(**over)
    batches = [b for b in _loader_batches(**over) if b["_bucket"] == 16]
    batches = [{k: v for k, v in b.items() if not k.startswith("_")}
               for b in batches[:2]]
    key = jax.random.PRNGKey(0)
    jparams, jcache = jcore.speedyfeed_state(jcfg, key)
    jopt = joptim.adam_init(jparams)
    step0 = 100                           # p_t = 0.86: the gate opens
    state = state_from_jax(jax.tree.map(np.asarray, jparams),
                           jax.tree.map(np.asarray, jopt),
                           (np.asarray(jcache.emb),
                            np.asarray(jcache.written_step)),
                           step0, device="cpu")
    jstep = jax.jit(jmake_step(jcfg))
    tstep = make_sf_train_step(tcfg)
    params, opt, cache = state.params, state.opt, state.cache
    reused = 0
    for i in range(5):
        step = step0 + i
        batch = batches[i % 2]
        rng = jax.random.fold_in(key, step)
        rng_cache, rng_neg = jax.random.split(rng)
        u = float(jax.random.uniform(rng_cache))
        neg = jcore.sample_negatives(rng_neg, jcfg.merged_cap,
                                     batch["hist_mask"][:, 1:].shape,
                                     jcfg.n_neg)
        jparams, jopt, jcache, jm = jstep(jparams, jopt, jcache,
                                          jnp.int32(step), rng, batch)
        tb = {k: _t(v) for k, v in batch.items()}
        params, opt, cache, tm = tstep(params, opt, cache, step, None, tb,
                                       u=u, neg_idx=_t(neg))
        _close(tm["loss"], jm["loss"], STEP_TOL, f"loss at step {step}")
        assert int(tm["encoded"]) == int(jm["encoded"])
        assert int(tm["reused"]) == int(jm["reused"])
        reused += int(tm["reused"])
    assert reused > 0
    exp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    worst = max(float((a.detach() - b).abs().max())
                for (_, a), (_, b) in zip(leaves(params), leaves(exp)))
    assert worst <= STEP_TOL, worst
    _close(cache.emb, jcache.emb, STEP_TOL, "cache")
    np.testing.assert_array_equal(cache.written_step.numpy(),
                                  np.asarray(jcache.written_step))
    assert int(opt["count"]) == int(jopt["count"]) == 5


def test_dynamic_batcher_is_bit_identical_to_jax():
    cfg = train.small_speedyfeed_config()
    _, log, store, lcfg = train.make_loader(cfg, n_news=400, n_users=80)
    b = data.DynamicBatcher(log, store, lcfg, n_threads=1, seed=3).start()
    got = []
    try:
        while (item := b.get(timeout=10)) is not data.EPOCH_END:
            got.append(item)
    finally:
        b.stop()
    exp = _loader_batches()
    assert len(got) == len(exp) > 3
    for g, e in zip(got, exp):
        assert g.keys() == e.keys()
        assert g["_bucket"] == e["_bucket"] and g["_stats"] == e["_stats"]
        for k in ("news_tokens", "news_freq", "news_ids", "hist_inv",
                  "hist_mask"):
            assert g[k].dtype == e[k].dtype, k
            np.testing.assert_array_equal(g[k], e[k], k)


def _synth_batch(cfg):
    b = data.synth_centralized_batch(
        m_cap=cfg.merged_cap, n_segments=cfg.plm.n_segments,
        seg_len=cfg.plm.seg_len, b_cap=cfg.batch_users,
        hist_len=cfg.hist_len, vocab=cfg.plm.vocab, seed=0)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_nonfinite_guard_holds_the_state_and_advances_step():
    cfg = train.small_speedyfeed_config()
    trainer = training.get_trainer("speedyfeed", cfg=cfg, device="cpu")
    state = trainer.init_state(0)
    batch = _synth_batch(cfg)
    ids = batch["news_ids"].long()
    # at step 1000 p_t rounds to 1 in f32, so the gate is open: every
    # cached row is fresh and infinite, and the loss is not finite. Half
    # the merged set was never cached: those rows are encoded and would
    # be written without the guard.
    state.cache.emb.fill_(float("inf"))
    state.cache.written_step.fill_(1000)
    state.cache.written_step[ids[1::2]] = core.NEVER
    state = state._replace(step=1000)
    before = [t.clone() for t in (*(p for _, p in leaves(state.params)),
                                  *(m for _, m in leaves(state.opt)),
                                  state.cache.emb, state.cache.written_step)]
    new, metrics = trainer.step(state, batch)
    assert new.step == 1001
    assert not bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["nonfinite_step"]) == 1.0
    assert int(metrics["encoded"]) > 0
    after = [*(p for _, p in leaves(new.params)),
             *(m for _, m in leaves(new.opt)), new.cache.emb,
             new.cache.written_step]
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_trainer_fit_refuses_checkpoints(tmp_path):
    """``fit`` resumes from ``ckpt_dir``, and refuses a checkpoint of
    another configuration (a shape mismatch: ValueError, which
    ``fit_supervised`` does not retry) before any step."""
    other = training.get_trainer(
        "speedyfeed", cfg=train.small_speedyfeed_config(news_dim=16),
        device="cpu")
    training.save_state(str(tmp_path), 1, other.init_state(0))
    trainer = training.get_trainer(
        "speedyfeed", cfg=train.small_speedyfeed_config(), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        trainer.fit(lambda e: None, steps=1, ckpt_dir=str(tmp_path))


def test_metrics_buffer_drains_in_one_pass():
    buf = training.MetricsBuffer()
    for i in range(3):
        buf.append({"loss": torch.tensor(float(i)), "n": i,
                    "nonfinite_step": torch.tensor(0.0)})
    last = buf.drain()
    assert buf.losses == [0.0, 1.0, 2.0] and last["loss"] == 2.0
    assert list(buf.history["n"]) == [0.0, 1.0, 2.0]


def test_train_speedyfeed_runs_end_to_end_on_the_cpu():
    res = train.train_speedyfeed(steps=4, device="cpu", log_every=2)
    assert res.steps_done == 4 and len(res.losses) == 4
    assert all(np.isfinite(res.losses))
    assert sum(res.bucket_steps.values()) == 4
    assert res.state.step == 4 and int(res.state.opt["count"]) == 4
    assert int((res.state.cache.written_step >= 0).sum()) > 0
    assert dataclasses.is_dataclass(res)
