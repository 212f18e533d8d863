"""The port's conventional workflow and speedup ladder against the JAX
package.

``click_loss``, ``build_conventional_batch``, ``conventional_forward``
and ``make_conventional_step`` are held to their JAX counterparts on the
same numpy inputs and bridged parameters, at ``tiny_cfg``'s widths
(tests/test_core_speedyfeed.py) with K=3, so the bus path runs. The JAX
side runs with ``attn_impl="xla"``; the port's bus attention on the CPU
is its plain forward and backward. The ladder
(``repro_torch.launch.speedup``) runs at ``bench`` on the CPU, and its
central rung's loss is held to the same calls made in JAX with the
negatives injected.
"""
import json
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore, data as jdata, optim as joptim  # noqa: E402
from repro.configs.speedyfeed_arch import (  # noqa: E402
    make_conventional_step as jmake_conv_step)
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import core, data, training  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.speedyfeed_arch import (  # noqa: E402
    make_conventional_step)
from repro_torch.launch import speedup, train  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-6        # one einsum, a select and a log-softmax in f32
FWD_TOL = 1e-5         # the whole encoder, the user model and the loss
BUSLM_GRAD_TOL = 1e-4  # tests/test_torch_train_kernels.py's
STEP_TOL = 1e-4        # tests/test_torch_train.py's, for train steps
STEP_DELTA_TOL = 1e-3  # a leaf's change over three steps, relative to JAX's
# tests/test_core_speedyfeed.py:tiny_cfg's widths, with K=3
TINY = dict(vocab=300, n_layers=1, d_model=32, n_heads=4, d_ff=64,
            n_segments=3, seg_len=8, news_dim=16, n_news=128, gamma=5,
            beta=1.0, encode_budget=12, batch_users=4, hist_len=8,
            merged_cap=32, n_neg=3)
# benchmarks/common.py:bench_cfg's keywords, for the JAX side
BENCH = dict(vocab=5000, n_layers=2, d_model=64, n_heads=4, d_ff=128,
             n_segments=3, seg_len=16, news_dim=32, n_news=1201, gamma=20,
             beta=2e-2, encode_budget=128, batch_users=16, hist_len=30,
             merged_cap=384, n_neg=4)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(**over):
    kw = {**TINY, **over}
    return (jcore.make_config(attn_impl="xla", **kw),
            core.make_config(**kw))


# ------------------------------------------------------------ click_loss

def test_click_loss_matches_jax():
    rng = np.random.default_rng(0)
    B, C, d = 10, 5, 8
    user = rng.normal(size=(B, d)).astype(np.float32)
    cand = rng.normal(size=(B, C, d)).astype(np.float32)
    labels = (np.arange(B) % C).astype(np.int32)   # every position
    mask = rng.random((B, C)) < 0.6
    mask[np.arange(B), labels] = True
    mask[0] = False
    mask[0, labels[0]] = True                      # one candidate only
    assert (~mask).any()
    eloss, em = jcore.click_loss(*(jnp.asarray(x)
                                   for x in (user, cand, labels, mask)))
    gloss, gm = core.click_loss(*(_t(x) for x in (user, cand, labels, mask)))
    np.testing.assert_allclose(float(gloss), float(eloss), rtol=0,
                               atol=LOSS_TOL)
    assert float(gm["click_acc"]) == float(em["click_acc"])
    assert 0 < float(gm["click_acc"]) < 1


# ------------------------------------------------------ the batch builder

@pytest.fixture(scope="module")
def stores():
    """The JAX and the port's loader over the same 300-news corpus; L=8."""
    jcfg, tcfg = _configs()
    _, jlog, jstore, jlcfg = jtrain.make_loader(jcfg, n_news=300,
                                                n_users=60)
    _, log, store, lcfg = train.make_loader(tcfg, n_news=300, n_users=60)
    return (jlog, jstore, jlcfg), (log, store, lcfg)


def _instances(log, n, L):
    """``n`` histories with pad slots, then one longer than L + 1."""
    insts = [h for h in log.histories if 2 <= len(h) <= L][:n]
    long = np.concatenate(log.histories[:6])
    assert len(long) > L + 1
    return insts + [long]


@pytest.mark.parametrize("n_cands", [2, 4])
def test_build_conventional_batch_is_bit_identical_to_jax(stores, n_cands):
    (jlog, jstore, jlcfg), (log, store, lcfg) = stores
    L = lcfg.hist_len
    insts = _instances(log, 6, L)
    jinsts = _instances(jlog, 6, L)
    assert all(np.array_equal(a, b) for a, b in zip(insts, jinsts))
    exp = jdata.build_conventional_batch(jinsts, jstore, jlcfg,
                                         n_cands=n_cands,
                                         rng=np.random.default_rng(5))
    got = data.build_conventional_batch(insts, store, lcfg, n_cands=n_cands,
                                        rng=np.random.default_rng(5))
    assert got.keys() == exp.keys()
    assert got["_stats"] == exp["_stats"]
    for k in exp:
        if k != "_stats":
            assert got[k].dtype == exp[k].dtype, k
            np.testing.assert_array_equal(got[k], exp[k], k)
    assert (~got["hist_mask"]).any() and got["hist_mask"][-1].all()
    assert 0 < got["_stats"]["data_efficiency"] < 1


# ------------------------------------------------- the forward and steps

def _conv_batches(n_batches=1, users=4):
    """Conventional batches of the tiny config's loader (pad slots
    included), host arrays without ``_stats``."""
    _, tcfg = _configs()
    _, log, store, lcfg = train.make_loader(tcfg, n_news=200, n_users=40)
    insts = [h for h in log.histories if len(h) >= 2]
    out = []
    for i in range(n_batches):
        b = data.build_conventional_batch(
            insts[i * users:(i + 1) * users], store, lcfg,
            rng=np.random.default_rng(i))
        out.append({k: v for k, v in b.items() if not k.startswith("_")})
    assert all((~b["hist_mask"]).any() for b in out)
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_conventional_forward_matches_jax(remat):
    jcfg, tcfg = _configs(remat=remat)
    (batch,) = _conv_batches()
    jparams = _np_tree(jcore.init_speedyfeed(jax.random.PRNGKey(0), jcfg))

    def jloss(p):
        return jcore.conventional_forward(p, jcfg, batch)

    (eloss, em), egrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    exp = params_from_jax(_np_tree(egrads), device="cpu")

    tparams = params_from_jax(jparams, device="cpu")
    flat = [p.requires_grad_() for _, p in leaves(tparams)]
    gloss, gm = core.conventional_forward(
        tparams, tcfg, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(gloss, flat, allow_unused=True)
    np.testing.assert_allclose(float(gloss.detach()), float(eloss), rtol=0,
                               atol=FWD_TOL)
    assert float(gm["click_acc"]) == float(em["click_acc"])
    n = 0
    for (path, e), g in zip(leaves(exp), grads):
        if g is None:
            assert float(e.abs().max()) == 0.0, path
            continue
        err = float((g - e).abs().max())
        assert err <= BUSLM_GRAD_TOL, f"{path}: {err}"
        n += 1
    assert n >= 20


def test_three_conventional_steps_match_jax():
    jcfg, tcfg = _configs()
    batches = _conv_batches(n_batches=2)
    jparams = jinit = jcore.init_speedyfeed(jax.random.PRNGKey(1), jcfg)
    jopt = joptim.adam_init(jparams)
    params = params_from_jax(_np_tree(jparams), device="cpu")
    opt = {"m": params_from_jax(_np_tree(jopt["m"]), device="cpu"),
           "v": params_from_jax(_np_tree(jopt["v"]), device="cpu"),
           "count": _t(jopt["count"])}
    jstep = jax.jit(jmake_conv_step(jcfg))
    tstep = make_conventional_step(tcfg)
    for i in range(3):
        batch = batches[i % 2]
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        params, opt, tm = tstep(params, opt,
                                {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=STEP_TOL,
                                   err_msg=f"loss at step {i}")
        assert set(tm) >= {"loss", "grad_norm", "lr", "click_acc"}
    exp = params_from_jax(_np_tree(jparams), device="cpu")
    worst = max(float((a.detach() - b).abs().max())
                for (_, a), (_, b) in zip(leaves(params), leaves(exp)))
    assert worst <= STEP_TOL, worst
    assert int(opt["count"]) == int(jopt["count"]) == 3
    # SF_OPT's PLM lr (8e-6) moves a PLM leaf by ~2.4e-5 in three steps,
    # under STEP_TOL: hold each leaf's own change to JAX's, relative to it.
    # The key biases' gradient is 0 in exact arithmetic (softmax ignores a
    # shift shared by all keys), so Adam moves them by the sign of noise:
    # they are held by STEP_TOL above only
    start = dict(leaves(params_from_jax(_np_tree(jinit), device="cpu")))
    n_plm = 0
    for (path, a), (_, b) in zip(leaves(params), leaves(exp)):
        if path.endswith("attn/k/b"):
            continue
        got, want = a.detach() - start[path], b - start[path]
        size = float(want.norm())
        assert size > 0, f"{path} did not move in JAX"
        rel = float((got - want).norm()) / size
        assert rel <= STEP_DELTA_TOL, f"{path}: change off by {rel:.2e}"
        n_plm += path.startswith("plm/")
    assert n_plm >= 10


# --------------------------------------------------------------- registry

def test_conventional_trainer_is_registered():
    assert "speedyfeed_conventional" in training.registered_trainers()


def test_conventional_trainer_step_leaves_the_cache_untouched():
    _, tcfg = _configs()
    trainer = training.get_trainer("speedyfeed_conventional", cfg=tcfg,
                                   device="cpu")
    state = trainer.init_state(0)
    state.cache.emb.normal_()                  # a cache that is not blank
    before = (state.cache.emb.clone(), state.cache.written_step.clone())
    q0 = state.params["user"]["query"].detach().clone()
    (batch,) = _conv_batches()
    new, m = trainer.step(state, {k: _t(v) for k, v in batch.items()})
    assert new.step == state.step + 1
    assert torch.equal(new.cache.emb, before[0])
    assert torch.equal(new.cache.written_step, before[1])
    assert math.isfinite(float(m["loss"]))
    assert not torch.equal(new.params["user"]["query"], q0)


def test_conventional_trainer_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.get_trainer("speedyfeed_conventional",
                             cfg=_configs()[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        speedup.run("bench")


# ---------------------------------------------------------------- ladder

def _jax_row_names():
    src = (ROOT / "benchmarks" / "speedup.py").read_text()
    return re.findall(r'rows\.append\(\("(speedup/\w+)"', src)


def test_ladder_at_bench_gives_the_jax_rows(tmp_path):
    out = tmp_path / "speedup.jsonl"
    rows, info = speedup.main(["--device", "cpu", "--warmup", "0",
                               "--iters", "1", "--out", str(out)])
    names = _jax_row_names()
    assert len(names) == 6
    assert [r[0] for r in rows] == names
    for name, us, factor in rows:
        assert math.isfinite(us) and us > 0, name
        assert math.isfinite(factor) and factor > 0, name
    assert rows[0][2] == 1.0
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [ln["name"] for ln in lines[:-1]] == names
    assert lines[-1]["config"] == "bench"
    # the AR row's B*(L-1) against the step's own valid predictions
    assert 0 < info["ar_n_predictions"] <= info["ar_clicks_assumed"]
    assert info["conventional_news_per_step"] == 16 * (30 + 2)


def test_central_loss_matches_jax():
    cfg = speedup.bench_cfg()
    assert cfg == core.make_config(**BENCH)
    jcfg = jcore.make_config(attn_impl="xla", **BENCH)
    _, log, _, lcfg, store = speedup.bench_corpus(cfg)
    batch = {k: v for k, v in
             speedup.centralized_batch_from_log(cfg, log, store,
                                                lcfg).items()
             if not k.startswith("_")}
    neg = np.asarray(jcore.sample_negatives(
        jax.random.PRNGKey(0), cfg.merged_cap,
        batch["hist_mask"][:, 1:].shape, cfg.n_neg))
    jparams = _np_tree(jcore.init_speedyfeed(jax.random.PRNGKey(0), jcfg))

    def jcentral(p, b):
        # benchmarks/speedup.py's central_loss, the negatives injected
        emb = jcore.buslm_encode(p["plm"], jcfg.plm, b["news_tokens"],
                                 b["news_freq"], impl="xla")
        emb = emb * (b["news_ids"] != 0)[:, None]
        theta = emb[b["hist_inv"]]
        mask = b["hist_mask"]
        mu = jcore.attentive_user(p["user"], theta, mask)[:, None, :]
        mu = jnp.broadcast_to(mu, theta.shape)
        last = mask.sum(1) - 1
        lmask = jnp.arange(mask.shape[1] - 1)[None, :] == (last - 1)[:, None]
        return jcore.ar_loss(mu, theta, mask & jnp.pad(
            lmask, ((0, 0), (1, 0)), constant_values=True), emb,
            b["news_ids"], jnp.asarray(neg), hist_inv=b["hist_inv"])

    eloss, em = jax.jit(jcentral)(jparams, batch)
    gloss, gm = speedup.central_loss(
        params_from_jax(jparams, device="cpu"), cfg,
        {k: _t(v) for k, v in batch.items()}, _t(neg))
    np.testing.assert_allclose(float(gloss), float(eloss), rtol=0,
                               atol=FWD_TOL)
    assert int(gm["n_predictions"]) == int(em["n_predictions"]) > 0
    assert float(gm["ar_acc"]) == float(em["ar_acc"])

