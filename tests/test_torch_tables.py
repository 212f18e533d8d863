"""The port's quality tables (``repro_torch.launch.tables``, the port of
``benchmarks/tables.py``) and the ablation configurations they train,
against the JAX package.

The train steps of Tables 3, 5 and 6's configurations (the NRMS user
encoder, no cache, no frequency embedding, no bus, a head-truncated
store) are held to JAX from a bridged state, with the cache gate's
uniform and the negatives drawn from the JAX keys and injected, as
tests/test_torch_train.py does. The JAX side runs ``attn_impl="xla"``;
the port's bus attention on the CPU is its plain forward and backward.
Table 1 and Figure 8 are numpy only, so their rows are held exactly to
the JAX functions' on this host; JAX's ``benchmarks/tables.py`` is
imported from the repo root as it is.
"""
import copy
import importlib
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore, data as jdata, optim as joptim  # noqa: E402
from repro.configs.speedyfeed_arch import (  # noqa: E402
    make_sf_train_step as jmake_step)
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import core, data, optim  # noqa: E402
from repro_torch.bridge import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.configs.speedyfeed_arch import make_sf_train_step  # noqa
from repro_torch.launch import tables, train  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_TOL = 1e-4        # tests/test_torch_train.py's, for train steps
ACC_ROWS = ("table3/", "table5/", "table6/")


def _t(x):
    return torch.as_tensor(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, exp, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(exp, np.float64), rtol=0,
                               atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def jtables():
    """JAX's ``benchmarks/tables.py``, imported from the repo root."""
    sys.path.insert(0, str(ROOT))
    try:
        yield importlib.import_module("benchmarks.tables")
    finally:
        sys.path.remove(str(ROOT))


# ------------------------------------------------ the ablation train steps

def _stores(cfg, refine: bool):
    """The same corpus, log and store in each package (make_loader's
    recipe at 400 news and 80 users, with ``refine``): ((log, store,
    lcfg) in JAX, (log, store, lcfg) in the port)."""
    out = []
    for pkg in (jdata, data):
        rng = np.random.default_rng(0)
        corpus = pkg.make_corpus(rng, n_news=400)
        log = pkg.make_click_log(rng, corpus, n_users=80,
                                 max_hist=cfg.hist_len)
        stats = pkg.build_corpus_stats(
            [corpus.text(i) for i in range(corpus.n_news)])
        lcfg = pkg.LoaderConfig(
            vocab=cfg.plm.vocab, n_segments=cfg.plm.n_segments,
            seg_len=cfg.plm.seg_len,
            buckets=pkg.default_buckets(cfg.plm.seg_len), token_budget=4000,
            b_cap=cfg.batch_users, m_cap=cfg.merged_cap,
            hist_len=cfg.hist_len, refine=refine)
        out.append((log, pkg.NewsStore(corpus, stats, lcfg), lcfg))
    return out


def _first_batch(log, store, lcfg):
    b = jdata.DynamicBatcher(log, store, lcfg, n_threads=1, seed=3).start()
    try:
        item = b.get(timeout=10)
    finally:
        b.stop()
    return {k: v for k, v in item.items() if not k.startswith("_")}


# Tables 3, 5 and 6's configurations: table3's NRMS user encoder (the
# Algorithm-1 step with kind="nrms"), table5's w/o bus, w/o cache (gamma
# 0, as table6's first row) and w/o refine (use_freq=False over a store
# of head-truncated news), and use_freq=False over the refined store
ABLATIONS = {
    "user_nrms": (dict(user_kind="nrms"), True),
    "gamma0": (dict(gamma=0), True),
    "no_freq": (dict(use_freq=False), True),
    "no_bus": (dict(use_bus=False), True),
    "no_refine": (dict(use_freq=False), False),
}


@pytest.mark.parametrize("variant", list(ABLATIONS))
def test_ablation_train_steps_match_jax(variant):
    over, refine = ABLATIONS[variant]
    over = dict(encode_budget=32, **over)      # encode and reuse mix
    jcfg = jtrain.small_speedyfeed_config(attn_impl="xla", **over)
    tcfg = train.small_speedyfeed_config(**over)
    (jlog, jstore, jlcfg), (tlog, tstore, _) = _stores(jcfg, refine)
    for name in ("tokens", "freq", "lengths"):
        a, b = getattr(tstore, name), getattr(jstore, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    assert [list(h) for h in tlog.histories] == \
        [list(h) for h in jlog.histories]
    if not refine:   # head truncation: a token's frequency is 1, pads 0
        np.testing.assert_array_equal(jstore.freq, jstore.tokens != 0)
    batch = _first_batch(jlog, jstore, jlcfg)
    key = jax.random.PRNGKey(0)
    jparams, jcache = jcore.speedyfeed_state(jcfg, key)
    if variant == "user_nrms":
        assert "self_attn" in jparams["user"]
    jopt = joptim.adam_init(jparams)
    step0 = 100                               # the cache gate opens
    state = state_from_jax(_np_tree(jparams), _np_tree(jopt),
                           (np.asarray(jcache.emb),
                            np.asarray(jcache.written_step)),
                           step0, device="cpu")
    jstep = jax.jit(jmake_step(jcfg))
    tstep = make_sf_train_step(tcfg)
    params, opt, cache = state.params, state.opt, state.cache
    tb = {k: _t(v) for k, v in batch.items()}
    reused = 0
    for i in range(2):                        # the second step reads the cache
        step = step0 + i
        rng = jax.random.fold_in(key, step)
        rng_cache, rng_neg = jax.random.split(rng)
        u = float(jax.random.uniform(rng_cache))
        neg = jcore.sample_negatives(rng_neg, jcfg.merged_cap,
                                     batch["hist_mask"][:, 1:].shape,
                                     jcfg.n_neg)
        jparams, jopt, jcache, jm = jstep(jparams, jopt, jcache,
                                          jnp.int32(step), rng, batch)
        params, opt, cache, tm = tstep(params, opt, cache, step, None, tb,
                                       u=u, neg_idx=_t(neg))
        _close(tm["loss"], jm["loss"], STEP_TOL, f"{variant} loss, step {i}")
        _close(tm["ar_acc"], jm["ar_acc"], 1e-6, f"{variant} ar_acc")
        assert int(tm["encoded"]) == int(jm["encoded"])
        assert int(tm["reused"]) == int(jm["reused"])
        reused += int(tm["reused"])
    # gamma 0 expires every cached row: nothing is reused
    assert (reused == 0) == (variant == "gamma0"), reused
    exp = params_from_jax(_np_tree(jparams), device="cpu")
    assert [p for p, _ in leaves(params)] == [p for p, _ in leaves(exp)]
    worst = max(float((a.detach() - b).abs().max())
                for (_, a), (_, b) in zip(leaves(params), leaves(exp)))
    assert worst <= STEP_TOL, worst
    _close(cache.emb, jcache.emb, STEP_TOL, "cache")
    np.testing.assert_array_equal(cache.written_step.numpy(),
                                  np.asarray(jcache.written_step))


def test_nrms_user_encoder_trains_through_the_pipeline():
    """``make_config(user_kind="nrms")``: the self-attention's leaves get
    gradients through ``speedyfeed_forward`` and move in one step."""
    cfg = train.small_speedyfeed_config(user_kind="nrms")
    gen = torch.Generator().manual_seed(0)
    params, cache = core.speedyfeed_state(cfg, gen)
    before = {p: t.clone() for p, t in leaves(params)
              if p.startswith("user/self_attn/")}
    assert len(before) == 8                   # q, k, v, o: w and b
    b = data.synth_centralized_batch(
        m_cap=cfg.merged_cap, n_segments=cfg.plm.n_segments,
        seg_len=cfg.plm.seg_len, b_cap=cfg.batch_users,
        hist_len=cfg.hist_len, vocab=cfg.plm.vocab, seed=0)
    params, _, _, m = make_sf_train_step(cfg)(
        params, optim.adam_init(params), cache, 0, gen,
        {k: _t(v) for k, v in b.items() if not k.startswith("_")})
    assert math.isfinite(float(m["loss"]))
    now = dict(leaves(params))
    moved = [p for p, t in before.items() if not torch.equal(t, now[p])]
    assert len(moved) == len(before), sorted(set(before) - set(moved))


# ------------------------------------------------------- the table rows

def test_table1_rows_are_exactly_jax(jtables):
    got, exp = tables.table1_longtail(), jtables.table1_longtail()
    assert len(got) == len(exp) == 6
    for g, e in zip(got, exp):
        assert g[0] == e[0] and g[1] == e[1] == 0.0
        assert g[2] == e[2], g[0]


def test_fig8_rows_are_exactly_jax(jtables):
    got, exp = tables.fig8_data_efficiency(), jtables.fig8_data_efficiency()
    assert len(got) == len(exp) == 4
    for g, e in zip(got, exp):
        assert g == e


def test_fig9_flops_are_jax_plm_flops(jtables, monkeypatch):
    # JAX's rows with its timer stubbed out (nothing is compiled); the
    # FLOPs column is core.plm_flops at each split
    monkeypatch.setattr(jtables, "time_fn", lambda *a, **k: 0.0)
    exp = jtables.fig9_buslm()
    got = tables.fig9_buslm(device="cpu", warmup=0, iters=1)
    assert [r[0] for r in got] == [r[0] for r in exp]
    assert [r[2] for r in got] == [r[2] for r in exp]
    for k_seg in tables.FIG9_SEGMENTS:
        S = tables.FIG9_TOTAL // k_seg
        jcfg = jtables.bench_cfg(n_segments=k_seg, seg_len=S)
        tcfg = tables.bench_cfg(n_segments=k_seg, seg_len=S)
        assert core.plm_flops(tcfg.plm, 256) == jcore.plm_flops(jcfg.plm,
                                                                256)
    assert all(us > 0 for _, us, _ in got)


def _jax_row_names(jtables, monkeypatch):
    """Every JAX table's row names, in order, with its Algorithm-1 runs
    and its timer stubbed out (table3's NRMS arm runs one step)."""
    monkeypatch.setattr(jtables, "_train_speedy",
                        lambda *a, **k: (0.5, 1.0))
    monkeypatch.setattr(jtables, "time_fn", lambda *a, **k: 0.0)
    rows = (jtables.table1_longtail() + jtables.table3_quality(steps=1)
            + jtables.table5_ablation(steps=1)
            + jtables.table6_cache_gamma(steps=1)
            + jtables.fig8_data_efficiency() + jtables.fig9_buslm())
    return [r[0] for r in rows]


def test_main_gives_the_jax_rows_in_order(jtables, monkeypatch, tmp_path):
    out = tmp_path / "tables.jsonl"
    rows, info = tables.main(["--device", "cpu", "--table3-steps", "2",
                              "--table5-steps", "2", "--table6-steps", "2",
                              "--warmup", "0", "--iters", "1",
                              "--out", str(out)])
    assert [r[0] for r in rows] == _jax_row_names(jtables, monkeypatch)
    assert len(rows) == 25
    for name, us, value in rows:
        assert math.isfinite(us) and us >= 0, name
        assert math.isfinite(value), name
        if name.startswith(ACC_ROWS):
            assert 0.0 <= value <= 1.0 and us > 0, (name, value)
        elif not name.startswith("fig9/"):
            assert 0.0 < value <= 1.0, (name, value)
    lines = out.read_text().splitlines()
    assert len(lines) == len(rows) + 1
    assert [json.loads(ln)["name"] for ln in lines[:-1]] == \
        [r[0] for r in rows]
    assert json.loads(lines[-1])["steps"] == {"table3": 2, "table5": 2,
                                              "table6": 2}
    assert set(info["seconds"]) == set(tables.FUNCTIONS)


def test_only_runs_the_functions_named():
    rows, info = tables.main(["--device", "cpu", "--only", "fig8,table1"])
    assert [r[0].split("/")[0] for r in rows] == ["table1"] * 6 + ["fig8"] * 4
    assert list(info["seconds"]) == ["table1", "fig8"]
    with pytest.raises(ValueError, match="unknown functions"):
        tables.run(("table2",), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_default_device_raises_without_a_gpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tables.main(["--only", "table1"])


# ----------------------------------------------------------- the warm-up

def test_warm_up_leaves_the_measured_state_untouched():
    """The port's step updates in place, so a warm-up on the state itself
    would train it on random batches; ``warm_up`` steps a copy."""
    cfg = tables.bench_cfg()
    _, _, _, lcfg, _ = tables.bench_corpus(cfg, n_news=200, n_users=40)
    gen = torch.Generator().manual_seed(0)
    params, cache = core.speedyfeed_state(cfg, gen)
    opt = optim.adam_init(params)
    state = (params, opt, cache)
    before = copy.deepcopy(state)
    step_fn = make_sf_train_step(cfg)
    losses = tables.warm_up(step_fn, state, cfg, lcfg, device="cpu")
    assert len(losses) == len(lcfg.buckets) == 2
    assert all(math.isfinite(x) for x in losses)

    def same(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y) in
                   zip(leaves(a), leaves(b)))

    assert same(params, before[0]) and same(opt, before[1])
    assert torch.equal(cache.emb, before[2].emb)
    assert torch.equal(cache.written_step, before[2].written_step)
    # the control: the same step on the state itself changes it
    wb = data.synth_centralized_batch(
        m_cap=lcfg.m_cap, n_segments=lcfg.n_segments,
        seg_len=lcfg.buckets[0], b_cap=cfg.batch_users,
        hist_len=cfg.hist_len, vocab=lcfg.vocab, seed=0)
    step_fn(params, opt, cache, 0, gen,
            {k: _t(v) for k, v in wb.items() if not k.startswith("_")})
    assert not same(params, before[0])
    assert not torch.equal(cache.written_step, before[2].written_step)
