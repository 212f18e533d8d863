"""The port's data mesh against the JAX package, in gloo ranks on the CPU:
the counterparts of ``tests/test_mesh.py``.

One group of 4 ranks (``launch.mesh.run_on_mesh`` over ``["cpu"] * 4``)
runs every training scenario (``_torch_mesh_ranks.train_scenarios``) and
returns its results; the tests hold them to the port's one-process step
and to JAX's single-device step, both from the same bridged JAX state
with JAX's draws injected. The sharded index runs in this process over
``["cpu"] * 8``, as JAX's forced host devices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro import core as jcore, data as jdata, optim as joptim  # noqa
from repro import serving as jserving, training as jtraining  # noqa: E402
from repro.configs.speedyfeed_arch import (  # noqa: E402
    make_sf_train_step as jmake_step)
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import data, obs, serving, training  # noqa: E402
from repro_torch.bridge import (params_from_jax, snapshot_from_arrays,  # noqa
                                state_from_jax)
from repro_torch.configs.speedyfeed_arch import make_sf_train_step  # noqa
from repro_torch.launch import mesh as tmesh, serve, train  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402

N = 4
STEP_TOL = 1e-5     # the mesh against the port's one process: sums reordered
JAX_TOL = 1e-4      # against JAX's single-device step (the train tests')
SCORE_TOL = 1e-4    # IVF scores, f32, another sum order
STEPS = 4
# 2,004 cache rows and 16 users split over 4 ranks; 2,001 rows and 14 users
# do not, so the cache and the user side are replicated
CASES = {"sharded": dict(encode_budget=32, n_news=2004),
         "replicated": dict(encode_budget=32, n_news=2001, batch_users=14)}
FIT = dict(over=dict(n_news=2004), steps=4)
# a hung rank fails the fixture well inside the test run's time limit
MESH_TIMEOUT_S = 300


def _close(got, exp, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(exp, np.float64), rtol=0,
                               atol=tol, err_msg=what)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_batches(jcfg):
    _, log, store, lcfg = jtrain.make_loader(jcfg, n_news=400, n_users=80)
    b = jdata.DynamicBatcher(log, store, lcfg, n_threads=1, seed=3).start()
    out = []
    try:
        while (item := b.get(timeout=10)) is not jdata.EPOCH_END:
            if item["_bucket"] == 16:
                out.append({k: v for k, v in item.items()
                            if not k.startswith("_")})
    finally:
        b.stop()
    return out[:2]


def _jax_case(over):
    """STEPS JAX steps from step 100 (the cache gate open) over two
    loader batches in turn: the inputs the ranks get, and JAX's result."""
    jcfg = jtrain.small_speedyfeed_config(attn_impl="xla", **over)
    batches = _jax_batches(jcfg)
    key = jax.random.PRNGKey(0)
    # jitted: one compile in place of the eager init's many (the state is
    # bridged, so both packages start from whatever it holds)
    jparams, jcache = jax.jit(jcore.speedyfeed_state, static_argnums=0)(
        jcfg, key)
    jopt = joptim.adam_init(jparams)
    state = (jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, jopt),
             (np.asarray(jcache.emb), np.asarray(jcache.written_step)))
    jstep = jax.jit(jmake_step(jcfg))
    case = dict(over=over, state=state, step0=100, batches=[], draws=[])
    jax_out = {"losses": [], "encoded": [], "reused": []}
    for i in range(STEPS):
        step, batch = 100 + i, batches[i % 2]
        rng = jax.random.fold_in(key, step)
        rng_cache, rng_neg = jax.random.split(rng)
        neg = jcore.sample_negatives(rng_neg, jcfg.merged_cap,
                                     batch["hist_mask"][:, 1:].shape,
                                     jcfg.n_neg)
        case["batches"].append(batch)
        case["draws"].append((float(jax.random.uniform(rng_cache)),
                              np.asarray(neg)))
        jparams, jopt, jcache, m = jstep(jparams, jopt, jcache,
                                         jnp.int32(step), rng, batch)
        for k, dst in (("loss", "losses"), ("encoded", "encoded"),
                       ("reused", "reused")):
            jax_out[dst].append(float(m[k]))
    jax_out.update(params=jax.tree.map(np.asarray, jparams),
                   opt=jax.tree.map(np.asarray, jopt),
                   emb=np.asarray(jcache.emb),
                   written_step=np.asarray(jcache.written_step))
    return case, jax_out


def _port_case(case):
    """The port's one-process steps on the case's inputs."""
    cfg = train.small_speedyfeed_config(**case["over"])
    st = state_from_jax(*case["state"], case["step0"], device="cpu")
    step_fn = make_sf_train_step(cfg)
    p, o, c = st.params, st.opt, st.cache
    losses = []
    for i, (batch, (u, neg)) in enumerate(zip(case["batches"],
                                              case["draws"])):
        p, o, c, m = step_fn(p, o, c, case["step0"] + i, None,
                             {k: _t(v) for k, v in batch.items()}, u=u,
                             neg_idx=_t(neg))
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": [t.detach() for _, t in leaves(p)],
            "emb": c.emb, "written_step": c.written_step}


def _synth_batch(cfg, seed=0):
    b = data.synth_centralized_batch(
        m_cap=cfg.merged_cap, n_segments=cfg.plm.n_segments,
        seg_len=cfg.plm.seg_len, b_cap=cfg.batch_users,
        hist_len=cfg.hist_len, vocab=cfg.plm.vocab, seed=seed)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    cases, refs = {}, {}
    for name, over in CASES.items():
        cases[name], jax_out = _jax_case(over)
        refs[name] = {"jax": jax_out, "port": _port_case(cases[name])}
    # a one-device checkpoint after one step; a JAX one after STEPS steps
    cfg = train.small_speedyfeed_config(**FIT["over"])
    tr1 = training.get_trainer("speedyfeed", cfg=cfg, device="cpu")
    one, _ = tr1.step(tr1.init_state(3), _synth_batch(cfg))
    d1 = str(tmp_path_factory.mktemp("one_device"))
    training.save_state(d1, 1, one)
    jx = refs["sharded"]["jax"]
    d3 = str(tmp_path_factory.mktemp("jax"))
    jtraining.save_state(d3, 104, jtraining.make_state(
        jx["params"], jx["opt"], jcore.CacheState(jx["emb"],
                                                  jx["written_step"]),
        step=104, rng=jax.random.PRNGKey(5)))
    inp = dict(cases=[cases[n] for n in CASES],
               fit=dict(FIT, dir=str(tmp_path_factory.mktemp("fit"))),
               one_device_dir=d1, jax_dir=d3,
               mesh_dir=str(tmp_path_factory.mktemp("from_mesh")))
    out = run_on_mesh(ranks.train_scenarios, N, ["cpu"] * N, args=(inp,),
                      timeout=MESH_TIMEOUT_S)
    return dict(inp=inp, refs=refs, out=out, one=one, cfg=cfg)


# ---------------------------------------------------------------- training

@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_one_process_and_jax(mesh_run, name):
    """4 steps on 4 ranks: every rank's loss within STEP_TOL of the port's
    one-process step and JAX_TOL of JAX's; replicated parameters equal on
    every rank; the cache blocks joined equal to the one-process cache
    (sharded) or each the whole cache (replicated)."""
    i = list(CASES).index(name)
    got = [r["cases"][i] for r in mesh_run["out"]]
    port, jx = mesh_run["refs"][name]["port"], mesh_run["refs"][name]["jax"]
    for r in got:
        _close(r["losses"], port["losses"], STEP_TOL, "vs one process")
        _close(r["losses"], jx["losses"], JAX_TOL, "vs JAX")
        assert r["encoded"] == [int(x) for x in jx["encoded"]]
        assert r["reused"] == [int(x) for x in jx["reused"]]
        assert r["count"] == STEPS
    assert sum(got[0]["reused"]) > 0
    assert len({r["params_crc"] for r in got}) == 1
    exp_jax = params_from_jax(jx["params"], device="cpu")
    for a, b, (_, c) in zip(got[0]["params"], port["params"],
                            leaves(exp_jax)):
        _close(a, b, STEP_TOL, "params vs one process")
        _close(a, c, JAX_TOL, "params vs JAX")
    n_news = CASES[name]["n_news"]
    if name == "sharded":
        assert [r["cache_rows"] for r in got] == [n_news // N] * N
        emb = np.concatenate([r["emb"] for r in got])
        ws = np.concatenate([r["written_step"] for r in got])
    else:
        assert [r["cache_rows"] for r in got] == [n_news] * N
        for r in got[1:]:
            np.testing.assert_array_equal(r["emb"], got[0]["emb"])
        emb, ws = got[0]["emb"], got[0]["written_step"]
    _close(emb, port["emb"], STEP_TOL, "cache vs one process")
    _close(emb, jx["emb"], JAX_TOL, "cache vs JAX")
    np.testing.assert_array_equal(ws, port["written_step"].numpy())
    np.testing.assert_array_equal(ws, jx["written_step"])


def test_mesh_fit_matches_a_one_process_fit_on_its_batches(mesh_run):
    """A mesh fit over a two-thread loader: every rank trains on the
    batches rank 0 loaded (the losses are the same on every rank), and a
    one-process fit over those batches in that order gives the same
    losses and cache."""
    fits = [r["fit"] for r in mesh_run["out"]]
    assert all(f["steps"] == FIT["steps"] for f in fits)
    for f in fits[1:]:
        assert f["losses"] == fits[0]["losses"]
    assert len({f["params_crc"] for f in fits}) == 1
    consumed = fits[0]["consumed"]
    assert len(consumed) == FIT["steps"]
    cfg = train.small_speedyfeed_config(**FIT["over"])
    tr = training.get_trainer("speedyfeed", cfg=cfg, device="cpu")
    res = tr.fit(lambda epoch: ranks.Replay(consumed),
                 steps=FIT["steps"], log_every=0)
    assert res.steps_done == FIT["steps"]
    _close(fits[0]["losses"], res.losses, JAX_TOL, "fit losses")
    emb = np.concatenate([f["emb"] for f in fits])
    _close(emb, res.state.cache.emb, JAX_TOL, "fit cache")
    assert ranks.tree_crc(res.state.params) != 0


def test_mesh_fit_exports_the_straggler_gauges(mesh_run):
    """``fit(hosts=4)``: the straggler control plane's gauges, every
    allocation at least 1 and their sum the global 4."""
    f = mesh_run["out"][0]["fit"]
    assert f["stragglers"] is not None
    assert all(a >= 1 for a in f["alloc"]) and sum(f["alloc"]) == 4


def test_mesh_fit_resumes_from_its_checkpoint(mesh_run):
    """The fit checkpointed every 2 steps (gathered to rank 0); a second
    fit resumed from its last step on every rank, and that checkpoint
    restores on one device to the mesh's state."""
    fits = [r["fit"] for r in mesh_run["out"]]
    last = FIT["steps"]
    assert [f["resumed_from"] for f in fits] == [last] * N
    assert [f["steps_again"] for f in fits] == [last + 2] * N
    tr = training.get_trainer("speedyfeed", cfg=mesh_run["cfg"],
                              device="cpu")
    step, st = training.restore_state(mesh_run["inp"]["fit"]["dir"],
                                      tr.init_state(9), step=last)
    assert step == last
    assert ranks.tree_crc(st.params) == fits[0]["params_crc"]
    np.testing.assert_array_equal(
        st.cache.emb.numpy(), np.concatenate([f["emb"] for f in fits]))


def _assert_state_equal(a, b):
    for (pa, x), (pb, y) in zip(leaves({"p": a.params, "o": a.opt}),
                                leaves({"p": b.params, "o": b.opt})):
        assert pa == pb and torch.equal(x.detach(), y.detach()), pa
    assert torch.equal(a.cache.emb, b.cache.emb)
    assert torch.equal(a.cache.written_step, b.cache.written_step)


def test_checkpoint_from_one_device_onto_the_mesh_and_back(mesh_run):
    """A one-device checkpoint restores onto the mesh (each rank its rows,
    the rest whole); the mesh's checkpoint of that state restores on one
    device leaf for leaf."""
    one = mesh_run["one"]
    got = [r["from_one_device"] for r in mesh_run["out"]]
    rows = one.cache.emb.shape[0] // N
    for r, g in enumerate(got):
        assert g["step"] == g["state_step"] == 1
        assert g["params_crc"] == ranks.tree_crc(one.params)
        assert g["opt_crc"] == ranks.tree_crc({"m": one.opt["m"],
                                               "v": one.opt["v"]})
        assert g["count"] == 1
        np.testing.assert_array_equal(
            g["emb"], one.cache.emb[r * rows:(r + 1) * rows].numpy())
        np.testing.assert_array_equal(
            g["written_step"],
            one.cache.written_step[r * rows:(r + 1) * rows].numpy())
    tr = training.get_trainer("speedyfeed", cfg=mesh_run["cfg"],
                              device="cpu")
    step, back = training.restore_state(mesh_run["inp"]["mesh_dir"],
                                        tr.init_state(5))
    assert step == back.step == 2
    _assert_state_equal(back, one)


def test_jax_checkpoint_onto_the_mesh(mesh_run):
    """A JAX checkpoint restores onto the mesh: each rank's cache rows
    and the replicated parameters and moments are JAX's."""
    jx = mesh_run["refs"]["sharded"]["jax"]
    got = [r["from_jax"] for r in mesh_run["out"]]
    rows = jx["emb"].shape[0] // N
    want_p = ranks.tree_crc(params_from_jax(jx["params"], device="cpu"))
    for r, g in enumerate(got):
        assert g["step"] == g["state_step"] == 104
        assert g["params_crc"] == want_p
        assert g["count"] == STEPS
        np.testing.assert_array_equal(g["emb"],
                                      jx["emb"][r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(
            g["written_step"], jx["written_step"][r * rows:(r + 1) * rows])


# ---------------------------------------------------------------- serving

def _corpus():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(3000, 32)).astype(np.float32),
            np.arange(1, 3001), rng.normal(size=(16, 32)).astype(np.float32))


def _jax_bridged(snap):
    return snapshot_from_arrays(
        version=snap.version, kind=snap.kind, dim=snap.dim,
        ntotal=snap.ntotal, nprobe=snap.nprobe, metric=snap.metric,
        cent_unit=np.asarray(snap.cent_unit),
        cent_raw=np.asarray(snap.cent_raw),
        list_ids=np.asarray(snap.list_ids), payload=np.asarray(snap.payload),
        lens=np.asarray(snap.lens),
        pq_centers=(None if snap.pq_centers is None
                    else np.asarray(snap.pq_centers)), device="cpu")


@pytest.mark.parametrize("kind", ["ivf-flat", "ivf-pq"])
def test_sharded_index_matches_unsharded_and_jax(kind):
    """Global probing over the whole centroid table gives the sharded
    index the unsharded candidate set, so its top-k is the unsharded
    top-k id for id (nlist 37 over 8 shards: the padded tail). Held to
    the port's own unsharded build, and, on a snapshot carrying the JAX
    build's arrays, to JAX's unsharded search."""
    x, ids, q = _corpus()
    kw = dict(ivf=serving.IVFConfig(nlist=37, nprobe=8),
              pq=serving.PQConfig(n_subvec=8, n_codes=32), seed=0)
    plain = serving.IndexBuilder(kind, 32, device="cpu", **kw)
    shard = serving.IndexBuilder(kind, 32, devices=["cpu"] * 8, **kw)
    snap, ssnap = plain.build(ids, x), shard.build(ids, x)
    assert isinstance(ssnap, serving.ShardedIndexSnapshot)
    assert (ssnap.n_shards, ssnap.rows_per_shard) == (8, 5)
    assert ssnap.ntotal == snap.ntotal == 3000
    np.testing.assert_array_equal(np.sort(ssnap.member_ids),
                                  np.sort(snap.member_ids))
    s_ref, i_ref = snap.search(q, 10)
    s_got, i_got = ssnap.search(q, 10)
    assert torch.equal(i_got, i_ref)
    _close(s_got, s_ref, SCORE_TOL)

    jkw = dict(ivf=jserving.IVFConfig(nlist=37, nprobe=8),
               pq=jserving.PQConfig(n_subvec=8, n_codes=32), seed=0)
    jsnap = jserving.IndexBuilder(kind, 32, **jkw).build(ids, x)
    js, ji = jsnap.search(q, 10)
    bridged = serving.shard_snapshot(_jax_bridged(jsnap), ["cpu"] * 8)
    s_b, i_b = bridged.search(q, 10)
    np.testing.assert_array_equal(i_b.numpy(), np.asarray(ji))
    _close(s_b, js, SCORE_TOL)

    back = serving.unshard_snapshot(ssnap)
    for name in ("list_ids", "payload", "lens", "cent_unit", "cent_raw"):
        assert torch.equal(getattr(back, name), getattr(snap, name)), name
    assert torch.equal(back.search(q, 10)[1], i_ref)


def test_sharded_compact_absorbs_rows():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    fresh = rng.normal(size=(64, 32)).astype(np.float32)
    shard = serving.IndexBuilder(
        "ivf-flat", 32, ivf=serving.IVFConfig(nlist=16, nprobe=8),
        devices=["cpu"] * 8)
    snap = shard.build(np.arange(1, 2001), x)
    snap2 = shard.compact(snap, np.arange(2001, 2065), fresh)
    assert isinstance(snap2, serving.ShardedIndexSnapshot)
    assert snap2.ntotal == 2064 and snap2.version > snap.version
    _, got = snap2.search(fresh[:4], 1)          # fresh rows retrievable
    np.testing.assert_array_equal(got[:, 0].numpy(), np.arange(2001, 2005))
    assert snap.ntotal == 2000                   # the source is unchanged
    with pytest.raises(ValueError, match="exact"):
        serving.IndexBuilder("exact", 32, devices=["cpu"] * 2)


# ------------------------------------------------------------------ launch

def test_parse_mesh_arg_contract():
    assert tmesh.parse_mesh_arg(None) is None
    assert tmesh.parse_mesh_arg("data=1") is None   # the one-process path
    m = tmesh.parse_mesh_arg("data=8", "cpu")
    assert m.world == 8 and m.shape == {"data": 8, "model": 1}
    assert m.devices == (torch.device("cpu"),) * 8
    for bad in ("bogus", "model=4"):
        with pytest.raises(SystemExit):
            tmesh.parse_mesh_arg(bad, "cpu")
    with pytest.raises(SystemExit):
        tmesh.parse_mesh_arg(f"data={torch.cuda.device_count() + 2}", "cuda")
    assert tmesh.backend_for(["cuda:0"] * 4) == "gloo"
    assert tmesh.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert tmesh.backend_for(["cpu"] * 2) == "gloo"
    prod = tmesh.make_production_mesh(multi_pod=True)
    assert prod.world == 512 and prod.axis_names == ("pod", "data", "model")
    # the mesh-less Trainer is the one-process path
    tr = training.get_trainer("speedyfeed",
                              cfg=train.small_speedyfeed_config(),
                              device="cpu")
    assert tr.mesh is None and tr.state_shardings is None


def test_train_launcher_mesh_on_cpu():
    """``--mesh data=2 --device cpu``: 2 gloo ranks train the same fit;
    rank 0's summary comes back."""
    res = train.main(["--device", "cpu", "--mesh", "data=2", "--steps",
                      "4"])
    assert res["steps_done"] == 4 and len(res["losses"]) == 4
    assert np.isfinite(res["losses"]).all()


def test_serve_launcher_mesh_on_cpu(capsys):
    """``--mesh data=4 --device cpu``: the IVF-PQ index in 4 shards,
    serving with the recall of the unsharded launcher."""
    args = ["--device", "cpu", "--requests", "16", "--batch", "8"]
    stats = serve.main(args + ["--mesh", "data=4"])
    assert "4 shards" in capsys.readouterr().out
    plain = serve.main(args)
    assert stats.n_requests == 16 and stats.recall_ok
    assert stats.recall_at_k == plain.recall_at_k
    obs.reset()
