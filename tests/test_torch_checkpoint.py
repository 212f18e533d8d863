"""The port's checkpoints: the JAX package's checkpoint contracts
(``tests/test_checkpoint.py``) held by the port's ``checkpoint`` module,
checkpoints that cross between the packages in both directions, a JAX
run continued by the port, and the port's own exact resume."""
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt, core as jcore, data as jdata  # noqa
from repro import optim as joptim, training as jtraining  # noqa: E402
from repro.configs.speedyfeed_arch import (  # noqa: E402
    make_sf_train_step as jmake_step)
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import checkpoint as ckpt, obs, training  # noqa: E402
from repro_torch.bridge import (params_from_jax, stack_layers,  # noqa: E402
                                state_from_jax)
from repro_torch.configs.speedyfeed_arch import make_sf_train_step  # noqa
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402
from repro_torch.resilience import FaultPlan, InjectedFault, faults  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 1e-4        # full train steps, as tests/test_torch_train.py
GEN_KEYS = {"rng", "torch_rng"}   # each package's own generator key


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "b": {"w": torch.randn(3, generator=g),
                  "count": torch.tensor(7, dtype=torch.int32)}}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------ the JAX package's contracts

def test_roundtrip(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), 5, t)
    step, restored = ckpt.restore(str(tmp_path), t)
    assert step == 5
    _eq(restored["a"], t["a"])
    _eq(restored["b"]["w"], t["b"]["w"])
    assert restored["b"]["count"].dtype == np.int32
    assert int(restored["b"]["count"]) == 7


def test_keep_k_prunes(tmp_path):
    t = tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, t, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_restore_latest_and_explicit(tmp_path):
    t0, t1 = tree(0), tree(1)
    ckpt.save(str(tmp_path), 1, t0)
    ckpt.save(str(tmp_path), 2, t1)
    _, r = ckpt.restore(str(tmp_path), t0)
    _eq(r["a"], t1["a"])
    _, r0 = ckpt.restore(str(tmp_path), t0, step=1)
    _eq(r0["a"], t0["a"])


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, tree())
    bad = {"a": torch.zeros(2, 2), "b": {"w": torch.zeros(3),
                                         "count": torch.tensor(0)}}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), bad)


def test_interrupted_write_never_corrupts_latest(tmp_path):
    """A writer killed mid-write leaves only a .tmp dir; LATEST still points
    at the previous good checkpoint."""
    t = tree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / ".tmp_dead")
    with open(tmp_path / ".tmp_dead" / "arrays.npz", "w") as f:
        f.write("garbage")
    step, restored = ckpt.restore(str(tmp_path), t)
    assert step == 1
    _eq(restored["a"], t["a"])


def test_async_checkpointer(tmp_path):
    t = tree()
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        w.save(s, t)
    w.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3


def _corrupt_npz(tmp_path, step):
    """Flip bytes inside the arrays archive without touching its length."""
    p = tmp_path / f"step_{step:010d}" / "arrays.npz"
    raw = bytearray(p.read_bytes())
    mid = len(raw) // 2
    for i in range(mid, min(mid + 64, len(raw))):
        raw[i] ^= 0xFF
    p.write_bytes(bytes(raw))


def test_corrupt_npz_falls_back_to_previous_step(tmp_path):
    t0, t1 = tree(0), tree(1)
    ckpt.save(str(tmp_path), 1, t0)
    ckpt.save(str(tmp_path), 2, t1)
    _corrupt_npz(tmp_path, 2)
    before = obs.counter("ckpt_corrupt_total").value
    with pytest.warns(UserWarning, match="quarantin"):
        step, restored = ckpt.restore(str(tmp_path), t0)
    assert step == 1
    _eq(restored["a"], t0["a"])
    assert not (tmp_path / "step_0000000002").exists()
    assert (tmp_path / "corrupt_step_0000000002").exists()
    assert ckpt.all_steps(str(tmp_path)) == [1]
    assert obs.counter("ckpt_corrupt_total").value == before + 1


def test_explicit_step_corruption_raises_not_falls_back(tmp_path):
    ckpt.save(str(tmp_path), 1, tree(0))
    ckpt.save(str(tmp_path), 2, tree(1))
    _corrupt_npz(tmp_path, 2)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(str(tmp_path), tree(0), step=2)
    assert (tmp_path / "step_0000000002").exists()


def test_all_snapshots_corrupt_raises_filenotfound(tmp_path):
    ckpt.save(str(tmp_path), 1, tree(0))
    ckpt.save(str(tmp_path), 2, tree(1))
    _corrupt_npz(tmp_path, 1)
    _corrupt_npz(tmp_path, 2)
    with pytest.warns(UserWarning):
        with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
            ckpt.restore(str(tmp_path), tree(0))


def test_checksum_mismatch_detected_even_when_zip_is_valid(tmp_path):
    t = tree(0)
    ckpt.save(str(tmp_path), 1, t)
    man = tmp_path / "step_0000000001" / "manifest.json"
    m = json.loads(man.read_text())
    m["checksums"]["a"] = "crc32:deadbeef"
    man.write_text(json.dumps(m))
    with pytest.raises(ckpt.CheckpointCorruptError, match="checksum"):
        ckpt.restore(str(tmp_path), t, step=1)
    step, _ = ckpt.restore(str(tmp_path), t, step=1, verify=False)
    assert step == 1


def test_legacy_manifest_without_checksums_restores(tmp_path):
    t = tree(0)
    ckpt.save(str(tmp_path), 1, t)
    man = tmp_path / "step_0000000001" / "manifest.json"
    m = json.loads(man.read_text())
    del m["checksums"]
    man.write_text(json.dumps(m))
    step, restored = ckpt.restore(str(tmp_path), t)
    assert step == 1
    _eq(restored["a"], t["a"])


def test_writer_sigkilled_mid_write_preserves_previous(tmp_path):
    """Chaos: SIGKILL a child process while it is writing step 2's npz.
    The atomic tmp-dir rename means step 1 must restore untouched. The
    child writes no bytecode and nothing outside ``tmp_path``."""
    t = tree(0)
    ckpt.save(str(tmp_path), 1, t)
    marker = tmp_path / "writing"
    child = subprocess.Popen([sys.executable, "-c", f"""
import pathlib, time
import numpy as np
import repro_torch.checkpoint.ckpt as C
def slow_savez(path, **arrays):
    # start a *partial* garbage write, signal the parent, then hang: the
    # parent SIGKILLs us mid-"write"
    with open(path, "wb") as f:
        f.write(b"PK\\x03\\x04 partial garbage")
        f.flush()
    pathlib.Path({str(marker)!r}).touch()
    time.sleep(60)
C.np.savez = slow_savez
tree = {{"a": np.ones((4, 8), np.float32),
         "b": {{"w": np.zeros(3, np.float32), "count": np.int32(9)}}}}
C.save({str(tmp_path)!r}, 2, tree)
"""], env={"PYTHONPATH": os.path.join(ROOT, "src"),
           "PYTHONDONTWRITEBYTECODE": "1", "PATH": "/usr/bin:/bin"},
        cwd=str(tmp_path))
    try:
        deadline = time.time() + 60
        while not marker.exists():
            assert child.poll() is None, "writer died before the write"
            assert time.time() < deadline, "writer never started writing"
            time.sleep(0.02)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    step, restored = ckpt.restore(str(tmp_path), t)
    assert step == 1
    _eq(restored["a"], t["a"])
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_async_writer_error_is_counted_and_reraised(tmp_path):
    target = tmp_path / "not_a_dir"
    target.write_text("file, not dir")        # makedirs will fail
    w = ckpt.AsyncCheckpointer(str(target / "ckpt"))
    before = obs.counter("ckpt_write_failures_total").value
    with pytest.warns(UserWarning, match="failed"):
        w.save(1, tree())
        with pytest.raises(OSError):
            w.wait()
    assert w.failures == 1
    assert obs.counter("ckpt_write_failures_total").value == before + 1
    w.wait()                                   # raise-once: now clean


def test_fault_site_ckpt_write(tmp_path):
    with faults.armed(FaultPlan().fail("ckpt.write", calls=1)):
        with pytest.raises(InjectedFault):
            ckpt.save(str(tmp_path), 1, tree())
        ckpt.save(str(tmp_path), 2, tree())    # next write goes through
    assert ckpt.latest_step(str(tmp_path)) == 2


# ------------------------------------------------ the port's own rules

def test_save_refuses_a_bf16_leaf(tmp_path):
    t = {"w": torch.ones(2, dtype=torch.bfloat16), "x": torch.ones(2)}
    with pytest.raises(ValueError, match="'w' is bfloat16"):
        ckpt.save(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.AsyncCheckpointer(str(tmp_path)).save(1, t)
    assert ckpt.all_steps(str(tmp_path)) == []


def _small_trainer():
    return training.get_trainer(
        "speedyfeed", cfg=train.small_speedyfeed_config(), device="cpu")


def _synth_batches(cfg, n):
    from repro_torch import data
    out = []
    for seed in range(n):
        b = data.synth_centralized_batch(
            m_cap=cfg.merged_cap, n_segments=cfg.plm.n_segments,
            seg_len=cfg.plm.seg_len, b_cap=cfg.batch_users,
            hist_len=cfg.hist_len, vocab=cfg.plm.vocab, seed=seed)
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


def _state_leaves(s):
    return ([t for _, t in leaves(s.params)] + [t for _, t in leaves(s.opt)]
            + [s.cache.emb, s.cache.written_step])


@pytest.fixture
def deterministic():
    """PyTorch's deterministic kernels for one test: on the CPU the step's
    scatter-adds otherwise sum in an order that varies between runs of the
    same step on the same inputs."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def test_restore_round_trip_and_one_step_are_bit_for_bit(tmp_path,
                                                         deterministic):
    """The port's own resume: every leaf, the step and the generator state
    restore exactly, and one step from the restored state equals one step
    from the in-memory state it came from, bit for bit on the CPU."""
    tr = _small_trainer()
    b0, b1, b2 = _synth_batches(tr.cfg, 3)
    state = tr.init_state(0)._replace(step=100)     # the cache gate opens
    for b in (b0, b1):
        state, _ = tr.step(state, b)
    training.save_state(str(tmp_path), state.step, state)
    step, got = training.restore_state(str(tmp_path), tr.init_state(1))
    assert step == got.step == state.step == 102
    assert all(torch.equal(a, b) for a, b in
               zip(_state_leaves(got), _state_leaves(state)))
    assert int((state.cache.written_step >= 0).sum()) > 0
    assert torch.equal(got.rng.get_state(), state.rng.get_state())
    got, mg = tr.step(got, b2)
    state, ms = tr.step(state, b2)
    assert torch.equal(mg["loss"], ms["loss"])
    assert all(torch.equal(a, b) for a, b in
               zip(_state_leaves(got), _state_leaves(state)))


def test_async_snapshot_is_not_changed_by_the_next_step(tmp_path,
                                                        monkeypatch):
    """The step updates the state in place; the writer's host copy is
    taken before ``save`` returns, so a step run before the write reaches
    the disk does not change what is written."""
    import repro_torch.checkpoint.ckpt as C
    tr = _small_trainer()
    b0, b1 = _synth_batches(tr.cfg, 2)
    state, _ = tr.step(tr.init_state(0), b0)
    before = [t.clone() for t in _state_leaves(state)]
    stepped = __import__("threading").Event()
    real_savez = C.np.savez

    def late_savez(path, **arrays):
        assert stepped.wait(30)
        real_savez(path, **arrays)

    monkeypatch.setattr(C.np, "savez", late_savez)
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    training.save_state(str(tmp_path), state.step, state, writer=w)
    state, _ = tr.step(state, b1)                   # in place
    stepped.set()
    w.wait()
    monkeypatch.setattr(C.np, "savez", real_savez)
    _, got = training.restore_state(str(tmp_path), tr.init_state(1))
    assert all(torch.equal(a, b)
               for a, b in zip(_state_leaves(got), before))
    assert not all(torch.equal(a, b) for a, b in
                   zip(_state_leaves(got), _state_leaves(state)))


def test_generator_across_device_types_raises(tmp_path):
    tr = _small_trainer()
    state = tr.init_state(0)
    tree = training.to_ckpt_tree(state)
    tree["torch_rng"] = np.zeros(16, np.uint8)      # a CUDA generator's
    ckpt.save(str(tmp_path), 3, tree)
    with pytest.raises(ValueError, match=r"16 bytes \(a cuda generator's\)"
                       r".*on cpu \(5056 bytes\)"):
        training.restore_state(str(tmp_path), tr.init_state(1))


def test_fit_checkpoints_and_resumes(tmp_path):
    """``fit`` saves on its cadence and a second fit resumes from the
    newest step; a directory whose snapshots are all corrupt warns and
    starts from scratch."""
    res = train.train_speedyfeed(steps=6, ckpt_dir=str(tmp_path),
                                 ckpt_every=3, log_every=3, device="cpu")
    assert res.resumed_from is None and res.steps_done == 6
    assert ckpt.all_steps(str(tmp_path)) == [3, 6]
    res2 = train.train_speedyfeed(steps=8, ckpt_dir=str(tmp_path),
                                  ckpt_every=3, log_every=4, device="cpu",
                                  async_ckpt=False)
    assert res2.resumed_from == 6 and res2.steps_done == 8
    assert len(res2.losses) == 2 and res2.state.step == 8
    _corrupt_npz(tmp_path, 3)
    _corrupt_npz(tmp_path, 6)
    with pytest.warns(UserWarning, match="training from scratch"):
        res3 = train.train_speedyfeed(steps=2, ckpt_dir=str(tmp_path),
                                      ckpt_every=10, device="cpu")
    assert res3.resumed_from is None and res3.steps_done == 2


# -------------------------------------------------- across the packages

def _loader_batches(**over):
    jcfg = jtrain.small_speedyfeed_config(**over)
    _, log, store, lcfg = jtrain.make_loader(jcfg, n_news=400, n_users=80)
    b = jdata.DynamicBatcher(log, store, lcfg, n_threads=1, seed=3)
    b.start()
    out = []
    try:
        while (item := b.get(timeout=10)) is not jdata.EPOCH_END:
            if item["_bucket"] == 16:
                out.append({k: v for k, v in item.items()
                            if not k.startswith("_")})
    finally:
        b.stop()
    return out[:2]


def _draws(key, step, batch, jcfg):
    """The JAX step's two random draws at ``step``, for the port."""
    rng = jax.random.fold_in(key, step)
    rng_cache, rng_neg = jax.random.split(rng)
    neg = jcore.sample_negatives(rng_neg, jcfg.merged_cap,
                                 batch["hist_mask"][:, 1:].shape, jcfg.n_neg)
    return rng, float(jax.random.uniform(rng_cache)), torch.as_tensor(
        np.asarray(neg))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Three JAX steps from step 100 (the cache gate open), the state
    saved by JAX at step 103, then two more JAX steps for reference."""
    over = dict(encode_budget=32)          # overflow: encode and reuse mix
    jcfg = jtrain.small_speedyfeed_config(attn_impl="xla", **over)
    batches = _loader_batches(**over)
    key = jax.random.PRNGKey(0)
    jparams, jcache = jcore.speedyfeed_state(jcfg, key)
    jopt = joptim.adam_init(jparams)
    jstep = jax.jit(jmake_step(jcfg))

    def run(params, opt, cache, steps):
        losses = []
        for step in steps:
            batch = batches[step % 2]
            rng = _draws(key, step, batch, jcfg)[0]
            params, opt, cache, m = jstep(params, opt, cache,
                                          jnp.int32(step), rng, batch)
            losses.append(float(m["loss"]))
        return params, opt, cache, losses

    jparams, jopt, jcache, _ = run(jparams, jopt, jcache, range(100, 103))
    jstate = jtraining.make_state(jparams, jopt, jcache, step=103, rng=key)
    d = tmp_path_factory.mktemp("jax_ckpt")
    jtraining.save_state(str(d), 103, jstate)
    after = run(jparams, jopt, jcache, range(103, 105))
    return dict(jcfg=jcfg, tcfg=train.small_speedyfeed_config(**over),
                batches=batches, key=key, jstate=jstate, dir=str(d),
                after=after)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def _port_like(cfg, seed=1):
    return training.get_trainer("speedyfeed", cfg=cfg,
                                device="cpu").init_state(seed)


def _bridged(jstate):
    return state_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.opt),
        (np.asarray(jstate.cache.emb), np.asarray(jstate.cache.written_step)),
        int(jstate.step), seed=7, device="cpu")


def test_port_manifest_equals_jax_manifest(jax_run, tmp_path):
    """A bridged state saved by the port: the same keys, shapes, dtypes and
    checksums as the JAX state saved by JAX, apart from each package's
    generator key."""
    training.save_state(str(tmp_path), 103, _bridged(jax_run["jstate"]))
    mj, mt = _manifest(jax_run["dir"], 103), _manifest(str(tmp_path), 103)
    assert set(mj["keys"]) ^ set(mt["keys"]) == GEN_KEYS
    assert "params::plm::layers::attn::q::w" in mt["keys"]
    for field in ("shapes", "dtypes", "checksums"):
        assert ({k: v for k, v in mj[field].items() if k not in GEN_KEYS}
                == {k: v for k, v in mt[field].items() if k not in GEN_KEYS})
    assert mt["shapes"]["torch_rng"] == [5056]
    assert mt["dtypes"]["step"] == "int32" and mt["step"] == mj["step"]


def test_jax_restores_a_port_checkpoint(jax_run, tmp_path):
    """JAX's ``restore_state`` of a port checkpoint: arrays equal to the
    port's; JAX keeps its own PRNG key and ignores ``torch_rng``."""
    state = _bridged(jax_run["jstate"])
    training.save_state(str(tmp_path), 103, state)
    key = jax.random.PRNGKey(11)
    jlike = jtraining.make_state(*jax.tree.map(
        jnp.zeros_like, (jax_run["jstate"].params, jax_run["jstate"].opt,
                         jax_run["jstate"].cache)), rng=key)
    step, got = jtraining.restore_state(str(tmp_path), jlike)
    assert step == int(got.step) == 103
    _eq(got.rng, key)
    want = ckpt.ckpt._flatten(training.to_ckpt_tree(state))
    have = jckpt.ckpt._flatten(jtraining.to_ckpt_tree(got))
    assert set(have) - GEN_KEYS == set(want) - GEN_KEYS
    for k in set(have) - GEN_KEYS:
        assert have[k].dtype == want[k].dtype, k
        _eq(have[k], want[k])


@pytest.mark.parametrize("legacy", [False, True], ids=["current", "age"])
def test_port_restores_a_jax_checkpoint(jax_run, tmp_path, legacy):
    """The port's ``restore_state`` of a JAX checkpoint (and of the legacy
    ``{params, opt, cache: {emb, age}}`` layout): tensors equal to JAX's,
    and the ``like`` state's seeded generator kept."""
    js = jax_run["jstate"]
    d = jax_run["dir"]
    if legacy:
        d = str(tmp_path)
        jckpt.save(d, 103, {"params": js.params, "opt": js.opt,
                            "cache": {"emb": js.cache.emb,
                                      "age": js.cache.written_step}})
    like = _port_like(jax_run["tcfg"])
    gen_state = like.rng.get_state().clone()
    step, got = training.restore_state(d, like)
    assert step == got.step == 103
    assert got.rng is like.rng
    assert torch.equal(got.rng.get_state(), gen_state)
    want = jckpt.ckpt._flatten(jtraining.to_ckpt_tree(js))
    have = ckpt.ckpt._flatten(training.to_ckpt_tree(got))
    assert set(have) - GEN_KEYS == set(want) - GEN_KEYS
    for k in set(have) - GEN_KEYS:
        assert have[k].dtype == want[k].dtype, k
        _eq(have[k], want[k])
    # the per-layer lists are views of nothing on disk: each its own tensor
    layers = got.params["plm"]["layers"]
    assert len(layers) == jax_run["tcfg"].plm.n_layers
    exp = params_from_jax(jax.tree.map(np.asarray, js.params), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves(got.params), leaves(exp)))


def test_port_continues_a_jax_run(jax_run):
    """3 JAX steps, a JAX save, then the port's restore and 2 port steps
    with the JAX draws injected: within STEP_TOL of the 2 JAX steps."""
    jcfg, tcfg = jax_run["jcfg"], jax_run["tcfg"]
    _, state = training.restore_state(jax_run["dir"], _port_like(tcfg))
    tstep = make_sf_train_step(tcfg)
    params, opt, cache = state.params, state.opt, state.cache
    jparams, jopt, jcache, jlosses = jax_run["after"]
    for i, step in enumerate(range(103, 105)):
        batch = jax_run["batches"][step % 2]
        _, u, neg = _draws(jax_run["key"], step, batch, jcfg)
        tb = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
        params, opt, cache, tm = tstep(params, opt, cache, step, None, tb,
                                       u=u, neg_idx=neg)
        assert abs(float(tm["loss"]) - jlosses[i]) <= STEP_TOL, step
    exp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    worst = max(float((a.detach() - b).abs().max())
                for (_, a), (_, b) in zip(leaves(params), leaves(exp)))
    assert worst <= STEP_TOL, worst
    np.testing.assert_allclose(cache.emb.numpy(), np.asarray(jcache.emb),
                               rtol=0, atol=STEP_TOL)
    _eq(cache.written_step, jcache.written_step)
    assert int(opt["count"]) == int(jopt["count"]) == 5


def test_stack_layers_inverts_split_layers():
    state = _port_like(train.small_speedyfeed_config())
    stacked = stack_layers(state.params)
    assert stacked["plm"]["layers"]["attn"]["q"]["w"].shape == (2, 64, 64)
    from repro_torch.bridge import split_layers
    back = split_layers(stacked)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves(back), leaves(state.params)))
