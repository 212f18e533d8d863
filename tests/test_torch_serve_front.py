"""The port's degraded-mode service, delta guard, cache ingest, OPQ and
autotuner on the CPU: the contracts of tests/test_resilience.py,
tests/test_serving.py and tests/test_pq_scale.py on ``repro_torch.serving``,
and the deterministic pieces against the JAX package (``ingest_from_cache``
on a bridged cache, ``opq_train`` with the JAX draws injected, the
autotuner's choice on one evaluator table)."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.serving import pq as jpq  # noqa: E402
from repro_torch import obs, serving  # noqa: E402
from repro_torch.resilience import FaultPlan, InjectedFault, faults  # noqa: E402
from repro_torch.serving import pq as tpq  # noqa: E402

ROT_TOL = 1e-4       # OPQ's rotation against JAX's, the draws injected
ORTHO_TOL = 1e-5     # R^T R against the identity


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The k-means and OPQ here are many small ops: on one intra-op thread
    a host loaded with other test workers does not spin its threads
    against theirs (a run under six workers took 100x its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_default_registry():
    obs.reset()
    yield
    obs.reset()
    faults.disarm()


def counter_value(name, **labels):
    return obs.counter(name, **labels).value


def make_corpus(n=2000, d=32, rank=8, seed=0):
    """Low-rank + noise: correlated dims, the regime OPQ exists for."""
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(rank, d))
    x = rng.normal(size=(n, rank)) @ basis + 0.1 * rng.normal(size=(n, d))
    return x.astype(np.float32)


def recall_at_k(ids, ref_ids):
    k = ids.shape[1]
    return np.mean([len(set(ids[b]) & set(ref_ids[b])) / k
                    for b in range(ids.shape[0])])


# ------------------------------------------------- degraded-mode serving

def _make_service(n=300, d=16, **kw):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(1, n + 1)
    store = np.zeros((2 * n + 1, d), np.float32)
    store[ids] = x
    builder = serving.IndexBuilder("ivf-flat", d, device="cpu",
                                   ivf=serving.IVFConfig(nlist=4, nprobe=4))
    kw.setdefault("build_backoff_s", 0.001)
    svc = serving.RetrievalService(builder, store, k=5, k_prime=32,
                                   device="cpu", **kw)
    svc.swap(builder.build(ids, x))
    return svc, x, ids, rng


def test_rebuild_retries_through_transient_failures():
    svc, x, ids, rng = _make_service(build_retries=2)
    f0 = counter_value("index_build_failures_total", mode="full")
    r0 = counter_value("index_build_retries_total", mode="full")
    v0 = svc.version
    with faults.armed(FaultPlan().fail("index.rebuild", calls=1)) as plan:
        snap = svc.rebuild(mode="full", block=True)
    assert plan.fired("index.rebuild") == 1
    assert snap is not None and svc.version > v0
    assert counter_value("index_build_failures_total", mode="full") == f0 + 1
    assert counter_value("index_build_retries_total", mode="full") == r0 + 1
    assert counter_value("index_build_total", mode="full") == 1
    assert obs.histogram("span_ms", name="index_rebuild", mode="full").count \
        == 1                                   # the fault fires before it
    assert svc.health()["status"] == "healthy"   # success reset the streak


def test_background_rebuild_failure_is_never_silent():
    svc, x, ids, rng = _make_service(build_retries=0,
                                     degraded_after_failures=2)
    t0 = counter_value("health_transitions_total", component="index",
                       to="degraded")
    for _ in range(2):
        with faults.armed(FaultPlan().fail("index.rebuild", calls=1)):
            t = svc.rebuild(mode="full", block=False)
            assert t is not None
            with pytest.raises(InjectedFault):
                svc.wait_for_build()
    assert not svc.build_in_flight             # no dangling thread/lock
    assert svc._build_thread is None
    h = svc.health()
    assert h["status"] == "degraded" and not h["components"]["index"]["ok"]
    assert h["components"]["index"]["consecutive_build_failures"] == 2
    assert "InjectedFault" in h["components"]["index"]["last_build_error"]
    assert counter_value("health_transitions_total", component="index",
                         to="degraded") == t0 + 1
    assert obs.gauge("health_status", component="index").value == 0.0
    svc.wait_for_build()                       # raise-once
    q = rng.normal(size=(3, x.shape[1])).astype(np.float32)
    _, got = svc.query(q)
    assert (got != serving.PAD_ID).all()
    svc.rebuild(mode="full", block=True)
    assert svc.health()["status"] == "healthy"
    assert counter_value("health_transitions_total", component="index",
                         to="healthy") >= 1


def test_publish_backpressure_at_delta_hard_cap():
    svc, x, ids, rng = _make_service(compact_threshold=1000,
                                     auto_compact=False, delta_hard_cap=8)
    n, d = x.shape
    fresh = rng.normal(size=(8, d)).astype(np.float32)
    svc.publish(np.arange(n + 1, n + 9), fresh)          # exactly at cap
    assert svc.n_pending == 8
    assert svc.health()["status"] == "degraded"          # cap reached
    assert obs.gauge("index_delta_size").value == 8
    b0 = counter_value("publish_backpressure_total")
    p0 = counter_value("index_publish_total")
    store0, view0 = svc.store.emb.clone(), svc._view
    with pytest.raises(serving.BackpressureError):
        svc.publish(np.array([n + 9]), fresh[:1])
    assert counter_value("publish_backpressure_total") == b0 + 1
    assert counter_value("index_publish_total") == p0
    # the refusal had no side effects: store and view untouched
    assert svc.n_pending == 8 and svc._view is view0
    assert torch.equal(svc.store.emb, store0)
    assert not svc.store.emb[n + 9].any()
    # re-publishing an id already in the delta is an in-place upsert
    svc.publish(np.array([n + 1]), fresh[:1] + 1.0)
    assert svc.n_pending == 8
    q = rng.normal(size=(2, d)).astype(np.float32)
    _, got = svc.query(q)
    assert (got != serving.PAD_ID).all()
    svc.rebuild(mode="full", block=True)
    assert svc.n_pending == 0
    assert svc.health()["status"] == "healthy"
    svc.publish(np.array([n + 9]), fresh[:1])            # accepted again
    assert svc.n_pending == 1


def test_bootstrap_past_the_delta_hard_cap_is_refused_untouched():
    """The Recommender's bootstrap publishes the whole corpus into the
    delta tier, so a corpus past the hard cap (8 x compact_threshold by
    default) is refused before any mutation, as in the JAX package; a cap
    that holds the corpus bootstraps it."""
    from repro_torch.launch import serve as tserve
    x = make_corpus(2000)
    kw = dict(k=10, index_kind="ivf-pq", nprobe=8, compact_threshold=64,
              device="cpu")
    rec = tserve.Recommender(None, {}, None, **kw)
    with pytest.raises(serving.BackpressureError, match="512"):
        rec.build_index_from(torch.as_tensor(x))
    assert rec.service.n_pending == 0 and rec.service.version == 0
    assert counter_value("publish_backpressure_total") == 1
    rec = tserve.Recommender(None, {}, None, service_kw={
        "delta_hard_cap": x.shape[0]}, **kw)
    svc = rec.build_index_from(torch.as_tensor(x))
    assert svc.ntotal == x.shape[0] - 1 and svc.n_pending == 0
    _, got = svc.query(x[1:5])
    assert (got > 0).all()


def test_profile_slice_bootstraps_a_corpus_past_the_default_cap():
    """``launch.profile``'s serve slice over 4,200 news, past the default
    cap of 4,096: every build of ``recall_repeat`` bootstraps and serves."""
    from repro_torch.launch import profile
    rng = np.random.default_rng(3)
    emb = torch.as_tensor(make_corpus(4200, d=16, rank=8, seed=3))
    user = torch.as_tensor(rng.normal(size=(16, 16)).astype(np.float32))
    out = profile.recall_repeat(emb, user, seeds=(0,), repeats=1,
                                small_probe=8, device="cpu")
    assert [r["build"] for r in out["builds"]] == [
        "default-0", "deterministic-0", "cpu-0", "cpu-1"]
    assert all(r["same_snapshot_as_first"] for r in out["builds"][2:])
    assert all(0.0 < r["recall_at_10"] <= 1.0 for r in out["builds"])


def test_delta_overflow_guard_is_upsert_aware():
    buf = serving.DeltaBuffer(4, max_size=2, device="cpu")
    buf.add([1, 2], np.ones((2, 4), np.float32))
    assert buf.would_overflow([3]) and not buf.would_overflow([1, 2])
    with pytest.raises(serving.DeltaOverflowError):
        buf.add([3], np.ones((1, 4), np.float32))
    buf.add([2], np.zeros((1, 4), np.float32))           # upsert: fine
    assert len(buf) == 2


def test_lifecycle_gauges_and_counters():
    svc, x, ids, rng = _make_service(auto_compact=False)
    assert obs.gauge("index_snapshot_version").value == svc.version == 1
    assert obs.gauge("index_staleness_s").value >= 0.0
    assert counter_value("index_swap_total") == 1
    svc.publish(np.array([400]), x[:1])
    assert counter_value("index_publish_total") == 1
    svc.rebuild(mode="compact", block=True)
    assert counter_value("index_build_total", mode="compact") == 1
    assert counter_value("index_swap_total") == 2
    assert obs.gauge("index_snapshot_version").value == svc.version == 2
    assert obs.gauge("health_status", component="service").value == 1.0
    assert svc.store_emb is svc.store.emb


# ------------------------------------------------------------ cache ingest

def test_ingest_from_cache_matches_jax():
    from repro.core.cache import CacheConfig as JCacheConfig
    from repro.core.cache import CacheState as JCacheState
    from repro.core.cache import init_cache as jinit_cache
    from repro_torch.core.cache import NEVER, CacheState
    jstate = jinit_cache(JCacheConfig(n_news=50, news_dim=8))
    emb = jnp.arange(50 * 8, dtype=jnp.float32).reshape(50, 8)
    written = jstate.written_step.at[jnp.array([3, 7, 11])].set(5)
    jstate = JCacheState(emb, written)
    state = CacheState(torch.as_tensor(np.array(emb)),
                       torch.as_tensor(np.array(written)))
    assert int(state.written_step[0]) == NEVER
    ids = [3, 7, 9, 11]
    jdelta = jserving.DeltaBuffer(8)
    delta = serving.DeltaBuffer(8, device="cpu")
    n_j = jserving.ingest_from_cache(jdelta, jstate, ids)
    n_t = serving.ingest_from_cache(delta, state, ids)
    assert n_t == n_j == 3 and len(delta) == len(jdelta) == 3  # 9: never
    np.testing.assert_array_equal(delta.ids, jdelta.ids)
    np.testing.assert_array_equal(delta.emb, np.asarray(jdelta.emb))
    np.testing.assert_allclose(delta.emb[0], np.asarray(emb[3]))
    assert serving.ingest_from_cache(delta, state, [9, 20]) == 0


def test_compact_into_upserts_and_clears():
    x = make_corpus(400, d=16)
    ids = np.arange(1, 401)
    idx = serving.make_index("ivf-flat", 16, device="cpu",
                             ivf=serving.IVFConfig(nlist=8, nprobe=8))
    idx.train(torch.Generator().manual_seed(0), torch.as_tensor(x))
    idx.add(ids, x)
    delta = serving.DeltaBuffer(16, compact_threshold=1, device="cpu")
    q = x[7]
    fresh = 100.0 * q / np.linalg.norm(q)      # beats every row on <q, .>
    delta.add([5], fresh[None])
    delta.compact_into(idx)
    assert len(delta) == 0 and delta.watermark() == 1
    assert idx.ntotal == 400                   # replaced, not appended
    _, got = idx.search(q[None], 5)
    got = np.asarray(got)
    assert got[0, 0] == 5 and len(set(got[0].tolist())) == 5


# ------------------------------------------------------------------- OPQ

class _ScriptedPerms:
    """Stands in for ``torch`` inside ``repro_torch.serving.pq``: every
    ``randperm`` returns the next scripted permutation and ``pq.fork``'s
    child seed draws 0; everything else is torch."""

    def __init__(self, perms):
        self._perms = list(perms)

    def __getattr__(self, name):
        return getattr(torch, name)

    def randint(self, low, high, size, **kw):
        assert high == 2 ** 62                 # only pq.fork draws here
        return torch.zeros(size, dtype=torch.long)

    def randperm(self, n, **kw):
        return self._perms.pop(0)


def _jax_kmeans_perms(key, n, cfg):
    """The k-means seeding draws JAX's opq_train makes for ``key`` over n
    rows (n <= train_sample, so no row sample; Lloyd's, not mini-batch):
    per alternation t and the final fit, per subspace m, ``choice(split(
    fold_in(key, t), M)[m], n, (K,))``, as a permutation led by them."""
    perms = []
    for t in range(cfg.opq_iters + 1):
        keys = jax.random.split(jax.random.fold_in(key, t), cfg.n_subvec)
        for m in range(cfg.n_subvec):
            idx = np.asarray(jax.random.choice(keys[m], n, (cfg.n_codes,),
                                               replace=False))
            perms.append(torch.as_tensor(np.concatenate(
                [idx, np.setdiff1d(np.arange(n), idx)])))
    return perms


def test_opq_train_matches_jax_with_its_draws(monkeypatch):
    """On correlated but full-rank data (an anisotropic Gaussian, rotated):
    x^T rec is well conditioned there, so its polar factor U V^T is
    stable. On make_corpus's rank-8 data its small singular values sit at
    1e-6 of the largest, and the factor turns with the rounding."""
    rng = np.random.default_rng(2)
    basis = np.linalg.qr(rng.normal(size=(16, 16)))[0]
    x = ((rng.normal(size=(600, 16)) * np.linspace(0.5, 3.0, 16)) @ basis
         ).astype(np.float32)
    cfg = tpq.PQConfig(n_subvec=4, n_codes=16, train_iters=8, opq_iters=2)
    jcfg = jpq.PQConfig(n_subvec=4, n_codes=16, train_iters=8, opq_iters=2)
    assert x.shape[0] <= max(2 * cfg.train_batch, 4 * cfg.n_codes)
    key = jax.random.PRNGKey(4)
    fake = _ScriptedPerms(_jax_kmeans_perms(key, x.shape[0], cfg))
    monkeypatch.setattr(tpq, "torch", fake)
    cb = tpq.opq_train(torch.Generator(), torch.as_tensor(x), cfg)
    monkeypatch.undo()
    assert not fake._perms                     # every draw consumed
    jcb = jpq.opq_train(key, jnp.asarray(x), jcfg)
    rot = cb.rot.numpy()
    np.testing.assert_allclose(rot, np.asarray(jcb.rot), rtol=0,
                               atol=ROT_TOL)
    np.testing.assert_allclose(rot.T @ rot, np.eye(16), rtol=0,
                               atol=ORTHO_TOL)
    np.testing.assert_allclose(cb.centers.numpy(), np.asarray(jcb.centers),
                               rtol=0, atol=ROT_TOL)


def test_opq_rotation_is_orthogonal_and_not_worse():
    x = torch.as_tensor(make_corpus(3000))
    cfg = serving.PQConfig(n_subvec=16, n_codes=32, opq_iters=4)
    cb = serving.opq_train(torch.Generator().manual_seed(0), x, cfg)
    r = cb.rot.numpy()
    np.testing.assert_allclose(r.T @ r, np.eye(r.shape[0]), rtol=0,
                               atol=1e-4)
    rec_opq = serving.pq_decode(cb, serving.pq_encode(cb, x)).numpy()
    cb0 = serving.pq_train(torch.Generator().manual_seed(0), x,
                           dataclasses.replace(cfg, opq_iters=0))
    rec_pq = serving.pq_decode(cb0, serving.pq_encode(cb0, x)).numpy()
    xn = x.numpy()
    err_opq = np.linalg.norm(rec_opq - xn) / np.linalg.norm(xn)
    err_pq = np.linalg.norm(rec_pq - xn) / np.linalg.norm(xn)
    assert err_opq <= err_pq + 5e-3, (err_opq, err_pq)


def test_opq_two_stage_recall_not_below_plain_pq():
    x, q = make_corpus(2000), make_corpus(16, seed=7)
    ids = np.arange(1, x.shape[0] + 1)
    exact = serving.IndexBuilder("exact", x.shape[1],
                                 device="cpu").build(ids, x)
    _, ref_ids = exact.search(q, 10)
    ref_ids = ref_ids.numpy()
    store = np.zeros((x.shape[0] + 1, x.shape[1]), np.float32)
    store[ids] = x

    def recall(opq_iters):
        b = serving.IndexBuilder(
            "ivf-pq", x.shape[1], device="cpu",
            ivf=serving.IVFConfig(nlist=32, nprobe=8),
            pq=serving.PQConfig(n_subvec=16, n_codes=32,
                                opq_iters=opq_iters))
        svc = serving.RetrievalService(b, store, k=10, k_prime=100,
                                       device="cpu")
        svc.swap(b.build(ids, x))
        assert (svc.snapshot().pq_rot is None) == (opq_iters == 0)
        _, got = svc.query(q, 10)
        return recall_at_k(got, ref_ids)

    assert recall(4) >= recall(0) - 0.02


def test_pre_opq_snapshot_serves_identically_to_explicit_identity():
    x, q = make_corpus(1500), make_corpus(8, seed=5)
    ids = np.arange(1, x.shape[0] + 1)
    b = serving.IndexBuilder("ivf-pq", x.shape[1], device="cpu",
                             ivf=serving.IVFConfig(nlist=16, nprobe=8),
                             pq=serving.PQConfig(n_subvec=16, n_codes=32))
    snap = b.build(ids, x)
    assert snap.pq_rot is None                     # plain builds stay rot-free
    snap_eye = dataclasses.replace(
        snap, pq_rot=torch.eye(x.shape[1], dtype=torch.float32))
    s0, i0 = snap.search(q, 10)
    s1, i1 = snap_eye.search(q, 10)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    np.testing.assert_allclose(s0.numpy(), s1.numpy(), rtol=1e-5, atol=1e-5)
    extra = make_corpus(64, seed=11)
    snap2 = b.compact(snap, np.arange(2000, 2064), extra)
    assert snap2.ntotal == snap.ntotal + 64 and snap2.pq_rot is None
    _, got = snap2.search(extra[:4], 10)
    got = got.numpy()
    hits = sum(2000 + i in got[i] for i in range(4))   # compressed search:
    assert hits >= 3                                   # allow one PQ miss


# ------------------------------------------------------------- autotuner

@pytest.mark.parametrize("target", [0.9, 0.99, 0.5])
def test_autotune_choice_equals_jax(target):
    rng = np.random.default_rng(int(target * 100))
    table = {(p, kp): (float(rng.uniform(0.6, 1.0)),
                       float(rng.integers(1, 6)))   # cost ties, on purpose
             for p in (4, 8, 16, 32) for kp in (40, 64, 128)}
    kw = dict(nprobes=(4, 8, 16, 32), k_primes=(40, 64, 128),
              target_recall=target)
    got = serving.autotune(lambda p, kp: table[(p, kp)], **kw)
    exp = jserving.autotune(lambda p, kp: table[(p, kp)], **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(exp)
    assert len(got.trials) == 12


def test_autotune_picks_cheapest_config_meeting_target():
    table = {(4, 50): (0.80, 1.0), (4, 100): (0.85, 2.0),
             (8, 50): (0.92, 3.0), (8, 100): (0.97, 5.0)}
    best = serving.autotune(lambda p, kp: table[(p, kp)],
                            nprobes=(4, 8), k_primes=(50, 100),
                            target_recall=0.9)
    assert (best.nprobe, best.k_prime) == (8, 50) and best.met_target
    best = serving.autotune(lambda p, kp: table[(p, kp)],
                            nprobes=(4, 8), k_primes=(50, 100),
                            target_recall=0.99)
    assert (best.nprobe, best.k_prime) == (8, 100) and not best.met_target


def _tune_fixture():
    x, q = make_corpus(1500), make_corpus(16, seed=7)
    ids = np.arange(1, x.shape[0] + 1)
    b = serving.IndexBuilder("ivf-pq", x.shape[1], device="cpu",
                             ivf=serving.IVFConfig(nlist=16, nprobe=2),
                             pq=serving.PQConfig(n_subvec=16, n_codes=32))
    store = np.zeros((x.shape[0] + 1, x.shape[1]), np.float32)
    store[ids] = x
    svc = serving.RetrievalService(b, store, k=10, k_prime=20, device="cpu")
    svc.swap(b.build(ids, x))
    exact = serving.IndexBuilder("exact", x.shape[1],
                                 device="cpu").build(ids, x)
    ref_ids = exact.search(q, 10)[1].numpy()

    def measure():
        _, got = svc.query(q, 10)
        return recall_at_k(got, ref_ids), 1.0

    return svc, b, x, measure


def test_tune_service_installs_winner_and_clamps_grid():
    svc, b, x, measure = _tune_fixture()
    snap0 = svc.snapshot()
    best = serving.tune_service(svc, measure, nprobes=(2, 8, 64),
                                k_primes=(50, 10 ** 6), target_recall=0.9)
    assert best.nprobe <= 16                       # clamped to nlist
    assert best.k_prime <= x.shape[0]              # clamped to ntotal
    assert svc.k_prime == best.k_prime
    assert svc.snapshot().nprobe == best.nprobe
    assert b.ivf.nprobe == best.nprobe             # rebuilds inherit
    # the installed snapshot shares the original's device tensors
    assert svc.snapshot().payload is snap0.payload
    assert svc.snapshot().list_ids is snap0.list_ids
    assert obs.gauge("index_tuned_nprobe").value == best.nprobe
    assert obs.gauge("index_tuned_k_prime").value == best.k_prime
    recall, _ = measure()
    assert recall >= 0.9


def test_tune_service_restores_the_original_without_apply():
    svc, b, x, measure = _tune_fixture()
    snap0, kp0 = svc.snapshot(), svc.k_prime
    best = serving.tune_service(svc, measure, nprobes=(2, 8),
                                k_primes=(50,), target_recall=0.9,
                                apply=False)
    assert len(best.trials) == 2
    assert svc.snapshot() is snap0 and svc.k_prime == kp0
    assert b.ivf.nprobe == 2


# --------------------------------------------- scheduler -> service health

def test_scheduler_on_a_service_degrades_its_health_when_saturated():
    """The scheduler serving the service's own queries: a saturated
    admission queue turns the service degraded, and draining it healthy,
    while the index and delta components stay ok."""
    svc, x, ids, rng = _make_service(auto_compact=False)
    gate = threading.Event()
    started = threading.Event()

    def execute(payloads, pad_to):
        started.set()
        gate.wait(30.0)
        q = np.zeros((pad_to, x.shape[1]), np.float32)
        q[:len(payloads)] = np.stack(payloads)
        _, got = svc.query(q)
        return [got[i] for i in range(len(payloads))]

    sched = serving.RequestScheduler(execute, max_batch=2, max_queue=3)
    try:
        sched.attach_to(svc)
        first = sched.submit(x[0])
        assert started.wait(10.0)
        rest = [sched.submit(x[i]) for i in (1, 2, 3)]
        h = svc.health()
        assert h["status"] == "degraded"
        assert h["components"]["index"]["ok"] and h["components"]["delta"]["ok"]
        assert not h["components"]["scheduler"]["ok"]
        with pytest.raises(serving.BackpressureError):
            sched.submit(x[4])
        gate.set()
        got = [r.result(timeout=10.0) for r in [first] + rest]
        np.testing.assert_array_equal(np.stack(got), svc.query(x[:4])[1])
        assert svc.health()["status"] == "healthy"
        assert svc.health()["components"]["scheduler"]["rejected_total"] == 1
    finally:
        gate.set()
        sched.stop()
