"""The port's retrieval tier against the JAX package's.

Quantizers trained by the two packages draw from different random
streams, so the parity tests score on identical quantizers: codebooks and
IVF snapshots built by the JAX package and bridged into the port. The
port's own build is held to the JAX build by recall instead.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.serving import index as jindex  # noqa: E402
from repro.serving import online as jonline  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.bridge import snapshot_from_arrays  # noqa: E402
from repro_torch.serving import index as tindex  # noqa: E402

SCORE_TOL = 1e-4       # ADC / inner-product scores, f32, other sum order
LUT_TOL = 1e-5
DISTORTION_TOL = 0.01  # share of residual energy the PQ codes lose


def make_corpus(n=2000, d=32, rank=8, seed=0):
    """Low-rank + noise vectors (the spectral shape of PLM embeddings)."""
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(rank, d))
    x = rng.normal(size=(n, rank)) @ basis + 0.1 * rng.normal(size=(n, d))
    return x.astype(np.float32)


def bridge(snap):
    """A JAX IndexSnapshot's arrays -> the port's snapshot on the CPU."""
    return snapshot_from_arrays(
        version=snap.version, kind=snap.kind, dim=snap.dim,
        ntotal=snap.ntotal, nprobe=snap.nprobe, metric=snap.metric,
        cent_unit=np.asarray(snap.cent_unit),
        cent_raw=np.asarray(snap.cent_raw),
        list_ids=np.asarray(snap.list_ids), payload=np.asarray(snap.payload),
        lens=np.asarray(snap.lens),
        pq_centers=(None if snap.pq_centers is None
                    else np.asarray(snap.pq_centers)),
        device="cpu")


def assert_same_topk(got_s, got_i, exp_s, exp_i):
    """Scores within SCORE_TOL and equal id sets per row (the two
    frameworks' top-k order ties differently)."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    np.testing.assert_allclose(got_s, np.asarray(exp_s, np.float32),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    for a, b in zip(got_i, np.asarray(exp_i)):
        assert set(a.tolist()) == set(b.tolist())


@pytest.fixture(scope="module")
def corpus():
    x = make_corpus()
    q = make_corpus(16, seed=7)
    ids = np.arange(1, x.shape[0] + 1)
    return x, q, ids


@pytest.fixture(scope="module")
def jax_snapshots(corpus):
    x, _, ids = corpus
    out = {}
    for kind in ("ivf-flat", "ivf-pq"):
        b = jserving.IndexBuilder(kind, x.shape[1],
                                  ivf=jserving.IVFConfig(nlist=16, nprobe=4))
        out[kind] = b.build(ids, x)
    return out


# ---------------------------------------------------------------- PQ core
def test_pq_encode_lut_decode_match_jax_on_a_bridged_codebook(corpus):
    x, q, _ = corpus
    jcb = jserving.pq_train(jax.random.PRNGKey(0), jnp.asarray(x[:600]),
                            jserving.PQConfig())
    tcb = serving.PQCodebook(torch.tensor(np.asarray(jcb.centers)))
    jcodes = np.asarray(jserving.pq_encode(jcb, jnp.asarray(x)))
    tcodes = serving.pq_encode(tcb, torch.tensor(x))
    assert tcodes.dtype == torch.uint8
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    np.testing.assert_allclose(
        serving.pq_lut(tcb, torch.tensor(q)).numpy(),
        np.asarray(jserving.pq_lut(jcb, jnp.asarray(q))),
        rtol=LUT_TOL, atol=LUT_TOL)
    np.testing.assert_allclose(
        serving.pq_decode(tcb, torch.tensor(jcodes)).numpy(),
        np.asarray(jserving.pq_decode(jcb, jnp.asarray(jcodes))),
        rtol=0, atol=0)
    # the flat ADC scan (the LUT kernel's shared-codes path)
    ts, tr = serving.pq_search(tcb, torch.tensor(jcodes), torch.tensor(q), 10)
    js, jr = jserving.pq_search(jcb, jnp.asarray(jcodes), q, 10)
    assert_same_topk(ts, tr, js, jr)


# ----------------------------------------------- search on bridged snapshots
@pytest.mark.parametrize("kind", ["ivf-flat", "ivf-pq"])
def test_snapshot_search_matches_jax(corpus, jax_snapshots, kind):
    _, q, _ = corpus
    jsnap = jax_snapshots[kind]
    tsnap = bridge(jsnap)
    assert tsnap.ntotal == jsnap.ntotal and tsnap.cap == jsnap.cap
    np.testing.assert_array_equal(np.sort(tsnap.member_ids),
                                  np.sort(jsnap.member_ids))
    exp_s, exp_i = jsnap.search(q, 10)
    got_s, got_i = tsnap.search(q, 10)
    assert_same_topk(got_s, got_i, exp_s, exp_i)


@pytest.mark.parametrize("dense", [True, False])
def test_search_flat_csr_matches_jax(corpus, jax_snapshots, dense):
    _, q, _ = corpus
    s = jax_snapshots["ivf-flat"]
    exp = jindex._search_flat_csr(
        jnp.asarray(q), s.cent_unit, s.cent_raw, s.list_ids, s.payload,
        s.lens, nprobe=4, k=10, metric="l2", dense=dense)
    t = bridge(s)
    got = tindex._search_flat_csr(
        torch.tensor(q), t.cent_unit, t.cent_raw, t.list_ids, t.payload,
        t.lens, nprobe=4, k=10, metric="l2", dense=dense)
    assert_same_topk(*got, *exp)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_search_pq_csr_matches_jax(corpus, jax_snapshots, metric):
    _, q, _ = corpus
    s = jax_snapshots["ivf-pq"]
    exp = jindex._search_pq_csr(
        jnp.asarray(q), s.cent_unit, s.cent_raw, s.list_ids, s.payload,
        s.lens, s.pq_centers, None, nprobe=4, k=10, metric=metric,
        block_n=256)
    t = bridge(s)
    got = tindex._search_pq_csr(
        torch.tensor(q), t.cent_unit, t.cent_raw, t.list_ids, t.payload,
        t.lens, t.pq_centers, None, nprobe=4, k=10, metric=metric)
    assert_same_topk(*got, *exp)


@pytest.mark.parametrize("kind", ["ivf-flat", "ivf-pq"])
def test_service_query_on_a_bridged_snapshot_matches_jax(corpus,
                                                        jax_snapshots, kind):
    """The two-stage query (k' recall + exact re-rank) over one snapshot."""
    x, q, _ = corpus
    store = np.concatenate([np.zeros((1, x.shape[1]), np.float32), x])
    ivf = jserving.IVFConfig(nlist=16, nprobe=4)
    jsvc = jserving.RetrievalService(
        jserving.IndexBuilder(kind, x.shape[1], ivf=ivf), store, k=10,
        k_prime=48)
    jsvc.swap(jax_snapshots[kind])
    tsvc = serving.RetrievalService(
        serving.IndexBuilder(kind, x.shape[1], ivf=serving.IVFConfig(
            nlist=16, nprobe=4), device="cpu"), store, k=10, k_prime=48,
        device="cpu")
    tsvc.swap(bridge(jax_snapshots[kind]))
    assert_same_topk(*tsvc.query(q), *jsvc.query(q))


# ------------------------------------------- host-side merge, exact equality
def test_merge_topk_dedup_equals_jax_exactly():
    rng = np.random.default_rng(3)
    B, C, k = 6, 40, 12
    scores = rng.integers(-5, 5, (B, C)).astype(np.float32)   # many ties
    scores[rng.random((B, C)) < 0.1] = -np.inf
    ids = rng.integers(0, 15, (B, C)).astype(np.int64)        # duplicates
    ids[rng.random((B, C)) < 0.15] = jserving.PAD_ID
    es, ei = jserving.merge_topk_dedup(scores, ids, k)
    gs, gi = serving.merge_topk_dedup(torch.tensor(scores), torch.tensor(ids),
                                      k)
    np.testing.assert_array_equal(gs.numpy(), es)
    np.testing.assert_array_equal(gi.numpy(), ei)


class _FixedMain:
    """A main tier returning fixed results (both packages see the same)."""

    def __init__(self, scores, ids):
        self.scores, self.ids = scores, ids

    def search(self, queries, k):
        s, i = self.scores[:, :k], self.ids[:, :k]
        if not isinstance(queries, torch.Tensor):   # the JAX package's call
            return s, i
        return torch.tensor(s), torch.tensor(i)


def test_hybrid_search_equals_jax_exactly():
    """Over-fetch, stale nulling and the merge, on integer-valued data so
    both frameworks compute identical delta scores."""
    rng = np.random.default_rng(5)
    B, d, k = 4, 8, 6
    main_ids = np.stack([rng.permutation(np.arange(1, 40))[:32]
                         for _ in range(B)]).astype(np.int64)
    main_s = -np.sort(-rng.integers(-20, 20, (B, 32)), axis=1).astype(
        np.float32)
    q = rng.integers(-2, 3, (B, d)).astype(np.float32)
    d_ids = np.array([3, 7, 11, 50, 51], np.int64)     # 3 overlap the main
    d_emb = rng.integers(-2, 3, (5, d)).astype(np.float32)
    exp = jonline.hybrid_search(
        _FixedMain(main_s, main_ids), jonline.DeltaView(d_ids, d_emb), q, k)
    got = serving.hybrid_search(
        _FixedMain(main_s, main_ids),
        serving.DeltaView(d_ids, d_emb, torch.device("cpu")),
        torch.tensor(q), k)
    np.testing.assert_array_equal(got[0].numpy(), exp[0])
    np.testing.assert_array_equal(got[1].numpy(), exp[1])


def test_csr_append_and_remove_equal_jax_exactly():
    rng = np.random.default_rng(9)
    nlist, cap, M = 6, 16, 4
    lens = rng.integers(0, 8, nlist).astype(np.int32)
    list_ids = np.full((nlist, cap), -1, np.int32)
    payload = np.zeros((nlist, cap, M), np.uint8)
    nid = 100
    for c in range(nlist):
        list_ids[c, :lens[c]] = np.arange(nid, nid + lens[c])
        payload[c, :lens[c]] = rng.integers(0, 255, (lens[c], M))
        nid += lens[c]
    assign = rng.integers(0, nlist, 20).astype(np.int32)
    new_ids = np.arange(500, 520, dtype=np.int32)
    new_payload = rng.integers(0, 255, (20, M)).astype(np.uint8)
    exp = jindex._csr_append(jnp.asarray(list_ids), jnp.asarray(payload),
                             jnp.asarray(lens), jnp.asarray(assign),
                             jnp.asarray(new_ids), jnp.asarray(new_payload))
    got = tindex._csr_append(torch.tensor(list_ids), torch.tensor(payload),
                             torch.tensor(lens), torch.tensor(assign).long(),
                             torch.tensor(new_ids), torch.tensor(new_payload))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    drop = np.array([100, 101, 505, 519, 999], np.int32)
    exp = jindex._csr_remove(*exp, jnp.asarray(drop))
    got = tindex._csr_remove(*got, torch.tensor(drop))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


# --------------------------------------------------- lifecycle on the port
def test_snapshot_never_changes_after_compaction(corpus):
    """Compaction copies the snapshot's tensors before it writes."""
    x, q, ids = corpus
    b = serving.IndexBuilder("ivf-pq", x.shape[1], device="cpu",
                             ivf=serving.IVFConfig(nlist=16, nprobe=16))
    snap1 = b.build(ids[:1500], x[:1500])
    s1, i1 = snap1.search(q, 10)
    payload1 = snap1.payload.clone()
    snap2 = b.compact(snap1, ids[1500:], x[1500:])
    assert snap2.ntotal == 2000 and snap1.ntotal == 1500
    assert torch.equal(snap1.payload, payload1)
    s1b, i1b = snap1.search(q, 10)
    assert torch.equal(s1, s1b) and torch.equal(i1, i1b)


def test_publish_then_background_rebuild_serves_fresh_ids(corpus):
    x, q, ids = corpus
    store = np.concatenate([np.zeros((1, x.shape[1]), np.float32), x])
    svc = serving.RetrievalService(
        serving.IndexBuilder("ivf-flat", x.shape[1], device="cpu",
                             ivf=serving.IVFConfig(nlist=16, nprobe=16)),
        store, k=10, auto_compact=False, device="cpu")
    svc.publish(ids[:1800], x[:1800])
    svc.rebuild(mode="full", block=True)
    fresh = ids[1800:]
    svc.publish(fresh, x[1800:])                       # into the delta tier
    assert svc.n_pending == 200
    # exhaustive probing: (snapshot + delta) must equal exact MIPS
    exact = ids[np.argsort(-(q @ x.T), axis=1)[:, :10]]
    _, before = svc.query(q)
    assert np.isin(before, fresh).any()               # the delta serves
    for a, b in zip(before, exact):
        assert set(a) == set(b)
    svc.rebuild(mode="compact", block=False)
    svc.wait_for_build()
    assert svc.n_pending == 0 and svc.ntotal == 2000 and svc.version == 2
    _, after = svc.query(q)
    for a, b in zip(after, exact):
        assert set(a) == set(b)


def _recall_case(corpus):
    """Vectors, probe queries, IVF settings, k' and build seeds for the
    recall comparison: the small corpus with one seed, or, where
    REPRO_RECALL_VECTORS names the .npz that ``python -m
    repro_torch.launch.profile --recall-repeat`` writes on the card, the
    serve slice's corpus embeddings (row 0, the pad news, dropped), its
    probe users and index settings, with sixteen seeds."""
    path = os.environ.get("REPRO_RECALL_VECTORS")
    if not path:
        x, q, ids = corpus
        return x, q, ids, dict(nlist=16, nprobe=4), None, [0]
    z = np.load(path)
    x = z["emb"][1:]
    ivf = dict(nlist=int(z["nlist"]), nprobe=int(z["nprobe"]),
               metric=str(z["metric"]))
    return (x, z["user"], np.arange(1, x.shape[0] + 1), ivf,
            int(z["k_prime"]), list(range(16)))


def _pq_distortion(store, snap) -> float:
    """sum ||r - decode(code)||^2 / sum ||r||^2 over an IVF-PQ snapshot's
    members, r = x - mean[cell]: the share of residual energy the codes
    lose (numpy, for either package's snapshot)."""
    list_ids, payload, lens = (np.asarray(a) for a in
                               (snap.list_ids, snap.payload, snap.lens))
    cent_raw, centers = np.asarray(snap.cent_raw), np.asarray(snap.pq_centers)
    live = np.arange(list_ids.shape[1])[None] < lens[:, None]
    cells = np.broadcast_to(np.arange(lens.shape[0])[:, None], live.shape)
    r = store[list_ids[live]] - cent_raw[cells[live]]
    codes = payload[live].astype(np.int64)                     # [n, M]
    dec = centers[np.arange(codes.shape[1])[None], codes].reshape(r.shape)
    return float(((r - dec) ** 2).sum() / (r ** 2).sum())


def test_port_build_recall_close_to_jax_build(corpus):
    """Quantizers from torch's RNG: recall@10 against exact MIPS at most
    0.1 below the JAX build's on the same vectors, and the PQ codes' lost
    residual energy at most DISTORTION_TOL above it (means over the
    seeds; the distortion, a mean over every vector, is the steadier of
    the two)."""
    x, q, ids, ivf, k_prime, seeds = _recall_case(corpus)
    exact = x @ q.T
    ref = ids[np.argsort(-exact, axis=0)[:10].T]
    store = np.concatenate([np.zeros((1, x.shape[1]), np.float32), x])

    def recall(found):
        return np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(np.asarray(found), ref)])

    r_jax, r_port, d_jax, d_port = [], [], [], []
    for seed in seeds:
        # a full build installed by swap, as RetrievalService.rebuild
        # does (publishing 16k rows at once would trip the JAX
        # service's delta backpressure)
        jb = jserving.IndexBuilder("ivf-pq", x.shape[1], seed=seed,
                                   ivf=jserving.IVFConfig(**ivf))
        jsvc = jserving.RetrievalService(jb, store, k=10, k_prime=k_prime)
        jsvc.swap(jb.build(ids, x))
        r_jax.append(recall(jsvc.query(q)[1]))
        d_jax.append(_pq_distortion(store, jsvc.snapshot()))
        tb = serving.IndexBuilder("ivf-pq", x.shape[1], device="cpu",
                                  seed=seed, ivf=serving.IVFConfig(**ivf))
        tsvc = serving.RetrievalService(tb, store, k=10, k_prime=k_prime,
                                        device="cpu")
        tsvc.swap(tb.build(ids, x))
        r_port.append(recall(tsvc.query(q)[1]))
        d_port.append(_pq_distortion(store, tsvc.snapshot()))
    print(f"over seeds {seeds}: recall@10 jax {r_jax} port {r_port}; "
          f"PQ distortion jax {d_jax} port {d_port}")
    assert np.mean(r_port) >= np.mean(r_jax) - 0.1, (r_port, r_jax)
    assert np.mean(d_port) <= np.mean(d_jax) + DISTORTION_TOL, (d_port, d_jax)
