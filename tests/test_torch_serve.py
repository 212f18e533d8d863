"""The serving slice end to end on the CPU: the port's Recommender against
the JAX package's, on bridged parameters, the same corpus, and a bridged
IVF-PQ snapshot."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    params_from_jax, snapshot_from_arrays)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ENCODE_TOL = 5e-4      # the full BusLM encoder (tests/test_kernels.py)
USER_TOL = 1e-4        # gather + attentive pooling over encoded news
N_NEWS, N_USERS = 300, 64


@pytest.fixture(scope="module")
def slice_pair():
    cfg_j = jtrain.small_speedyfeed_config()
    cfg_t = ttrain.small_speedyfeed_config()
    _, jlog, jstore, _ = jtrain.make_loader(cfg_j, n_news=N_NEWS,
                                            n_users=N_USERS)
    _, tlog, tstore, _ = ttrain.make_loader(cfg_t, n_news=N_NEWS,
                                            n_users=N_USERS)
    jparams, _ = jcore.speedyfeed_state(cfg_j, jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jrec = jserve.Recommender(cfg_j, jparams, jstore, k=10,
                              index_kind="ivf-pq", nprobe=4, k_prime=32)
    trec = tserve.Recommender(cfg_t, tparams, tstore, k=10,
                              index_kind="ivf-pq", nprobe=4, k_prime=32,
                              device="cpu")
    return dict(jlog=jlog, tlog=tlog, jstore=jstore, tstore=tstore,
                jrec=jrec, trec=trec)


def test_make_loader_is_bit_identical(slice_pair):
    j, t = slice_pair["jstore"], slice_pair["tstore"]
    np.testing.assert_array_equal(t.tokens, j.tokens)
    np.testing.assert_array_equal(t.freq, j.freq)
    np.testing.assert_array_equal(t.lengths, j.lengths)
    jh, th = slice_pair["jlog"].histories, slice_pair["tlog"].histories
    assert len(jh) == len(th) == N_USERS
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(a, b)


def test_encode_users_and_recommend_match_jax(slice_pair):
    jrec, trec = slice_pair["jrec"], slice_pair["trec"]
    jemb = jrec._encode_corpus()
    temb = trec._encode_corpus()
    assert tuple(temb.shape) == (N_NEWS + 1, 32)
    assert (temb[0] == 0).all()
    np.testing.assert_allclose(temb.numpy(), jemb, rtol=ENCODE_TOL,
                               atol=ENCODE_TOL)

    # both serve the JAX build: the port swaps in its bridged snapshot
    jsvc = jrec.build_index()
    trec.build_index_from(torch.tensor(jemb))
    js = jsvc.snapshot()
    trec.service.swap(snapshot_from_arrays(
        version=js.version, kind=js.kind, dim=js.dim, ntotal=js.ntotal,
        nprobe=js.nprobe, metric=js.metric,
        cent_unit=np.asarray(js.cent_unit), cent_raw=np.asarray(js.cent_raw),
        list_ids=np.asarray(js.list_ids), payload=np.asarray(js.payload),
        lens=np.asarray(js.lens), pq_centers=np.asarray(js.pq_centers),
        device="cpu"))
    assert trec.service.ntotal == N_NEWS

    hist, mask = tserve._pad_histories(trec, slice_pair["tlog"].histories[:16],
                                       16)
    mask[3] = False                            # an empty history
    exp_u = jrec.encode_users(hist.astype(np.int32), mask)
    got_u = trec.encode_users(hist, mask).numpy()
    np.testing.assert_allclose(got_u, exp_u, rtol=USER_TOL, atol=USER_TOL)

    _, exp_ids = jrec.recommend(hist.astype(np.int32), mask)
    _, got_ids = trec.recommend(hist, mask)
    for a, b in zip(got_ids, exp_ids):
        assert set(a.tolist()) == set(b.tolist())


def test_port_build_and_micro_batch_loop(slice_pair):
    """The port's own path: encode, torch-RNG IVF-PQ build, batched
    requests padded to pow2 buckets, and the recall probe."""
    cfg = ttrain.small_speedyfeed_config()
    _, log, store, _ = ttrain.make_loader(cfg, n_news=N_NEWS,
                                          n_users=N_USERS, seed=1)
    params = slice_pair["trec"].params
    rec = tserve.Recommender(cfg, params, store, k=10, index_kind="ivf-pq",
                             nprobe=4, k_prime=32, device="cpu")
    svc = rec.build_index()
    assert svc.ntotal == N_NEWS and svc.version == 1
    reqs = log.histories[:21]
    results, n_batches, lat = tserve.micro_batch_loop(rec, reqs, max_batch=8)
    assert n_batches == 3 and len(results) == len(lat) == 21
    assert all(len(r) == 10 and (r > 0).all() for r in results)
    assert tserve.pow2_bucket(5, 8) == 8 and tserve.pow2_bucket(3, 16) == 4
    recall = tserve.measure_recall(rec, reqs, k=10, probe=8)
    assert 0.0 < recall <= 1.0


def test_serve_main_on_the_cpu():
    stats = tserve.main(["--device", "cpu", "--requests", "16", "--batch",
                         "8", "--index", "ivf-flat", "--nprobe", "8"])
    assert stats.n_requests == 16 and stats.n_batches == 2
    assert stats.ntotal == 2000 and stats.index_version == 1
    assert stats.p99_ms >= stats.p50_ms > 0
    assert 0.0 < stats.recall_at_k <= 1.0
