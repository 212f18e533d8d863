"""The serving slice end to end on the CPU: the port's Recommender against
the JAX package's, on bridged parameters, the same corpus, and a bridged
IVF-PQ snapshot; the launcher's closed loop on the request scheduler, and
its open-loop, chaos, autotune and metrics flags."""
import json
import pathlib
import re
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.serving import loadgen as jloadgen  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    params_from_jax, snapshot_from_arrays)
from repro_torch import obs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.serving.scheduler import bucket_for, pow2_buckets  # noqa: E402

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
    obs.reset()
    # a 50 ms flush window: the 21 submissions gather into 8 + 8 + 5
    results, n_batches = tserve.micro_batch_loop(rec, reqs, max_batch=8,
                                                 max_wait_ms=50)
    assert n_batches == 3 and len(results) == 21
    assert all(len(r) == 10 and (r > 0).all() for r in results)
    e2e = obs.histogram("query_latency_ms", phase="e2e")
    execute = obs.histogram("query_latency_ms", phase="execute")
    assert e2e.count == execute.count == 21
    assert obs.counter("serve_batches_total").value == n_batches
    assert e2e.percentile(50) >= execute.percentile(50) > 0
    # a partial batch pads to the smallest power-of-two bucket that fits
    buckets = pow2_buckets(8)
    assert bucket_for(5, buckets) == 8 and bucket_for(3, pow2_buckets(16)) == 4
    _, ids = rec.recommend(*tserve._pad_histories(rec, reqs[:3], 4))
    for a, b in zip(results[:3], ids):
        np.testing.assert_array_equal(a, b)
    recall = tserve.measure_recall(rec, reqs, k=10, probe=8)
    assert 0.0 < recall <= 1.0


def test_serve_main_on_the_cpu():
    # a 50 ms flush window: the 16 submissions always gather into 2 batches
    stats = tserve.main(["--device", "cpu", "--requests", "16", "--batch",
                         "8", "--index", "ivf-flat", "--nprobe", "8",
                         "--max-wait-ms", "50"])
    assert stats.n_requests == 16 and stats.n_batches == 2
    assert stats.ntotal == 2000 and stats.index_version == 1
    assert stats.p99_ms >= stats.p50_ms > 0
    assert 0.0 < stats.recall_at_k <= 1.0


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tree_state(path: pathlib.Path) -> dict:
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(path.rglob("*")) if p.is_file()}


def test_serve_main_open_loop_sweep(tmp_path):
    bench_before = _tree_state(ROOT / "benchmarks")
    out = tmp_path / "b.json"
    stats = tserve.main(["--device", "cpu", "--open-loop", "--sweep", "20",
                         "40", "--duration", "0.2", "--bench-out", str(out)])
    assert _tree_state(ROOT / "benchmarks") == bench_before
    (entry,) = stats.load_sweep
    # the JAX package's keys, entry and points
    jentry = jloadgen.sweep(types.SimpleNamespace(
        max_batch=16, max_wait_ms=2.0, max_queue=256, buckets=(1, 2)), [],
        [], extra={"index": "ivf-pq", "ntotal": 0})
    assert set(entry) == set(jentry)
    jpoint = jloadgen.summarize([], 0, 0, qps=1.0, duration_s=1.0,
                                slo_ms=None)
    assert [set(p) for p in entry["points"]] == [set(jpoint)] * 2
    assert entry["scenario"] == "quiescent" and entry["slo_ms"] == 250.0
    assert [p["offered_qps"] for p in entry["points"]] == [20.0, 40.0]
    for p in entry["points"]:
        assert p["completed"] + p["rejected"] + p["late_dropped"] \
            + p["errors"] == p["offered"]
        assert p["offered"] == len(jloadgen.arrival_offsets(
            p["offered_qps"], 0.2, 11 + entry["points"].index(p)))
    assert json.loads(out.read_text()) == {"results": [entry]}
    assert stats.n_requests == obs.counter("serve_requests_total").value > 0


def test_serve_main_chaos_rebuild_mid_loop_ends_healthy(capsys):
    stats = tserve.main(["--device", "cpu", "--requests", "32", "--batch",
                         "8", "--max-wait-ms", "0", "--rebuild-mid-loop",
                         "--chaos-rebuild-failures", "1"])
    printed = capsys.readouterr().out
    m = re.search(r"chaos: (\d+) rebuild faults injected over (\d+) build "
                  r"attempts; health now (\w+)", printed)
    assert m and m.groups() == ("1", "2", "healthy"), printed
    assert faults.active() is None              # disarmed in finally
    assert obs.counter("index_build_failures_total", mode="full").value == 1
    assert obs.counter("index_build_retries_total", mode="full").value == 1
    assert obs.counter("health_transitions_total", component="index",
                       to="degraded").value == 1
    assert obs.counter("health_transitions_total", component="index",
                       to="healthy").value == 1
    assert stats.index_version == 2 and stats.n_swaps == 2
    assert stats.n_requests == 32


def test_serve_main_autotune_installs_the_printed_winner(monkeypatch,
                                                         capsys):
    installed = {}
    real_tune = tserve.tune

    def spy(rec, reqs, args):
        best = real_tune(rec, reqs, args)
        installed.update(nprobe=rec.service.snapshot().nprobe,
                         k_prime=rec.service.k_prime,
                         builder_nprobe=rec.service.builder.ivf.nprobe)
        return best

    monkeypatch.setattr(tserve, "tune", spy)
    tserve.main(["--device", "cpu", "--requests", "16", "--batch", "8",
                 "--autotune"])
    m = re.search(r"autotuned: nprobe=(\d+) k'=(\d+) recall@10=([\d.]+) "
                  r"\(([\d.]+)ms/batch, 12 configs tried\)",
                  capsys.readouterr().out)
    assert m
    nprobe, k_prime = int(m.group(1)), int(m.group(2))
    assert installed == {"nprobe": nprobe, "k_prime": k_prime,
                         "builder_nprobe": nprobe}
    assert obs.gauge("index_tuned_nprobe").value == nprobe
    assert obs.gauge("index_tuned_k_prime").value == k_prime


def test_serve_main_metrics_out(tmp_path):
    out = tmp_path / "m.jsonl"
    tserve.main(["--device", "cpu", "--requests", "16", "--batch", "8",
                 "--metrics-out", str(out)])
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert lines
    metrics = lines[-1]["metrics"]
    e2e = metrics['query_latency_ms{phase="e2e"}']
    assert e2e["count"] == 16 and e2e["p99"] >= e2e["p50"] > 0
    assert metrics["index_swap_total"] == 1
    assert metrics['query_latency_ms{phase="queued"}']["count"] == 16
    assert metrics["serve_requests_total"] == 16
