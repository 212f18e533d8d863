"""The port's continuous-batching scheduler and open-loop load harness:
the contracts of tests/test_scheduler.py on ``repro_torch.serving``, and
the deterministic pieces (shape buckets, arrival traces, summaries, the
sweep merge) against the JAX package's on the same inputs."""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import loadgen as jloadgen  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch import obs, serving  # noqa: E402
from repro_torch.serving import loadgen  # noqa: E402
from repro_torch.serving.scheduler import bucket_for, pow2_buckets  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_default_registry():
    """Scheduler metrics land in the module-default registry; every test
    starts and ends with it empty."""
    obs.reset()
    yield
    obs.reset()


def echo_execute(payloads, pad_to):
    return list(payloads)


def make_sched(execute=echo_execute, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5.0)
    return serving.RequestScheduler(execute, **kw)


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------

def test_pow2_buckets_geometry():
    assert pow2_buckets(1) == (1,)
    assert pow2_buckets(8) == (1, 2, 4, 8)
    assert pow2_buckets(12) == (1, 2, 4, 8, 12)
    for n in range(1, 70):
        assert pow2_buckets(n) == jscheduler.pow2_buckets(n)
    with pytest.raises(ValueError):
        pow2_buckets(0)


def test_bucket_for_picks_smallest_fit():
    b = pow2_buckets(16)
    assert [bucket_for(n, b) for n in (1, 2, 3, 5, 9, 16)] == \
        [1, 2, 4, 8, 16, 16]
    for mb in (1, 5, 12, 16):
        bk = pow2_buckets(mb)
        assert [bucket_for(n, bk) for n in range(1, mb + 3)] == \
            [jscheduler.bucket_for(n, bk) for n in range(1, mb + 3)]


def test_partial_batch_pads_to_smallest_bucket():
    pads = []

    def execute(payloads, pad_to):
        pads.append((len(payloads), pad_to))
        return list(payloads)

    # max_wait high so all three submissions gather into one batch
    sched = make_sched(execute, max_batch=8, max_wait_ms=200.0)
    try:
        hs = [sched.submit(i) for i in range(3)]
        assert [h.result(timeout=10.0) for h in hs] == [0, 1, 2]
    finally:
        sched.stop()
    assert pads == [(3, 4)]
    occ = obs.histogram("sched_batch_occupancy")
    assert occ.count == 1 and 0.7 < occ.sum / occ.count <= 0.76  # 3/4


# ---------------------------------------------------------------------------
# admission + flush
# ---------------------------------------------------------------------------

def test_timeout_flush_of_lone_request():
    sched = make_sched(max_batch=8, max_wait_ms=10.0)
    try:
        t0 = time.monotonic()
        h = sched.submit("solo")
        assert h.result(timeout=10.0) == "solo"
        assert time.monotonic() - t0 < 5.0          # not the 30 s drain path
    finally:
        sched.stop()
    assert obs.counter("sched_flush_total", reason="timeout").value >= 1
    assert h.status == "ok" and h.e2e_ms >= 0.0


def test_bounded_queue_rejects_with_backpressure():
    gate = threading.Event()

    def gated(payloads, pad_to):
        gate.wait(30.0)
        return list(payloads)

    sched = make_sched(gated, max_batch=1, max_queue=2)
    try:
        first = sched.submit("in-flight")
        deadline = time.monotonic() + 10.0     # the worker dequeues it
        while sched.depth and time.monotonic() < deadline:
            time.sleep(0.005)
        q1, q2 = sched.submit("q1"), sched.submit("q2")
        assert sched.saturated
        with pytest.raises(serving.BackpressureError):
            sched.submit("overflow")
        assert obs.counter("serve_rejected_total").value == 1
        gate.set()
        assert [h.result(timeout=10.0) for h in (first, q1, q2)] == \
            ["in-flight", "q1", "q2"]
    finally:
        gate.set()
        sched.stop()


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------

def test_slo_late_drop_and_completed_late():
    def slow(payloads, pad_to):
        time.sleep(0.08)
        return list(payloads)

    sched = make_sched(slow, max_batch=1, max_queue=16, slo_ms=20.0)
    try:
        hs = [sched.submit(i) for i in range(4)]
        for h in hs:
            h.wait(10.0)
    finally:
        sched.stop()
    # the first executes but finishes past its 20 ms deadline (delivered,
    # counted); the ones behind it are expired at dequeue and dropped
    assert hs[0].status == "ok" and not hs[0].slo_ok
    assert hs[0].result() == 0
    late = [h for h in hs if h.status == "late"]
    assert late
    with pytest.raises(serving.DeadlineExceededError):
        late[0].result()
    assert obs.counter("serve_slo_violations_total",
                       kind="completed_late").value >= 1
    assert obs.counter("serve_slo_violations_total",
                       kind="late_drop").value == len(late)
    assert obs.counter("serve_requests_total").value == len(hs) - len(late)


def test_per_request_slo_override():
    sched = make_sched(max_batch=2, slo_ms=0.001)   # default: instantly late
    try:
        h = sched.submit("x", slo_ms=float("inf"))  # opt out per request
        assert h.result(timeout=10.0) == "x"
        assert h.slo_ok
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# stop: drain vs cancel
# ---------------------------------------------------------------------------

def test_stop_drain_completes_everything():
    sched = make_sched(max_batch=4, max_wait_ms=50.0, max_queue=64)
    hs = [sched.submit(i) for i in range(17)]
    sched.stop(drain=True)
    assert [h.result(timeout=0.0) for h in hs] == list(range(17))
    assert obs.counter("serve_requests_total").value == 17
    assert obs.counter("sched_flush_total", reason="drain").value >= 1


def test_stop_without_drain_cancels_queued():
    gate = threading.Event()
    started = threading.Event()

    def gated(payloads, pad_to):
        started.set()
        gate.wait(30.0)
        return list(payloads)

    sched = make_sched(gated, max_batch=1, max_queue=16)
    hs = [sched.submit(i) for i in range(4)]
    assert started.wait(10.0)              # first is in flight, rest queued
    threading.Timer(0.1, gate.set).start()
    sched.stop(drain=False)                # in-flight batch still completes
    assert hs[0].result(timeout=10.0) == 0
    for h in hs[1:]:
        assert h.status == "cancelled"
        with pytest.raises(serving.RequestCancelledError):
            h.result()
    with pytest.raises(RuntimeError):
        sched.submit("after-stop")


def test_execute_error_delivered_per_request():
    def flaky(payloads, pad_to):
        if "bad" in payloads:
            raise ValueError("boom")
        return list(payloads)

    sched = make_sched(flaky, max_batch=1)
    try:
        bad = sched.submit("bad")
        with pytest.raises(ValueError, match="boom"):
            bad.result(timeout=10.0)
        assert bad.status == "error"
        assert sched.submit("good").result(timeout=10.0) == "good"
    finally:
        sched.stop()
    assert obs.counter("sched_execute_errors_total").value == 1


# ---------------------------------------------------------------------------
# shape hygiene: warm buckets, mixed traffic pads into them only
# ---------------------------------------------------------------------------

def test_warmup_then_mixed_traffic_only_sees_bucket_shapes():
    """The torch path compiles nothing, so where the JAX test counts
    compiles this one counts shapes: warmup() runs one execute per
    bucket, and a mixed-size stream afterwards pads only into those
    buckets."""
    seen = []

    def execute(payloads, pad_to):
        seen.append(pad_to)
        x = torch.zeros(pad_to, 4)
        for i, p in enumerate(payloads):
            x[i] = torch.as_tensor(p)
        out = (x * 2.0).sum(dim=1).numpy()
        return [float(out[i]) for i in range(len(payloads))]

    sched = make_sched(execute, max_batch=8, max_wait_ms=20.0)
    try:
        assert sched.warmup(np.ones(4, np.float32)) == 4
        assert seen == list(sched.buckets) == [1, 2, 4, 8]
        seen.clear()
        rng = np.random.default_rng(0)
        for burst in rng.integers(1, 9, size=12):
            hs = [sched.submit(np.ones(4, np.float32))
                  for _ in range(int(burst))]
            for h in hs:
                assert h.result(timeout=10.0) == pytest.approx(8.0)
        assert seen and set(seen) <= set(sched.buckets)
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# service health integration
# ---------------------------------------------------------------------------

def test_attach_to_service_health():
    """A saturated admission queue degrades service health (with
    transition edges on the write path) and recovers once drained."""
    d = 8
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(32, d)).astype(np.float32)
    emb[0] = 0.0
    svc = serving.RetrievalService(
        serving.IndexBuilder("exact", d, device="cpu"), emb, k=4, k_prime=8,
        device="cpu")
    svc.rebuild(mode="full", block=True)

    gate = threading.Event()
    started = threading.Event()

    def gated(payloads, pad_to):
        started.set()
        gate.wait(30.0)
        return list(payloads)

    sched = make_sched(gated, max_batch=1, max_queue=2)
    try:
        sched.attach_to(svc)
        h = svc.health()
        assert h["ok"] and h["components"]["scheduler"]["ok"]
        assert obs.gauge("health_status", component="scheduler").value == 1.0

        sched.submit("in-flight")
        assert started.wait(10.0)
        hs = [sched.submit(i) for i in range(2)]        # queue now full
        assert sched.saturated
        h = svc.health()
        assert h["status"] == "degraded" and not h["ok"]
        comp = h["components"]["scheduler"]
        assert not comp["ok"] and comp["queue_depth"] == comp["max_queue"] == 2
        assert obs.gauge("health_status", component="scheduler").value == 0.0
        # a write-path event while saturated records the transition edge
        svc.publish(np.array([33]), rng.normal(size=(1, d)).astype(np.float32))
        assert obs.counter("health_transitions_total", component="scheduler",
                           to="degraded").value == 1

        gate.set()
        for r in hs:
            r.wait(10.0)
        assert svc.health()["ok"]
        svc.publish(np.array([34]), rng.normal(size=(1, d)).astype(np.float32))
        assert obs.counter("health_transitions_total", component="scheduler",
                           to="healthy").value == 1
    finally:
        gate.set()
        sched.stop()


# ---------------------------------------------------------------------------
# loadgen: deterministic traces, summaries, the sweep merge
# ---------------------------------------------------------------------------

def test_arrival_offsets_deterministic_and_bounded():
    a = loadgen.arrival_offsets(200.0, 0.5, seed=7)
    b = loadgen.arrival_offsets(200.0, 0.5, seed=7)
    np.testing.assert_array_equal(a, b)
    assert a.size > 0 and float(a[-1]) < 0.5
    assert np.all(np.diff(a) >= 0)
    assert not np.array_equal(a, loadgen.arrival_offsets(200.0, 0.5, seed=8))
    with pytest.raises(ValueError):
        loadgen.arrival_offsets(0.0, 1.0)
    # the JAX package's trace, bit for bit (the tail top-up included)
    for qps, dur, seed in ((200.0, 0.5, 7), (5737.3, 2.0, 11), (0.5, 300.0,
                                                                 3)):
        assert np.array_equal(loadgen.arrival_offsets(qps, dur, seed),
                              jloadgen.arrival_offsets(qps, dur, seed))


def test_open_loop_sweep_and_summary_fields():
    sched = make_sched(max_batch=8, max_wait_ms=1.0, slo_ms=500.0)
    try:
        sched.warmup("w")
        entry = loadgen.sweep(sched, ["p"], [300.0], duration_s=0.3,
                              slo_ms=500.0, seed=3, scenario="quiescent",
                              source="test", extra={"index": "echo"})
    finally:
        sched.stop()
    assert entry["kind"] == "load_sweep" and entry["source"] == "test"
    assert entry["index"] == "echo" and entry["buckets"] == [1, 2, 4, 8]
    (pt,) = entry["points"]
    assert pt["offered"] > 0 and pt["completed"] > 0
    assert pt["completed"] + pt["rejected"] + pt["late_dropped"] \
        + pt["errors"] == pt["offered"]
    assert pt["goodput_qps"] > 0 and pt["reject_rate"] == 0.0
    assert np.isfinite(pt["e2e_ms_p99"]) and np.isfinite(pt["queued_ms_p99"])
    assert pt["offered"] == len(jloadgen.arrival_offsets(300.0, 0.3, 3))


def test_summarize_matches_jax_on_the_same_stamps():
    """Handles with every status, stamped by hand, summarized by both
    packages: the same keys and values."""
    from repro.serving.scheduler import ScheduledRequest as JRequest
    from repro_torch.serving.scheduler import ScheduledRequest as TRequest
    rng = np.random.default_rng(5)
    statuses = ["ok"] * 30 + ["late"] * 4 + ["error"] * 2 + ["cancelled"]
    handles = {"jax": [], "torch": []}
    for i, st in enumerate(statuses):
        t_enq = float(rng.uniform(0, 2))
        deadline = t_enq + 0.05
        t_deq = t_enq + float(rng.exponential(0.01))
        t_done = t_deq + float(rng.exponential(0.03))
        for key, cls in (("jax", JRequest), ("torch", TRequest)):
            h = cls(i, t_enq, deadline)
            h.status = st
            if st != "cancelled":
                h.t_deq = t_deq
            if st == "ok":
                h.t_done = t_done
                h.slo_ok = t_done <= deadline
            handles[key].append(h)
    kw = dict(qps=123.45, duration_s=2.0, slo_ms=50.0)
    got = loadgen.summarize(handles["torch"], 45, 8, **kw)
    exp = jloadgen.summarize(handles["jax"], 45, 8, **kw)
    assert got == exp
    assert got["completed_late"] > 0 and got["late_dropped"] == 4


def test_record_sweep_merges_by_key(tmp_path):
    doc0 = {"results": [
        {"kind": "retrieval", "index": "ivf-pq", "qps": 123.0},
        {"kind": "load_sweep", "source": "serve", "scenario": "quiescent",
         "points": [{"goodput_qps": 1.0}]},
    ]}
    fresh = {"kind": "load_sweep", "source": "serve", "scenario": "quiescent",
             "points": [{"goodput_qps": 2.0}]}
    other = {"kind": "load_sweep", "source": "serve",
             "scenario": "during_rebuild", "points": []}
    docs = {}
    for name, mod in (("torch", loadgen), ("jax", jloadgen)):
        out = tmp_path / f"{name}.json"
        out.write_text(json.dumps(doc0))
        mod.record_sweep([fresh, other], out)
        docs[name] = json.loads(out.read_text())
    doc = docs["torch"]
    kinds = [(e.get("kind"), e.get("source"), e.get("scenario"))
             for e in doc["results"]]
    # replaced its own row, left the retrieval section alone
    assert kinds.count(("load_sweep", "serve", "quiescent")) == 1
    assert any(e.get("kind") == "retrieval" for e in doc["results"])
    swept = [e for e in doc["results"] if e.get("kind") == "load_sweep"][0]
    assert swept["points"][0]["goodput_qps"] == 2.0
    assert doc == docs["jax"]
    # a file that does not exist yet starts a minimal document
    new = loadgen.record_sweep([fresh], tmp_path / "new.json")
    assert json.loads(new.read_text()) == {"results": [fresh]}
