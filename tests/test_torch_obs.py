"""The port's telemetry layer against the JAX package's contracts
(``tests/test_obs.py``, every test of what the port has: the log2
histogram geometry and exact percentiles, series identity, thread safety,
span nesting, the overhead budget, the MetricsBuffer's history,
``finite_metrics``'s NaN routing and the exporters), the same JSONL and
Prometheus text as the JAX package's ``obs`` for the same calls, and spans
forwarded to ``torch.profiler.record_function`` inside a profiler."""
import json
import math
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs.export import (Reporter, prometheus_text,  # noqa: E402
                                    write_jsonl)
from repro_torch.obs.registry import (MetricsRegistry, N_BUCKETS,  # noqa
                                      _bucket_index, bucket_le, series_key)


@pytest.fixture(autouse=True)
def _clean_default_registry():
    """Tests that touch the module-default registry start and end empty
    (other suites run launchers in-process and assert exact counts)."""
    obs.reset()
    obs.set_enabled(True)
    yield
    obs.reset()
    obs.set_enabled(True)


# ---------------------------------------------------------------------------
# bucket geometry + percentile accuracy
# ---------------------------------------------------------------------------

def test_bucket_geometry():
    assert bucket_le(N_BUCKETS - 1) == math.inf
    les = [bucket_le(i) for i in range(N_BUCKETS)]
    assert les == sorted(les)
    rng = np.random.default_rng(0)
    for v in np.concatenate([10.0 ** rng.uniform(-4, 5, 200),
                             [0.0, -1.0, 1e-12, 1e12]]):
        i = _bucket_index(float(v))
        assert 0 <= i < N_BUCKETS
        assert v < bucket_le(i) or i == 0
        if i > 0:
            assert v >= bucket_le(i - 1)


def test_histogram_percentiles_match_numpy():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    rng = np.random.default_rng(1)
    xs = rng.lognormal(mean=2.0, sigma=1.5, size=1000)
    for x in xs:
        h.observe(float(x))
    for p in (50, 90, 95, 99, 99.9):
        assert h.percentile(p) == pytest.approx(np.percentile(xs, p),
                                                rel=0, abs=0)
    assert h.count == 1000
    assert h.sum == pytest.approx(xs.sum())
    assert sum(h.bucket_counts()) == 1000


def test_histogram_reservoir_windows_to_recent():
    reg = MetricsRegistry()
    h = reg.histogram("w", reservoir=100)
    for v in range(1000):
        h.observe(float(v))
    # ring holds the most recent 100 samples: 900..999
    assert h.percentile(50) == pytest.approx(
        np.percentile(np.arange(900, 1000), 50))
    assert h.count == 1000                  # buckets still see the stream
    assert sum(h.bucket_counts()) == 1000


def test_histogram_empty_percentile_is_nan():
    reg = MetricsRegistry()
    assert math.isnan(reg.histogram("e").percentile(99))


# ---------------------------------------------------------------------------
# series identity
# ---------------------------------------------------------------------------

def test_label_series_isolation():
    reg = MetricsRegistry()
    a = reg.counter("req_total", phase="queued")
    b = reg.counter("req_total", phase="e2e")
    plain = reg.counter("req_total")
    a.inc(3)
    b.inc()
    assert a is reg.counter("req_total", phase="queued")   # memoized
    assert a.value == 3 and b.value == 1 and plain.value == 0
    snap = reg.collect()
    assert snap['req_total{phase="queued"}'] == 3
    assert snap['req_total{phase="e2e"}'] == 1
    assert snap["req_total"] == 0


def test_series_key_sorts_labels():
    assert series_key("x", (("b", "2"), ("a", "1"))) == 'x{b="2",a="1"}'
    assert (series_key("x", tuple(sorted({"b": 2, "a": 1}.items())))
            == 'x{a="1",b="2"}')


def test_kind_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.histogram("x")


def test_label_named_name_is_legal():
    # span_ms uses a label literally called "name"
    reg = MetricsRegistry()
    h = reg.histogram("span_ms", name="rebuild")
    h.observe(1.0)
    assert 'span_ms{name="rebuild"}' in reg.collect()


def test_gauge_set_fn_computed_at_collect():
    reg = MetricsRegistry()
    box = {"v": 1}
    reg.gauge("depth").set_fn(lambda: box["v"])
    assert reg.collect()["depth"] == 1
    box["v"] = 7
    assert reg.collect()["depth"] == 7
    reg.gauge("bad").set_fn(lambda: 1 / 0)
    assert math.isnan(reg.collect()["bad"])


# ---------------------------------------------------------------------------
# thread safety + span nesting
# ---------------------------------------------------------------------------

def test_counter_and_histogram_under_threads():
    reg = MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("h")

    def work():
        for i in range(1000):
            c.inc()
            h.observe(float(i % 7) + 0.5)

    ts = [threading.Thread(target=work) for _ in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert c.value == 8000
    assert h.count == 8000
    assert sum(h.bucket_counts()) == 8000


def test_span_nesting_records_each_level():
    reg = MetricsRegistry()
    with obs.span("outer", registry=reg):
        with obs.span("inner", registry=reg):
            time.sleep(0.002)
    outer = reg.histogram("span_ms", name="outer")
    inner = reg.histogram("span_ms", name="inner")
    assert outer.count == 1 and inner.count == 1
    assert outer.percentile(50) >= inner.percentile(50) >= 2.0


def test_span_reentrant_across_threads():
    """Background-rebuild + request-loop shape: spans of different names
    (and the same name) time concurrently into their own series."""
    reg = MetricsRegistry()
    stop = threading.Event()

    def rebuild():
        while not stop.is_set():
            with obs.span("rebuild", registry=reg):
                time.sleep(0.001)

    t = threading.Thread(target=rebuild)
    t.start()
    try:
        for _ in range(20):
            with obs.span("request", registry=reg):
                with obs.span("request", registry=reg, stage="rerank"):
                    time.sleep(0.0005)
    finally:
        stop.set()
        t.join()
    assert reg.histogram("span_ms", name="request").count == 20
    assert reg.histogram("span_ms", name="request",
                         stage="rerank").count == 20
    assert reg.histogram("span_ms", name="rebuild").count >= 1


def test_span_disabled_creates_nothing():
    reg = MetricsRegistry(enabled=False)
    with obs.span("x", registry=reg):
        pass
    assert reg.collect() == {}


# ---------------------------------------------------------------------------
# overhead budget (ISSUE: counter inc + span in single-digit µs, disabled
# path near-zero).  Budgets are several× the measured numbers (~1µs inc,
# ~10µs span) so a loaded CI box doesn't flake; min-of-repeats de-noises.
# ---------------------------------------------------------------------------

def _best_per_op_us(fn, n=2000, repeats=5):
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e6


def test_overhead_budget():
    reg = MetricsRegistry()
    c = reg.counter("ops")
    h = reg.histogram("lat")
    assert _best_per_op_us(c.inc) < 25.0
    assert _best_per_op_us(lambda: h.observe(1.25)) < 50.0

    def spin():
        with obs.span("s", registry=reg):
            pass

    assert _best_per_op_us(spin, n=500) < 250.0

    off = MetricsRegistry(enabled=False)
    oc = off.counter("ops")
    oh = off.histogram("lat")
    assert _best_per_op_us(oc.inc) < 5.0
    assert _best_per_op_us(lambda: oh.observe(1.25)) < 5.0

    def spin_off():
        with obs.span("s", registry=off):
            pass

    assert _best_per_op_us(spin_off, n=500) < 50.0


# ---------------------------------------------------------------------------
# MetricsBuffer: bounded history + non-scalar warning (regression: drain
# kept only `loss`, silently discarding every other per-step series)
# ---------------------------------------------------------------------------

def test_metrics_buffer_history_and_nonscalar_warning():
    from repro_torch.training.trainer import MetricsBuffer
    buf = MetricsBuffer(history_len=8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for i in range(12):
            buf.append({"loss": torch.tensor(float(i)),
                        "acc": torch.tensor(float(i * 2)),
                        "vec": torch.arange(3)})
        last = buf.drain()
    assert list(buf.history["loss"]) == [float(i) for i in range(4, 12)]
    assert list(buf.history["acc"]) == [float(i * 2) for i in range(4, 12)]
    assert "vec" not in buf.history
    assert tuple(last["vec"].shape) == (3,)
    assert len([x for x in w if "not a scalar" in str(x.message)]) == 1
    assert buf.losses == [float(i) for i in range(12)]


def test_metrics_buffer_on_drain_hook():
    from repro_torch.training.trainer import MetricsBuffer
    got = []
    buf = MetricsBuffer(on_drain=got.extend)
    buf.append({"loss": torch.tensor(1.0)})
    buf.append({"loss": torch.tensor(2.0)})
    buf.drain()
    assert [float(m["loss"]) for m in got] == [1.0, 2.0]


def test_trainer_drain_feeds_the_cache_counters():
    from repro_torch.training.trainer import _feed_cache_obs
    _feed_cache_obs([{"cache_hits": 3.0, "cache_misses": 1.0,
                      "cache_expired": 0.0, "cache_overflow": 2.0,
                      "nonfinite_step": 1.0},
                     {"cache_hits": 5.0, "cache_misses": 1.0,
                      "cache_expired": 2.0, "nonfinite_step": 0.0}])
    snap = obs.collect()
    assert snap["cache_hits_total"] == 8 and snap["cache_misses_total"] == 2
    assert snap["cache_expired_total"] == 2
    assert snap["cache_overflow_total"] == 2
    assert snap["train_nonfinite_steps_total"] == 1
    assert snap["cache_hit_rate"] == pytest.approx(8 / 12)


# ---------------------------------------------------------------------------
# finite_metrics NaN/Inf routing
# ---------------------------------------------------------------------------

def test_finite_metrics_counts_and_warns_once():
    from repro_torch.configs import base
    base._nonfinite_warned.discard("loss")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = base.finite_metrics({"loss": np.float32("nan"),
                                   "acc": torch.tensor(0.5)})
        base.finite_metrics({"loss": float("inf")})
    assert math.isnan(out["loss"]) and out["acc"] == pytest.approx(0.5)
    assert obs.counter("nonfinite_metrics_total", key="loss").value == 2
    assert obs.counter("nonfinite_metrics_total", key="acc").value == 0
    assert len([x for x in w if "non-finite" in str(x.message)]) == 1


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def test_write_jsonl_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("req").inc(3)
    reg.histogram("lat", phase="e2e").observe(2.0)
    p = tmp_path / "m.jsonl"
    write_jsonl(str(p), registry=reg, extra={"run": "t"})
    write_jsonl(str(p), registry=reg)
    rows = [json.loads(l) for l in p.read_text().splitlines()]
    assert len(rows) == 2 and rows[0]["run"] == "t"
    m = rows[-1]["metrics"]
    assert m["req"] == 3
    assert m['lat{phase="e2e"}']["count"] == 1
    assert m['lat{phase="e2e"}']["p50"] == pytest.approx(2.0)


def test_prometheus_text_shape():
    reg = MetricsRegistry()
    reg.counter("req_total", phase="a").inc(2)
    reg.gauge("depth").set(3)
    h = reg.histogram("lat_ms")
    h.observe(0.5)
    h.observe(100.0)
    txt = prometheus_text(reg)
    assert "# TYPE req_total counter" in txt
    assert 'req_total{phase="a"} 2' in txt
    assert "# TYPE depth gauge" in txt and "depth 3" in txt
    assert "# TYPE lat_ms histogram" in txt
    assert 'lat_ms_bucket{le="+Inf"} 2' in txt      # cumulative tops out
    assert "lat_ms_count 2" in txt
    # cumulative counts are monotone over le
    cums = [int(l.rsplit(" ", 1)[1]) for l in txt.splitlines()
            if l.startswith("lat_ms_bucket")]
    assert cums == sorted(cums)


def test_reporter_cadence_and_force(tmp_path):
    reg = MetricsRegistry()
    reg.counter("n").inc()
    p = tmp_path / "r.jsonl"
    r = Reporter(path=str(p), every_s=3600.0, registry=reg)
    assert r.tick() is False and not p.exists()
    assert r.tick(force=True) is True
    assert json.loads(p.read_text().splitlines()[-1])["metrics"]["n"] == 1


def test_module_helpers_and_reset():
    obs.counter("a").inc()
    obs.gauge("g").set(2)
    obs.histogram("h").observe(1.0)
    assert set(obs.collect()) == {"a", "g", "h"}
    obs.reset()
    assert obs.collect() == {}
    obs.set_enabled(False)
    obs.counter("a").inc()
    assert obs.counter("a").value == 0 and not obs.enabled()
    obs.set_enabled(True)


# ---------------------------------------------------------------------------
# the JAX package's output for the same calls
# ---------------------------------------------------------------------------

def _drive(mod, reg):
    reg.counter("req_total", phase="a").inc(2)
    reg.counter("req_total").inc()
    reg.gauge("depth").set(3)
    reg.gauge("nan_gauge").set(float("nan"))
    h = reg.histogram("lat_ms", phase="e2e")
    for v in (0.0, 0.5, 1.25, 3.0, 100.0, 1e9):
        h.observe(v)
    with mod.span("ckpt_save", registry=reg, mode="sync"):
        pass


def test_jsonl_and_prometheus_match_the_jax_package(tmp_path):
    from repro.obs.export import prometheus_text as jprom, write_jsonl as jw
    from repro.obs.registry import MetricsRegistry as JRegistry
    regs = {"port": MetricsRegistry(), "jax": JRegistry()}
    _drive(obs, regs["port"])
    _drive(jobs, regs["jax"])
    for r in regs.values():     # the span's one sample: 2 ms on both sides
        s = r.histogram("span_ms", name="ckpt_save", mode="sync")
        s._samples[:] = [2.0]
        s._sum, s._min, s._max = 2.0, 2.0, 2.0
        s._counts = [0] * N_BUCKETS
        s._counts[_bucket_index(2.0)] = 1
    assert prometheus_text(regs["port"]) == jprom(regs["jax"])
    rows = {}
    for name, write in (("port", write_jsonl), ("jax", jw)):
        path = tmp_path / f"{name}.jsonl"
        write(str(path), registry=regs[name], extra={"run": "t"})
        row = json.loads(path.read_text())
        row.pop("ts")
        rows[name] = row
    assert json.dumps(rows["port"], sort_keys=True) == json.dumps(
        rows["jax"], sort_keys=True)
    assert rows["port"]["metrics"]['lat_ms{phase="e2e"}']["count"] == 6


def test_span_forwards_to_record_function_inside_a_profiler():
    reg = MetricsRegistry()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("prefetch_h2d", registry=reg):
            torch.ones(4).sum()
    with obs.span("outside", registry=reg):
        pass
    names = {e.key for e in prof.key_averages()}
    assert "prefetch_h2d" in names and "outside" not in names
    assert reg.histogram("span_ms", name="prefetch_h2d").count == 1
    obs.set_trace_annotations(False)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.span("forced_off", registry=reg):
                pass
        assert "forced_off" not in {e.key for e in prof.key_averages()}
    finally:
        obs.set_trace_annotations(None)


def test_tick_drives_the_configured_reporter(tmp_path):
    assert obs.tick() is False              # nothing configured
    path = tmp_path / "t.jsonl"
    obs.configure_reporter(path=str(path), every_s=3600.0)
    obs.counter("n").inc()
    assert obs.tick() is False and obs.tick(force=True) is True
    assert json.loads(path.read_text())["metrics"]["n"] == 1
