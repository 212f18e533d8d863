"""The port's fault injection and supervised restarts: the JAX package's
contracts (``tests/test_resilience.py``, the parts this package ports:
the plan, the supervisor, the fit's non-finite bailout, the supervised
train, the prefetcher's fault site and leak counter), and the same plan
firing at the same calls in both packages."""
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.resilience import (  # noqa: E402
    FaultPlan as JFaultPlan, InjectedFault as JInjectedFault,
    faults as jfaults)
from repro_torch import data, obs, training  # noqa: E402
from repro_torch.resilience import (FaultPlan, InjectedFault,  # noqa: E402
                                    NonFiniteLossError, default_classify,
                                    faults, fit_supervised)
from repro_torch.resilience.supervise import FATAL_TYPES  # noqa: E402


def counter_value(name, **labels):
    return obs.counter(name, **labels).value


# ---------------------------------------------------------------- FaultPlan

def test_fire_is_noop_when_disarmed():
    faults.disarm()
    for site in faults.SITES:
        faults.fire(site)
    assert faults.active() is None
    assert faults.SITES == ("ckpt.write", "index.rebuild", "prefetch.h2d",
                            "train.step")


def test_call_count_rule_fires_once_per_listed_call():
    plan = FaultPlan().fail("ckpt.write", calls=2)
    with faults.armed(plan):
        faults.fire("ckpt.write")
        with pytest.raises(InjectedFault):
            faults.fire("ckpt.write")
        faults.fire("ckpt.write")
    assert plan.calls("ckpt.write") == 3
    assert plan.fired("ckpt.write") == 1
    assert faults.active() is None


def test_step_rule_fires_once_then_lets_resume_pass():
    plan = FaultPlan().fail("train.step", step=10)
    with faults.armed(plan):
        faults.fire("train.step", step=9)
        with pytest.raises(InjectedFault):
            faults.fire("train.step", step=10)
        faults.fire("train.step", step=10)
    assert plan.fired() == 1


def test_probabilistic_rule_replays_with_seed():
    def firing_pattern(seed):
        plan = FaultPlan(seed=seed).fail("index.rebuild", p=0.3)
        hits = []
        with faults.armed(plan):
            for i in range(64):
                try:
                    faults.fire("index.rebuild")
                except InjectedFault:
                    hits.append(i)
        return hits
    a, b = firing_pattern(7), firing_pattern(7)
    assert a == b and len(a) > 0
    assert firing_pattern(8) != a


def test_custom_exception_and_injection_counter():
    before = counter_value("faults_injected_total", site="prefetch.h2d")
    plan = FaultPlan().fail("prefetch.h2d", calls=1, exc=OSError("disk gone"))
    with faults.armed(plan):
        with pytest.raises(OSError, match="disk gone"):
            faults.fire("prefetch.h2d")
    assert counter_value("faults_injected_total",
                         site="prefetch.h2d") == before + 1


def _pattern(plan_cls, fmod, exc, seed):
    """Which calls fire, over an interleaving of every site with steps,
    under a plan of every kind of rule."""
    plan = (plan_cls(seed=seed)
            .fail("train.step", step=(3, 7))
            .fail("ckpt.write", calls=(2, 5))
            .fail("prefetch.h2d", p=0.25)
            .fail("index.rebuild", p=0.5, times=4)
            .fail("train.step", p=0.1))
    hits = []
    with fmod.armed(plan):
        for i in range(200):
            site = fmod.SITES[i % 4]
            try:
                fmod.fire(site, step=i // 4)
            except exc:
                hits.append((i, site))
    return hits, {s: plan.fired(s) for s in fmod.SITES}


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_same_plan_fires_at_the_same_calls_as_jax(seed):
    port = _pattern(FaultPlan, faults, InjectedFault, seed)
    ref = _pattern(JFaultPlan, jfaults, JInjectedFault, seed)
    assert port == ref
    assert len(port[0]) > 10


# ------------------------------------------------------------ fit_supervised

class StubTrainer:
    def __init__(self, failures):
        self.failures = list(failures)
        self.attempts = 0

    def fit(self, make_batcher, *, steps, ckpt_dir=None, **kw):
        self.attempts += 1
        if self.failures:
            raise self.failures.pop(0)
        return types.SimpleNamespace(steps_done=steps, restarts=0)


def test_supervisor_restarts_through_transient_failures():
    tr = StubTrainer([InjectedFault("boom"), OSError("disk hiccup")])
    naps = []
    r0 = counter_value("train_restarts_total", reason="InjectedFault")
    res = fit_supervised(tr, None, steps=10, ckpt_dir="unused",
                         max_restarts=3, backoff_s=0.5, backoff_factor=2.0,
                         sleep=naps.append)
    assert tr.attempts == 3
    assert res.steps_done == 10 and res.restarts == 2
    assert len(naps) == 2 and naps[1] > naps[0]
    assert counter_value("train_restarts_total",
                         reason="InjectedFault") == r0 + 1


def test_supervisor_refuses_fatal_errors():
    tr = StubTrainer([ValueError("bad config")])
    with pytest.raises(ValueError):
        fit_supervised(tr, None, steps=10, ckpt_dir="unused",
                       max_restarts=5, sleep=lambda s: None)
    assert tr.attempts == 1


def test_supervisor_exhausts_restart_budget():
    tr = StubTrainer([InjectedFault(f"crash {i}") for i in range(5)])
    with pytest.raises(InjectedFault, match="crash 2"):
        fit_supervised(tr, None, steps=10, ckpt_dir="unused",
                       max_restarts=2, sleep=lambda s: None)
    assert tr.attempts == 3


def test_supervisor_without_ckpt_dir_warns():
    tr = StubTrainer([])
    with pytest.warns(UserWarning, match="without ckpt_dir"):
        fit_supervised(tr, None, steps=1, ckpt_dir=None, max_restarts=1)


def test_classifier_taxonomy():
    assert default_classify(InjectedFault("x")) == "transient"
    assert default_classify(NonFiniteLossError("x")) == "transient"
    assert default_classify(OSError("x")) == "transient"
    assert default_classify(ValueError("x")) == "fatal"
    assert default_classify(KeyboardInterrupt()) == "fatal"
    assert all(default_classify(t("x")) == "fatal" for t in FATAL_TYPES)
    e = NonFiniteLossError("x", step=12, consecutive=4)
    assert (e.step, e.consecutive) == (12, 4)


def test_nonfinite_loss_error_lives_in_resilience_only():
    import repro_torch.training.trainer as tr
    assert tr.NonFiniteLossError is NonFiniteLossError
    assert not hasattr(training, "NonFiniteLossError")


# -------------------------------------- the fit's non-finite bailout

def _toy_trainer():
    """A 1-parameter Trainer whose loss is driven by the batch: a ``bad``
    flag poisons it with NaN, and the step holds the state then, as the
    port's guard does (``configs.speedyfeed_arch``)."""
    def make_step(cfg):
        def step(params, opt, cache, step_no, rng, batch):
            loss = (params["w"] * batch["x"]).mean()
            loss = torch.where(batch["bad"].any(), float("nan"), loss)
            ok = torch.isfinite(loss)
            params["w"].copy_(torch.where(
                ok, params["w"] - 0.1 * batch["x"].mean(), params["w"]))
            return params, opt, cache, {"loss": loss,
                                        "nonfinite_step": 1.0 - ok.float()}
        return step

    def init_fn(cfg, gen):
        return training.TrainState({"w": torch.tensor(1.0)}, {}, None, 0,
                                   gen)

    return training.Trainer(None, make_step=make_step, init_fn=init_fn,
                            device="cpu")


def _toy_batch(bad=False, x=2.0):
    return {"_bucket": 0, "x": np.full((4,), x, np.float32),
            "bad": np.array([bad])}


class FakeBatcher:
    def __init__(self, items):
        self._items = list(items)

    def get(self, timeout=None):
        if not self._items:
            return data.EPOCH_END
        return self._items.pop(0)

    def stop(self):
        pass


def test_fit_raises_after_consecutive_nonfinite():
    tr = _toy_trainer()
    mk = lambda epoch: FakeBatcher([_toy_batch(bad=True) for _ in range(12)])
    with pytest.raises(NonFiniteLossError) as ei:
        tr.fit(mk, steps=12, log_every=2, max_consecutive_nonfinite=3)
    assert ei.value.consecutive >= 3
    assert ei.value.step <= 6


def test_fit_tolerates_isolated_nonfinite_steps():
    bads = [False, True, False, True, False, False, False, False]
    tr = _toy_trainer()
    mk = lambda epoch: FakeBatcher([_toy_batch(bad=b) for b in bads])
    n0 = counter_value("train_nonfinite_steps_total")
    res = tr.fit(mk, steps=len(bads), log_every=2,
                 max_consecutive_nonfinite=3)
    assert res.steps_done == len(bads)
    assert counter_value("train_nonfinite_steps_total") == n0 + 2
    assert counter_value("train_steps_total", bucket="0") >= len(bads)


# --------------------------------------------- end-to-end supervised train

def test_supervised_train_rides_through_injected_crash(tmp_path):
    """The chaos loop: crash at step 8 via the train.step site, restart
    from the step-5 checkpoint, and still reach exactly the target."""
    from repro_torch.launch.train import train_speedyfeed
    plan = FaultPlan().fail("train.step", step=8)
    with faults.armed(plan):
        res = train_speedyfeed(steps=12, ckpt_dir=str(tmp_path),
                               ckpt_every=5, log_every=5, max_restarts=2,
                               backoff_s=0.01, device="cpu")
    assert plan.fired("train.step") == 1
    assert res.restarts == 1
    assert res.steps_done == 12
    assert res.resumed_from == 5
    assert res.state.step == 12
    assert int(res.state.opt["count"]) == 12


def test_launcher_flags_resume_and_report(tmp_path, capsys):
    from repro_torch.launch import train
    metrics = tmp_path / "m.jsonl"
    args = ["--device", "cpu", "--steps", "6", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "3", "--max-restarts",
            "1", "--chaos-crash-at", "4", "--metrics-out", str(metrics)]
    res = train.main(args)
    out = capsys.readouterr().out
    assert res.steps_done == 6 and res.restarts == 1
    assert "(restarts 1) (resumed from 3)" in out
    import json
    last = json.loads(metrics.read_text().splitlines()[-1])["metrics"]
    assert last['faults_injected_total{site="train.step"}'] == 1
    assert last['train_restarts_total{reason="InjectedFault"}'] == 1
    assert faults.active() is None


# ------------------------------------------------------- prefetch site

class WedgedBatcher:
    def __init__(self):
        self.stopped = threading.Event()

    def get(self, timeout=None):
        time.sleep(30.0)
        return data.EPOCH_END

    def stop(self):
        self.stopped.set()


def test_prefetch_fault_site_preserves_exception_type():
    plan = FaultPlan().fail("prefetch.h2d", calls=1, exc=OSError("h2d died"))
    with faults.armed(plan):
        p = training.DevicePrefetcher(lambda e: FakeBatcher([_toy_batch()]),
                                      max_epochs=1, device="cpu").start()
        try:
            with pytest.raises(OSError, match="h2d died"):
                p.get(timeout=10.0)
        finally:
            p.stop()


def test_prefetch_stop_counts_abandoned_thread():
    leaks0 = counter_value("prefetch_thread_leaks_total")
    p = training.DevicePrefetcher(lambda e: WedgedBatcher(), max_epochs=1,
                                  device="cpu").start()
    time.sleep(0.05)
    with pytest.warns(UserWarning, match="did not stop"):
        p.stop(timeout=0.1)
    assert counter_value("prefetch_thread_leaks_total") == leaks0 + 1
    assert p._thread is None


def test_prefetch_stop_clean_join_is_silent():
    leaks0 = counter_value("prefetch_thread_leaks_total")
    h0 = obs.histogram("span_ms", name="prefetch_h2d").count
    p = training.DevicePrefetcher(lambda e: FakeBatcher([_toy_batch()]),
                                  max_epochs=1, device="cpu").start()
    assert p.get(timeout=10.0) is not None
    p.stop()
    assert counter_value("prefetch_thread_leaks_total") == leaks0
    assert obs.histogram("span_ms", name="prefetch_h2d").count == h0 + 1
