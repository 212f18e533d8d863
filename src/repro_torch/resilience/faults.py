"""Deterministic, seedable fault injection for the train loop.

A trainer that runs for hours over a 1.2M-news corpus only survives its
failures if each has been *rehearsed*: a checkpoint writer dying
mid-npz, a wedged host-to-device copy, a crash in the step loop, an
index rebuild throwing on a background thread.  This module is the one
place chaos tests and smokes describe those rehearsals.  It is the JAX
package's ``resilience/faults.py`` as it is: the same plan fires at the
same calls in both packages, probabilistic rules included.

Usage::

    plan = FaultPlan(seed=0)
    plan.fail("train.step", step=10)               # crash once at step 10
    plan.fail("index.rebuild", calls=(1, 2))       # first two rebuilds die
    plan.fail("ckpt.write", p=0.25)                # seeded coin per write
    with faults.armed(plan):
        ...                                        # run the thing under test

Instrumented sites call ``faults.fire("<site>")`` (optionally with the
current ``step``); when no plan is armed that is a single module-global
``None`` check — zero overhead on the production path.  When a rule
matches, ``fire`` raises the rule's exception and increments
``faults_injected_total{site=}`` in the obs registry, so a chaos run's
injection count is part of the same metrics.jsonl every other signal
lands in.

Registered sites (an open set):

    ckpt.write      checkpoint/ckpt.py::save, before any byte is written
    index.rebuild   the serving tier's background rebuild (not wired in
                    the port yet: it comes with serving's build retries
                    and health view)
    prefetch.h2d    training/prefetch.py::_run, before the device copy
    train.step      training/trainer.py::fit, after each completed step

Determinism: call counts are per-site and process-wide (a resumed fit in
the same process does not re-fire an exhausted rule), ``step=`` rules
default to firing once per listed step, and probabilistic rules draw from
a per-site ``random.Random`` seeded by ``seed ^ crc32(site)`` — the same
plan replays the same faults.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import zlib

from repro_torch import obs

SITES = ("ckpt.write", "index.rebuild", "prefetch.h2d", "train.step")


class InjectedFault(RuntimeError):
    """Default exception raised at a firing site (transient by design:
    ``fit_supervised``'s classifier retries it)."""


def _as_tuple(x):
    if x is None:
        return ()
    if isinstance(x, (tuple, list, set, frozenset, range)):
        return tuple(int(v) for v in x)
    return (int(x),)


@dataclasses.dataclass
class FaultRule:
    """One trigger at one site.  A rule fires when any of its conditions
    match: ``calls`` (1-based per-site call count), ``step`` (the
    caller-provided step), or probability ``p``; ``times`` caps total
    fires (deterministic triggers default to one fire per listed
    occurrence, probabilistic ones to unlimited)."""
    site: str
    calls: tuple = ()
    step: tuple = ()
    p: float = 0.0
    times: int | None = None
    exc: type | BaseException = InjectedFault
    fired: int = 0

    def __post_init__(self):
        if self.times is None and (self.calls or self.step):
            self.times = len(self.calls) + len(self.step)

    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times

    def matches(self, n_calls: int, step: int | None, rng) -> bool:
        if self.exhausted():
            return False
        if n_calls in self.calls:
            return True
        if step is not None and step in self.step:
            return True
        return self.p > 0.0 and rng.random() < self.p

    def make_exc(self) -> BaseException:
        if isinstance(self.exc, BaseException):
            return self.exc
        return self.exc(f"injected fault at {self.site!r} "
                        f"(fire #{self.fired})")


class FaultPlan:
    """A seeded set of fault rules; arm with ``faults.arm``/``armed``.

    Thread-safe: sites fire from the step loop, the prefetch thread, the
    checkpoint writer, and the rebuild worker concurrently.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rules: dict[str, list[FaultRule]] = {}
        self._calls: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        self._lock = threading.Lock()

    def fail(self, site: str, *, calls=None, step=None, p: float = 0.0,
             times: int | None = None, exc=InjectedFault) -> "FaultPlan":
        """Add a rule (chainable).  ``calls``/``step`` take an int or a
        sequence; ``exc`` an exception class or instance."""
        rule = FaultRule(site, _as_tuple(calls), _as_tuple(step), p, times,
                         exc)
        with self._lock:
            self._rules.setdefault(site, []).append(rule)
        return self

    def calls(self, site: str) -> int:
        """How many times ``site`` has fired ``faults.fire`` so far."""
        return self._calls.get(site, 0)

    def fired(self, site: str | None = None) -> int:
        """Total injections so far (for ``site``, or across the plan)."""
        with self._lock:
            rules = (self._rules.get(site, ()) if site is not None
                     else [r for rs in self._rules.values() for r in rs])
            return sum(r.fired for r in rules)

    def check(self, site: str, step: int | None = None):
        """Record one call at ``site``; return an exception to raise (and
        mark the matching rule fired) or None."""
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            rng = self._rngs.get(site)
            if rng is None:
                rng = self._rngs[site] = random.Random(
                    self.seed ^ zlib.crc32(site.encode()))
            for rule in self._rules.get(site, ()):
                if rule.matches(n, step, rng):
                    rule.fired += 1
                    return rule.make_exc()
        return None


_armed_plan: FaultPlan | None = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as the process-wide active plan."""
    global _armed_plan
    _armed_plan = plan
    return plan


def disarm():
    """Deactivate fault injection (sites return to the no-op path)."""
    global _armed_plan
    _armed_plan = None


def active() -> FaultPlan | None:
    return _armed_plan


@contextlib.contextmanager
def armed(plan: FaultPlan):
    """Scope-bound arming: always disarms, even when the body raises
    (which, under fault injection, it is rather expected to)."""
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


def fire(site: str, step: int | None = None):
    """Fault-injection hook placed at an instrumented site.

    No plan armed -> one global read + ``is None`` check (the production
    path stays free).  A matching rule raises its exception here, after
    counting it into ``faults_injected_total{site=}``.
    """
    plan = _armed_plan
    if plan is None:
        return
    exc = plan.check(site, step)
    if exc is not None:
        obs.counter("faults_injected_total", site=site).inc()
        raise exc
