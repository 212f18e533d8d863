"""Cheap serving-time autotuner for the retrieval knobs (nprobe, k').

Recall@k of the two-stage pipeline is controlled by two cheap-to-change
knobs — how many coarse cells a query probes (``nprobe``, a static arg
of the snapshot search executables) and how many ANN candidates reach
the exact re-rank (``k_prime``) — neither of which requires retraining
or re-encoding anything.  ``autotune`` grid-searches them against a
caller-supplied evaluator (typically ``launch.serve.measure_recall``
plus a timed query) and picks the cheapest configuration that clears a
recall target; ``tune_service`` applies the grid to a live
``RetrievalService`` by atomically swapping nprobe-adjusted copies of
the current snapshot, leaving the winner installed.

The evaluator runs after each config is installed. A snapshot with
another nprobe is a ``dataclasses.replace`` of the current one: it shares
its device tensors, so trying a config copies nothing.
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class TuneResult:
    nprobe: int
    k_prime: int
    recall: float
    ms: float                      # evaluator-reported query cost
    met_target: bool
    trials: tuple = ()             # every (nprobe, k_prime) tried


def autotune(evaluate, *, nprobes=(4, 8, 16, 32), k_primes=(50, 100),
             target_recall: float = 0.9) -> TuneResult:
    """Grid-search ``evaluate(nprobe, k_prime) -> (recall, ms)``.

    Returns the cheapest (lowest ms) configuration with
    recall >= target_recall; if none clears the bar, the highest-recall
    one (ties broken by cost).  ``trials`` carries the full grid for
    logging/benchmark entries.
    """
    trials = []
    for npb, kp in itertools.product(nprobes, k_primes):
        recall, ms = evaluate(npb, kp)
        trials.append(TuneResult(int(npb), int(kp), float(recall),
                                 float(ms), float(recall) >= target_recall))
    ok = [t for t in trials if t.met_target]
    best = (min(ok, key=lambda t: t.ms) if ok
            else max(trials, key=lambda t: (t.recall, -t.ms)))
    return dataclasses.replace(best, trials=tuple(trials))


def tune_service(service, measure, *, nprobes=(4, 8, 16, 32),
                 k_primes=(50, 100), target_recall: float = 0.9,
                 apply: bool = True) -> TuneResult:
    """Tune a live RetrievalService in place.

    ``measure() -> (recall, ms)`` is called after each candidate config
    is installed (snapshot with adjusted nprobe swapped in atomically,
    ``k_prime`` set on the service).  With ``apply`` the winning config
    stays installed; otherwise the original snapshot/k_prime come back.
    Swaps go through the normal lifecycle, so in-flight queries are never
    disturbed and the tuner is safe to run against a serving process.
    """
    snap0, kp0 = service.snapshot(), service.k_prime
    if snap0.cent_unit is None:
        raise ValueError("tune_service needs an installed IVF snapshot")
    nlist = int(snap0.cent_unit.shape[0])
    # candidate grids, clamped to what this snapshot can express
    nprobes = sorted({min(int(p), nlist) for p in nprobes})
    limit = max(snap0.ntotal, 1)
    k_primes = sorted({min(int(kp), limit) for kp in k_primes})

    def evaluate(npb, kp):
        service.swap(dataclasses.replace(snap0, nprobe=npb))
        service.k_prime = kp
        return measure()

    best = autotune(evaluate, nprobes=nprobes, k_primes=k_primes,
                    target_recall=target_recall)
    if apply:
        service.swap(dataclasses.replace(snap0, nprobe=best.nprobe))
        service.k_prime = best.k_prime
        # future full rebuilds inherit the tuned probe width too
        b = service.builder
        b.ivf = dataclasses.replace(b.ivf,
                                    nprobe=min(best.nprobe, b.ivf.nlist))
    else:
        service.swap(snap0)
        service.k_prime = kp0
    obs.gauge("index_tuned_nprobe").set(best.nprobe)
    obs.gauge("index_tuned_k_prime").set(best.k_prime)
    return best
