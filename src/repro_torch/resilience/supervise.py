"""Supervised training: restart ``Trainer.fit`` from the latest checkpoint.

A long-running PLM-in-the-loop job (the paper's production premise) is
preemptible by construction: the loader can die, a checkpoint write can
hit a full disk, the step loop can be killed.  ``fit_supervised`` is the
supervisor around ``Trainer.fit`` that turns those into bounded restarts
instead of lost jobs — each attempt resumes from the newest *valid*
checkpoint (``checkpoint.restore`` already skips corrupt snapshots), with
exponential backoff + jitter between attempts, and a classifier that
refuses to retry programming/config errors (a ``ValueError`` loops
forever no matter how often you restart it).

The non-finite-loss path composes with this: the in-step guard
(``configs.speedyfeed_arch.make_sf_train_step``) holds the optimizer
update on a NaN/Inf loss so Adam is never poisoned, and after K
consecutive bad steps ``fit`` raises ``NonFiniteLossError`` — which
classifies as *transient* here, so the supervisor rolls the job back to
the last good checkpoint rather than letting it continue on a
pathological trajectory.
"""
from __future__ import annotations

import random
import time
import warnings

from repro_torch import obs


class NonFiniteLossError(RuntimeError):
    """Raised by ``Trainer.fit`` after K consecutive non-finite losses.

    Transient by classification: the supervisor restarts from the last
    checkpoint (the rollback), because by the time K steps in a row are
    NaN the live params/opt trajectory is not worth continuing even
    though the guard kept them finite."""

    def __init__(self, msg: str, *, step: int | None = None,
                 consecutive: int = 0):
        super().__init__(msg)
        self.step = step
        self.consecutive = consecutive


FATAL_TYPES = (TypeError, ValueError, KeyError, IndexError, AttributeError,
               NotImplementedError, ImportError, SyntaxError)


def default_classify(exc: BaseException) -> str:
    """'transient' (restart) or 'fatal' (re-raise immediately).

    Control-flow exceptions and programming/config errors are fatal —
    restarting cannot fix a bad argument, and swallowing Ctrl-C would be
    hostile.  Everything else (RuntimeError incl. injected faults and
    NonFiniteLossError, OSError from the checkpoint writer or loader,
    MemoryError from a transient spike) defaults to transient: crashes
    are exactly what the supervisor exists for."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return "fatal"
    if isinstance(exc, FATAL_TYPES):
        return "fatal"
    return "transient"


def fit_supervised(trainer, make_batcher, *, steps: int,
                   ckpt_dir: str | None, max_restarts: int = 3,
                   backoff_s: float = 0.5, backoff_factor: float = 2.0,
                   max_backoff_s: float = 30.0, jitter: float = 0.1,
                   classify=default_classify, sleep=time.sleep, **fit_kw):
    """Run ``trainer.fit`` to ``steps``, restarting on transient failures.

    Each restart resumes from the latest valid checkpoint in ``ckpt_dir``
    (with ``ckpt_dir=None`` every attempt restarts from scratch — legal,
    but warned about: progress is lost on every crash).  At most
    ``max_restarts`` restarts; the delay before attempt ``k`` is
    ``min(backoff_s * backoff_factor**(k-1), max_backoff_s)`` stretched
    by up to ``jitter`` (uniform), so a fleet of supervised jobs sharing
    a failed dependency does not retry in lockstep.

    Returns the successful attempt's ``TrainResult`` with ``.restarts``
    set.  Obs: ``train_restarts_total{reason=<exc type>}`` per restart.
    """
    if ckpt_dir is None and max_restarts > 0:
        warnings.warn("fit_supervised without ckpt_dir: every restart "
                      "re-initializes from scratch", stacklevel=2)
    restarts = 0
    while True:
        try:
            res = trainer.fit(make_batcher, steps=steps, ckpt_dir=ckpt_dir,
                              **fit_kw)
            res.restarts = restarts
            return res
        except BaseException as e:
            if classify(e) != "transient" or restarts >= max_restarts:
                raise
            restarts += 1
            reason = type(e).__name__
            obs.counter("train_restarts_total", reason=reason).inc()
            delay = min(backoff_s * backoff_factor ** (restarts - 1),
                        max_backoff_s)
            delay *= 1.0 + jitter * random.random()
            warnings.warn(
                f"fit_supervised: attempt {restarts}/{max_restarts} "
                f"restarting after {reason}: {e} (backoff {delay:.2f}s)",
                stacklevel=2)
            if delay > 0:
                sleep(delay)
