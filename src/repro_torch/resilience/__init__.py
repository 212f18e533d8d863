"""Resilience layer: fault injection and supervised restarts.

The JAX package's ``resilience`` for the port (its
``docs/resilience.md`` has the failure-mode table):

* ``faults`` — a deterministic, seedable fault-injection registry.  Chaos
  tests and the CI smokes arm a ``FaultPlan`` against named sites
  (``ckpt.write``, ``index.rebuild``, ``prefetch.h2d``, ``train.step``);
  unarmed, every site is a single ``None`` check.
* ``fit_supervised`` — the restart supervisor around ``Trainer.fit``:
  resume from the newest valid checkpoint on transient crashes, with
  exponential backoff + jitter and a transient/fatal classifier.
* checkpoint integrity lives in ``checkpoint.ckpt`` (per-array
  checksums, corrupt-snapshot quarantine); this package holds the
  injection sites and the supervisor that reacts to their failures.
"""
from . import faults
from .faults import FaultPlan, FaultRule, InjectedFault, SITES
from .supervise import NonFiniteLossError, default_classify, fit_supervised
