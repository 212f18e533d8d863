"""Straggler mitigation (host-side control plane), copied from the JAX
package's ``distributed/straggler.py``, which has no JAX in it.

  * ``StepTimeMonitor``: per-host EMA of step wall time; flags outliers
    and computes a rebalanced per-host microbatch allocation (work moves
    away from stragglers in units of microbatches; the global batch is
    invariant).
  * ``WorkStealingQueue``: the input pipeline's multi-producer queue;
    idle loader threads steal from the slowest shard's backlog.
"""
from __future__ import annotations

import collections
import threading
import time


class StepTimeMonitor:
    def __init__(self, n_hosts: int, *, alpha: float = 0.2,
                 threshold: float = 1.3):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.ema = [None] * n_hosts

    def record(self, host: int, seconds: float):
        e = self.ema[host]
        self.ema[host] = seconds if e is None else \
            (1 - self.alpha) * e + self.alpha * seconds

    def stragglers(self):
        known = [e for e in self.ema if e is not None]
        if len(known) < 2:
            return []
        med = sorted(known)[len(known) // 2]
        return [i for i, e in enumerate(self.ema)
                if e is not None and e > self.threshold * med]

    def rebalance(self, microbatches_per_host: int):
        """Return per-host microbatch counts keeping the global sum fixed.

        Each straggler sheds one microbatch per call; the fastest hosts pick
        them up. Never drops a host below 1 microbatch.  A shed is only
        committed when a receiver exists — with no non-straggler host the
        microbatch stays on the straggler (the global batch is invariant,
        so work may never evaporate)."""
        total = microbatches_per_host * self.n_hosts
        alloc = [microbatches_per_host] * self.n_hosts
        slow = set(self.stragglers())
        if not slow:
            return alloc
        # receivers, fastest first; hosts with no EMA yet go LAST (an
        # unknown host is not evidence of speed)
        fast = sorted((i for i in range(self.n_hosts) if i not in slow),
                      key=lambda i: (self.ema[i] is None, self.ema[i] or 0.0))
        fi = 0
        for s in sorted(slow):
            if alloc[s] > 1 and fast:
                alloc[fast[fi % len(fast)]] += 1   # receiver first:
                alloc[s] -= 1                      # shed only when received
                fi += 1
        if sum(alloc) != total:
            raise RuntimeError(f"rebalance lost work: {alloc} != {total}")
        return alloc


class WorkStealingQueue:
    """Multi-shard producer queue with stealing (used by the data loader)."""

    def __init__(self, n_shards: int):
        self._qs = [collections.deque() for _ in range(n_shards)]
        self._cv = threading.Condition()
        self.steals = 0

    def put(self, shard: int, item):
        with self._cv:
            self._qs[shard].append(item)
            self._cv.notify_all()

    def get(self, shard: int, *, timeout: float = 0.0):
        """Pop from own shard (FIFO), else steal the tail of the deepest
        OTHER shard's backlog; own-shard pops are never counted as steals.
        Blocks on a condition variable until an item arrives or
        ``timeout`` elapses (no busy-spin)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if self._qs[shard]:
                    return self._qs[shard].popleft()
                victims = [i for i in range(len(self._qs))
                           if i != shard and self._qs[i]]
                if victims:
                    victim = max(victims, key=lambda i: len(self._qs[i]))
                    self.steals += 1
                    return self._qs[victim].pop()   # steal from the tail
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def qsize(self):
        with self._cv:
            return sum(len(q) for q in self._qs)


def plan_elastic_mesh(n_devices: int, *, model: int = 16,
                      min_data: int = 1):
    """Largest (data, model) mesh for the surviving device count.

    Model parallelism is fixed by the checkpoint's weight sharding; the data
    axis absorbs elasticity. Returns (data, model) or None if impossible."""
    if n_devices < model * min_data:
        return None
    data = n_devices // model
    return (data, model)
