"""Trainer: the step and the fit loop over the async input pipeline.

The step path never waits on the device: batches arrive device-resident
from the DevicePrefetcher, each at its seg-length bucket (PyTorch runs
eagerly, so a bucket needs no program of its own), and step metrics stay
device scalars in a MetricsBuffer fetched in one transfer every
``log_every`` steps.

The non-finite guard lives in the step (``configs.speedyfeed_arch``):
when the loss is NaN or Inf the parameters, all of the Adam state and
the cache keep their old values, decided on the device by a select, and
the step still advances. The step reports it as ``nonfinite_step``;
``fit`` raises ``NonFiniteLossError`` after ``max_consecutive_nonfinite``
such steps in a row (checked when the metrics are drained).

``fit`` checkpoints the state every ``ckpt_every`` steps in the JAX
package's format (``training/state.py``) and resumes from the newest valid
step of ``ckpt_dir``, a JAX run's included; ``resilience.fit_supervised``
restarts it through transient failures.

On a data mesh (``Trainer(mesh=)``, in every rank of
``launch.mesh.run_on_mesh``) the state is placed by ``state_shardings``
(the cache row-sharded, the rest replicated), only rank 0 runs the
batcher, and each batch is broadcast from rank 0 on the step's thread
(``prefetch.broadcast_batch``), so every rank trains on the same batches
whatever the loader's thread count. Checkpoints are gathered to rank 0
and written there; only rank 0 prints.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import torch

from repro_torch import checkpoint as ckpt, obs
from repro_torch.device import check_device
from repro_torch.distributed.collectives import barrier
from repro_torch.distributed.straggler import StepTimeMonitor
from repro_torch.resilience import faults
from repro_torch.resilience.supervise import NonFiniteLossError

from .prefetch import STREAM_END, DevicePrefetcher, broadcast_batch
from .state import (TrainState, place_state, restore_state, save_state,
                    state_shardings)


class MetricsBuffer:
    """Accumulates per-step metric dicts of device scalars; ``drain``
    fetches everything pending in one device-to-host transfer.

    ``max_pending`` bounds the backlog when the caller never drains.
    Every drained scalar is appended to a bounded per-key ``history``
    (``history_len`` entries); non-scalar entries are kept in ``last``
    only, with one warning per key. ``on_drain`` (if given) receives each
    drained chunk as a list of host metric dicts: the Trainer feeds the
    obs registry's cache counters from it.
    """

    def __init__(self, max_pending: int = 512, history_len: int = 4096,
                 on_drain=None):
        self.max_pending = max_pending
        self.history_len = history_len
        self._on_drain = on_drain
        self._pending = []
        self._warned: set = set()
        self.losses: list = []
        self.history: dict = {}      # key -> deque of host floats
        self.last: dict = {}

    def append(self, metrics: dict):
        self._pending.append(metrics)
        if len(self._pending) >= self.max_pending:
            self.drain()

    def _fetch(self):
        """The pending dicts with every tensor scalar as a host float, from
        one stacked transfer."""
        scalars = [v for m in self._pending for v in m.values()
                   if isinstance(v, torch.Tensor) and v.dim() == 0]
        got = torch.stack([v.detach().double() for v in scalars]).tolist() \
            if scalars else []
        host = {id(v): x for v, x in zip(scalars, got)}
        out = []
        for m in self._pending:
            row = {}
            for k, v in m.items():
                if isinstance(v, torch.Tensor):
                    v = host[id(v)] if v.dim() == 0 else v.detach().cpu()
                row[k] = v
            out.append(row)
        return out

    def drain(self) -> dict:
        """Fetch everything accumulated since the last drain; returns the
        most recent step's metrics (host values)."""
        if self._pending:
            host = self._fetch()
            self._pending = []
            for m in host:
                for k, v in m.items():
                    if isinstance(v, (int, float)):
                        dq = self.history.get(k)
                        if dq is None:
                            dq = self.history[k] = collections.deque(
                                maxlen=self.history_len)
                        dq.append(float(v))
                    elif k not in self._warned:
                        self._warned.add(k)
                        warnings.warn(
                            f"MetricsBuffer: metric {k!r} is not a scalar; "
                            f"kept in .last but not in the history",
                            stacklevel=2)
            self.losses.extend(float(m["loss"]) for m in host if "loss" in m)
            # finite_metrics routes NaN/Inf scalars into the obs
            # nonfinite_metrics_total counter (one warning per key)
            from repro_torch.configs.base import finite_metrics
            self.last = finite_metrics(host[-1])
            if self._on_drain is not None:
                self._on_drain(host)
        return self.last


_CACHE_COUNTER_KEYS = (
    # per-step cache scalars of core/cache.py's plan
    # (pipeline.speedyfeed_forward) -> process counters, the paper's
    # headline cache-reuse signal
    ("cache_hits", "cache_hits_total"),
    ("cache_misses", "cache_misses_total"),
    ("cache_expired", "cache_expired_total"),
    ("cache_overflow", "cache_overflow_total"),
)


def _feed_cache_obs(host_metrics: list):
    """MetricsBuffer drain hook: fold the drained per-step cache scalars
    into obs counters and refresh the derived hit-rate gauge (plus the
    non-finite-guard skip counter, which drains on the same cadence)."""
    skipped = sum(float(m.get("nonfinite_step", 0.0)) for m in host_metrics)
    if skipped:
        obs.counter("train_nonfinite_steps_total").inc(skipped)
    for key, name in _CACHE_COUNTER_KEYS:
        total = sum(float(m[key]) for m in host_metrics if key in m)
        if total:
            obs.counter(name).inc(total)
    hits = obs.counter("cache_hits_total").value
    misses = obs.counter("cache_misses_total").value
    expired = obs.counter("cache_expired_total").value
    looked = hits + misses + expired
    if looked:
        obs.gauge("cache_hit_rate").set(hits / looked)


def _trailing_nonfinite(history: dict) -> int:
    """Length of the trailing run of guarded steps in the drained
    ``nonfinite_step`` history (0 when the newest drained step was fine)."""
    n = 0
    for v in reversed(history.get("nonfinite_step", ())):
        if v <= 0:
            break
        n += 1
    return n


@dataclasses.dataclass
class TrainResult:
    steps_done: int
    losses: list
    wall_seconds: float
    metrics: dict
    bucket_steps: dict = dataclasses.field(default_factory=dict)
    host_stall_fraction: float = 0.0
    state: object = None      # the final TrainState
    history: dict = dataclasses.field(default_factory=dict)  # key -> values
    resumed_from: int | None = None   # the checkpoint step fit resumed from
    # restarts consumed by resilience.fit_supervised (0 for a plain fit)
    restarts: int = 0


class Trainer:
    """Owns the step function and the fit loop.

    ``make_step(cfg)`` returns the raw step ``(params, opt, cache, step,
    rng, batch) -> (params, opt, cache, metrics)``; ``init_fn(cfg, gen) ->
    TrainState`` builds the initial state from a seeded generator on the
    device. Both come from the configuration module (see
    ``training.get_trainer``). ``device`` defaults to the card and raises
    without one; pass ``device="cpu"`` to train on the CPU.

    ``mesh`` (this rank's mesh, ``launch.mesh``): the device is the
    rank's, ``make_step(cfg, mesh=mesh)`` gives the data-parallel step,
    and ``init_state`` returns this rank's placed state
    (``state_shardings``, kept as ``self.state_shardings``).
    """

    def __init__(self, cfg, *, make_step, init_fn, device="cuda",
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = check_device(device if mesh is None else mesh.device)
        self._raw_step = make_step(cfg) if mesh is None else \
            make_step(cfg, mesh=mesh)
        self._init_fn = init_fn
        self.state_shardings: TrainState | None = None
        self.bucket_steps: dict = {}      # bucket -> steps run
        self.monitor: StepTimeMonitor | None = None   # set by fit()
        self.last_state: TrainState | None = None     # final state of fit()

    def init_state(self, seed: int = 0) -> TrainState:
        """The state from ``seed`` (every rank of a mesh draws the same
        one), placed on the mesh when there is one."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = self._init_fn(self.cfg, gen)
        if self.mesh is None:
            return state
        self.state_shardings = state_shardings(state, self.mesh)
        return place_state(state, self.state_shardings)

    @property
    def _rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def step(self, state: TrainState, batch: dict, bucket=None, **draws):
        """One train step on a batch of device tensors. Parameters, Adam
        state and cache are updated in place; returns (the next
        TrainState, device metrics). ``draws`` (``u``, ``neg_idx``) inject
        the step's random draws in place of the generator's."""
        params, opt, cache, metrics = self._raw_step(
            state.params, state.opt, state.cache, state.step, state.rng,
            batch, **draws)
        if bucket is not None:
            self.bucket_steps[bucket] = self.bucket_steps.get(bucket, 0) + 1
        return TrainState(params, opt, cache, state.step + 1,
                          state.rng), metrics

    def fit(self, make_batcher, *, steps: int, state: TrainState | None = None,
            seed: int = 0, ckpt_dir: str | None = None, ckpt_every: int = 50,
            async_ckpt: bool = True, log_every: int = 20,
            fail_at: int | None = None, prefetch_depth: int = 2,
            batch_timeout: float = 60.0, hosts: int | None = None,
            microbatches_per_host: int = 1,
            max_consecutive_nonfinite: int = 8) -> TrainResult:
        """Train until ``steps`` total steps, resuming from the newest
        *valid* checkpoint in ``ckpt_dir`` when one exists (corrupt
        snapshots are quarantined and skipped by ``checkpoint.restore``;
        if every snapshot is corrupt, training starts from scratch with a
        warning instead of crashing).

        ``make_batcher(epoch)`` -> a started DynamicBatcher; epochs roll
        over inside the prefetcher. A resumed run offsets the epochs by
        the restored step, so it does not replay the batches before the
        crash. The state is saved every ``ckpt_every`` steps, through a
        background writer when ``async_ckpt``. ``fail_at`` injects a
        crash after that many total steps (restart tests); the
        ``train.step`` fault site fires after each completed step.
        ``max_consecutive_nonfinite`` non-finite losses in a row raise
        ``NonFiniteLossError`` (0 disables), which ``fit_supervised``
        classifies as transient: a rollback to the last checkpoint.

        ``hosts`` (default: the mesh's ranks, else 1) sets the straggler
        monitor's host count; with more than one, each step's wall time
        is attributed round-robin to the hosts, and the monitor's
        ``stragglers()`` / ``rebalance(microbatches_per_host)`` feed the
        ``straggler_hosts`` / ``microbatch_alloc{host=}`` gauges at the
        drain cadence. On a mesh, ``state`` must come from this trainer's
        ``init_state`` (or be None).
        """
        t0 = time.time()
        bs0 = dict(self.bucket_steps)
        mesh = self.mesh
        state = state if state is not None else self.init_state(seed)
        if mesh is not None and self.state_shardings is None:
            raise ValueError("on a mesh, fit's state comes from this "
                             "trainer's init_state")
        resumed = None
        if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
            try:
                resumed, state = restore_state(
                    ckpt_dir, state, shardings=self.state_shardings)
            except FileNotFoundError as e:
                # every snapshot failed verification (all quarantined by
                # restore): degrade to a fresh start, don't die on resume
                warnings.warn(f"resume skipped — {e}; training from "
                              f"scratch", stacklevel=2)
        step = state.step
        # a resumed run must not replay the pre-crash batch stream: offset
        # the loader's epoch numbering (and thus its seeds) by the
        # restored step
        epoch0 = step if resumed is not None else 0
        writer = ckpt.AsyncCheckpointer(ckpt_dir) \
            if (ckpt_dir and async_ckpt and self._rank0) else None
        prefetcher = DevicePrefetcher(
            lambda e: make_batcher(e + epoch0), depth=prefetch_depth,
            device=self.device).start() if self._rank0 else None
        n_hosts = hosts if hosts is not None else \
            (mesh.world if mesh is not None else 1)
        monitor = StepTimeMonitor(n_hosts=max(n_hosts, 1))
        buf = MetricsBuffer(on_drain=_feed_cache_obs)
        stall, de_sum, de_n = 0.0, 0.0, 0
        drain_mark, drain_step = time.perf_counter(), step
        step_hists: dict = {}     # bucket -> train_step_ms histogram
        step_ctrs: dict = {}      # bucket -> train_steps_total counter
        try:
            while step < steps:
                t_iter = tw = time.perf_counter()
                with obs.span("train_host_stall"):
                    pb = prefetcher.get(timeout=batch_timeout) \
                        if prefetcher is not None else None
                    if mesh is not None:
                        pb = broadcast_batch(pb, mesh)
                stall += time.perf_counter() - tw
                if pb is STREAM_END:       # bounded-epoch source ran dry
                    break
                if pb is None:
                    raise RuntimeError(
                        f"no batch within {batch_timeout}s at step {step}")
                state, metrics = self.step(state, pb.arrays, pb.bucket)
                buf.append(metrics)
                if pb.stats and "data_efficiency" in pb.stats:
                    de_sum += float(pb.stats["data_efficiency"])
                    de_n += 1
                step += 1
                # per-step wall at the loop (dispatch + stall; converges to
                # true step time once the queued device work backpressures)
                hist = step_hists.get(pb.bucket)
                if hist is None:
                    b = str(pb.bucket)
                    hist = step_hists[pb.bucket] = obs.histogram(
                        "train_step_ms", bucket=b)
                    step_ctrs[pb.bucket] = obs.counter(
                        "train_steps_total", bucket=b)
                hist.observe((time.perf_counter() - t_iter) * 1e3)
                step_ctrs[pb.bucket].inc()
                if monitor.n_hosts > 1:
                    # the step's loop wall, attributed round-robin (each
                    # rank runs every step, so the hosts are simulated)
                    monitor.record((step - 1) % monitor.n_hosts,
                                   time.perf_counter() - t_iter)
                obs.tick()
                if fail_at is not None and step >= fail_at:
                    raise RuntimeError("injected failure")
                faults.fire("train.step", step=step)
                if ckpt_dir and step % ckpt_every == 0:
                    save_state(ckpt_dir, step, state, writer=writer,
                               shardings=self.state_shardings)
                if log_every and step % log_every == 0:
                    m = buf.drain()
                    bad = _trailing_nonfinite(buf.history)
                    if max_consecutive_nonfinite and \
                            bad >= max_consecutive_nonfinite:
                        raise NonFiniteLossError(
                            f"{bad} consecutive non-finite losses at step "
                            f"{step}: params held at their last finite "
                            f"values by the guard; rolling back to the "
                            f"last checkpoint", step=step, consecutive=bad)
                    now = time.perf_counter()
                    if monitor.n_hosts == 1:
                        # the true wall a step at the (blocking) drain
                        monitor.record(0, (now - drain_mark)
                                       / max(step - drain_step, 1))
                    else:
                        slow = monitor.stragglers()
                        obs.gauge("straggler_hosts").set(float(len(slow)))
                        for h, a in enumerate(
                                monitor.rebalance(microbatches_per_host)):
                            obs.gauge("microbatch_alloc",
                                      host=str(h)).set(float(a))
                    drain_mark, drain_step = now, step
                    if self._rank0:
                        print(f"step {step}: loss={m.get('loss', 0):.4f} "
                              f"acc={m.get('ar_acc', 0):.3f} "
                              f"reused={int(m.get('reused', 0))} "
                              f"p_t={m.get('p_t', 0):.2f} "
                              f"de={de_sum / max(de_n, 1):.2f} "
                              f"[bucket {pb.bucket}]", flush=True)
        finally:
            if prefetcher is not None:
                prefetcher.stop()
            if writer:
                writer.wait()
        if mesh is not None and ckpt_dir:
            # every rank sees rank 0's last checkpoint once fit returns
            barrier(mesh)
        self.monitor = monitor
        self.last_state = state
        final = dict(buf.drain())
        if de_n:      # loader-side Eq. 1 data efficiency (paper Figure 8)
            final["loader_data_efficiency"] = de_sum / de_n
        wall = time.time() - t0
        obs.gauge("train_host_stall_fraction").set(stall / max(wall, 1e-9))
        bsteps = {k: v - bs0.get(k, 0) for k, v in self.bucket_steps.items()
                  if v - bs0.get(k, 0) > 0}
        return TrainResult(step, buf.losses, wall, final, bsteps,
                           stall / max(wall, 1e-9), state=state,
                           history={k: list(v)
                                    for k, v in buf.history.items()},
                           resumed_from=resumed)
