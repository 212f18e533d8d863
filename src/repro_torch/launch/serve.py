"""Serving launcher: two-stage batched news recommendation (paper §5.1.4).

  1. offline: encode the news corpus with BusLM, then bootstrap the
     snapshot lifecycle — publish the corpus and run one full
     ``IndexBuilder`` build (exact, IVF-Flat or IVF-PQ), installed by
     atomic swap; full-precision embeddings stay in the service's
     ``EmbeddingStore`` (on the device) for user encoding and
     re-rank,
  2. online: every request goes through the continuous-batching
     ``serving.RequestScheduler`` (bounded admission queue, power-of-two
     shape buckets, ``max_wait_ms`` timeout flush, optional SLO
     deadlines): encode users (history -> user embedding), then ANN recall
     of k' candidates (one frozen snapshot + fresh-news delta view) and
     exact re-rank to top-k. Fresh news enters via ``service.publish``
     (pure delta append) and is absorbed by background rebuilds that swap
     in without blocking a query (``--rebuild-mid-loop``).

Two drivers feed the scheduler:
  closed-loop   ``micro_batch_loop`` submits a fixed request list and
                drains it,
  open-loop     ``--open-loop`` fires seeded Poisson arrivals at offered
                rates (``--sweep``/``--qps``), measures p50/p99 queued and
                e2e latency, goodput under ``--slo-ms``, reject rate and
                late-drops, and merges the sweep into ``--bench-out``
                (nothing is recorded unless it names a file).

Every request-loop number flows through the process-wide
``repro_torch.obs`` registry (``query_latency_ms{phase=queued|execute|
e2e}``, ``serve_batch_size``, ``sched_*``, ...); ``ServeStats`` is a view
rendered from that registry after the loop, and ``--metrics-out``
snapshots the whole registry (train + publish + serve) to JSONL.

``--mesh data=N`` shards the IVF index's CSR rows across N devices
(``serving/sharded.py``, one process): the cards ``cuda:0`` ..
``cuda:N-1``, or N shards on the CPU with ``--device cpu``.

Run: python -m repro_torch.launch.serve --requests 64 --batch 16 \
         [--index ivf-pq|ivf-flat|exact] [--nprobe 16] [--k-prime 64] \
         [--rebuild-mid-loop] [--train-steps 6] [--metrics-out m.jsonl] \
         [--device cuda|cpu] [--mesh data=N]
     python -m repro_torch.launch.serve --open-loop --sweep 50 100 200 \
         --slo-ms 250 [--duration 2.0] [--bench-out sweep.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import core, obs, serving
from repro_torch.device import check_device
from repro_torch.launch.mesh import parse_mesh_arg
from repro_torch.resilience import FaultPlan, faults


def ivf_nlist(n_rows: int) -> int:
    """Coarse cells the launcher builds over a corpus of ``n_rows``."""
    return max(4, min(64, n_rows // 32))


def ivf_scan_shape(n_rows: int, nprobe: int) -> dict:
    """The IVF-PQ scan's shape for a corpus of ``n_rows`` spread evenly
    over the launcher's lists: ``nlist``, each list's length, the
    power-of-two capacity bucket that holds it (``cap``), the lists a
    query probes and ``N = probes * cap``, the candidate slots a query's
    LUT scan scores."""
    nlist = ivf_nlist(n_rows)
    per_list = -(-n_rows // nlist)
    cap = serving.index._next_cap(per_list)
    probes = min(nprobe, nlist)
    return {"nlist": nlist, "per_list": per_list, "cap": cap,
            "probes": probes, "N": probes * cap}


def pq_scan_inputs(n_rows: int, *, batch: int, n_subvec: int,
                   n_codes: int, nprobe: int | None, gen: torch.Generator,
                   device) -> dict:
    """Seeded inputs of one query batch's LUT scan over a corpus of
    ``n_rows`` (no encoder needed): f32 LUTs [batch, M, K] and uint8
    codes drawn uniformly. With ``nprobe``, the IVF-PQ scan at
    ``ivf_scan_shape``: codes [batch, N, M], list lengths within 5% of
    the even share (at most ``cap``), each query probing ``probes``
    distinct lists, and slot validity [batch, N] from the probed lists'
    lengths. Without it, the flat scan: codes [1, n_rows,
    M] shared by the batch, no validity."""
    lut = torch.randn(batch, n_subvec, n_codes, generator=gen,
                      device=device)
    if nprobe is None:
        codes = torch.randint(0, n_codes, (1, n_rows, n_subvec),
                              generator=gen, device=device,
                              dtype=torch.uint8)
        return {"lut": lut, "codes": codes, "valid": None}
    shape = ivf_scan_shape(n_rows, nprobe)
    cap, probes = shape["cap"], shape["probes"]
    jitter = 1 + 0.05 * (2 * torch.rand(shape["nlist"], generator=gen,
                                        device=device) - 1)
    lens = (shape["per_list"] * jitter).long().clamp(1, cap)
    probed = torch.rand(batch, shape["nlist"], generator=gen,
                        device=device).argsort(dim=1)[:, :probes]
    slot = torch.arange(cap, device=device)
    valid = (slot[None, None] < lens[probed][..., None]).reshape(batch, -1)
    codes = torch.randint(0, n_codes, (batch, shape["N"], n_subvec),
                          generator=gen, device=device, dtype=torch.uint8)
    return {"lut": lut, "codes": codes, "valid": valid, **shape}


@dataclasses.dataclass
class ServeStats:
    n_requests: int
    n_batches: int
    p50_ms: float             # per request, queued + execute (e2e)
    p99_ms: float
    recall_at_k: float        # true recall@k vs the exact-MIPS oracle
    recall_ok: bool           # recall_at_k >= the threshold
    index_kind: str = "exact"
    ntotal: int = 0
    index_version: int = 0
    n_swaps: int = 0
    # --open-loop only: the load-sweep entries (per offered-rate point:
    # goodput / p50 / p99 / reject rate)
    load_sweep: list | None = None

    @classmethod
    def from_registry(cls, *, recall_at_k: float, recall_ok: bool,
                      index_kind: str, ntotal: int) -> "ServeStats":
        """Render the stats view from the obs registry, the single source
        of truth."""
        e2e = obs.histogram("query_latency_ms", phase="e2e")
        return cls(
            n_requests=int(obs.counter("serve_requests_total").value),
            n_batches=int(obs.counter("serve_batches_total").value),
            p50_ms=e2e.percentile(50), p99_ms=e2e.percentile(99),
            recall_at_k=recall_at_k, recall_ok=recall_ok,
            index_kind=index_kind, ntotal=ntotal,
            index_version=int(obs.gauge("index_snapshot_version").value),
            n_swaps=int(obs.counter("index_swap_total").value))


def params_to(params, device):
    """The parameter tree (dicts and lists of tensors) on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


class Recommender:
    """Two-stage (ANN retrieve -> exact re-rank) news recommender."""

    def __init__(self, cfg: core.SpeedyFeedConfig, params, store, *, k=10,
                 index_kind: str = "ivf-pq", nprobe: int = 8,
                 k_prime: int | None = None, compact_threshold: int = 512,
                 probe_metric: str = "ip", service_kw=None, device="cuda",
                 mesh=None):
        # probe_metric: the launcher serves raw MIPS over unnormalized
        # encoder embeddings, where ranking cells by raw inner product
        # recalls the large-norm winners the spherical ("l2") ranking
        # misses; "l2" stays the library default for normalized corpora.
        # mesh (launch.mesh.Mesh): the IVF index's rows shard across its
        # devices, the first of which serves everything else
        self.mesh = mesh
        self.device = check_device(device if mesh is None
                                   else mesh.devices[0])
        self.cfg, self.store, self.k = cfg, store, k
        self.params = params_to(params, self.device)
        self.index_kind = index_kind
        self.nprobe = nprobe
        self.probe_metric = probe_metric
        self.k_prime = k_prime or max(4 * k, 32)
        self.compact_threshold = compact_threshold
        # extra RetrievalService knobs (build_retries,
        # degraded_after_failures, delta_hard_cap, ...); the store grows
        # by chunks, so a small publish does not reallocate [N, d]
        self.service_kw = dict(service_kw or {})
        self.service_kw.setdefault("store_grow_chunk", 1024)
        self.service: serving.RetrievalService | None = None

    @torch.inference_mode()
    def _encode_corpus(self, *, chunk: int = 256):
        """Bulk encode of the whole corpus -> [N, news_dim] on the device;
        the tail chunk is padded to the full chunk shape."""
        toks, freq = self.store.tokens, self.store.freq
        n = toks.shape[0]
        outs = []
        for i in range(0, n, chunk):
            t = torch.as_tensor(toks[i:i + chunk], device=self.device)
            f = torch.as_tensor(freq[i:i + chunk], device=self.device)
            m = t.shape[0]
            if m < chunk:
                pad = (0, 0, 0, 0, 0, chunk - m)
                t = torch.nn.functional.pad(t, pad)
                f = torch.nn.functional.pad(f, pad)
            e = core.buslm_encode(self.params["plm"], self.cfg.plm,
                                  t.long(), f.long())
            outs.append(e[:m])
        emb = torch.cat(outs)
        emb[0] = 0.0              # pad news scores nothing
        return emb

    def build_index(self, *, chunk: int = 256, seed: int = 0):
        """Encode the corpus, then bootstrap the snapshot lifecycle:
        publish everything and install the first full build by swap."""
        return self.build_index_from(self._encode_corpus(chunk=chunk),
                                     seed=seed)

    def build_index_from(self, emb, *, seed: int = 0):
        """``build_index`` over corpus embeddings [N, d] already encoded
        (by ``_encode_corpus``)."""
        n = emb.shape[0]
        nlist = ivf_nlist(n)
        devices = None
        if self.mesh is not None and self.index_kind != "exact":
            devices = list(self.mesh.devices)
        builder = serving.IndexBuilder(
            self.index_kind, emb.shape[1],
            ivf=serving.IVFConfig(nlist=nlist,
                                  nprobe=min(self.nprobe, nlist),
                                  metric=self.probe_metric),
            seed=seed, device=self.device, devices=devices)
        self.service = serving.RetrievalService(
            builder, emb, k=self.k, k_prime=min(self.k_prime, n - 1),
            compact_threshold=self.compact_threshold, auto_compact=False,
            device=self.device, **self.service_kw)
        # row 0 is the pad news, never a candidate
        self.service.publish(np.arange(1, n), emb[1:])
        self.service.rebuild(mode="full", block=True)
        self.service.auto_compact = True
        return self.service

    def publish(self, ids, emb):
        """Fresh news straight into the serving path (store + delta)."""
        self.service.publish(ids, emb)

    @torch.inference_mode()
    def encode_users(self, hist_batch: np.ndarray, mask: np.ndarray):
        """History -> user embedding [B, news_dim], off the device store."""
        hist = torch.as_tensor(hist_batch, dtype=torch.long,
                               device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        theta = self.service.store.emb[hist]
        return core.attentive_user(self.params["user"], theta, mask)

    def recommend(self, hist_batch: np.ndarray, mask: np.ndarray):
        """-> (scores [B, k], ids [B, k]) numpy."""
        user = self.encode_users(hist_batch, mask)
        return self.service.query(user, self.k)


def _pad_histories(rec: Recommender, histories, rows: int):
    L = rec.cfg.hist_len
    hist = np.zeros((rows, L), np.int64)
    mask = np.zeros((rows, L), bool)
    for i, h in enumerate(histories):
        h = np.asarray(h)[-L:]
        hist[i, :len(h)] = h
        mask[i, :len(h)] = True
    return hist, mask


def make_recommend_execute(rec: Recommender):
    """The scheduler's model-side callable: pad ``len(payloads)``
    histories up to the batch dim ``pad_to`` (one of the scheduler's
    power-of-two buckets, not ``max_batch``) and run the two-stage
    pipeline. Returns one top-k id row per payload, in order, on the host:
    the ids are on the host when it returns."""

    def execute(payloads, pad_to):
        hist, mask = _pad_histories(rec, payloads, pad_to)
        _, ids = rec.recommend(hist, mask)
        return [ids[i] for i in range(len(payloads))]

    return execute


def micro_batch_loop(rec: Recommender, requests, *, max_batch: int,
                     max_wait_ms: float = 2.0, on_batch=None):
    """Closed-loop driver over the continuous-batching scheduler; returns
    (results, n_batches).

    Submit the fixed request list, wait for every handle, drain.
    Batching, shape bucketing, timeout flush and the request-loop
    telemetry (``query_latency_ms{phase=queued|execute|e2e}``,
    ``serve_batch_size``, request/batch counters) live in
    ``serving.RequestScheduler``: this path and the open-loop harness
    measure the same machinery. ``on_batch(i)`` fires on the scheduler's
    worker after batch i completes.
    """
    sched = serving.RequestScheduler(
        make_recommend_execute(rec), max_batch=max_batch,
        max_wait_ms=max_wait_ms, max_queue=max(len(requests), 1),
        on_batch=on_batch)
    try:
        handles = [sched.submit(h) for h in requests]
        results = [h.result(timeout=300.0) for h in handles]
    finally:
        sched.stop(drain=True)
    return results, sched.n_batches


def open_loop_harness(args, rec: Recommender, requests, *, chaos_n: int = 0):
    """Open-loop Poisson load sweep through the continuous-batching
    scheduler.

    Sweeps the offered rates (``--sweep`` / ``--qps``; default 3 points)
    against one warmed scheduler under ``--slo-ms`` deadlines, recording
    p50/p99 queued and e2e latency, goodput under the SLO, reject rate and
    late-drops per point. With --rebuild-mid-loop (or chaos), one extra
    point runs at the middle rate while a publisher + full-rebuild churn
    loop holds a build in flight. The churn re-publishes fresh embeddings
    for the same id block, and one publish->rebuild cycle runs before the
    measured window, the bucket warm-up repeated while the delta tier is
    non-empty, so the window measures rebuild contention and not first
    calls. ``chaos_n > 0`` arms the fault plan after the warm cycle, so
    the injected rebuild failures land inside the measured window.
    Returns (entries, chaos_plan)."""
    svc = rec.service
    qps_points = [float(q) for q in (
        args.sweep if args.sweep
        else ([args.qps] if args.qps else [50.0, 100.0, 200.0]))]
    sched = serving.RequestScheduler(
        make_recommend_execute(rec), max_batch=args.batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.queue_depth,
        slo_ms=args.slo_ms)
    sched.attach_to(svc)          # saturated admission queue => degraded
    n_warm = sched.warmup(requests[0])
    print(f"scheduler warm: {n_warm} shape buckets {sched.buckets}, "
          f"slo={args.slo_ms}ms, queue cap {args.queue_depth}")
    extra = {"index": args.index, "ntotal": svc.ntotal}
    chaos_plan = None
    rebuild_scenario = args.rebuild_mid_loop or chaos_n > 0
    rng = np.random.default_rng(1)
    n0 = svc.store.emb.shape[0]
    fresh_ids = np.arange(n0, n0 + 32)

    def fresh_rows():
        return (svc.store.emb[1:33].cpu().numpy()
                + 0.01 * rng.normal(size=(32, svc.store.dim))
                ).astype(np.float32)

    try:
        if rebuild_scenario:
            # warm cycle (outside every measured window)
            rec.publish(fresh_ids, fresh_rows())     # O(append)
            sched.warmup(requests[0])                # delta non-empty path
            svc.rebuild(mode="full", block=True)
            if chaos_n > 0:
                chaos_plan = faults.arm(FaultPlan().fail(
                    "index.rebuild", calls=range(1, chaos_n + 1)))
        entries = [serving.loadgen.sweep(
            sched, requests, qps_points, duration_s=args.duration,
            slo_ms=args.slo_ms, seed=11, scenario="quiescent",
            source="serve", extra=extra)]
        if rebuild_scenario:
            stop_ev = threading.Event()
            cuda_index = (torch.cuda.current_device()
                          if rec.device.type == "cuda" else None)

            def churn():
                if cuda_index is not None:
                    torch.cuda.set_device(cuda_index)
                while not stop_ev.is_set():
                    try:
                        rec.publish(fresh_ids, fresh_rows())
                        svc.rebuild(mode="full", block=True)
                    except Exception:
                        # retries exhausted under chaos: the view stays
                        # on the last good snapshot; keep churning
                        pass

            churn_t = threading.Thread(target=churn, name="rebuild-churn",
                                       daemon=True)
            churn_t.start()
            mid = qps_points[len(qps_points) // 2]
            entries.append(serving.loadgen.sweep(
                sched, requests, [mid], duration_s=args.duration,
                slo_ms=args.slo_ms, seed=23, scenario="during_rebuild",
                source="serve", extra=extra))
            stop_ev.set()
            churn_t.join(timeout=120.0)
    finally:
        sched.stop(drain=True)
    for e in entries:
        for pt in e["points"]:
            print(f"[{e['scenario']:>14}] offered {pt['offered_qps']:>6} "
                  f"qps: goodput {pt['goodput_qps']:>6} qps, e2e p50/p99 "
                  f"{pt['e2e_ms_p50']}/{pt['e2e_ms_p99']}ms, queued p99 "
                  f"{pt['queued_ms_p99']}ms, rejected {pt['rejected']} "
                  f"({100 * pt['reject_rate']:.1f}%), "
                  f"late {pt['late_dropped']}")
    if args.bench_out:
        p = serving.loadgen.record_sweep(entries, args.bench_out)
        print(f"merged {len(entries)} load-sweep entries into {p}")
    return entries, chaos_plan


def _probe_users(rec: Recommender, histories, probe: int):
    """Encode the probe-subset histories into user embeddings."""
    probe = min(probe, len(histories))
    hist, mask = _pad_histories(rec, histories[:probe], probe)
    return rec.encode_users(hist, mask)


def measure_recall(rec: Recommender, histories, *, k: int, probe: int = 16):
    """True recall@k of the served path vs an exact-MIPS oracle over the
    full-precision store, on a probe subset of requests."""
    probe = min(probe, len(histories))
    user = _probe_users(rec, histories, probe)
    _, got = rec.service.query(user, k)
    store = rec.service.store.emb
    scores = user @ store.T
    live = (store != 0.0).any(dim=1)          # unpublished gap rows excluded
    live[0] = False                           # pad news is never a candidate
    scores = scores.masked_fill(~live, float("-inf"))
    ref_ids = torch.topk(scores, k, dim=1).indices.cpu().numpy()
    return float(np.mean([len(set(got[b]) & set(ref_ids[b])) / k
                          for b in range(probe)]))


def chaos_service_kw(chaos_n: int) -> dict:
    """Service knobs for ``--chaos-rebuild-failures N``: enough retries to
    outlast the injected failures, tight backoff, and a 1-failure
    degraded threshold, so the degraded->healthy transition is sure to
    appear in the metrics."""
    return dict(build_retries=max(2, chaos_n), build_backoff_s=0.01,
                degraded_after_failures=1)


def tune(rec: Recommender, reqs, args) -> serving.TuneResult:
    """``--autotune``: grid-tune (nprobe, k') of the live service against
    the exact-MIPS recall oracle and one timed probe query; the winner is
    installed by atomic swap and future rebuilds inherit it."""
    svc = rec.service

    def tune_measure():
        recall = measure_recall(rec, reqs, k=args.k, probe=args.probe)
        user = _probe_users(rec, reqs, args.probe)
        t0 = time.perf_counter()
        svc.query(user, args.k)          # ends with the ids on the host
        return recall, (time.perf_counter() - t0) * 1e3

    best = serving.tune_service(
        svc, tune_measure, nprobes=(4, 8, 16, 32),
        k_primes=(max(4 * args.k, 32), args.k_prime, 2 * args.k_prime),
        target_recall=args.recall_threshold)
    rec.nprobe, rec.k_prime = best.nprobe, best.k_prime
    print(f"autotuned: nprobe={best.nprobe} k'={best.k_prime} "
          f"recall@{args.k}={best.recall:.3f} ({best.ms:.1f}ms/batch, "
          f"{len(best.trials)} configs tried)")
    return best


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--index", default="ivf-pq",
                    choices=["exact", "ivf-flat", "ivf-pq"])
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--k-prime", type=int, default=64)
    ap.add_argument("--probe-metric", default="ip", choices=["ip", "l2"],
                    help="cell-probe ranking; ip recalls large-norm MIPS "
                         "winners on unnormalized encoder embeddings")
    ap.add_argument("--autotune", action="store_true",
                    help="grid-tune (nprobe, k') against the exact-MIPS "
                         "recall oracle after the bootstrap build; the "
                         "winner is installed by atomic swap and future "
                         "rebuilds inherit it")
    ap.add_argument("--rebuild-mid-loop", action="store_true",
                    help="publish fresh news and run a background full "
                         "rebuild + atomic swap in the middle of the "
                         "request loop")
    ap.add_argument("--chaos-rebuild-failures", type=int, default=0,
                    metavar="N",
                    help="fault injection: make the first N mid-loop "
                         "rebuild attempts fail (the bootstrap build is "
                         "untouched); the service must retry through them, "
                         "go degraded, and recover; implies "
                         "--rebuild-mid-loop")
    ap.add_argument("--open-loop", action="store_true",
                    help="open-loop Poisson load harness: sweep offered "
                         "rates through the continuous-batching scheduler "
                         "instead of draining a fixed request list; "
                         "records p50/p99 latency, goodput under --slo-ms, "
                         "reject rate and batch occupancy per point")
    ap.add_argument("--qps", type=float, default=None,
                    help="single offered rate for --open-loop (default: "
                         "the 3-point --sweep)")
    ap.add_argument("--sweep", type=float, nargs="+", default=None,
                    metavar="QPS",
                    help="offered rates for --open-loop (default 50 100 "
                         "200)")
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="per-request SLO deadline for --open-loop: past "
                         "it a queued request is late-dropped, a "
                         "completed one counts as a violation; goodput "
                         "counts only completions within it")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="seconds of offered load per sweep point")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="scheduler flush timeout: a partial batch waits "
                         "at most this long for followers")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="bounded admission queue; submissions beyond it "
                         "are rejected with BackpressureError")
    ap.add_argument("--bench-out", default="",
                    help="merge --open-loop sweep entries into this JSON "
                         "file (empty: record nothing)")
    ap.add_argument("--recall-threshold", type=float, default=0.7)
    ap.add_argument("--probe", type=int, default=16,
                    help="probe-subset size for the recall oracle")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="run N training steps first and serve the trained "
                         "params: train, publish and serve metrics then "
                         "land in one registry snapshot")
    ap.add_argument("--metrics-out", default=None,
                    help="append a JSONL registry snapshot here at the end "
                         "(and periodically if --metrics-every > 0)")
    ap.add_argument("--metrics-every", type=float, default=0.0,
                    help="periodic in-loop snapshot cadence, seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for")
    ap.add_argument("--mesh", default=None, metavar="data=N",
                    help="shard the IVF index's CSR rows across N devices "
                         "(cuda:0..N-1, or N shards on the CPU with "
                         "--device cpu; data=1 / omitted: one device)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = check_device(args.device)
    mesh = parse_mesh_arg(args.mesh, device)

    # one launcher run = one registry's worth of numbers (tests call
    # main() in-process)
    obs.reset()
    if args.metrics_out:
        obs.configure_reporter(path=args.metrics_out,
                               every_s=args.metrics_every or 10.0)

    from repro_torch.launch.train import (make_loader, small_speedyfeed_config,
                                          train_speedyfeed)
    cfg = small_speedyfeed_config()
    _, log, store, _ = make_loader(cfg, seed=args.seed)
    if args.train_steps > 0:
        res = train_speedyfeed(steps=args.train_steps, cfg=cfg,
                               seed=args.seed, device=device,
                               log_every=max(args.train_steps // 2, 1))
        params = res.state.params
        print(f"trained {res.steps_done} steps before serving "
              f"(loss {res.losses[-1]:.3f})" if res.losses else
              f"trained {res.steps_done} steps before serving")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = core.init_speedyfeed(gen, cfg)
    chaos_n = args.chaos_rebuild_failures
    rebuild_mid_loop = args.rebuild_mid_loop or chaos_n > 0
    rec = Recommender(cfg, params, store, k=args.k, index_kind=args.index,
                      nprobe=args.nprobe, k_prime=args.k_prime,
                      probe_metric=args.probe_metric,
                      service_kw=chaos_service_kw(chaos_n) if chaos_n > 0
                      else None, device=device, mesh=mesh)
    t0 = time.time()
    rec.build_index(seed=args.seed)
    svc = rec.service
    chaos_plan = None
    if chaos_n > 0 and not args.open_loop:
        # armed only now: the bootstrap build above ran clean (--open-loop
        # arms inside the harness instead, after its warm cycle)
        chaos_plan = faults.arm(FaultPlan().fail(
            "index.rebuild", calls=range(1, chaos_n + 1)))
    shards = getattr(svc.snapshot(), "n_shards", 1)
    print(f"index built: {store.tokens.shape[0]} news "
          f"({args.index}, ntotal={svc.ntotal}, v{svc.version}"
          + (f", {shards} shards" if shards > 1 else "") + ") in "
          f"{time.time() - t0:.1f}s")
    reqs = list(log.histories[:args.requests])

    if args.autotune and args.index != "exact":
        tune(rec, reqs, args)

    on_batch = None
    if rebuild_mid_loop:
        n0 = svc.store.emb.shape[0]
        rng = np.random.default_rng(1)

        def on_batch(i):
            if i != 2:            # once, early in the loop
                return
            fresh_ids = np.arange(n0, n0 + 32)
            fresh = (svc.store.emb[1:33].cpu().numpy()
                     + 0.01 * rng.normal(size=(32, svc.store.dim))
                     ).astype(np.float32)
            rec.publish(fresh_ids, fresh)        # O(append) on this path
            svc.rebuild(mode="full", block=False)  # absorb off-path

    sweep_entries = None
    try:
        if args.open_loop:
            args.rebuild_mid_loop = rebuild_mid_loop   # chaos implies it
            sweep_entries, chaos_plan = open_loop_harness(
                args, rec, reqs, chaos_n=chaos_n)
        else:
            micro_batch_loop(rec, reqs, max_batch=args.batch,
                             max_wait_ms=args.max_wait_ms,
                             on_batch=on_batch)
            if rebuild_mid_loop:
                svc.wait_for_build()
    finally:
        faults.disarm()          # tests call main() in-process
    if chaos_plan is not None:
        print(f"chaos: {chaos_plan.fired('index.rebuild')} rebuild faults "
              f"injected over {chaos_plan.calls('index.rebuild')} build "
              f"attempts; health now {svc.health()['status']}")
    recall = measure_recall(rec, reqs, k=args.k, probe=args.probe)
    stats = ServeStats.from_registry(
        recall_at_k=recall, recall_ok=recall >= args.recall_threshold,
        index_kind=args.index, ntotal=svc.ntotal)
    stats.load_sweep = sweep_entries
    if args.metrics_out:
        obs.tick(force=True)     # final full-registry snapshot
    print(f"{stats.n_requests} requests in {stats.n_batches} batches; "
          f"p50={stats.p50_ms:.1f}ms p99={stats.p99_ms:.1f}ms "
          f"recall@{args.k}={recall:.3f} "
          f"(v{stats.index_version}, {stats.n_swaps} swaps)")
    return stats


if __name__ == "__main__":
    main()
