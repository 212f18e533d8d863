"""Serving launcher: two-stage batched news recommendation (paper §5.1.4).

  1. offline: encode the news corpus with BusLM, then bootstrap the
     snapshot lifecycle — publish the corpus and run one full
     ``IndexBuilder`` build (exact, IVF-Flat or IVF-PQ), installed by
     atomic swap; full-precision embeddings stay in the service's
     ``EmbeddingStore`` (on the device) for user encoding and
     re-rank,
  2. online: requests are served in batches of ``--batch`` (padded to
     power-of-two shape buckets): encode users (history -> user
     embedding), then IVF-PQ/IVF-Flat recall of k' candidates and exact
     re-rank to top-k.

Run: python -m repro_torch.launch.serve --requests 64 --batch 16 \
         [--index ivf-pq|ivf-flat|exact] [--nprobe 16] [--k-prime 64] \
         [--device cuda|cpu]

The continuous-batching scheduler, the open-loop load harness and the
metrics registry belong to later slices: ``micro_batch_loop`` runs the
request list as consecutive batches and times each one itself.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import core, serving
from repro_torch.device import check_device


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
    p50_ms: float
    p99_ms: float
    recall_at_k: float        # true recall@k vs the exact-MIPS oracle
    recall_ok: bool           # recall_at_k >= the threshold
    index_kind: str = "exact"
    ntotal: int = 0
    index_version: int = 0
    n_swaps: int = 0


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
                 probe_metric: str = "ip", store_grow_chunk: int = 1024,
                 device="cuda"):
        # probe_metric: the launcher serves raw MIPS over unnormalized
        # encoder embeddings, where ranking cells by raw inner product
        # recalls the large-norm winners the spherical ("l2") ranking
        # misses; "l2" stays the library default for normalized corpora.
        self.device = check_device(device)
        self.cfg, self.store, self.k = cfg, store, k
        self.params = params_to(params, self.device)
        self.index_kind = index_kind
        self.nprobe = nprobe
        self.probe_metric = probe_metric
        self.k_prime = k_prime or max(4 * k, 32)
        self.compact_threshold = compact_threshold
        self.store_grow_chunk = store_grow_chunk
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
        builder = serving.IndexBuilder(
            self.index_kind, emb.shape[1],
            ivf=serving.IVFConfig(nlist=nlist,
                                  nprobe=min(self.nprobe, nlist),
                                  metric=self.probe_metric),
            seed=seed, device=self.device)
        self.service = serving.RetrievalService(
            builder, emb, k=self.k, k_prime=min(self.k_prime, n - 1),
            compact_threshold=self.compact_threshold, auto_compact=False,
            store_grow_chunk=self.store_grow_chunk, device=self.device)
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
    """The batch callable: pad ``len(payloads)`` histories up to the
    static batch dim ``pad_to`` and run the two-stage pipeline. Returns
    one top-k id row per payload, in order."""

    def execute(payloads, pad_to):
        hist, mask = _pad_histories(rec, payloads, pad_to)
        _, ids = rec.recommend(hist, mask)
        return [ids[i] for i in range(len(payloads))]

    return execute


def pow2_bucket(n: int, max_batch: int) -> int:
    """Smallest of the shape buckets 1, 2, 4, ..., max_batch holding n."""
    return min(1 << max(n - 1, 0).bit_length(), max_batch)


def micro_batch_loop(rec: Recommender, requests, *, max_batch: int):
    """Closed loop over consecutive ``max_batch`` chunks of the request
    list -> (results, n_batches, per-request latency in ms). A request's
    latency is its batch's execute time, from the start of the batch to
    its ids on the host."""
    execute = make_recommend_execute(rec)
    results, latencies = [], []
    n_batches = 0
    for i in range(0, len(requests), max_batch):
        chunk = requests[i:i + max_batch]
        t0 = time.perf_counter()
        results.extend(execute(chunk, pow2_bucket(len(chunk), max_batch)))
        latencies.extend([(time.perf_counter() - t0) * 1e3] * len(chunk))
        n_batches += 1
    return results, n_batches, latencies


def measure_recall(rec: Recommender, histories, *, k: int, probe: int = 16):
    """True recall@k of the served path vs an exact-MIPS oracle over the
    full-precision store, on a probe subset of requests."""
    probe = min(probe, len(histories))
    hist, mask = _pad_histories(rec, histories[:probe], probe)
    user = rec.encode_users(hist, mask)
    _, got = rec.service.query(user, k)
    store = rec.service.store.emb
    scores = user @ store.T
    live = (store != 0.0).any(dim=1)          # unpublished gap rows excluded
    live[0] = False                           # pad news is never a candidate
    scores = scores.masked_fill(~live, float("-inf"))
    ref_ids = torch.topk(scores, k, dim=1).indices.cpu().numpy()
    return float(np.mean([len(set(got[b]) & set(ref_ids[b])) / k
                          for b in range(probe)]))


def main(argv=None):
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
    ap.add_argument("--recall-threshold", type=float, default=0.7)
    ap.add_argument("--probe", type=int, default=16,
                    help="probe-subset size for the recall oracle")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    from repro_torch.launch.train import make_loader, small_speedyfeed_config
    cfg = small_speedyfeed_config()
    _, log, store, _ = make_loader(cfg, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = core.init_speedyfeed(gen, cfg)
    rec = Recommender(cfg, params, store, k=args.k, index_kind=args.index,
                      nprobe=args.nprobe, k_prime=args.k_prime,
                      probe_metric=args.probe_metric, device=device)
    t0 = time.time()
    rec.build_index(seed=args.seed)
    svc = rec.service
    print(f"index built: {store.tokens.shape[0]} news "
          f"({args.index}, ntotal={svc.ntotal}, v{svc.version}) in "
          f"{time.time() - t0:.1f}s")
    reqs = list(log.histories[:args.requests])
    _, n_batches, lat = micro_batch_loop(rec, reqs, max_batch=args.batch)
    recall = measure_recall(rec, reqs, k=args.k, probe=args.probe)
    stats = ServeStats(
        n_requests=len(reqs), n_batches=n_batches,
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        recall_at_k=recall, recall_ok=recall >= args.recall_threshold,
        index_kind=args.index, ntotal=svc.ntotal,
        index_version=svc.version, n_swaps=svc.n_swaps)
    print(f"{stats.n_requests} requests in {stats.n_batches} batches; "
          f"p50={stats.p50_ms:.1f}ms p99={stats.p99_ms:.1f}ms "
          f"recall@{args.k}={recall:.3f} "
          f"(v{stats.index_version}, {stats.n_swaps} swaps)")
    return stats


if __name__ == "__main__":
    main()
