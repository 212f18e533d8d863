"""ANN indexes over news embeddings: exact-flat, IVF-Flat, IVF-PQ.

A spherical k-means coarse quantizer (IVF) partitions the corpus into
nlist cells on the unit sphere; a query probes the nprobe best cells and
scores only their members, in full precision (IVF-Flat) or through
residual product-quantization codes around the raw-space cell means
(IVF-PQ, uint8 codes scored by ``kernels.ops.pq_lut_scores``). All
indexes share one API:

    idx.train(gen, vectors)          # fit quantizers (no-op for Flat)
    idx.add(ids, vectors)            # incremental — used by online deltas
    idx.snapshot(version) -> IndexSnapshot
    idx.search(queries, k) -> (scores [B, k], ids [B, k])   tensors

Storage is device-resident padded CSR: fixed-capacity ``[nlist, cap]``
id/payload tensors plus per-list lengths, where ``cap`` grows in
power-of-two buckets (MIN_CAP, doubling on overflow). The JAX package
rebinds fresh arrays on every mutation; here ``_csr_append`` writes its
rows in place, and an index copies its tensors once before the first
mutation after a snapshot was taken of them (copy on write), so a
snapshot never changes after it is taken.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

from .pq import (PQCodebook, PQConfig, fit_kmeans, fork, opq_train,
                 pq_encode, pq_lut, pq_train, sample_rows)

PAD_ID = -1
MIN_CAP = 8            # smallest per-list capacity bucket

# IVF-Flat scores every cell densely (one matmul) while
# nlist <= DENSE_PROBE_FACTOR * B * nprobe, else gathers only probed
# payloads per query
DENSE_PROBE_FACTOR = 4
ENCODE_CHUNK = 65536   # bulk PQ encode chunk: bounds the [chunk, M*K] buffer


def _host(x) -> np.ndarray:
    """A host float32/int64-compatible numpy view of a tensor or array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _next_cap(n: int) -> int:
    """Smallest power-of-two capacity bucket holding n entries per list."""
    return max(MIN_CAP, 1 << max(int(n) - 1, 0).bit_length())


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    nlist: int = 32        # coarse cells
    nprobe: int = 8        # cells scanned per query
    train_iters: int = 15
    train_sample: int = 16384   # coarse k-means fits on at most this many rows
    train_batch: int = 1024     # mini-batch size past which Lloyd's is
    #                             replaced by kmeans_minibatch
    metric: str = "l2"     # cell-probe metric: "l2" ranks cells on the unit
    #                        sphere (the metric the partition was built
    #                        with); "ip" ranks by raw inner product against
    #                        the unnormalized cell means


def _topk_padded(scores, cand_ids, k):
    """scores [B, C], cand_ids [B, C] (PAD_ID = invalid) -> top-k
    (scores f32, ids int64), padded with (-inf, PAD_ID) past C."""
    B, C = cand_ids.shape
    dev = scores.device
    if C == 0:
        return (torch.full((B, k), float("-inf"), device=dev),
                torch.full((B, k), PAD_ID, dtype=torch.int64, device=dev))
    scores = scores.masked_fill(cand_ids == PAD_ID, float("-inf"))
    k_eff = min(k, C)
    s, pos = torch.topk(scores, k_eff, dim=1)
    ids = torch.gather(cand_ids, 1, pos).long()
    ids = torch.where(torch.isfinite(s), ids, PAD_ID)
    if k_eff < k:            # fewer candidates than requested: pad out
        s = torch.nn.functional.pad(s, (0, k - k_eff), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=PAD_ID)
    return s.float(), ids


# ---------------------------------------------------------------------------
# padded-CSR primitives
# ---------------------------------------------------------------------------

def _normalize(x, eps: float = 1e-9):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(eps)


def _probe_cells(q, cent_unit, cent_raw, nprobe: int, metric: str):
    """Top-nprobe coarse cells per query -> [B, nprobe] int64."""
    if metric == "l2":
        aff = q @ cent_unit.T
    elif metric == "ip":
        aff = q @ cent_raw.T
    else:
        raise ValueError(f"unknown probe metric: {metric!r}")
    return torch.topk(aff, nprobe, dim=1).indices


def _masked_topk(scores, cand_ids, valid, k: int):
    """Top-k over fixed-width candidates; invalid slots -> PAD_ID."""
    scores = scores.masked_fill(~valid, float("-inf"))
    s, pos = torch.topk(scores, k, dim=1)
    ids = torch.gather(cand_ids, 1, pos)
    return s, torch.where(torch.isfinite(s), ids, PAD_ID)


def _gather_candidates(q, cent_unit, cent_raw, list_ids, lens, *,
                       nprobe: int, metric: str):
    """Probe cells, then gather the fixed-width candidate window: probed
    cells [B, P], candidate ids [B, P*cap], and slot validity."""
    B, cap = q.shape[0], list_ids.shape[1]
    probes = _probe_cells(q, cent_unit, cent_raw, nprobe, metric)  # [B, P]
    cand_ids = list_ids[probes].reshape(B, -1)                 # [B, P*cap]
    valid = (torch.arange(cap, device=q.device)[None, None]
             < lens[probes][:, :, None]).reshape(B, -1)
    return probes, cand_ids, valid


def _search_flat_csr(q, cent_unit, cent_raw, list_ids, list_vecs, lens, *,
                     nprobe: int, k: int, metric: str, dense: bool = True):
    """IVF-Flat search over padded-CSR storage: q [B, d]; cent_* [nlist,
    d]; list_ids [nlist, cap] int32; list_vecs [nlist, cap, d]; lens
    [nlist] int32."""
    B = q.shape[0]
    probes, cand_ids, valid = _gather_candidates(
        q, cent_unit, cent_raw, list_ids, lens, nprobe=nprobe, metric=metric)
    if dense:
        # few cells, many probes: score every cell in one matmul and
        # gather only the probed [B, P, cap] score blocks
        all_s = torch.einsum("bd,lcd->blc", q, list_vecs)   # [B, nlist, cap]
        scores = torch.gather(
            all_s, 1, probes[:, :, None].expand(-1, -1, all_s.shape[2]))
    else:
        scores = torch.einsum("bd,bpcd->bpc", q, list_vecs[probes])
    return _masked_topk(scores.reshape(B, -1), cand_ids, valid, k)


def flat_dense_crossover(nlist: int, batch: int, nprobe: int) -> bool:
    """Dense-vs-gather regime for the IVF-Flat scan."""
    return nlist <= DENSE_PROBE_FACTOR * batch * nprobe


def _pq_scan_inputs(q, cent_unit, cent_raw, list_ids, list_codes, lens,
                    cb_centers, cb_rot=None, *, nprobe: int, metric: str):
    """Everything an IVF-PQ search feeds its LUT scan, and what it adds to
    the scan's result: the query LUTs [B, M, K], the gathered
    [B, nprobe*cap, M] uint8 codes, slot validity, candidate ids, and
    each slot's coarse term <q, mean[cell]> [B, nprobe*cap]."""
    B, cap = q.shape[0], list_ids.shape[1]
    probes, cand_ids, valid = _gather_candidates(
        q, cent_unit, cent_raw, list_ids, lens, nprobe=nprobe, metric=metric)
    lut = pq_lut(PQCodebook(cb_centers, cb_rot), q).contiguous()
    codes = list_codes[probes].reshape(B, -1, list_codes.shape[-1])
    coarse = torch.gather(q @ cent_raw.T, 1, probes)
    return lut, codes, valid, cand_ids, coarse.repeat_interleave(cap, dim=1)


def _search_pq_csr(q, cent_unit, cent_raw, list_ids, list_codes, lens,
                   cb_centers, cb_rot=None, *, nprobe: int, k: int,
                   metric: str):
    """IVF-PQ search: coarse term + masked LUT scan over the gathered
    codes (``kernels.ops.pq_lut_scores``)."""
    lut, codes, valid, cand_ids, coarse = _pq_scan_inputs(
        q, cent_unit, cent_raw, list_ids, list_codes, lens, cb_centers,
        cb_rot, nprobe=nprobe, metric=metric)
    scores = ops.pq_lut_scores(lut, codes, valid) + coarse
    return _masked_topk(scores, cand_ids, valid, k)


def _csr_append(list_ids, payload, lens, assign, new_ids, new_payload):
    """Scatter n new rows into their lists' next free slots, IN PLACE
    (the JAX package rebinds; callers own the tensors they pass).

    Each new row i lands at slot lens[assign[i]] + (rank of i among the
    new rows assigned to the same list); ranks come from a stable sort.
    """
    a, order = torch.sort(assign, stable=True)
    rank = (torch.arange(a.shape[0], device=a.device)
            - torch.searchsorted(a, a, side="left"))
    slot = lens[a].long() + rank
    list_ids[a, slot] = new_ids[order].to(list_ids.dtype)
    payload[a, slot] = new_payload[order].to(payload.dtype)
    lens += torch.bincount(assign, minlength=lens.shape[0]).to(lens.dtype)
    return list_ids, payload, lens


def _csr_remove(list_ids, payload, lens, drop_ids):
    """Drop matching ids and re-pack every list front-aligned (returns new
    tensors)."""
    cap = list_ids.shape[1]
    slot = torch.arange(cap, device=list_ids.device)[None]
    keep = (slot < lens[:, None]) & ~torch.isin(list_ids, drop_ids)
    perm = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    list_ids = torch.gather(list_ids, 1, perm)
    idx = perm.reshape(perm.shape + (1,) * (payload.dim() - 2))
    payload = torch.gather(payload, 1, idx.expand_as(payload))
    lens = keep.sum(dim=1).to(lens.dtype)
    list_ids = torch.where(slot < lens[:, None], list_ids,
                           torch.full_like(list_ids, PAD_ID))
    return list_ids, payload, lens


# ---------------------------------------------------------------------------
# indexes
# ---------------------------------------------------------------------------

class FlatIndex:
    """Exact MIPS over the full corpus — the fallback and recall oracle.
    Host (numpy) storage; a snapshot moves it to its device."""

    kind = "exact"

    def __init__(self, dim: int, device="cuda"):
        self.dim = dim
        self.device = torch.device(device)
        self._vecs = np.zeros((0, dim), np.float32)
        self._ids = np.zeros((0,), np.int64)

    @property
    def ntotal(self) -> int:
        return self._vecs.shape[0]

    def train(self, gen, vectors):   # noqa: ARG002 - uniform API
        return self

    def remove(self, ids):
        keep = ~np.isin(self._ids, _host(ids).astype(np.int64))
        self._vecs, self._ids = self._vecs[keep], self._ids[keep]

    def add(self, ids, vectors):
        """Upsert: a re-added id replaces its previous row."""
        self.remove(ids)
        self._vecs = np.concatenate(
            [self._vecs, _host(vectors).astype(np.float32)])
        self._ids = np.concatenate([self._ids, _host(ids).astype(np.int64)])

    def snapshot(self, version: int = 0):
        from .snapshot import snapshot_from_index
        return snapshot_from_index(self, version)

    def search(self, queries, k: int):
        return self.snapshot().search(queries, k)


class IVFFlatIndex:
    """IVF coarse quantizer + full-precision scoring of probed cells, on
    padded-CSR device storage."""

    kind = "ivf-flat"

    def __init__(self, dim: int, cfg: IVFConfig = IVFConfig(),
                 device="cuda"):
        self.dim, self.cfg = dim, cfg
        self.device = torch.device(device)
        self._cent_dev = None                  # [nlist, d] unit centroids
        self._cent_raw_dev = None              # [nlist, d] raw cell means
        self._cap = MIN_CAP
        self._ids_dev = torch.full((cfg.nlist, MIN_CAP), PAD_ID,
                                   dtype=torch.int32, device=self.device)
        self._payload_dev = self._empty_payload_dev(MIN_CAP)
        self._lens = torch.zeros(cfg.nlist, dtype=torch.int32,
                                 device=self.device)
        self._shared = False                   # tensors held by a snapshot

    # --- storage hooks (overridden by IVFPQIndex) ---------------------
    def _empty_payload_dev(self, cap: int):
        return torch.zeros((self.cfg.nlist, cap, self.dim),
                           device=self.device)

    def _encode_payload_dev(self, vectors, assign):   # noqa: ARG002
        return vectors

    # ------------------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return int(self._lens.sum())

    @property
    def is_trained(self) -> bool:
        return self._cent_dev is not None

    def train(self, gen: torch.Generator, vectors):
        """Spherical k-means on at most ``cfg.train_sample`` sampled rows;
        raw-space cell means are kept alongside (the PQ residual origin,
        the coarse score term, and the "ip" probe ranking)."""
        vectors = torch.as_tensor(vectors, dtype=torch.float32,
                                  device=self.device)
        xs = sample_rows(fork(gen), _normalize(vectors),
                         self.cfg.train_sample)
        cent, _ = fit_kmeans(gen, xs, self.cfg.nlist,
                             iters=self.cfg.train_iters,
                             batch=self.cfg.train_batch)
        self._cent_dev = _normalize(cent)
        assign = self._assign_cells(vectors)
        counts = torch.bincount(assign, minlength=self.cfg.nlist).float()
        sums = torch.zeros_like(self._cent_dev).index_add_(0, assign, vectors)
        means = sums / counts.clamp_min(1.0)[:, None]
        self._cent_raw_dev = torch.where(counts[:, None] > 0, means,
                                         self._cent_dev)
        self._post_train(gen, vectors, assign)
        return self

    def _post_train(self, gen, vectors, assign):
        pass

    def _assign_cells(self, vectors):
        """Nearest cell on the unit sphere -> [n] int64 (one matmul)."""
        return (vectors @ self._cent_dev.T).argmax(dim=1)

    def _own_storage(self):
        """Copy on write: the first mutation after a snapshot took these
        tensors works on private copies."""
        if self._shared:
            self._ids_dev = self._ids_dev.clone()
            self._payload_dev = self._payload_dev.clone()
            self._lens = self._lens.clone()
            self._shared = False

    def _grow(self, new_cap: int):
        pad = new_cap - self._cap
        ids_pad = torch.full((self.cfg.nlist, pad), PAD_ID, dtype=torch.int32,
                             device=self.device)
        self._ids_dev = torch.cat([self._ids_dev, ids_pad], dim=1)
        shape = (self.cfg.nlist, pad) + tuple(self._payload_dev.shape[2:])
        self._payload_dev = torch.cat(
            [self._payload_dev,
             torch.zeros(shape, dtype=self._payload_dev.dtype,
                         device=self.device)], dim=1)
        self._lens = self._lens.clone()
        self._cap = new_cap
        self._shared = False

    def _check_ids(self, ids):
        """Lists store ids as int32; reject ids that would wrap."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.max() >= 2 ** 31 or ids.min() < 0):
            raise ValueError("device layout requires ids in [0, 2**31)")
        return ids

    def remove(self, ids):
        ids = self._check_ids(ids)
        if ids.size == 0:
            return
        # _csr_remove returns fresh tensors: nothing shared is written
        self._ids_dev, self._payload_dev, self._lens = _csr_remove(
            self._ids_dev, self._payload_dev, self._lens,
            torch.as_tensor(ids, dtype=torch.int32, device=self.device))
        self._shared = False

    def add(self, ids, vectors):
        """Upsert: a re-added id replaces its previous (stale) entry."""
        if not self.is_trained:
            raise RuntimeError("train() before add()")
        ids = self._check_ids(ids)
        if self.ntotal:        # nothing to displace on a bulk build
            self.remove(ids)
        vecs = torch.as_tensor(vectors, dtype=torch.float32,
                               device=self.device)
        assign = self._assign_cells(vecs)
        counts = torch.bincount(assign, minlength=self.cfg.nlist)
        needed = int((self._lens + counts).max())
        if needed > self._cap:
            self._grow(_next_cap(needed))
        payload = self._encode_payload_dev(vecs, assign)
        self._own_storage()
        _csr_append(self._ids_dev, self._payload_dev, self._lens, assign,
                    torch.as_tensor(ids, dtype=torch.int32,
                                    device=self.device), payload)

    def snapshot(self, version: int = 0):
        from .snapshot import snapshot_from_index
        return snapshot_from_index(self, version)

    def search(self, queries, k: int):
        return self.snapshot().search(queries, k)


class IVFPQIndex(IVFFlatIndex):
    """IVF + residual product quantization, scored by the LUT kernel.

    Vectors are stored as uint8 PQ codes of the residual x - mean[cell];
    a candidate's score is <q, mean[cell]> + the LUT sum over its codes.
    """

    kind = "ivf-pq"

    def __init__(self, dim: int, cfg: IVFConfig = IVFConfig(),
                 pq_cfg: PQConfig = PQConfig(), device="cuda"):
        self.pq_cfg = pq_cfg
        self.codebook: PQCodebook | None = None
        super().__init__(dim, cfg, device)

    def _empty_payload_dev(self, cap: int):
        return torch.zeros((self.cfg.nlist, cap, self.pq_cfg.n_subvec),
                           dtype=torch.uint8, device=self.device)

    def _post_train(self, gen, vectors, assign):
        residuals = vectors - self._cent_raw_dev[assign]
        fit = opq_train if self.pq_cfg.opq_iters > 0 else pq_train
        self.codebook = fit(fork(gen), residuals, self.pq_cfg)

    def _encode_payload_dev(self, vectors, assign):
        residuals = vectors - self._cent_raw_dev[assign]
        return torch.cat([pq_encode(self.codebook,
                                    residuals[i:i + ENCODE_CHUNK])
                          for i in range(0, residuals.shape[0],
                                         ENCODE_CHUNK)])


def make_index(kind: str, dim: int, *, ivf: IVFConfig = IVFConfig(),
               pq: PQConfig = PQConfig(), device="cuda"):
    """Factory: 'exact' | 'ivf-flat' | 'ivf-pq'."""
    if kind == "exact":
        return FlatIndex(dim, device)
    if kind == "ivf-flat":
        return IVFFlatIndex(dim, ivf, device)
    if kind == "ivf-pq":
        return IVFPQIndex(dim, ivf, pq, device)
    raise ValueError(f"unknown index kind: {kind!r}")
