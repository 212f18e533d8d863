"""Immutable, versioned index snapshots — the only object query paths see.

An ``IndexSnapshot`` freezes everything one search needs: the coarse
quantizer (unit centroids + raw cell means), the PQ codebooks, the
padded-CSR membership lists, and a monotonically increasing ``version``.
Its tensors are never written after it is taken: the index it came from
copies them before its next mutation (see ``IVFFlatIndex._own_storage``),
and a builder that compacts a snapshot works on copies.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from .index import (PAD_ID, FlatIndex, IVFFlatIndex, IVFPQIndex,
                    _search_flat_csr, _search_pq_csr, _topk_padded,
                    flat_dense_crossover)

KINDS = ("exact", "ivf-flat", "ivf-pq")


@dataclasses.dataclass(frozen=True)
class IndexSnapshot:
    """Frozen view of one ANN tier build.

    ``version`` 0 is the pre-first-build sentinel (empty, searches return
    all-PAD). Exactly one payload family is populated per kind:
    ``flat_*`` for "exact", the padded-CSR tensors for the IVF kinds (+
    ``pq_centers`` for "ivf-pq"). All tensors live on ``device``.
    """
    version: int
    kind: str
    dim: int
    ntotal: int
    device: torch.device
    nprobe: int = 0
    metric: str = "l2"
    flat_ids: Any = None           # [n] int64
    flat_vecs: Any = None          # [n, d] f32
    cent_unit: Any = None          # [nlist, d] unit centroids
    cent_raw: Any = None           # [nlist, d] raw cell means
    list_ids: Any = None           # [nlist, cap] int32
    payload: Any = None            # [nlist, cap, d] f32 | [nlist, cap, M] u8
    lens: Any = None               # [nlist] int32
    pq_centers: Any = None         # [M, K, d/M] PQ codebooks
    pq_rot: Any = None             # [d, d] OPQ rotation; None = identity
    built_at: float = 0.0          # wall clock of the build (0 = sentinel)

    @property
    def cap(self) -> int:
        """Per-list capacity bucket (0 for the exact/empty kinds)."""
        return 0 if self.list_ids is None else int(self.list_ids.shape[1])

    @functools.cached_property
    def member_ids(self) -> np.ndarray:
        """All ids this snapshot serves, host int64 (feeds full rebuilds)."""
        if self.kind == "exact" or self.list_ids is None:
            if self.flat_ids is None:
                return np.zeros((0,), np.int64)
            return self.flat_ids.cpu().numpy().astype(np.int64)
        ids_h = self.list_ids.cpu().numpy()
        lens_h = self.lens.cpu().numpy()
        mask = np.arange(ids_h.shape[1])[None, :] < lens_h[:, None]
        return ids_h[mask].astype(np.int64)

    def search(self, queries, k: int):
        """(scores [B, k] f32, ids [B, k] int64) tensors on ``device``,
        PAD_ID-padded."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        B = q.shape[0]
        if self.ntotal == 0:
            return (torch.full((B, k), float("-inf"), device=self.device),
                    torch.full((B, k), PAD_ID, dtype=torch.int64,
                               device=self.device))
        if self.kind == "exact":
            scores = q @ self.flat_vecs.T
            cand = self.flat_ids[None].expand(B, -1)
            return _topk_padded(scores, cand, k)
        k_eff = min(k, self.nprobe * self.cap)
        if self.kind == "ivf-flat":
            s, ids = _search_flat_csr(
                q, self.cent_unit, self.cent_raw, self.list_ids,
                self.payload, self.lens,
                nprobe=self.nprobe, k=k_eff, metric=self.metric,
                dense=flat_dense_crossover(self.list_ids.shape[0], B,
                                           self.nprobe))
        else:
            s, ids = _search_pq_csr(
                q, self.cent_unit, self.cent_raw, self.list_ids,
                self.payload, self.lens, self.pq_centers, self.pq_rot,
                nprobe=self.nprobe, k=k_eff, metric=self.metric)
        s, ids = s.float(), ids.long()
        if k_eff < k:            # fewer candidates than requested: pad out
            s = torch.nn.functional.pad(s, (0, k - k_eff),
                                        value=float("-inf"))
            ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=PAD_ID)
        return s, ids


def empty_snapshot(dim: int, device="cuda") -> IndexSnapshot:
    """The version-0 sentinel a service starts from (searches return PAD)."""
    device = torch.device(device)
    return IndexSnapshot(
        version=0, kind="exact", dim=dim, ntotal=0, device=device,
        flat_ids=torch.zeros(0, dtype=torch.int64, device=device),
        flat_vecs=torch.zeros((0, dim), device=device))


def snapshot_from_index(idx, version: int,
                        built_at: float = 0.0) -> IndexSnapshot:
    """Freeze an index's current state. The IVF tensors are shared with
    the index until its next mutation, which copies them first."""
    if isinstance(idx, IVFFlatIndex):             # covers IVFPQIndex too
        if not idx.is_trained:
            raise RuntimeError("snapshot of an untrained IVF index")
        kind = "ivf-pq" if isinstance(idx, IVFPQIndex) else "ivf-flat"
        idx._shared = True
        return IndexSnapshot(
            version=version, kind=kind, dim=idx.dim, ntotal=idx.ntotal,
            device=idx.device,
            nprobe=min(idx.cfg.nprobe, idx.cfg.nlist), metric=idx.cfg.metric,
            cent_unit=idx._cent_dev, cent_raw=idx._cent_raw_dev,
            list_ids=idx._ids_dev, payload=idx._payload_dev, lens=idx._lens,
            pq_centers=(idx.codebook.centers if kind == "ivf-pq" else None),
            pq_rot=(idx.codebook.rot if kind == "ivf-pq" else None),
            built_at=built_at)
    if isinstance(idx, FlatIndex):
        return IndexSnapshot(
            version=version, kind="exact", dim=idx.dim, ntotal=idx.ntotal,
            device=idx.device,
            flat_ids=torch.as_tensor(idx._ids, device=idx.device),
            flat_vecs=torch.as_tensor(idx._vecs, device=idx.device),
            built_at=built_at)
    raise TypeError(f"cannot snapshot {type(idx).__name__}")
