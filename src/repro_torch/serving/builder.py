"""IndexBuilder: batched (re)builds and off-path compaction -> snapshots.

  build(ids, emb)              full rebuild — train quantizers (spherical
                               k-means, PQ codebooks) from scratch and bulk
                               add; the nightly-build path.
  compact(snapshot, ids, emb)  absorb fresh rows into an existing build
                               without retraining: a mutable index over
                               the snapshot's tensors, which copies them
                               before it writes, then re-freeze.

Both return a new immutable ``IndexSnapshot`` carrying the next version;
the caller installs it with ``RetrievalService.swap``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from .index import IVFConfig, IVFPQIndex, make_index
from .pq import PQCodebook, PQConfig
from .snapshot import KINDS, IndexSnapshot, empty_snapshot, snapshot_from_index


class IndexBuilder:
    """Produces immutable IndexSnapshots for one (kind, dim, config) cell
    on one device. ``seed`` seeds the k-means/PQ training generator, so
    rebuilds over identical data are deterministic on one device."""

    def __init__(self, kind: str, dim: int, *, ivf: IVFConfig = IVFConfig(),
                 pq: PQConfig = PQConfig(), seed: int = 0, device="cuda"):
        if kind not in KINDS:
            raise ValueError(f"unknown index kind: {kind!r}")
        self.kind, self.dim = kind, dim
        self.ivf, self.pq = ivf, pq
        self.seed = seed
        self.device = torch.device(device)
        self._versions = itertools.count(1)    # next() is atomic under GIL

    def empty(self) -> IndexSnapshot:
        """The version-0 sentinel a service starts from."""
        return empty_snapshot(self.dim, self.device)

    def build(self, ids, emb, *, gen: torch.Generator | None = None
              ) -> IndexSnapshot:
        """Full rebuild: train + bulk add -> new snapshot (off-path work)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return dataclasses.replace(self.empty(),
                                       version=next(self._versions),
                                       built_at=time.time())
        emb = torch.as_tensor(emb, dtype=torch.float32, device=self.device)
        idx = make_index(self.kind, self.dim, ivf=self.ivf, pq=self.pq,
                         device=self.device)
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
        idx.train(gen, emb)
        idx.add(ids, emb)
        return snapshot_from_index(idx, next(self._versions), time.time())

    def compact(self, snapshot: IndexSnapshot, ids, emb) -> IndexSnapshot:
        """Absorb fresh rows into ``snapshot`` without retraining (upsert:
        a re-published id replaces its stale entry). An empty snapshot has
        no quantizers to reuse, so it takes a full ``build``."""
        if snapshot.ntotal == 0:
            return self.build(ids, emb)
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return dataclasses.replace(snapshot,
                                       version=next(self._versions),
                                       built_at=time.time())
        idx = self._materialize(snapshot)
        idx.add(ids, emb)
        return snapshot_from_index(idx, next(self._versions), time.time())

    def _materialize(self, snap: IndexSnapshot):
        """Mutable index over a snapshot's tensors, marked shared so its
        first write copies them (the snapshot keeps serving unchanged)."""
        if snap.kind != self.kind:
            raise ValueError(
                f"snapshot kind {snap.kind!r} != builder kind {self.kind!r}")
        idx = make_index(self.kind, self.dim, ivf=self.ivf, pq=self.pq,
                         device=self.device)
        if snap.kind == "exact":
            idx._ids = snap.flat_ids.cpu().numpy().astype(np.int64)
            idx._vecs = snap.flat_vecs.cpu().numpy().astype(np.float32)
            return idx
        if snap.list_ids.shape[0] != self.ivf.nlist:
            raise ValueError(
                f"snapshot nlist {snap.list_ids.shape[0]} != "
                f"builder nlist {self.ivf.nlist}")
        idx._cent_dev = snap.cent_unit
        idx._cent_raw_dev = snap.cent_raw
        idx._cap = snap.cap
        idx._ids_dev = snap.list_ids
        idx._payload_dev = snap.payload
        idx._lens = snap.lens
        idx._shared = True
        if isinstance(idx, IVFPQIndex):
            idx.codebook = PQCodebook(snap.pq_centers, snap.pq_rot)
        return idx
