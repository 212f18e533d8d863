"""IndexBuilder: batched (re)builds and off-path compaction -> snapshots.

  build(ids, emb)              full rebuild — train quantizers (spherical
                               k-means, PQ codebooks) from scratch and bulk
                               add; the nightly-build path.
  compact(snapshot, ids, emb)  absorb fresh rows into an existing build
                               without retraining: a mutable index over
                               the snapshot's tensors, which copies them
                               before it writes, then re-freeze.

Both return a new immutable ``IndexSnapshot`` carrying the next version;
the caller installs it with ``RetrievalService.swap``. With ``devices``
every snapshot comes back device-sharded (``serving/sharded.py``), its
rows one block a device; a build or compaction runs on the first device.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from .index import IVFConfig, IVFPQIndex, make_index
from .pq import PQCodebook, PQConfig
from .sharded import (ShardedIndexSnapshot, shard_mesh, shard_snapshot,
                      unshard_snapshot)
from .snapshot import KINDS, IndexSnapshot, empty_snapshot, snapshot_from_index


class IndexBuilder:
    """Produces immutable IndexSnapshots for one (kind, dim, config) cell
    on one device. ``seed`` seeds the k-means/PQ training generator, so
    rebuilds over identical data are deterministic on one device.

    ``devices`` (a list, repeats allowed; it replaces ``device``, which
    becomes its first): every snapshot is a ``ShardedIndexSnapshot`` over
    those devices, the same list for the builder's lifetime. The exact
    kind has no CSR rows and refuses it."""

    def __init__(self, kind: str, dim: int, *, ivf: IVFConfig = IVFConfig(),
                 pq: PQConfig = PQConfig(), seed: int = 0, device="cuda",
                 devices=None):
        if kind not in KINDS:
            raise ValueError(f"unknown index kind: {kind!r}")
        if devices is not None and kind == "exact":
            raise ValueError("the exact kind has no CSR rows to shard; "
                             "use an IVF kind with devices=")
        self.kind, self.dim = kind, dim
        self.ivf, self.pq = ivf, pq
        self.seed = seed
        self.devices = None if devices is None else shard_mesh(devices)
        self.device = torch.device(device) if devices is None \
            else self.devices[0]
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
        return self._freeze(idx)

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
        return self._freeze(idx)

    def _freeze(self, idx):
        """Snapshot the index; with ``devices``, sharded across them."""
        snap = snapshot_from_index(idx, next(self._versions), time.time())
        if self.devices is None:
            return snap
        return shard_snapshot(snap, self.devices)

    def _materialize(self, snap: IndexSnapshot):
        """Mutable index over a snapshot's tensors, marked shared so its
        first write copies them (the snapshot keeps serving unchanged). A
        sharded snapshot is joined on the first device first."""
        if isinstance(snap, ShardedIndexSnapshot):
            snap = unshard_snapshot(snap)
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
