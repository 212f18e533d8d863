"""Device-sharded IVF retrieval: padded-CSR lists partitioned across
devices, the JAX package's ``serving/sharded.py`` in one process.

One device's memory bounds the unsharded ``IndexSnapshot``: its
``[nlist, cap]`` id and payload tensors live whole on one device. Here
the rows are partitioned contiguously across a list of devices: shard
``s`` owns global cells ``[s*R, (s+1)*R)`` with ``R = ceil(nlist / S)``
(the tail shard padded with empty rows), each block on its own device.
Repeats are allowed in the list: ``["cuda:0"] * 4`` gives four shards on
one card, ``["cpu"] * 8`` eight on the CPU.

  probe   global: the full ``[nlist, d]`` centroid table ranks the cells
          once, on the first device, so the probed cell set is the
          unsharded index's and the sharded top-k equals the unsharded
          top-k.
  score   per shard, on its device: each shard masks the probes it owns
          (``cell // R == s``), gathers only its own ``[R, cap]`` window,
          scores it (IVF-PQ through ``kernels.ops.pq_lut_scores``, one
          launch a shard) and takes a local top-k at the global ``k``.
  merge   on the first device: the shards' ``[B, k]`` results side by
          side as ``[B, S*k]`` and one final top-k. A local k equal to
          the global one keeps the true top-k even if every winner lives
          on one shard.

The JAX package scores IVF-PQ with an XLA LUT gather there, because a
``pallas_call`` has no GSPMD partitioning rule; each shard here runs the
card's PQ scan on its own window, the same function.

``shard_snapshot``/``unshard_snapshot`` convert between the two snapshot
forms; ``ShardedIndexSnapshot`` has ``IndexSnapshot``'s serving API
(version, kind, ntotal, device, member_ids, search, built_at), so the
delta tier, ``hybrid_search`` and ``RetrievalService`` work on it as on
the unsharded one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.device import check_device
from repro_torch.kernels import ops

from .index import PAD_ID, _masked_topk, _probe_cells
from .pq import PQCodebook, pq_lut
from .snapshot import IndexSnapshot


def shard_mesh(devices) -> tuple:
    """The shards' devices, in order (repeats allowed); a CUDA device
    with no GPU raises."""
    devices = tuple(check_device(d) for d in devices)
    if not devices:
        raise ValueError("a sharded index needs at least one device")
    return devices


@dataclasses.dataclass(frozen=True)
class ShardedIndexSnapshot:
    """Immutable device-sharded view of one IVF build: the CSR rows in one
    block a shard, each on its device; centroids and PQ codebooks whole
    on the first device (``device``), where probing and merging run."""
    version: int
    kind: str                      # "ivf-flat" | "ivf-pq"
    dim: int
    ntotal: int
    nprobe: int
    metric: str
    nlist: int                     # true cell count (rows may be padded)
    devices: tuple
    cent_unit: Any                 # [nlist, d], first device
    cent_raw: Any                  # [nlist, d], first device
    ids_s: tuple                   # S x [R, cap] int32, each on its device
    payload_s: tuple               # S x [R, cap, d] f32 | [R, cap, M] u8
    lens_s: tuple                  # S x [R] int32
    pq_centers: Any = None         # [M, K, d/M] (ivf-pq), first device
    pq_rot: Any = None             # [d, d] OPQ rotation or None
    built_at: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def n_shards(self) -> int:
        return len(self.ids_s)

    @property
    def rows_per_shard(self) -> int:
        return int(self.ids_s[0].shape[0])

    @property
    def cap(self) -> int:
        return int(self.ids_s[0].shape[1])

    @property
    def dim_codes(self) -> int:
        """The payload's last width: d (ivf-flat) or M codes (ivf-pq)."""
        return int(self.payload_s[0].shape[-1])

    @functools.cached_property
    def member_ids(self) -> np.ndarray:
        """All ids this snapshot serves, host int64."""
        ids_h = np.concatenate([t.cpu().numpy() for t in self.ids_s])
        lens_h = np.concatenate([t.cpu().numpy() for t in self.lens_s])
        mask = np.arange(self.cap)[None, :] < lens_h[:, None]
        return ids_h[mask].astype(np.int64)

    def window(self, s, probes):
        """Shard ``s``'s candidate window for ``probes`` [B, P] (global
        cells), on its device: the local rows [B, P] it gathers (0 where
        another shard owns the probe), candidate ids [B, P*cap], and the
        slots' validity (filled and owned) [B, P*cap]."""
        dev, R, cap = self.devices[s], self.rows_per_shard, self.cap
        probes = probes.to(dev)
        owned = probes // R == s
        local = torch.where(owned, probes % R, 0)
        B = probes.shape[0]
        cand = self.ids_s[s][local].reshape(B, -1)
        valid = ((torch.arange(cap, device=dev)[None, None]
                  < self.lens_s[s][local][:, :, None])
                 & owned[:, :, None]).reshape(B, -1)
        return local, cand, valid

    def probe(self, q):
        """The global probe on the first device: the probed cells [B, P]
        and, for IVF-PQ, the query LUTs [B, M, K] and the coarse term
        <q, mean[cell]> [B, P] (None for IVF-Flat)."""
        probes = _probe_cells(q, self.cent_unit, self.cent_raw, self.nprobe,
                              self.metric)
        if self.kind != "ivf-pq":
            return probes, None, None
        lut = pq_lut(PQCodebook(self.pq_centers, self.pq_rot),
                     q).contiguous()
        return probes, lut, torch.gather(q @ self.cent_raw.T, 1, probes)

    def _shard_topk(self, s, q, probes, k, lut, coarse):
        """Shard ``s``'s local top-k of its window, scored on its device,
        back on the first device."""
        dev, B = self.devices[s], q.shape[0]
        local, cand, valid = self.window(s, probes)
        if self.kind == "ivf-flat":
            sc = torch.einsum("bd,bpcd->bpc", q.to(dev),
                              self.payload_s[s][local]).reshape(B, -1)
        else:
            codes = self.payload_s[s][local].reshape(B, -1, self.dim_codes)
            sc = ops.pq_lut_scores(lut.to(dev), codes, valid) + \
                coarse.to(dev).repeat_interleave(self.cap, dim=1)
        sc_k, ids_k = _masked_topk(sc, cand, valid, k)
        return sc_k.to(self.device), ids_k.to(self.device)

    def search(self, queries, k: int):
        """(scores [B, k] f32, ids [B, k] int64) tensors on the first
        device, PAD_ID-padded: the unsharded snapshot's results (global
        probing gives the same candidates)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        B = q.shape[0]
        if self.ntotal == 0:
            return (torch.full((B, k), float("-inf"), device=self.device),
                    torch.full((B, k), PAD_ID, dtype=torch.int64,
                               device=self.device))
        k_eff = min(k, self.nprobe * self.cap)
        probes, lut, coarse = self.probe(q)
        parts = [self._shard_topk(s, q, probes, k_eff, lut, coarse)
                 for s in range(self.n_shards)]
        merged_sc = torch.cat([p[0] for p in parts], dim=1)  # [B, S*k]
        merged_ids = torch.cat([p[1] for p in parts], dim=1)
        s, ids = _masked_topk(merged_sc, merged_ids,
                              torch.isfinite(merged_sc), k_eff)
        s, ids = s.float(), ids.long()
        if k_eff < k:            # fewer candidates than requested: pad out
            s = torch.nn.functional.pad(s, (0, k - k_eff),
                                        value=float("-inf"))
            ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=PAD_ID)
        return s, ids


def shard_snapshot(snap: IndexSnapshot, devices) -> ShardedIndexSnapshot:
    """Partition an IVF snapshot's CSR rows across ``devices`` (one shard
    each). Rows are padded up to ``S * ceil(nlist / S)`` with empty cells
    (len 0, PAD ids), unreachable since probing ranks only the true
    ``nlist`` centroids."""
    if snap.kind not in ("ivf-flat", "ivf-pq"):
        raise ValueError(f"cannot device-shard kind {snap.kind!r} "
                         "(only the IVF kinds have CSR rows)")
    devices = shard_mesh(devices)
    S = len(devices)
    nlist, cap = snap.list_ids.shape
    R = -(-nlist // S)
    pad = S * R - nlist

    def blocks(t, fill):
        t = torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), fill)])
        return tuple(t[i * R:(i + 1) * R].to(d, copy=True)
                     for i, d in enumerate(devices))

    def first(t):
        return None if t is None else t.to(devices[0])

    return ShardedIndexSnapshot(
        version=snap.version, kind=snap.kind, dim=snap.dim,
        ntotal=snap.ntotal, nprobe=snap.nprobe, metric=snap.metric,
        nlist=nlist, devices=devices,
        cent_unit=first(snap.cent_unit), cent_raw=first(snap.cent_raw),
        ids_s=blocks(snap.list_ids, PAD_ID),
        payload_s=blocks(snap.payload, 0),
        lens_s=blocks(snap.lens, 0),
        pq_centers=first(snap.pq_centers), pq_rot=first(snap.pq_rot),
        built_at=snap.built_at)


def unshard_snapshot(ssnap: ShardedIndexSnapshot) -> IndexSnapshot:
    """The single-device snapshot on the first device (the blocks joined,
    the row padding stripped): the route for compaction of a sharded
    build."""
    dev, n = ssnap.device, ssnap.nlist

    def whole(ts):
        return torch.cat([t.to(dev) for t in ts])[:n]

    return IndexSnapshot(
        version=ssnap.version, kind=ssnap.kind, dim=ssnap.dim,
        ntotal=ssnap.ntotal, device=dev, nprobe=ssnap.nprobe,
        metric=ssnap.metric, cent_unit=ssnap.cent_unit,
        cent_raw=ssnap.cent_raw, list_ids=whole(ssnap.ids_s),
        payload=whole(ssnap.payload_s), lens=whole(ssnap.lens_s),
        pq_centers=ssnap.pq_centers, pq_rot=ssnap.pq_rot,
        built_at=ssnap.built_at)
