"""Graph data: random graph generators, fanout neighbor sampling
(GraphSAGE-style, for minibatch_lg), and triplet-list construction for
DimeNet's directional message passing.

The draws are the JAX package's numpy ``Generator`` calls, in its order
(``data/graph.py``), so one seed gives bit-identical arrays in both
packages; the batch dicts then go to ``device`` (the card unless the
caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import check_device


def to_device(arrays: dict, device: torch.device) -> dict:
    """A dict of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def build_triplets(src: np.ndarray, dst: np.ndarray, *, t_cap: int,
                   rng: np.random.Generator | None = None):
    """Triplets (kj -> ji): for each edge ji, pair with every edge kj whose
    destination is j (k != i). Returns (trip_kj, trip_ji, mask) padded/capped
    to ``t_cap``; over-budget triplets are uniformly subsampled.

    Vectorised over a CSR of the edges by destination, whose in-edges
    keep ascending edge order: the triplets come out ordered by ji, then
    kj, as the JAX package's loop appends them, so ``rng.choice`` draws
    the same subsample."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    E = len(src)
    if E:
        n = int(max(src.max(), dst.max())) + 1
        in_order = np.argsort(dst, kind="stable")         # in-edges by node
        indptr = np.zeros(n + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(dst, minlength=n))
        start = indptr[src]                                # in-edges of j
        count = indptr[src + 1] - start
        ji = np.repeat(np.arange(E, dtype=np.int64), count)
        first = np.repeat(np.cumsum(count) - count, count)
        pos = np.arange(len(ji), dtype=np.int64) - first + start[ji]
        kj = in_order[pos]
        keep = src[kj] != dst[ji]                          # k != i
        kj = kj[keep].astype(np.int32)
        ji = ji[keep].astype(np.int32)
    else:
        kj = np.zeros(0, np.int32)
        ji = np.zeros(0, np.int32)
    if len(kj) > t_cap:
        rng = rng or np.random.default_rng(0)
        sel = rng.choice(len(kj), t_cap, replace=False)
        kj, ji = kj[sel], ji[sel]
    mask = np.zeros(t_cap, bool)
    mask[:len(kj)] = True
    out_kj = np.zeros(t_cap, np.int32)
    out_ji = np.zeros(t_cap, np.int32)
    out_kj[:len(kj)] = kj
    out_ji[:len(ji)] = ji
    return out_kj, out_ji, mask


def random_graph(rng: np.random.Generator, n: int, e: int):
    """Random directed graph without self loops."""
    src = rng.integers(0, n, e)
    dst = (src + 1 + rng.integers(0, n - 1, e)) % n
    return src.astype(np.int32), dst.astype(np.int32)


def random_molecule_batch(rng: np.random.Generator, *, n_graphs: int,
                          nodes_per_graph: int, t_cap: int,
                          edges_per_graph: int | None = None,
                          device="cuda"):
    """Batched small molecules flattened into one disjoint graph, on
    ``device``: z [N] int32, pos [N, 3] f32, edge_src/dst [E] int32,
    edge_mask [E], trip_kj/ji [T] int32, trip_mask [T], graph_id [N]
    int32, targets [G] f32."""
    device = check_device(device)
    npg = nodes_per_graph
    epg = edges_per_graph or npg * 2
    N, E = n_graphs * npg, n_graphs * epg
    srcs, dsts, gids = [], [], []
    for g in range(n_graphs):
        s, d = random_graph(rng, npg, epg)
        srcs.append(s + g * npg)
        dsts.append(d + g * npg)
        gids.append(np.full(npg, g, np.int32))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    kj, ji, tm = build_triplets(src, dst, t_cap=t_cap, rng=rng)
    return to_device({
        "z": rng.integers(1, 10, N).astype(np.int32),
        "pos": (rng.normal(size=(N, 3)) * 1.5).astype(np.float32),
        "edge_src": src, "edge_dst": dst,
        "edge_mask": np.ones((E,), bool),
        "trip_kj": kj, "trip_ji": ji, "trip_mask": tm,
        "graph_id": np.concatenate(gids),
        "targets": rng.normal(size=(n_graphs,)).astype(np.float32),
    }, device)


class CSRGraph:
    """Compressed neighbor lists for fanout sampling."""

    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray):
        order = np.argsort(dst, kind="stable")
        self.src_sorted = src[order]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        self.indptr[1:] = np.cumsum(np.bincount(dst, minlength=n_nodes))
        self.n_nodes = n_nodes

    def neighbors(self, v: int):
        return self.src_sorted[self.indptr[v]:self.indptr[v + 1]]


def fanout_sample(graph: CSRGraph, seeds: np.ndarray, fanouts,
                  rng: np.random.Generator):
    """GraphSAGE fanout sampling. Returns (node_ids, src, dst) where src/dst
    index into node_ids (local ids) and edges point sampled-neighbor -> node.
    """
    nodes = list(seeds)
    local = {int(v): i for i, v in enumerate(seeds)}
    src_l, dst_l = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for v in frontier:
            nbrs = graph.neighbors(int(v))
            if len(nbrs) == 0:
                continue
            pick = nbrs if len(nbrs) <= f else rng.choice(nbrs, f,
                                                          replace=False)
            for u in pick:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                src_l.append(local[u])
                dst_l.append(local[int(v)])
        frontier = nxt
    return (np.asarray(nodes, np.int64),
            np.asarray(src_l, np.int32), np.asarray(dst_l, np.int32))


def padded_subgraph_batch(graph: CSRGraph, feats: np.ndarray,
                          labels: np.ndarray, seeds: np.ndarray, fanouts,
                          *, n_cap: int, e_cap: int, t_cap: int,
                          rng: np.random.Generator, device="cuda"):
    """Sample + pad to static caps -> DimeNet node-level batch dict on
    ``device`` (the loss on the seeds: ``label_mask``)."""
    device = check_device(device)
    nodes, src, dst = fanout_sample(graph, seeds, fanouts, rng)
    nodes = nodes[:n_cap]
    keep = (src < n_cap) & (dst < n_cap)
    src, dst = src[keep][:e_cap], dst[keep][:e_cap]
    n, e = len(nodes), len(src)
    kj, ji, tm = build_triplets(src, dst, t_cap=t_cap, rng=rng)
    feat = np.zeros((n_cap, feats.shape[1]), np.float32)
    feat[:n] = feats[nodes]
    pos = rng.normal(size=(n_cap, 3)).astype(np.float32)  # synthetic geometry
    lab = np.zeros(n_cap, np.int32)
    lab[:n] = labels[nodes]
    lmask = np.zeros(n_cap, bool)
    lmask[:min(len(seeds), n)] = True                     # loss on seeds
    es = np.zeros(e_cap, np.int32)
    ed = np.zeros(e_cap, np.int32)
    em = np.zeros(e_cap, bool)
    es[:e], ed[:e], em[:e] = src, dst, True
    return to_device({"feat": feat, "pos": pos, "edge_src": es, "edge_dst": ed,
                "edge_mask": em, "trip_kj": kj, "trip_ji": ji,
                "trip_mask": tm, "labels": lab, "label_mask": lmask}, device)
