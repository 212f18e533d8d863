"""The GNN family: DimeNet at its four graph shapes (the JAX package's
``configs/gnn_family.py``), its train step and its batches.

Shapes: full_graph_sm (Cora-scale full batch), minibatch_lg (Reddit-scale
fanout-sampled subgraph), ogb_products (full-batch large), molecule (128
batched small graphs, DimeNet's native regime). Each shape carries an
explicit triplet cap T: the host fills up to T, and extra triplets are
subsampled.

``make_fn(cfg, "train")`` is the JAX cell's step with no mesh;
``train_batch`` builds a concrete batch at a cell's caps. ogb_products
does not fit one card (``OGB_PRODUCTS_REFUSAL``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import optim
from repro_torch.data.graph import (CSRGraph, build_triplets,
                                    padded_subgraph_batch, random_graph,
                                    random_molecule_batch, to_device)
from repro_torch.device import check_device
from repro_torch.models.gnn import dimenet

from .base import Arch, Cell, assert_finite


def _pad512(x: int) -> int:
    """Edge/triplet arrays shard over up to 512 devices -> pad (mask'd)."""
    return -(-x // 512) * 512


GNN_SHAPES = {
    # n, e, t: real sizes; e/t arrays are padded to /512 (edge_mask covers)
    "full_graph_sm": dict(kind="train", n=2708, e=_pad512(10556), t=32768,
                          d_feat=1433, n_classes=7, e_real=10556),
    "minibatch_lg": dict(kind="train", n=169984, e=_pad512(168960), t=262144,
                         d_feat=602, n_classes=41, seeds=1024, e_real=168960),
    "ogb_products": dict(kind="train", n=2449029, e=_pad512(61859140),
                         t=_pad512(61859140), d_feat=100, n_classes=47,
                         e_real=61859140),
    "molecule": dict(kind="train", n=3840, e=8192, t=16384, graph_level=True,
                     n_graphs=128),
}

GNN_OPT = optim.AdamConfig(lr=1e-3, grad_clip=1.0)

DIMENET = dimenet.DimeNetConfig(
    name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
    n_radial=6)

# molecule: 128 graphs of 30 nodes and 64 edges (N = 3,840, E = 8,192)
MOLECULE_GRAPH = dict(n_graphs=128, nodes_per_graph=30, edges_per_graph=64)
# minibatch_lg's fanouts: 1,024 seeds x 15, then x 10 (the caps decode as
# 1,024 + 15,360 + 153,600 nodes, 15,360 + 153,600 edges)
MINIBATCH_FANOUTS = (15, 10)
# minibatch_lg's base graph: Reddit as GraphSAINT lists it (Zeng et al.,
# ICLR 2020, Table 1): 232,965 nodes, 11,606,919 edges; 602 features and
# 41 classes are GNN_SHAPES'. The edges are drawn at random.
REDDIT_NODES, REDDIT_EDGES = 232_965, 11_606_919
# full_graph_sm's training labels: Planetoid's split of Cora (Yang et al.,
# ICML 2016), 20 nodes a class
CORA_TRAIN_PER_CLASS = 20
OGB_PRODUCTS_REFUSAL = (
    "ogb_products does not fit one 80 GB card: a single [E, 128] f32 "
    "activation over its 61,859,140 edges is 31.7 GB, a training step keeps "
    "several for each of its 6 blocks, and the host's triplet build walks "
    "61.9M edges; it waits for the multi-card port (ROADMAP.md Queue 1 "
    "item 4)")


def _cfg_for(shp) -> dimenet.DimeNetConfig:
    if shp.get("graph_level"):
        return DIMENET
    return dataclasses.replace(DIMENET, d_feat=shp["d_feat"],
                               out_dim=shp["n_classes"], node_level=True)


def cell_config(shape: str) -> dimenet.DimeNetConfig:
    """The config the cell ``shape`` trains: ``DIMENET``, with the shape's
    features and classes at node level."""
    return _cfg_for(GNN_SHAPES[shape])


def _gnn_flops(cfg, shp):
    d, nb = cfg.d_hidden, cfg.n_bilinear
    nsbf = cfg.n_spherical * cfg.n_radial
    e, t = shp["e"], shp["t"]
    per_block = 2 * e * d * d * 4 + 2 * t * nsbf * d * nb + 2 * t * nsbf * nsbf
    return 3 * cfg.n_blocks * per_block     # train = fwd + bwd


def make_fn(cfg: dimenet.DimeNetConfig, kind: str, *, n_graphs: int = 1):
    """``train``: (params, opt_state, batch) -> (params, opt_state,
    metrics), ``dimenet.loss`` and its Adam step with ``GNN_OPT`` (the JAX
    cell's), parameters and moments updated in place. The batch must
    already live on the parameters' device (``train_batch``)."""
    if kind != "train":
        raise ValueError(f"unknown GNN step kind: {kind!r}")
    return optim.make_train_step(
        lambda p, b: dimenet.loss(p, cfg, b, n_graphs=n_graphs), GNN_OPT)


def train_batch(shape: str, rng: np.random.Generator, device="cuda") -> dict:
    """A concrete batch at the cell ``shape``'s caps, drawn from ``rng``,
    on ``device``:

    ``molecule``: ``random_molecule_batch`` of MOLECULE_GRAPH's 128 graphs
    (30 nodes, 64 edges each), T = 16,384.
    ``full_graph_sm``: a ``random_graph`` of 2,708 nodes and 10,556 edges,
    its triplets capped at 32,768, the edge arrays padded to 10,752 under
    ``edge_mask`` (pad edges self-loops at node 0), N(0, 1) features of
    1,433, labels uniform over 7 classes, N(0, 1) positions.
    ``label_mask`` marks Planetoid's training split's size, 20 nodes a
    class: the first 140 nodes (the graph is random, so which 140 is
    immaterial); the loss and accuracy are over those.
    ``minibatch_lg``: ``padded_subgraph_batch`` with MINIBATCH_FANOUTS
    from 1,024 distinct seeds on a ``random_graph`` of Reddit's size
    (REDDIT_NODES, REDDIT_EDGES), N(0, 1) f32 features of 602 and labels
    over 41 classes, padded to n 169,984, e 168,960, t 262,144; the loss
    on the seeds.
    ``ogb_products`` raises (OGB_PRODUCTS_REFUSAL)."""
    device = check_device(device)
    shp = GNN_SHAPES[shape]
    if shape == "ogb_products":
        raise ValueError(OGB_PRODUCTS_REFUSAL)
    if shape == "molecule":
        return random_molecule_batch(rng, t_cap=shp["t"], device=device,
                                     **MOLECULE_GRAPH)
    n, e_cap, t_cap = shp["n"], shp["e"], shp["t"]
    if shape == "full_graph_sm":
        src, dst = random_graph(rng, n, shp["e_real"])
        kj, ji, tm = build_triplets(src, dst, t_cap=t_cap, rng=rng)
        e = len(src)
        pad = lambda x, dt: np.concatenate(    # noqa: E731
            [x, np.zeros(e_cap - e, dt)])
        lmask = np.zeros(n, bool)
        lmask[:CORA_TRAIN_PER_CLASS * shp["n_classes"]] = True
        arrays = {
            "feat": rng.standard_normal((n, shp["d_feat"]), np.float32),
            "pos": rng.normal(size=(n, 3)).astype(np.float32),
            "edge_src": pad(src, np.int32), "edge_dst": pad(dst, np.int32),
            "edge_mask": pad(np.ones(e, bool), bool),
            "trip_kj": kj, "trip_ji": ji, "trip_mask": tm,
            "labels": rng.integers(0, shp["n_classes"], n).astype(np.int32),
            "label_mask": lmask}
        return to_device(arrays, device)
    src, dst = random_graph(rng, REDDIT_NODES, REDDIT_EDGES)
    graph = CSRGraph(REDDIT_NODES, src, dst)
    feats = rng.standard_normal((REDDIT_NODES, shp["d_feat"]), np.float32)
    labels = rng.integers(0, shp["n_classes"], REDDIT_NODES)
    seeds = rng.choice(REDDIT_NODES, shp["seeds"], replace=False)
    return padded_subgraph_batch(graph, feats, labels, seeds,
                                 MINIBATCH_FANOUTS, n_cap=n, e_cap=e_cap,
                                 t_cap=t_cap, rng=rng, device=device)


def _arch() -> Arch:
    cells = {}
    for shape, shp in GNN_SHAPES.items():
        cfg = cell_config(shape)
        ng = shp.get("n_graphs", 1)
        cells[shape] = Cell(
            arch="dimenet", shape=shape, kind="train",
            make_fn=lambda cfg=cfg, ng=ng: make_fn(cfg, "train", n_graphs=ng),
            meta={"model_flops": _gnn_flops(cfg, shp)})
    return Arch(name="dimenet", family="gnn", config=DIMENET, cells=cells,
                smoke=_smoke,
                notes="triplet-gather regime; message passing via "
                      "index_select + index_add_; SpeedyFeed core "
                      "inapplicable")


def _smoke(device="cuda"):
    """The JAX package's reduced smoke (2 blocks, d 32, 4 bilinear, 3
    spherical, 3 radial): one Adam step on 4 molecules of 8 nodes, then
    the node-level loss on a random 32-node graph, on ``device``, with
    torch draws for the weights."""
    device = check_device(device)
    small = dataclasses.replace(DIMENET, n_blocks=2, d_hidden=32,
                                n_bilinear=4, n_spherical=3, n_radial=3)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = random_molecule_batch(np.random.default_rng(0), n_graphs=4,
                                  nodes_per_graph=8, t_cap=256, device=device)
    params = dimenet.init(gen, small)
    params, _, metrics = make_fn(small, "train", n_graphs=4)(
        params, optim.adam_init(params), batch)
    assert_finite(metrics["loss"], "dimenet loss")
    # node-level mode
    small_n = dataclasses.replace(small, d_feat=16, out_dim=5,
                                  node_level=True)
    pn = dimenet.init(gen, small_n)
    rng = np.random.default_rng(1)
    n, e = 32, 96
    src = rng.integers(0, n, e)
    dst = (src + 1 + rng.integers(0, n - 1, e)) % n
    kj, ji, tm = build_triplets(src, dst, t_cap=256)
    arrays = {"feat": rng.normal(size=(n, 16)).astype(np.float32),
              "pos": (rng.normal(size=(n, 3)) * 2).astype(np.float32),
              "edge_src": src.astype(np.int32),
              "edge_dst": dst.astype(np.int32),
              "edge_mask": np.ones((e,), bool),
              "trip_kj": kj, "trip_ji": ji, "trip_mask": tm,
              "labels": rng.integers(0, 5, n).astype(np.int32),
              "label_mask": np.ones((n,), bool)}
    bn = to_device(arrays, device)
    with torch.no_grad():
        l, _ = dimenet.loss(pn, small_n, bn)
    assert_finite(l, "dimenet node loss")
    return {"loss": float(metrics["loss"]), "node_loss": float(l)}


def archs():
    return [_arch()]
