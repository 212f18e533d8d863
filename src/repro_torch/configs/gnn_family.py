"""The GNN family: DimeNet at its four graph shapes (the JAX package's
``configs/gnn_family.py``), its train step and its batches.

Shapes: full_graph_sm (Cora-scale full batch), minibatch_lg (Reddit-scale
fanout-sampled subgraph), ogb_products (full-batch large), molecule (128
batched small graphs, DimeNet's native regime). Each shape carries an
explicit triplet cap T: the host fills up to T, and extra triplets are
subsampled.

``make_fn(cfg, "train")`` is the JAX cell's step with no mesh;
``train_batch`` builds a concrete batch at a cell's caps. Every cell has
``abstract_args`` (the JAX cell's ``_batch_abs``, ogb_products's too:
meta needs no triplet build) and, but ogb_products, ``concrete_args``.
ogb_products does not fit one card (``OGB_PRODUCTS_REFUSAL``).

``make_fn(cfg, "train", mesh=)`` is the JAX cell's ``make_fn(mesh)`` on a
mesh of ranks (``launch/mesh.py``): the parameters whole on every rank
(``gnn_rules``), the batch whole, each rank cutting its block of the
edges and triplets (``gnn_batch_specs``, ``batch_block``);
``models/gnn/dimenet.py`` says how the step runs there. Every cell's
E and T are multiples of 512, so 4, 256 and 512 ranks divide them; a
mesh that does not raises with the reason. ``abstract_args(mesh=)``
gives a rank's meta blocks (the JAX cell's ``args(mesh)``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import optim
from repro_torch.data.graph import (CSRGraph, build_triplets,
                                    padded_subgraph_batch, random_graph,
                                    random_molecule_batch, to_device)
from repro_torch.device import check_device
from repro_torch.distributed import sharding as shx
from repro_torch.models.gnn import dimenet
from repro_torch.optim.adam import leaves

from .base import (F32, I32, Arch, Cell, abstract_opt, abstract_params,
                   assert_finite, meta, shard_abstract)


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
    "61.9M edges. Nor does it fit a rank of the mesh step: counted on meta "
    "(launch/dryrun.py --mesh), a rank peaks at 79.6 GB on 16 x 16 and 73.8 "
    "GB on 2 x 16 x 16, over the 72 GB a step may hold, as each block "
    "all-gathers the whole [E, 128] messages (a triplet reads any edge's) "
    "and its backward sums their whole gradient")


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


def _batch_abs(shp) -> dict:
    """The JAX cell's batch on meta: node arrays of n, edge arrays of e,
    triplet arrays of t (e and t padded to /512), and the graph-level
    (z, graph_id, targets) or node-level (feat, labels, label_mask)
    fields."""
    n, e, t = shp["n"], shp["e"], shp["t"]
    b = {"pos": meta((n, 3), F32),
         "edge_src": meta((e,), I32), "edge_dst": meta((e,), I32),
         "edge_mask": meta((e,), torch.bool),
         "trip_kj": meta((t,), I32), "trip_ji": meta((t,), I32),
         "trip_mask": meta((t,), torch.bool)}
    if shp.get("graph_level"):
        b.update(z=meta((n,), I32), graph_id=meta((n,), I32),
                 targets=meta((shp["n_graphs"],), F32))
    else:
        b.update(feat=meta((n, shp["d_feat"]), F32), labels=meta((n,), I32),
                 label_mask=meta((n,), torch.bool))
    return b


def _abstract_args(shape: str, mesh=None, whole_batch: bool = False):
    """The cell's (parameters, Adam state, batch) on meta. With ``mesh``:
    one rank's blocks (``shard_abstract``): the parameters and moments
    whole (``gnn_rules``), the edge and triplet arrays cut over every
    axis (``gnn_batch_specs``) unless ``whole_batch`` (the batch as the
    mesh step takes it), the node arrays whole."""
    params = abstract_params(
        lambda g: dimenet.init(g, cell_config(shape)))
    opt = abstract_opt(params)
    batch = _batch_abs(GNN_SHAPES[shape])
    if mesh is not None:
        specs = shx.spec_tree(params, shx.gnn_rules())
        opt = dict(opt, m=shard_abstract(opt["m"], specs, mesh),
                   v=shard_abstract(opt["v"], specs, mesh))
        params = shard_abstract(params, specs, mesh)
        if not whole_batch:
            _check_divides(batch, mesh)
            batch = shard_abstract(batch, shx.gnn_batch_specs(mesh, batch),
                                   mesh)
    return (params, opt, batch)


def _check_divides(batch: dict, mesh):
    """Raise unless the mesh's ranks divide every edge and triplet
    array."""
    R = mesh.world
    bad = {k: v.shape[0] for k, v in batch.items()
           if k.startswith(("edge_", "trip_")) and v.shape[0] % R}
    if bad:
        raise ValueError(
            f"DimeNet on a mesh of {R} ranks cuts the edge and triplet "
            f"arrays into contiguous blocks, so {R} must divide their "
            f"lengths; it does not divide {bad} (the registry's cells pad "
            f"E and T to multiples of 512)")


def batch_block(batch: dict, mesh) -> dict:
    """This rank's block of a whole batch (``gnn_batch_specs``): its
    contiguous block of every edge and triplet array, the node arrays
    whole."""
    _check_divides(batch, mesh)
    specs = shx.gnn_batch_specs(mesh, batch)
    return {k: shx.shard_block(v, specs[k], mesh) for k, v in batch.items()}


def _concrete_args(shape: str, device):
    """The cell's (parameters, Adam state, ``train_batch``) on ``device``:
    parameters from a generator seeded with 0, the batch from a numpy
    generator of 0."""
    params = dimenet.init(torch.Generator(device=device).manual_seed(0),
                          cell_config(shape))
    return (params, optim.adam_init(params),
            train_batch(shape, np.random.default_rng(0), device=device))


def make_fn(cfg: dimenet.DimeNetConfig, kind: str, *, n_graphs: int = 1,
            mesh=None):
    """``train``: (params, opt_state, batch) -> (params, opt_state,
    metrics), ``dimenet.loss`` and its Adam step with ``GNN_OPT`` (the JAX
    cell's), parameters and moments updated in place. The batch must
    already live on the parameters' device (``train_batch``).

    With ``mesh`` (in each rank of it): the parameters and the Adam state
    whole on every rank, the batch whole; each rank runs the loss on its
    block of the edges and triplets (``batch_block``), the gradients are
    summed over the axes ``dimenet.grad_axes`` names, and the clip takes
    the global norm once (``optim.make_train_step(mesh=)``)."""
    if kind != "train":
        raise ValueError(f"unknown GNN step kind: {kind!r}")
    if mesh is None or mesh.world == 1:
        return optim.make_train_step(
            lambda p, b: dimenet.loss(p, cfg, b, n_graphs=n_graphs), GNN_OPT)
    whole = shx.Spec()
    return optim.make_train_step(
        lambda p, b: dimenet.loss(p, cfg, batch_block(b, mesh),
                                  n_graphs=n_graphs, mesh=mesh), GNN_OPT,
        mesh=mesh,
        specs=lambda p: {path: whole for path, _ in leaves(p)},
        grad_axes=lambda p: dimenet.grad_axes(p, mesh))


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
            make_fn=lambda device="cuda", mesh=None, cfg=cfg, ng=ng: make_fn(
                cfg, "train", n_graphs=ng, mesh=mesh),
            meta={"model_flops": _gnn_flops(cfg, shp)},
            abstract_args=functools.partial(_abstract_args, shape),
            concrete_args=(functools.partial(_concrete_args, shape)
                           if shape != "ogb_products" else None))
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
