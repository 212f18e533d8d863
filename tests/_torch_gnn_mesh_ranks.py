"""What each rank of ``tests/test_torch_gnn_mesh.py`` runs (``launch.mesh.
run_on_mesh`` pickles these functions by name, so they live in a module
of their own that imports torch and the port, never JAX), the inputs
both packages read (``inputs``) and the port's one-process reference
(``one_process``).

One group of 4 ranks runs every case on a (data=4, model=1) mesh and on
a (data=2, model=2) one (``submesh``), at graph level (4 molecules) and
at node level (a padded fanout subgraph) of DimeNet's reduced config:
the loss, each gradient leaf as Adam takes it (after the mesh step's
sum, ``optim.adam.sync_grads`` over ``dimenet.grad_axes``), and 2 train
steps of the registry's ``gnn_family.make_fn(mesh=)``; and the controls,
each of which must miss: a sum that also adds ``out_mlp1``/``out_mlp2``
over the mesh, a sum over ``data`` only, and blocks whose triplet sums
are not reduce-scattered (each rank keeps its own partial sum).
"""
import dataclasses

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import gnn_family as gf
from repro_torch.data import graph
from repro_torch.launch.mesh import submesh
from repro_torch.models.gnn import dimenet
from repro_torch.optim.adam import leaves, sync_grads, unflatten

MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
LEVELS = {"graph": 4, "node": 1}           # level -> n_graphs
N_STEPS = 2


def mesh_config(level: str) -> dimenet.DimeNetConfig:
    """DimeNet at the JAX smoke's reduced size (2 blocks, d 32, 4
    bilinear, 3 spherical, 3 radial); node level with 16 features and 5
    classes."""
    cfg = dataclasses.replace(gf.DIMENET, n_blocks=2, d_hidden=32,
                              n_bilinear=4, n_spherical=3, n_radial=3)
    if level == "node":
        cfg = dataclasses.replace(cfg, d_feat=16, out_dim=5, node_level=True)
    return cfg


def _batch(level: str) -> dict:
    """Numpy arrays: 4 molecules of 8 nodes (E 64, T 256), or a padded
    fanout subgraph of 16 seeds (N 96, E 160, T 128; pad edges and
    triplets included)."""
    if level == "graph":
        b = graph.random_molecule_batch(
            np.random.default_rng(0), n_graphs=4, nodes_per_graph=8,
            t_cap=256, device="cpu")
    else:
        rng = np.random.default_rng(7)
        src, dst = graph.random_graph(rng, 300, 2400)
        g = graph.CSRGraph(300, src, dst)
        feats = rng.normal(size=(300, 16)).astype(np.float32)
        labels = rng.integers(0, 5, 300)
        seeds = rng.choice(300, 16, replace=False)
        b = graph.padded_subgraph_batch(g, feats, labels, seeds, (5, 3),
                                        n_cap=96, e_cap=160, t_cap=128,
                                        rng=rng, device="cpu")
    return {k: v.numpy() for k, v in b.items()}


def inputs() -> dict:
    """{``<level>/p/<path>``: a parameter (the port's init from a seeded
    generator, in the JAX package's tree), ``<level>/b/<key>``: the
    batch} for both levels."""
    out = {}
    for level in LEVELS:
        p = dimenet.init(torch.Generator().manual_seed(1),
                         mesh_config(level))
        out.update({f"{level}/p/{k}": v.numpy() for k, v in leaves(p)})
        out.update({f"{level}/b/{k}": v for k, v in _batch(level).items()})
    return out


def params_of(inp: dict, level: str):
    """The parameter tree of ``level`` from ``inputs()``."""
    like = dimenet.init(torch.Generator().manual_seed(1), mesh_config(level))
    return unflatten(like, [torch.tensor(inp[f"{level}/p/{k}"])
                            for k, _ in leaves(like)])


def batch_of(inp: dict, level: str) -> dict:
    pre = f"{level}/b/"
    return {k[len(pre):]: torch.tensor(v) for k, v in inp.items()
            if k.startswith(pre)}


def grads(params, cfg, batch, ng, mesh, axes_of=None):
    """(loss, [each leaf's gradient as Adam takes it]): the loss on this
    rank's block, its gradients summed over ``axes_of(params)`` (by
    default ``dimenet.grad_axes``)."""
    flat = [p.requires_grad_() for _, p in leaves(params)]
    loss, _ = dimenet.loss(params, cfg, gf.batch_block(batch, mesh),
                           n_graphs=ng, mesh=mesh)
    g = torch.autograd.grad(loss, flat)
    axes = (axes_of or dimenet.grad_axes)(params, mesh)
    g = sync_grads(list(g), flat, [()] * len(flat), mesh,
                   [axes[k] for k, _ in leaves(params)])
    return loss.detach(), [x.detach() for x in g]


def steps(params, cfg, batch, ng, mesh):
    """(losses, parameters) after N_STEPS of ``gnn_family.make_fn``."""
    step = gf.make_fn(cfg, "train", n_graphs=ng, mesh=mesh)
    opt = optim.adam_init(params)
    losses = []
    for _ in range(N_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return losses, [p.detach() for _, p in leaves(params)]


def _over_every_axis(params, mesh):
    every = tuple(mesh.axis_names)
    return {k: every for k, _ in leaves(params)}


def _over_data(params, mesh):
    return {k: ("data",) for k, _ in leaves(params)}


def _kept_partial(x, mesh):
    """The control for the triplet sums: each rank's own edge rows of its
    partial sum, never summed over the mesh."""
    n = x.shape[0] // mesh.world
    return x.narrow(0, mesh.rank * n, n)


def gnn_mesh_cases(world, inp):
    """Every case on both meshes of the world's 4 ranks (module
    docstring); {``<mesh>/<level>/<what>``: value}."""
    out = {}
    for mname, (d, m) in MESHES.items():
        mesh = submesh(world, data=d, model=m)
        for level, ng in LEVELS.items():
            cfg, tag = mesh_config(level), f"{mname}/{level}"
            batch = batch_of(inp, level)
            loss, g = grads(params_of(inp, level), cfg, batch, ng, mesh)
            out[f"{tag}/loss"], out[f"{tag}/grads"] = loss, g
            out[f"{tag}/losses"], out[f"{tag}/params"] = steps(
                params_of(inp, level), cfg, batch, ng, mesh)
            out[f"{tag}/ctl_every"] = grads(params_of(inp, level), cfg,
                                            batch, ng, mesh,
                                            _over_every_axis)[1]
            if m > 1:
                out[f"{tag}/ctl_data"] = grads(params_of(inp, level), cfg,
                                               batch, ng, mesh,
                                               _over_data)[1]
            own = dimenet._own_edges
            dimenet._own_edges = _kept_partial
            try:
                out[f"{tag}/ctl_rs"] = grads(params_of(inp, level), cfg,
                                             batch, ng, mesh)[0]
            finally:
                dimenet._own_edges = own
    return out


def one_process(inp, level):
    """The port's one-process loss, gradients and steps of ``level``."""
    cfg, ng = mesh_config(level), LEVELS[level]
    batch = batch_of(inp, level)
    params = params_of(inp, level)
    flat = [p.requires_grad_() for _, p in leaves(params)]
    loss, _ = dimenet.loss(params, cfg, batch, n_graphs=ng)
    g = torch.autograd.grad(loss, flat)
    losses, after = steps(params_of(inp, level), cfg, batch, ng, None)
    return {"loss": loss.detach(), "grads": [x.detach() for x in g],
            "losses": losses, "params": after}
