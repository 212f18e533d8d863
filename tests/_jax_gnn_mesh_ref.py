"""The JAX package's DimeNet on a (data, model) mesh of 4 host devices:
the reference ``tests/test_torch_gnn_mesh.py`` holds the port's ranks to.

    python tests/_jax_gnn_mesh_ref.py INPUTS.npz OUTPUTS.npz [MESH ...]

INPUTS holds, per level (``graph``, ``node``), the parameters (JAX's
layout; list nodes as their indices) under ``<level>/p/<path>`` and the
batch under ``<level>/b/<key>``. For each mesh of ``MESHES`` it places
the parameters by ``gnn_rules`` and the batch by ``gnn_batch_specs``
(the edge and triplet arrays over every axis, the node arrays whole), as
the registry's cells do, and runs the loss, its gradient, and 2 steps of
``optim.make_train_step(dimenet.loss, GNN_OPT)`` (the cells'
``make_fn(mesh)``), jitted, GSPMD placing the collectives. Every result
is written whole to OUTPUTS under ``<mesh>/<level>/...``; MESH names the
meshes to run (all by default), so two processes can share the work.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim  # noqa: E402
from repro.configs import gnn_family  # noqa: E402
from repro.distributed import sharding as shx  # noqa: E402
from repro.launch.mesh import make_mesh_for  # noqa: E402
from repro.models.gnn import dimenet  # noqa: E402

MESHES = {"4x1": (4, 1), "2x2": (4, 2)}     # name -> make_mesh_for(n, model)
LEVELS = {"graph": 4, "node": 1}            # level -> n_graphs
N_STEPS = 2


def mesh_config(level):
    """``_torch_gnn_mesh_ranks.mesh_config``: the reduced DimeNet."""
    cfg = dataclasses.replace(gnn_family.DIMENET, n_blocks=2, d_hidden=32,
                              n_bilinear=4, n_spherical=3, n_radial=3)
    if level == "node":
        cfg = dataclasses.replace(cfg, d_feat=16, out_dim=5, node_level=True)
    return cfg


def unflatten(flat: dict, prefix: str):
    """The tree under ``prefix``; a node whose keys are all digits is a
    list."""
    tree = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _flatten(tree, prefix: str, out: dict):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                       for p in path)
        out[prefix + key] = np.asarray(leaf)


def run_level(level, inp, mesh, out, tag):
    cfg, ng = mesh_config(level), LEVELS[level]
    params = jax.tree.map(jnp.asarray, unflatten(inp, f"{level}/p/"))
    specs = shx.spec_tree(params, shx.gnn_rules())
    put = lambda t, s: jax.device_put(t, shx.named(mesh, s))  # noqa: E731
    params = put(params, specs)
    batch = {k: jnp.asarray(v) for k, v in
             unflatten(inp, f"{level}/b/").items()}
    batch = put(batch, shx.gnn_batch_specs(mesh, batch))
    loss_fn = lambda p, b: dimenet.loss(p, cfg, b, n_graphs=ng)  # noqa: E731
    loss, g = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b)[0]))(
        params, batch)
    out[f"{tag}/loss"] = np.asarray(loss)
    _flatten(g, f"{tag}/grad/", out)
    step = jax.jit(optim.make_train_step(loss_fn, gnn_family.GNN_OPT))
    opt = put(optim.adam_init(params), {"m": specs, "v": specs,
                                        "count": jax.sharding.PartitionSpec()})
    losses = []
    for _ in range(N_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    out[f"{tag}/losses"] = np.array(losses)
    _flatten(params, f"{tag}/params/", out)


def main(src, dst, meshes=tuple(MESHES)):
    inp = dict(np.load(src))
    out = {}
    for mname in meshes:
        n, model = MESHES[mname]
        mesh = make_mesh_for(n, model=model)
        for level in LEVELS:
            run_level(level, inp, mesh, out, f"{mname}/{level}")
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], tuple(sys.argv[3:]) or tuple(MESHES))
