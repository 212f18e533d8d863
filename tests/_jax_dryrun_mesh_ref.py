"""The JAX package on a (data=2, model=2) mesh of 4 host devices: the
reference ``tests/test_torch_dryrun_mesh.py`` holds the port's mesh count
and SpeedyFeed's conventional mesh step to.

    python tests/_jax_dryrun_mesh_ref.py INPUTS.npz OUTPUTS.npz

For DimeNet ``molecule`` and DCN-v2 ``serve_p99`` it lowers and compiles
the registry cell on the mesh (the JAX dry-run's ``run_cell``, with its
``activation_specs``) and writes ``launch.roofline.from_compiled``'s
record as JSON under ``<arch>/<shape>``. For the conventional workflow
it places INPUTS' parameters (``conv/p/<path>``, replicated) and batch
(``conv/b/<key>``, the instances over every axis, as the JAX cell lays
them) and writes the loss's gradient and 2 steps of
``make_conventional_step`` (loss, grad norm, parameters) under
``conv/``.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro import configs, core  # noqa: E402
from repro.configs.speedyfeed_arch import make_conventional_step  # noqa: E402
from repro.distributed import sharding as shx  # noqa: E402
from repro.launch import roofline as rl  # noqa: E402
from repro.launch.mesh import make_mesh_for, set_mesh  # noqa: E402

CELLS = (("dimenet", "molecule"), ("dcn-v2", "serve_p99"))
N_STEPS = 2


def compiled_record(arch, shape, mesh) -> dict:
    cell = configs.get_arch(arch).cells[shape]
    shx.set_activation_specs({k: NamedSharding(mesh, v) for k, v in
                              cell.activation_specs(mesh).items()})
    try:
        with set_mesh(mesh):
            compiled = jax.jit(cell.make_fn(mesh)).lower(
                *cell.abstract_args(mesh)).compile()
    finally:
        shx.set_activation_specs({})
    return rl.from_compiled(cell, compiled, "2x2", 4).to_dict()


def unflatten(flat: dict, prefix: str):
    tree = {}
    for key, arr in flat.items():
        if key.startswith(prefix):
            node, parts = tree, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(arr)
    return tree


def _flatten(tree, prefix: str, out: dict):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                       for p in path)
        out[prefix + key] = np.asarray(leaf)


def conventional(inp, mesh, out):
    cfg = core.make_config(attn_impl="xla", **json.loads(str(inp["conv/cfg"])))
    params = jax.device_put(unflatten(inp, "conv/p/"),
                            NamedSharding(mesh, P()))
    every = tuple(mesh.axis_names)
    batch = {k: jax.device_put(v, NamedSharding(
        mesh, P(every, *([None] * (v.ndim - 1)))))
        for k, v in unflatten(inp, "conv/b/").items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: core.conventional_forward(p, cfg, b)[0]))(params, batch)
    out["conv/loss"] = np.asarray(loss)
    _flatten(g, "conv/grad/", out)
    step = jax.jit(make_conventional_step(cfg))
    from repro import optim
    opt = optim.adam_init(params)
    losses, norms = [], []
    for _ in range(N_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["conv/losses"], out["conv/grad_norms"] = np.array(losses), \
        np.array(norms)
    _flatten(params, "conv/params/", out)


def main(src, dst):
    inp = dict(np.load(src))
    mesh = make_mesh_for(4, model=2)
    out = {f"{a}/{s}": json.dumps(compiled_record(a, s, mesh))
           for a, s in CELLS}
    conventional(inp, mesh, out)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
