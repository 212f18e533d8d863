"""The JAX package's recsys family on a (data, model) mesh of 4 host
devices: the reference ``tests/test_torch_recsys_mesh.py`` holds the
port's ranks to.

    python tests/_jax_recsys_mesh_ref.py INPUTS.npz OUTPUTS.npz [MESH ...]

INPUTS holds, per config, the parameters (JAX's layout; list nodes as
their indices) under ``<name>/p/<path>`` and the batch under
``<name>/b/<key>``, the retrieval candidates under ``<name>/cand`` and
the BERT4Rec ``row_chunk``. For each mesh of ``MESHES`` it places the
parameters by ``recsys_rules`` (``guard_divisible``) and the batches by
``recsys_batch_specs``, and runs the registry cells' ``make_fn(mesh,
cfg=<reduced>)``: a CTR config's serve (its logits) and BERT4Rec's
(``serve_sharded``, top-100), each loss's gradient and 2 train steps
(``RS_OPT``; the gradient and the step in one jitted call), retrieval
(1 query, the candidates over the data axes); and BERT4Rec's
``serve_sharded`` again at ``row_chunk``, so that more than one chunk
runs. The CTR cells run ``impl="xla"``: a ``pallas_call`` has no GSPMD
rule. Every result is written whole (gathered) to OUTPUTS under
``<mesh>/<name>/...``; MESH names the meshes to run (all by default), so
two processes can share the work.
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
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro import optim  # noqa: E402
from repro.configs import get_arch, recsys_family  # noqa: E402
from repro.configs.base import data_axes, opt_spec_tree  # noqa: E402
from repro.distributed import sharding as shx  # noqa: E402
from repro.launch.mesh import make_mesh_for  # noqa: E402
from repro.models.recsys import bert4rec  # noqa: E402

MESHES = {"1x2": (2, 2), "2x2": (4, 2)}     # name -> make_mesh_for(n, model)
NAMES = ("wide-deep", "dlrm-rm2", "dcn-v2", "bert4rec")
B4R_ITEMS = 3000


def mesh_config(name):
    """The reduced config the test runs: the JAX package's smoke size
    (``_ctr_smoke``, ``_b4r_smoke``), BERT4Rec at 3,000 items so that its
    4,096-row table holds items in both model blocks."""
    cfg = get_arch(name).config
    if name == "bert4rec":
        return dataclasses.replace(cfg, n_items=B4R_ITEMS, embed_dim=16,
                                   seq_len=24, d_ff=32, n_mask=4, n_neg=8)
    from repro.models.recsys.common import SparseSpec
    return dataclasses.replace(
        cfg, sparse=SparseSpec(
            n_fields=cfg.sparse.n_fields,
            vocab_sizes=tuple([97] * cfg.sparse.n_fields),
            embed_dim=8, nnz=cfg.sparse.nnz),
        mlp_dims=(32, 16) if cfg.mlp_dims else (),
        bot_mlp=(16, 8) if cfg.bot_mlp else (),
        top_mlp=(16, 8, 1) if cfg.top_mlp else ())


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


def _put(tree, specs, mesh):
    return jax.device_put(tree, shx.named(mesh, specs))


def run_config(name, inp, mesh, out, tag):
    cfg = mesh_config(name)
    cells = get_arch(name).cells
    params = jax.tree.map(jnp.asarray, unflatten(inp, f"{name}/p/"))
    specs = shx.guard_divisible(shx.spec_tree(params, shx.recsys_rules()),
                                params, mesh)
    params = _put(params, specs, mesh)
    batch = {k: jnp.asarray(v) for k, v in
             unflatten(inp, f"{name}/b/").items()}
    bspecs = shx.guard_divisible(shx.recsys_batch_specs(mesh, batch), batch,
                                 mesh)
    batch = _put(batch, bspecs, mesh)
    serve_in = ({"tokens": batch["tokens"]} if name == "bert4rec" else
                {k: v for k, v in batch.items() if k != "label"})
    serve = jax.jit(cells["serve_p99"].make_fn(mesh, cfg=cfg))
    res = serve(params, serve_in)
    if name == "bert4rec":
        out[f"{tag}/serve_vals"], out[f"{tag}/serve_ids"] = map(np.asarray,
                                                                res)
        chunked = jax.jit(lambda p, b: bert4rec.serve_sharded(
            p, cfg, b, mesh, k=100, row_chunk=int(inp["row_chunk"])))
        vals, ids = chunked(params, serve_in)
        out[f"{tag}/chunked_vals"], out[f"{tag}/chunked_ids"] = (
            np.asarray(vals), np.asarray(ids))
        loss_fn = lambda p, b: bert4rec.loss(p, cfg, b)[0]  # noqa: E731
    else:
        out[f"{tag}/logits"] = np.asarray(res)
        from repro.models.recsys import ctr
        loss_fn = lambda p, b: ctr.loss(p, cfg, b)[0]  # noqa: E731
    train = cells["train_batch"].make_fn(mesh, cfg=cfg)
    grad = jax.grad(loss_fn)
    step = jax.jit(lambda p, o, b: (grad(p, b),) + train(p, o, b))
    opt_specs = opt_spec_tree(specs)
    opt = _put(optim.adam_init(params), opt_specs, mesh)
    losses, norms = [], []
    for i in range(2):
        g, params, opt, m = step(params, opt, batch)
        if i == 0:
            _flatten(g, f"{tag}/grad/", out)
        # back on the input placement: the next call reuses the compile
        params, opt = _put(params, specs, mesh), _put(opt, opt_specs, mesh)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{tag}/losses"] = np.array(losses)
    out[f"{tag}/grad_norms"] = np.array(norms)
    _flatten(params, f"{tag}/params/", out)
    for k in "mv":
        _flatten(opt[k], f"{tag}/{k}/", out)
    # retrieval from the starting parameters: one query, its batch whole
    # (the cell's), the candidates over the data axes
    params = _put(jax.tree.map(jnp.asarray, unflatten(inp, f"{name}/p/")),
                  specs, mesh)
    query = {k: jnp.asarray(v[:1]) for k, v in
             unflatten(inp, f"{name}/b/").items()
             if k in (("tokens",) if name == "bert4rec" else
                      ("sparse_idx", "sparse_w", "dense"))}
    cand = np.asarray(inp[f"{name}/cand"])
    cand = jax.device_put(jnp.asarray(cand), NamedSharding(
        mesh, P(data_axes(mesh), *([None] * (cand.ndim - 1)))))
    retr = jax.jit(cells["retrieval_cand"].make_fn(mesh, cfg=cfg))
    vals, ids = retr(params, query, cand)
    out[f"{tag}/retr_vals"], out[f"{tag}/retr_ids"] = (np.asarray(vals),
                                                       np.asarray(ids))


def main(src, dst, meshes=tuple(MESHES)):
    inp = dict(np.load(src))
    out = {}
    for mname in meshes:
        n, model = MESHES[mname]
        mesh = make_mesh_for(n, model=model)
        for name in NAMES:
            run_config(name, inp, mesh, out, f"{mname}/{name}")
    np.savez(dst, **out)


if __name__ == "__main__":
    assert recsys_family.RS_OPT.accum_steps == 1
    main(sys.argv[1], sys.argv[2], tuple(sys.argv[3:]) or tuple(MESHES))
