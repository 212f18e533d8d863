"""The JAX package's LM family on a mesh of 4 host devices: the
reference ``tests/test_torch_lm_mesh.py`` (the (data, model) meshes
``MESHES``) and ``tests/test_torch_lm_mesh_heads.py`` (``HEADS_MESHES``:
(data 1, model 4) and (pod 2, data 1, model 2), the configs
``HEADS`` at ``heads_config``'s head counts) hold the port's ranks to.

    python tests/_jax_lm_mesh_ref.py INPUTS.npz OUTPUTS.npz [MESH ...]

INPUTS holds, per config, the parameters (JAX's layout, stacked layers)
under ``<name>/p/<path>``, the decode cache under ``<name>/cache/<k|v>``,
and the shared ``tokens``, ``labels``, ``decode_tokens``, ``decode_start``,
the MoE overflow case's ``moe/*`` and ``opt_count``, Adam's step count the
train steps start from. For each mesh of ``MESHES`` it places the
parameters by ``lm_rules(fsdp=True)`` (``guard_divisible``), the batches
by ``lm_batch_specs``, and runs ``lm.prefill``, ``lm.decode_step`` (4
steps) and ``lm.lm_loss``'s gradient with ``mesh=``, and 2 steps of the
registry's ``_make_train(cfg, mesh)`` from Adam's state at ``opt_count``
(the gradient and the step in one jitted call, one compile; the
parameters and both moments after them); and
``nn.moe_ep`` with its gradients on the overflow case. On the CPU the
JAX LM runs attention through XLA (no Pallas call is on the path, so
nothing refuses to partition). Every result is written whole (gathered)
to OUTPUTS under ``<mesh>/<name>/...``; MESH names the meshes to run
(those of ``MESHES`` by default), so two processes can share the work.
The decode cache is placed by ``lm_batch_specs`` after
``guard_divisible`` (at model=4 over 2 KV heads the heads dim is
replicated).
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
from repro.configs import lm_family  # noqa: E402
from repro.configs.base import opt_spec_tree  # noqa: E402
from repro.distributed import sharding as shx  # noqa: E402
from repro.launch.mesh import make_mesh_for  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.nn.moe import MoEConfig, moe_ep  # noqa: E402

MESHES = {"1x2": (2, 2), "2x2": (4, 2)}     # name -> make_mesh_for(n, model)
CONFIGS = {c.name: c for c in (lm_family.QWEN3_14B, lm_family.CHATGLM3_6B,
                               lm_family.DBRX_132B, lm_family.LLAMA4_SCOUT)}
# name -> (shape, axes) over the first 4 host devices
HEADS_MESHES = {"1x4": ((1, 4), ("data", "model")),
                "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# name -> (n_heads, n_kv) of heads_config
HEADS = {"qwen3-14b": (6, 2), "chatglm3-6b": (4, 2),
         "llama4-scout-17b-a16e": (6, 2)}


def mesh_config(cfg):
    """The reduced config the test runs: ``reduced_lm``, the MoE two back
    on ``moe_impl="ep"``; Qwen3-14B with remat and a loss chunk of 8 (the
    vocab-parallel cross entropy chunked, the layers checkpointed)."""
    r = lm_family.reduced_lm(cfg)
    if cfg.is_moe:
        r = dataclasses.replace(r, moe_impl="ep")
    if cfg.name == "qwen3-14b":
        r = dataclasses.replace(r, remat=True, loss_chunk=8)
    return r


def heads_config(cfg):
    """``mesh_config`` at ``HEADS``' head counts (of 16): Qwen3-14B and
    Scout 6 over 2 KV heads (G = 3: at model=4 each KV head on 2 ranks
    that hold 2 and 1 query heads), ChatGLM3-6B 4 over 2 (1 a rank at
    model=4)."""
    n_heads, n_kv = HEADS[cfg.name]
    return dataclasses.replace(mesh_config(cfg), n_heads=n_heads, n_kv=n_kv)


def heads_mesh(name):
    shape, axes = HEADS_MESHES[name]
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             axes)


MOE_CFG = MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2,
                    capacity_factor=0.5)


def _unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
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


def _put(tree, spec_tree, mesh):
    return jax.device_put(tree, shx.named(mesh, spec_tree))


def run_config(name, cfg, inp, mesh, out, tag):
    params = _unflatten(inp, f"{name}/p/")
    specs = shx.guard_divisible(
        shx.spec_tree(params, shx.lm_rules(True)), params, mesh)
    params = _put(params, specs, mesh)
    dspec = shx.data_spec(mesh)
    tokens = jax.device_put(jnp.asarray(inp["tokens"]),
                            NamedSharding(mesh, dspec))
    labels = jax.device_put(jnp.asarray(inp["labels"]),
                            NamedSharding(mesh, dspec))
    pre = jax.jit(lambda p, t: lm.prefill(p, cfg, t, mesh=mesh))
    out[f"{tag}/prefill"] = np.asarray(pre(params, tokens))
    whole = {k: jnp.asarray(inp[f"{name}/cache/{k}"]) for k in ("k", "v")}
    cspec = shx.guard_divisible(shx.lm_batch_specs(mesh, "decode")["cache"],
                                whole, mesh)
    cache = {k: jax.device_put(whole[k], NamedSharding(mesh, cspec[k]))
             for k in ("k", "v")}
    dec = jax.jit(lambda p, t, c, i: lm.decode_step(p, cfg, t, c, i,
                                                    mesh=mesh))
    logits = []
    start = int(inp["decode_start"])
    for s, tok in enumerate(inp["decode_tokens"]):
        tok = jax.device_put(jnp.asarray(tok), NamedSharding(mesh, dspec))
        lg, cache = dec(params, tok, cache, jnp.int32(start + s))
        logits.append(np.asarray(lg))
    out[f"{tag}/decode"] = np.stack(logits)
    out[f"{tag}/cache_k"] = np.asarray(cache["k"])
    batch = {"tokens": tokens, "labels": labels}
    train = lm_family._make_train(cfg, mesh)
    grad = jax.grad(lambda p, b: lm.lm_loss(p, cfg, b, mesh=mesh)[0])
    step = jax.jit(lambda p, o, b: (grad(p, b),) + train(p, o, b))
    opt_specs = opt_spec_tree(specs)
    opt = optim.adam_init(params)
    opt["count"] = jnp.asarray(inp["opt_count"], jnp.int32)
    opt = _put(opt, opt_specs, mesh)
    losses, norms, auxes = [], [], []
    for i in range(2):
        g, params, opt, m = step(params, opt, batch)
        if i == 0:
            _flatten(g, f"{tag}/grad/", out)
        # back on the input placement: the next call reuses the compile
        params, opt = _put(params, specs, mesh), _put(opt, opt_specs, mesh)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        auxes.append(float(m["moe_aux"]))
    out[f"{tag}/losses"] = np.array(losses)
    out[f"{tag}/grad_norms"] = np.array(norms)
    out[f"{tag}/moe_aux"] = np.array(auxes)
    _flatten(params, f"{tag}/params/", out)
    for k in "mv":
        _flatten(opt[k], f"{tag}/{k}/", out)


def run_moe(inp, mesh, out, tag):
    p = _unflatten(inp, "moe/p/")
    x = jnp.asarray(inp["moe/x"])
    w = jnp.asarray(inp["moe/w"])
    p = _put(p, {"router": P(), "w1": P("model", None, None),
                 "w2": P("model", None, None),
                 "w3": P("model", None, None)}, mesh)
    x = jax.device_put(x, NamedSharding(mesh, P(shx.data_spec(mesh)[0],
                                                 None, None)))

    def f(p, x):
        y, aux = moe_ep(p, x, MOE_CFG, mesh)
        return (y * w).sum() + 10.0 * aux, (y, aux)

    (_, (y, aux)), g = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, x)
    out[f"{tag}/moe/y"] = np.asarray(y)
    out[f"{tag}/moe/aux"] = np.asarray(aux)
    _flatten(g[0], f"{tag}/moe/grad/", out)
    out[f"{tag}/moe/grad_x"] = np.asarray(g[1])


def main(src, dst, meshes=tuple(MESHES)):
    inp = dict(np.load(src))
    out = {}
    for mname in meshes:
        if mname in HEADS_MESHES:
            mesh = heads_mesh(mname)
            for name in HEADS:
                run_config(name, heads_config(CONFIGS[name]), inp, mesh,
                           out, f"{mname}/{name}")
            continue
        n, model = MESHES[mname]
        mesh = make_mesh_for(n, model=model)
        for name, cfg in CONFIGS.items():
            run_config(name, mesh_config(cfg), inp, mesh, out,
                       f"{mname}/{name}")
        run_moe(inp, mesh, out, mname)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], tuple(sys.argv[3:]) or tuple(MESHES))
