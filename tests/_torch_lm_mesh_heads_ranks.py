"""What each rank of ``tests/test_torch_lm_mesh_heads.py`` runs
(``launch.mesh.run_on_mesh`` pickles these functions by name, so they
live in a module of their own that imports torch and the port, never
JAX).

One group of 4 CPU ranks runs every case on a (data=1, model=4) mesh and
on a (pod=2, data=1, model=2) one (``submesh``): the reduced Qwen3-14B,
ChatGLM3-6B and Scout at ``heads_config``'s head counts, prefill, 4
decode steps, the loss's gradient and 2 train steps, each through the
registry's ``Cell.make_fn(device="cpu", mesh=)``. On (1, 4), where each
KV head is replicated over 2 model ranks, two controls: the gradient
without the sum over the ranks that share a KV head
(``lm_parallel.kv_in_region`` made the identity), and 2 train steps
whose clip counts each replica of a KV head's block
(``optim.adam.replica_mask`` without the owner rule).
"""
import dataclasses

import torch

import _torch_lm_mesh_ranks as base
from repro_torch import bridge, optim
from repro_torch.configs import lm_family
from repro_torch.distributed import sharding as shx
from repro_torch.launch.mesh import submesh
from repro_torch.models import lm, lm_parallel
from repro_torch.optim.adam import leaves

MESHES = {"1x4": (1, 1, 4), "2x1x2": (2, 1, 2)}     # (pod, data, model)
# name -> (n_heads, n_kv): the JAX reference's HEADS
HEADS = {"qwen3-14b": (6, 2), "chatglm3-6b": (4, 2),
         "llama4-scout-17b-a16e": (6, 2)}
NAMES = tuple(HEADS)
OPT_COUNT = base.OPT_COUNT


def heads_config(name):
    """The JAX reference's config (``_jax_lm_mesh_ref.heads_config``):
    ``mesh_config`` at ``HEADS``' head counts."""
    n_heads, n_kv = HEADS[name]
    return dataclasses.replace(base.mesh_config(name), n_heads=n_heads,
                               n_kv=n_kv)


def cache_block(cache: dict, cfg, mesh) -> dict:
    """This rank's block of a whole decode cache ({k, v} [L, B, S, Hkv,
    hd]): the batch over the data axes as ``lm_parallel.data_block`` cuts
    it, the rank's KV heads by the head plan (a replicated head on each
    rank that shares it); ``lm.init_cache(mesh=)`` gives its shape."""
    D = mesh.size(shx.DATA_AXES)
    lo, hi = lm_parallel.plan_of(cfg, mesh).kv[mesh.index("model")]

    def block(t):
        B = t.shape[1]
        if D > 1 and B % D == 0:
            n, i = B // D, mesh.index(shx.DATA_AXES)
            t = t[:, i * n:(i + 1) * n]
        return t[:, :, :, lo:hi].clone()

    return {k: block(t) for k, t in cache.items()}


def _grads(params, cfg, batch, mesh) -> dict:
    """The loss's gradient, summed as the train step sums it, whole."""
    flat_p = [p.requires_grad_() for _, p in leaves(params)]
    loss, _ = lm.lm_loss(params, cfg, batch, mesh=mesh)
    grads = torch.autograd.grad(loss, flat_p)
    spec_of = lm_parallel.specs_by_path(params, cfg, mesh)
    grads = optim.adam.sync_grads(
        grads, flat_p, [spec_of[p] for p, _ in leaves(params)], mesh)
    for p in flat_p:
        p.requires_grad_(False)
    return base.flat(lm_parallel.unplace_params(
        optim.adam.unflatten(params, grads), cfg, mesh))


def _each_replica(specs, mesh):
    """``replica_mask`` that counts every replica of a ``Blocks`` cut's
    block (the clip's control)."""
    return [all(mesh.index(a) == 0 for a in mesh.axis_names
                if a not in optim.adam._axes_of(s)) for s in specs]


def run_config(inp, name, mesh):
    cfg = heads_config(name)
    cells = lm_family.lm_arch(cfg).cells
    whole = base.bridged(inp, name)

    def placed():
        return bridge.lm_params_from_jax(
            base.unflatten(inp, f"{name}/p/"), cfg, mesh, device="cpu")

    params = placed()
    out = {"round_trip": all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves(lm_parallel.unplace_params(params, cfg, mesh)),
        leaves(whole)))}
    out["block_shapes"] = {p: tuple(t.shape) for p, t in leaves(params)}
    out["local_heads"] = (lm_parallel.local_attn_cfg(cfg.attn_cfg(), mesh)
                          .n_heads)
    tokens, labels = base._t(inp["tokens"]), base._t(inp["labels"])
    out["prefill"] = cells["prefill_32k"].make_fn(
        device="cpu", mesh=mesh)(params, tokens)
    cache = cache_block(
        {k: base._t(inp[f"{name}/cache/{k}"]) for k in "kv"}, cfg, mesh)
    like = lm.init_cache(cfg, tokens.shape[0], cache["k"].shape[2],
                         torch.float32, device="cpu", mesh=mesh)
    out["cache_shape_ok"] = all(like[k].shape == cache[k].shape
                                for k in "kv")
    dec = cells["decode_32k"].make_fn(device="cpu", mesh=mesh)
    logits = []
    for s, tok in enumerate(inp["decode_tokens"]):
        lg, cache = dec(params, base._t(tok), cache,
                        int(inp["decode_start"]) + s)
        logits.append(lg)
    out["decode"] = torch.stack(logits)
    out["cache_k"] = cache["k"]
    batch = {"tokens": tokens, "labels": labels}
    out["grad"] = _grads(params, cfg, batch, mesh)
    step = cells["train_4k"].make_fn(device="cpu", mesh=mesh)
    out.update(base.train(step, params, batch, cfg, mesh))
    # the KV blocks of the ranks that share a head after the steps
    out["kv_blocks"] = {p: t.clone() for p, t in leaves(params)
                        if "/attn/k/" in p or "/attn/v/" in p}
    if lm_parallel.plan_of(cfg, mesh).R > 1:
        real_kv = lm_parallel.kv_in_region
        lm_parallel.kv_in_region = lambda attn, mesh, R: attn
        try:
            out["no_kv_sum_grad"] = _grads(placed(), cfg, batch, mesh)
        finally:
            lm_parallel.kv_in_region = real_kv
        real_mask = optim.adam.replica_mask
        optim.adam.replica_mask = _each_replica
        try:
            out["clip_each_replica"] = base.train(step, placed(), batch,
                                                  cfg, mesh)
        finally:
            optim.adam.replica_mask = real_mask
    return out


def heads_cases(world, inp):
    """Every case on both meshes."""
    out = {"rank": world.rank}
    for mname, (pod, data, model) in MESHES.items():
        mesh = submesh(world, data=data, model=model, pod=pod)
        out[mname] = {"index": {a: mesh.index(a) for a in mesh.axis_names},
                      "data_block": mesh.index(shx.DATA_AXES)}
        for name in NAMES:
            out[mname][name] = run_config(inp, name, mesh)
    return out
