"""What each rank of ``tests/test_torch_lm_mesh.py`` runs (``launch.mesh.
run_on_mesh`` pickles these functions by name, so they live in a module
of their own that imports torch and the port, never JAX).

One group of 4 CPU ranks runs every case on a (data=1, model=2) mesh (the
world cut in two, ``submesh``) and on a (data=2, model=2) one: the four
reduced LM configs' prefill, 4 decode steps, the loss's gradient and 2
train steps, each through the registry's ``Cell.make_fn(device="cpu",
mesh=)``; and ``nn.moe_ep`` on the overflow case.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge, nn, optim
from repro_torch.configs import lm_family
from repro_torch.distributed import sharding as shx
from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.launch.mesh import submesh
from repro_torch.models import lm, lm_parallel
from repro_torch.optim.adam import leaves

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
NAMES = ("qwen3-14b", "chatglm3-6b", "dbrx-132b", "llama4-scout-17b-a16e")
MOE_CFG = nn.MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2,
                       capacity_factor=0.5)
# the train steps start from Adam's count at the schedule's warm-up (200),
# where the learning rate is at its peak, 3e-4: each step moves a weight
# by ~1e-3, well above the tolerances (at count 0 the rate is 1.5e-6,
# below them)
OPT_COUNT = 200
# the configs whose 2 steps on (2, 2) also run without ``sync_grads`` (the
# control the parameter check must fail: the data replicas drift)
NO_SYNC = ("qwen3-14b", "dbrx-132b")


def mesh_config(name):
    """The JAX reference's config (``_jax_lm_mesh_ref.mesh_config``):
    ``reduced_lm``, the MoE two back on ``moe_impl="ep"``, Qwen3-14B with
    remat and a loss chunk of 8."""
    r = lm_family.reduced_lm(lm_family.CONFIGS[name])
    if r.is_moe:
        r = dataclasses.replace(r, moe_impl="ep")
    if name == "qwen3-14b":
        r = dataclasses.replace(r, remat=True, loss_chunk=8)
    return r


def unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, arr in flat.items():
        if key.startswith(prefix):
            node, parts = tree, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree


def bridged(inp, name):
    """The config's parameters in the port's layout, on the CPU."""
    return bridge.params_from_jax(unflatten(inp, f"{name}/p/"), device="cpu")


def flat(tree) -> dict:
    return {p: t.detach().numpy().copy() for p, t in leaves(tree)}


def _t(x):
    return torch.as_tensor(np.array(x))


def run_config(inp, name, mesh):
    cfg = mesh_config(name)
    cells = lm_family.lm_arch(cfg).cells
    whole = bridged(inp, name)
    params = bridge.lm_params_from_jax(unflatten(inp, f"{name}/p/"), cfg,
                                       mesh, device="cpu")
    out = {"round_trip": all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves(lm_parallel.unplace_params(params, cfg, mesh)),
        leaves(whole)))}
    tokens, labels = _t(inp["tokens"]), _t(inp["labels"])
    out["prefill"] = cells["prefill_32k"].make_fn(
        device="cpu", mesh=mesh)(params, tokens)
    with torch.no_grad():
        out["forward"] = lm.forward(params, cfg, tokens, mesh=mesh)[0]
    cache = shx.place({k: _t(inp[f"{name}/cache/{k}"]) for k in "kv"},
                      shx.lm_batch_specs(mesh, "decode")["cache"], mesh)
    dec = cells["decode_32k"].make_fn(device="cpu", mesh=mesh)
    logits = []
    for s, tok in enumerate(inp["decode_tokens"]):
        lg, cache = dec(params, _t(tok), cache, int(inp["decode_start"]) + s)
        logits.append(lg)
    out["decode"] = torch.stack(logits)
    out["cache_k"] = cache["k"]
    # the loss's gradient, summed as the train step sums it, then whole
    batch = {"tokens": tokens, "labels": labels}
    flat_p = [p.requires_grad_() for _, p in leaves(params)]
    loss, _ = lm.lm_loss(params, cfg, batch, mesh=mesh)
    grads = torch.autograd.grad(loss, flat_p)
    spec_of = lm_parallel.specs_by_path(params, cfg, mesh)
    grads = optim.adam.sync_grads(
        grads, flat_p, [spec_of[p] for p, _ in leaves(params)], mesh)
    for p in flat_p:
        p.requires_grad_(False)
    out["grad"] = flat(lm_parallel.unplace_params(
        optim.adam.unflatten(params, grads), cfg, mesh))
    step = cells["train_4k"].make_fn(device="cpu", mesh=mesh)
    out["block_shapes"] = {p: tuple(t.shape) for p, t in leaves(params)}
    out["whole_over_data"] = [p for p, spec in spec_of.items() if not any(
        e == "data" or (isinstance(e, tuple) and "data" in e)
        for e in spec)]
    out.update(train(step, params, batch, cfg, mesh))
    if mesh.size("data") > 1 and name in NO_SYNC:
        real = optim.adam.sync_grads
        optim.adam.sync_grads = lambda grads, *_: grads
        try:
            out["no_sync_params"] = train(step, bridge.lm_params_from_jax(
                unflatten(inp, f"{name}/p/"), cfg, mesh, device="cpu"),
                batch, cfg, mesh)["params"]
        finally:
            optim.adam.sync_grads = real
    return out


def train(step, params, batch, cfg, mesh) -> dict:
    """2 steps from Adam's state at OPT_COUNT: losses, grad norms, MoE
    balance losses, and the parameters and both moments after them,
    gathered whole."""
    opt = optim.adam_init(params)
    opt["count"].fill_(OPT_COUNT)
    out = {"losses": [], "grad_norms": [], "moe_aux": []}
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["moe_aux"].append(float(m["moe_aux"]))
    out["params"] = flat(lm_parallel.unplace_params(params, cfg, mesh))
    for k in "mv":
        out[k] = flat(lm_parallel.unplace_params(opt[k], cfg, mesh))
    return out


def short_grads(inp, mesh):
    """The reduced Qwen3-14B's loss and gradient on a short batch (2 x 8:
    the data ranks' rows fewer than d_model, so the head's row path runs
    in place of its gather), summed over ``data`` and gathered whole."""
    cfg = mesh_config("qwen3-14b")
    params = lm_family.place_params(bridged(inp, "qwen3-14b"), cfg, mesh)
    batch = {k: _t(inp[k])[:2, :8] for k in ("tokens", "labels")}
    flat_p = [p.requires_grad_() for _, p in leaves(params)]
    loss, _ = lm.lm_loss(params, cfg, batch, mesh=mesh)
    grads = torch.autograd.grad(loss, flat_p)
    spec_of = lm_parallel.specs_by_path(params, cfg, mesh)
    grads = optim.adam.sync_grads(
        grads, flat_p, [spec_of[p] for p, _ in leaves(params)], mesh)
    return {"loss": float(loss.detach()), "grad": flat(
        lm_parallel.unplace_params(optim.adam.unflatten(params, grads), cfg,
                                   mesh))}


def run_moe(inp, mesh):
    """``nn.moe_ep`` on the overflow case: this rank's y and x gradient
    blocks, aux, and the weights' gradients summed over ``data`` (each
    rank's are its shard's part), the experts' gathered over ``model``."""
    p = {k: _t(v) for k, v in unflatten(inp, "moe/p/").items()}
    E_l = MOE_CFG.n_experts // mesh.size("model")
    lo = mesh.index("model") * E_l
    local = {k: (v if k == "router" else v[lo:lo + E_l].clone())
             .requires_grad_() for k, v in p.items()}
    x, _ = lm_parallel.data_block(_t(inp["moe/x"]), mesh)
    w, _ = lm_parallel.data_block(_t(inp["moe/w"]), mesh)
    x = x.clone().requires_grad_()
    y, aux = nn.moe_ep(local, x, MOE_CFG, mesh)
    loss = (y * w).sum() + 10.0 * aux
    names = sorted(local)
    grads = torch.autograd.grad(loss, [local[k] for k in names] + [x])
    g = dict(zip(names, grads[:-1]))
    for k in names:
        g[k] = all_reduce(g[k].clone(), mesh, axis="data")
        if k != "router":
            g[k] = all_gather(g[k], mesh, "model")
    return {"y": y.detach(), "aux": float(aux.detach()), "grad": g,
            "grad_x": grads[-1]}


def lm_mesh_cases(world, inp):
    """Every case on both meshes; the MoE layers' calls of
    ``moe_ep_partial`` counted by config (a spy on ``models.lm``'s
    name)."""
    calls = {"n": 0}
    real = lm.moe_ep_partial

    def spy(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    lm.moe_ep_partial = spy
    out = {"rank": world.rank}
    try:
        for mname, (data, model) in MESHES.items():
            mesh = submesh(world, data=data, model=model)
            out[mname] = {"index": {a: mesh.index(a) for a in
                                    ("data", "model")}}
            for name in NAMES:
                calls["n"] = 0
                out[mname][name] = run_config(inp, name, mesh)
                out[mname][name]["moe_ep_calls"] = calls["n"]
            out[mname]["moe"] = run_moe(inp, mesh)
            out[mname]["short"] = short_grads(inp, mesh)
    finally:
        lm.moe_ep_partial = real
    return out
