"""What each rank of ``tests/test_torch_recsys_mesh.py`` runs (``launch.
mesh.run_on_mesh`` pickles these functions by name, so they live in a
module of their own that imports torch and the port, never JAX), the
inputs both packages read (``inputs``) and the port's one-process
reference (``one_process``); ``tests/test_torch_gpu.py`` runs the same
cases on the card.

One group of 4 ranks runs every case on a (data=1, model=2) mesh (the
world cut in two, ``submesh``) and on a (data=2, model=2) one: the four
reduced recsys configs' serve, the loss's gradient, 2 train steps and
retrieval, each through the registry's ``Cell.make_fn(device=, mesh=)``;
BERT4Rec's ``serve_sharded`` at a row chunk below the rank's batch; and
the controls: the steps without ``sync_grads``, BERT4Rec's gradient
without ``copy_to``, the CTR forward with another rank's slots weighted.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge, optim
from repro_torch.configs import recsys_family as rf
from repro_torch.configs.base import abstract_params
from repro_torch.kernels import ops
from repro_torch.launch.mesh import submesh
from repro_torch.models.recsys import bert4rec, ctr
from repro_torch.models.recsys import parallel as rp
from repro_torch.optim.adam import leaves

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
NAMES = ("wide-deep", "dlrm-rm2", "dcn-v2", "bert4rec")
CTR_NAMES = NAMES[:3]
B4R_ITEMS = 3000
# the configs whose 2 steps on (2, 2) also run without ``sync_grads``
NO_SYNC = ("dlrm-rm2", "bert4rec")
# the microbatches of the accumulated BERT4Rec step
ACCUM = 2
B, N_CAND, ROW_CHUNK = 8, 512, 2


def mesh_config(name):
    """The JAX reference's config (``_jax_recsys_mesh_ref.mesh_config``):
    ``reduced_ctr`` / ``reduced_b4r``, BERT4Rec at 3,000 items so that
    its 4,096-row table holds items in both model blocks."""
    cfg = rf.CONFIGS[name]
    if name == "bert4rec":
        return dataclasses.replace(rf.reduced_b4r(cfg), n_items=B4R_ITEMS)
    return rf.reduced_ctr(cfg)


def unflatten(flat: dict, prefix: str):
    """The tree under ``prefix``; a node whose keys are all digits is a
    list (the JAX layout's list nodes)."""
    tree = {}
    for key, arr in flat.items():
        if key.startswith(prefix):
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


def _param(rng, key, shape):
    """A weight drawn for ``key``: tables N(0, 0.05), norm scales 1 +
    N(0, 0.1), biases N(0, 0.01), matrices N(0, 1 / fan_in)."""
    if key.endswith(("fused", "table")):
        return rng.normal(0, 0.05, shape)
    if key.endswith("scale"):
        return 1 + rng.normal(0, 0.1, shape)
    if len(shape) == 1:
        return rng.normal(0, 0.01, shape)
    return rng.normal(0, shape[0] ** -0.5, shape)


def inputs(seed=0) -> dict:
    """Every input, drawn with numpy: each config's parameters (the
    layout of its ``init``, list nodes as their indices: JAX's), a batch
    of B (CTR: weights with padded slots, labels, dense features;
    BERT4Rec: padded sequences with masked positions, some masked
    positions invalid, negatives), the retrieval candidates."""
    rng = np.random.default_rng(seed)
    inp = {"row_chunk": np.int32(ROW_CHUNK)}
    for name in NAMES:
        cfg = mesh_config(name)
        shapes = abstract_params(lambda g: rf._init(cfg)(g, cfg))
        for key, leaf in leaves(shapes):
            inp[f"{name}/p/{key}"] = _param(rng, key, tuple(
                leaf.shape)).astype(np.float32)
        b = f"{name}/b/"
        if name == "bert4rec":
            S, m, V = cfg.seq_len, cfg.n_mask, cfg.n_items
            tok = rng.integers(1, V, (B, S)).astype(np.int32)
            lengths = rng.integers(S // 2, S + 1, B)
            mask_pos = np.stack([rng.choice(n, m, replace=False)
                                 for n in lengths]).astype(np.int32)
            for i, n in enumerate(lengths):
                tok[i, n:] = 0
                tok[i, mask_pos[i]] = cfg.mask_token
            valid = rng.random((B, m)) < 0.8
            valid[:, 0] = True
            inp.update({b + "tokens": tok, b + "mask_pos": mask_pos,
                        b + "labels": rng.integers(1, V, (B, m)).astype(
                            np.int32),
                        b + "mask_valid": valid,
                        b + "neg": rng.integers(1, V, (B, m, cfg.n_neg))
                        .astype(np.int32)})
            # distinct ids: a repeated id would tie with itself, and
            # either package could return either of its positions
            inp[f"{name}/cand"] = rng.choice(V, N_CAND, replace=False).astype(
                np.int32)
        else:
            F, nnz = cfg.sparse.n_fields, cfg.sparse.nnz
            w = rng.uniform(0.5, 1.5, (B, F, nnz)).astype(np.float32)
            w[rng.random((B, F, nnz)) < 0.2] = 0.0        # padded slots
            inp.update({b + "sparse_idx": rng.integers(0, 97, (B, F, nnz))
                        .astype(np.int32), b + "sparse_w": w,
                        b + "label": (rng.random(B) < 0.5).astype(
                            np.float32)})
            if cfg.n_dense:
                inp[b + "dense"] = rng.normal(0, 1, (B, cfg.n_dense)).astype(
                    np.float32)
            inp[f"{name}/cand"] = rng.normal(0, 1, (
                N_CAND, rf.ctr_repr_dim(cfg))).astype(np.float32)
    return inp


def bridged(inp, name, device="cpu"):
    """The config's parameters in the port's layout, on ``device``."""
    return bridge.params_from_jax(unflatten(inp, f"{name}/p/"), device=device)


def batch(inp, name, device="cpu") -> dict:
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in unflatten(inp, f"{name}/b/").items()}


def serve_batch(inp, name, device="cpu") -> dict:
    b = batch(inp, name, device)
    return ({"tokens": b["tokens"]} if name == "bert4rec" else
            {k: v for k, v in b.items() if k != "label"})


def query(inp, name, device="cpu") -> dict:
    """The retrieval query: the batch's first row (the serve keys)."""
    return {k: v[:1] for k, v in serve_batch(inp, name, device).items()}


def cand(inp, name, device="cpu"):
    return torch.as_tensor(inp[f"{name}/cand"], device=device)


def flat(tree) -> dict:
    return {p: t.detach().cpu().numpy().copy() for p, t in leaves(tree)}


def loss_fn(cfg):
    mod = bert4rec if isinstance(cfg, rf.bert4rec.Bert4RecConfig) else ctr
    return lambda p, b, mesh=None: mod.loss(p, cfg, b, mesh=mesh)


def grads(params, cfg, b, mesh) -> dict:
    """The loss's gradient, summed over ``data`` as the train step sums
    it, gathered whole."""
    flat_p = [p.requires_grad_() for _, p in leaves(params)]
    loss, _ = loss_fn(cfg)(params, b, mesh)
    g = torch.autograd.grad(loss, flat_p)
    spec_of = rp.specs_by_path(params, mesh)
    g = optim.adam.sync_grads(g, flat_p, [spec_of[p] for p, _ in
                                          leaves(params)], mesh)
    for p in flat_p:
        p.requires_grad_(False)
    return flat(rp.unplace_params(optim.adam.unflatten(params, g), mesh))


def train(step, params, b, mesh) -> dict:
    """2 steps from a fresh Adam state: losses, grad norms, the parameters
    and both moments after them, gathered whole."""
    opt = rf.place_opt(optim.adam_init(rp.unplace_params(params, mesh)),
                       mesh)
    out = {"losses": [], "grad_norms": []}
    for _ in range(2):
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = flat(rp.unplace_params(params, mesh))
    for k in "mv":
        out[k] = flat(rp.unplace_params(opt[k], mesh))
    return out


LOCAL_SLOTS = rp.local_slots


def weighted_foreign_slots(shifted, weights, rows, mesh):
    """``parallel.local_slots`` with the slots another rank holds keeping
    their weights (a control: every rank's bag then adds rows it does not
    own)."""
    idx, _ = LOCAL_SLOTS(shifted, weights, rows, mesh)
    return idx, (torch.ones(shifted.shape, device=shifted.device)
                 if weights is None else weights)


def run_config(inp, name, mesh, device="cpu"):
    cfg = mesh_config(name)
    cells = rf.recsys_arch(cfg).cells
    whole = bridged(inp, name, device)
    params = rf.place_params(whole, mesh)
    out = {"round_trip": all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves(rp.unplace_params(params, mesh)), leaves(whole))),
        "block_shapes": {p: tuple(t.shape) for p, t in leaves(params)}}
    b, sb = batch(inp, name, device), serve_batch(inp, name, device)
    ops.reset_launch_counts()
    bags = {"n": 0}
    real_bag = ops.embedding_bag

    def spy(*a):
        bags["n"] += 1
        return real_bag(*a)

    ops.embedding_bag = spy
    try:
        res = cells["serve_p99"].make_fn(device=device, mesh=mesh)(params,
                                                                   sb)
    finally:
        ops.embedding_bag = real_bag
    out["serve_bags"] = bags["n"]
    if name == "bert4rec":
        out["serve_vals"], out["serve_ids"] = res
        out["chunked_vals"], out["chunked_ids"] = bert4rec.serve_sharded(
            params, cfg, sb, mesh, k=100, row_chunk=int(inp["row_chunk"]))
    else:
        out["logits"] = res
    out["retr_vals"], out["retr_ids"] = cells["retrieval_cand"].make_fn(
        device=device, mesh=mesh)(params, query(inp, name, device),
                                  cand(inp, name, device))
    out["grad"] = grads(params, cfg, b, mesh)
    step = cells["train_batch"].make_fn(device=device, mesh=mesh)
    out.update(train(step, params, b, mesh))
    out["launches"] = ops.launch_counts()
    spec_of = rp.specs_by_path(params, mesh)
    out["whole_over_data"] = sorted(spec_of)
    if mesh.size("data") > 1 and name in NO_SYNC:
        real = optim.adam.sync_grads
        optim.adam.sync_grads = lambda grads, *_: grads
        try:
            out["no_sync_params"] = train(step, rf.place_params(
                bridged(inp, name, device), mesh), b, mesh)["params"]
        finally:
            optim.adam.sync_grads = real
    fresh = rf.place_params(bridged(inp, name, device), mesh)
    if name == "bert4rec":
        real = bert4rec.copy_to
        bert4rec.copy_to = lambda x, *a, **k: x
        try:
            out["no_copy_to_grad"] = grads(fresh, cfg, b, mesh)
        finally:
            bert4rec.copy_to = real
        accum = optim.make_train_step(
            lambda p, bb: bert4rec.loss(p, cfg, bb, mesh=mesh),
            dataclasses.replace(rf.RS_OPT, accum_steps=ACCUM), mesh=mesh,
            specs=lambda p: rp.specs_by_path(p, mesh))
        p, _, m = accum(fresh, rf.place_opt(optim.adam_init(
            bridged(inp, name, device)), mesh), b)
        out["accum_loss"] = float(m["loss"])
        out["accum_params"] = flat(rp.unplace_params(p, mesh))
    else:
        serve = cells["serve_p99"].make_fn(device=device, mesh=mesh)
        real = rp.local_slots
        rp.local_slots = weighted_foreign_slots
        try:
            out["weighted_foreign_logits"] = serve(fresh, sb)
        finally:
            rp.local_slots = real
        out["edge_logits"] = serve(fresh, edge_batch(sb))
    return out


def edge_batch(sb: dict) -> dict:
    """The serve batch with row 0's first slot out of the whole table (an
    index past the padded rows) and row 1's first slot -1 (the table's
    last row, a pad row, which the last model rank holds)."""
    sb = {k: v.clone() for k, v in sb.items()}
    sb["sparse_idx"][0, 0, 0] = 10 ** 6
    sb["sparse_idx"][1, 0, 0] = -1
    return sb


def recsys_mesh_cases(world, inp, device="cpu"):
    """Every case on both meshes (on ``device``: the CPU, or the rank's
    card)."""
    out = {"rank": world.rank}
    for mname, (data, model) in MESHES.items():
        mesh = submesh(world, data=data, model=model)
        out[mname] = {"index": {a: mesh.index(a) for a in
                                ("data", "model")}}
        for name in NAMES:
            out[mname][name] = run_config(inp, name, mesh, device)
    return out


def one_process(inp, name, device="cpu") -> dict:
    """The port's one-process serve, retrieval, gradient and train steps
    (and the edge batch's and the accumulated step's references)."""
    cfg = mesh_config(name)
    out = {}
    params = bridged(inp, name, device)
    b, sb = batch(inp, name, device), serve_batch(inp, name, device)
    serve = rf.make_fn(cfg, "serve", device=device)
    if name == "bert4rec":
        out["serve_vals"], out["serve_ids"] = serve(params, sb)
    else:
        out["logits"] = serve(params, sb)
        out["edge_logits"] = serve(params, edge_batch(sb))
    out["retr_vals"], out["retr_ids"] = rf.make_fn(
        cfg, "retrieval", device=device)(params, query(inp, name, device),
                                         cand(inp, name, device))
    flat_p = [p.requires_grad_() for _, p in leaves(params)]
    g = torch.autograd.grad(loss_fn(cfg)(params, b)[0], flat_p)
    out["grad"] = {p: t.cpu().numpy() for (p, _), t in zip(leaves(params),
                                                            g)}
    for p in flat_p:
        p.requires_grad_(False)
    step, opt = rf.make_fn(cfg, "train", device=device), optim.adam_init(
        params)
    out["losses"] = []
    for _ in range(2):
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
    out["params"] = flat(params)
    for k in "mv":
        out[k] = flat(opt[k])
    if name == "bert4rec":
        p = bridged(inp, name, device)
        accum = optim.make_train_step(
            lambda pp, bb: bert4rec.loss(pp, cfg, bb),
            dataclasses.replace(rf.RS_OPT, accum_steps=ACCUM))
        p, _, m = accum(p, optim.adam_init(p), b)
        out["accum_loss"], out["accum_params"] = float(m["loss"]), flat(p)
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}
