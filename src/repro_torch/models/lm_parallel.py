"""The LM family on a (data, model) mesh: tensor parallelism and FSDP by
``lm_rules``, the port's counterpart of what GSPMD does for the JAX
package's ``models/lm.py`` when its entry points take ``mesh=``.

Placement (``param_specs``, ``place_params``): every leaf by
``distributed.sharding.lm_rules(fsdp)``. q, k, v (and their biases),
gate and up are column-parallel over ``model``, o and down row-parallel;
the MoE experts ``w1``/``w3``/``w2`` are cut over ``model`` on the expert
axis; the embedding table by vocabulary rows and the head by vocabulary
columns; norms and the router are whole. With FSDP the d_model dim of
every weight is also cut over ``data`` (ZeRO-3). Every data-sharded dim
of the table is d_model, so FSDP is on exactly where ``fsdp`` and D |
d_model (the JAX package's ``guard_divisible`` replicates a dim that
does not divide); a reader finds it from q's first dim (``fsdp_on``).

The model axis is held to whole heads: M must divide ``n_heads`` and
``n_kv`` (ChatGLM3-6B's ``n_kv=2`` allows M <= 2), the vocabulary, the
FFN width and the expert count, and ``check_tp`` raises otherwise, with
the reason. JAX's ``guard_divisible`` would shard k and v's columns at M
= 16 > n_kv = 8, where GSPMD splits a head; a rank of the port holds
whole heads, and replicating KV heads is not ported.

The forward (``models/lm.py`` with ``mesh=``) follows Megatron:

- each layer's FSDP blocks are gathered over ``data`` just before the
  layer (``gather_fsdp``, inside the layer's checkpoint, so remat gathers
  them again in the backward, whose reduce-scatter sums their gradients
  over ``data``);
- the normed input of attention and of the FFN enters its column blocks
  through ``copy_to`` (f); the row blocks' partial outputs are summed by
  ``reduce_from`` (g), and the o bias is added once, after the sum; a
  whole weight that acts on a rank's heads only (qk-norm's scales, the
  MoE router's gates) is read through ``copy_to`` too, so its gradient
  parts are summed;
- the embedding is vocab-parallel (``embed_vp``: a masked lookup of the
  rank's rows, then a sum over ``model``; under FSDP the looked-up rows'
  columns are joined over ``data``, never the table); the head
  column-parallel (``head_logits``: under FSDP, where the data ranks'
  rows are fewer than d_model, the rows are gathered over ``data`` and
  the partial logits summed, never the head; else the head is gathered),
  its cross entropy vocab-parallel (``nll_vp``); prefill and decode take
  the last position's logits and gather them over ``model``, so every
  rank returns its batch block's [B / D, V];
- an MoE layer runs ``nn.moe_ep_partial`` on the rank's experts, and the
  shared expert's partial output joins the same sum over ``model``.

Batches: the entry points take the whole batch and each rank reads its
block over ``data`` (``data_block``; the whole batch where D does not
divide it, as JAX's guard replicates it). The decode cache is the rank's
block by ``lm_batch_specs``: [L, B / D, S, Hkv / M, hd].

The gradient convention: each rank differentiates the global loss
through ``reduce_from``s whose backward is the identity, so its gradients
are its own part's; a leaf whole over ``data`` is then summed over
``data`` (``optim.adam``'s mesh step), an FSDP leaf arrives summed by
its gather's reduce-scatter, and a leaf whole over ``model`` needs no
sum (its gradient is computed alike on every model rank).

``constrain`` stays the identity: the JAX cells' ``"residual"`` spec
(Megatron sequence parallelism) changes memory per rank, not the
function.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import sharding as shx
from repro_torch.distributed.collectives import (all_gather, all_reduce,
                                                 copy_to, gather_tree,
                                                 gather_weight, owned_rows,
                                                 reduce_from,
                                                 reduce_scatter_grad)

MODEL, DATA = "model", "data"


def check_tp(cfg, mesh):
    """Raise unless the model axis divides every width it cuts."""
    M = mesh.size(MODEL)
    if M == 1:
        return
    widths = {"n_heads": cfg.n_heads, "n_kv": cfg.n_kv, "vocab": cfg.vocab}
    if cfg.is_moe:
        widths["n_experts"] = cfg.n_experts
        if cfg.n_shared_experts:
            widths["shared d_ff"] = cfg.d_ff * cfg.n_shared_experts
    else:
        widths["d_ff"] = cfg.d_ff
    for name, n in widths.items():
        if n % M:
            why = (" (a rank holds whole KV heads; the JAX package's "
                   "guard_divisible would cut k and v's columns and split "
                   "a head, which the port does not)" if name == "n_kv"
                   else "")
            raise ValueError(f"{cfg.name}: tensor parallelism over "
                             f"model={M} needs M to divide {name}={n}{why}")


def fsdp_on(params, cfg, mesh) -> bool:
    """Whether ``params`` hold FSDP blocks (q's d_model dim cut over
    data)."""
    return (mesh.size(DATA) > 1
            and params["layers"][0]["attn"]["q"]["w"].shape[0]
            != cfg.d_model)


def param_specs(tree, cfg, mesh, fsdp: bool = True, prefix=()):
    """The Spec of every leaf of an LM parameter tree (or of its subtree at
    ``prefix``, e.g. ``("layers", 3)``) by ``lm_rules``: FSDP where
    ``fsdp`` and D divides d_model."""
    check_tp(cfg, mesh)
    on = fsdp and cfg.d_model % mesh.size(DATA) == 0
    return shx.spec_tree(tree, shx.lm_rules(on), prefix=prefix)


def specs_by_path(params, cfg, mesh) -> dict:
    """{path: Spec} of placed ``params``, paths as ``optim.adam.leaves``
    writes them (``layers/0/attn/q/w``)."""
    out = {}

    def note(path, spec):
        out["/".join(str(p) for p in path)] = spec

    shx._map(note, param_specs(params, cfg, mesh, fsdp_on(params, cfg, mesh)))
    return out


def place_params(tree, cfg, mesh, fsdp: bool = True, prefix=()):
    """This rank's blocks of a whole LM parameter tree (or subtree at
    ``prefix``), each a tensor of its own."""
    return shx.place(tree, param_specs(tree, cfg, mesh, fsdp, prefix), mesh)


def unplace_params(blocks, cfg, mesh):
    """The whole tree from every rank's blocks (``place_params``'
    inverse): each leaf all-gathered over each axis its spec names, on
    every rank. A check's and a checkpoint's read, not a step's."""
    return gather_tree(blocks, param_specs(blocks, cfg, mesh,
                                           fsdp_on(blocks, cfg, mesh)), mesh)


def gather_fsdp(tree, specs, mesh):
    """``tree``'s leaves whole over ``data``: each leaf whose spec (from
    ``param_specs`` with ``fsdp_on``) names ``data`` gathered along that
    dim (``gather_weight``), the rest as they are."""
    if mesh.size(DATA) == 1:
        return tree
    return shx.tree_map(
        lambda spec, leaf: gather_weight(leaf, mesh, spec.index(DATA))
        if DATA in spec else leaf, specs, tree)


def attn_in_region(attn: dict, mesh) -> dict:
    """A layer's attention weights as a model rank reads them: qk-norm's
    scales are whole but act on the rank's heads only, so each rank's
    gradient of them is a part; they are read through ``copy_to``, which
    sums those parts over ``model``."""
    if "q_norm" not in attn or mesh.size(MODEL) == 1:
        return attn
    return dict(attn, **{k: {"scale": copy_to(attn[k]["scale"], mesh,
                                                MODEL)}
                         for k in ("q_norm", "k_norm")})


def local_attn_cfg(acfg, mesh):
    """The attention config of a model rank's heads."""
    M = mesh.size(MODEL)
    return dataclasses.replace(acfg, n_heads=acfg.n_heads // M,
                               n_kv=acfg.n_kv // M)


def data_block(t, mesh):
    """(this rank's block of ``t`` along dim 0 over ``data``, split): the
    whole ``t``, split False, where D does not divide its batch (the JAX
    package's ``guard_divisible`` replicates it; every data rank then
    computes the whole batch)."""
    D = mesh.size(DATA)
    if D == 1 or t.shape[0] % D:
        return t, D == 1
    n = t.shape[0] // D
    i = mesh.index(DATA)
    return t[i * n:(i + 1) * n], True


def embed_vp(table, ids, mesh, dtype=None, fsdp: bool = False):
    """Vocab-parallel lookup: ``table`` is this rank's V/M rows; rows it
    does not hold read 0, and the sum over ``model`` gives every rank the
    whole lookup (cast to ``dtype``).

    With ``fsdp`` the table is this rank's [V/M, d/D] block, and no rank
    gathers it: the data ranks' ids are gathered, each rank looks them
    all up in its d columns, ``gather_weight`` joins the rows' columns
    over ``data`` (its backward sums the rows' gradients over ``data`` and
    keeps the rank's columns), and the rank keeps its own ids' rows: the
    bytes of the looked-up rows cross the data axis, not the table's."""
    if fsdp and mesh.size(DATA) > 1:
        n, i = ids.shape[0], mesh.index(DATA)
        every = all_gather(ids.contiguous(), mesh, DATA)
        rows = gather_weight(owned_rows(table, every, mesh, dtype=dtype),
                             mesh, dim=-1)[i * n:(i + 1) * n]
    else:
        rows = owned_rows(table, ids, mesh, dtype=dtype)
    return reduce_from(rows, mesh, MODEL)


def head_logits(w, x, mesh, dtype=None, fsdp: bool = False):
    """Logits of rows x [..., d] (whole over ``model``) on this model
    rank's vocabulary columns, [..., V/M]. With ``fsdp``, ``w`` is the
    rank's [d/D, V/M] block and no rank gathers it: the data ranks' rows
    are gathered (``gather_weight`` on the rows: backward, their
    gradients summed over ``data``), each rank multiplies its d rows of
    the head, and the partial logits are summed over ``data``, each rank
    keeping its own rows' (``reduce_scatter_grad``: backward, the
    logits' gradients joined, so each rank's head block takes every
    data rank's rows' gradient). The bytes of the rows and their logits
    cross the data axis, not the head's: the cheaper where the data
    ranks' rows are fewer than d_model (``head_by_rows``)."""
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    if not (fsdp and mesh.size(DATA) > 1):
        return cast(x) @ cast(w)
    shape, d = x.shape, x.shape[-1]
    i, dl = mesh.index(DATA), w.shape[0]
    every = gather_weight(x.reshape(-1, d), mesh, dim=0)
    part = cast(every[:, i * dl:(i + 1) * dl]) @ cast(w)
    return reduce_scatter_grad(part, mesh, DATA).reshape(
        *shape[:-1], part.shape[-1])


def head_by_rows(rows: int, cfg, mesh, fsdp: bool) -> bool:
    """Whether ``head_logits``' row path moves fewer bytes than gathering
    the head: FSDP on, and the data ranks' ``rows`` fewer than d_model."""
    return fsdp and mesh.size(DATA) > 1 and \
        rows * mesh.size(DATA) < cfg.d_model


def nll_vp(logits, labels, mesh):
    """The cross entropy over a vocabulary cut into the model ranks'
    column blocks: ``logits`` [..., V/M] this rank's columns (whole rows),
    labels ints (negative = ignore) -> (nll_sum f32, count), the same on
    every model rank. The max and the sum of exponentials are reduced
    over ``model``; the label's logit comes from the rank that holds it.
    The JAX package's ``log_softmax`` in f32, rearranged: lse + max -
    logit."""
    logits = logits.float()
    Vl = logits.shape[-1]
    gmax = all_reduce(logits.detach().amax(-1).contiguous(), mesh, "max",
                      axis=MODEL)
    sumexp = reduce_from(torch.exp(logits - gmax[..., None]).sum(-1), mesh,
                         MODEL)
    valid = labels >= 0
    local = torch.where(valid, labels, 0).long() - mesh.index(MODEL) * Vl
    own = (local >= 0) & (local < Vl)
    target = logits.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    target = reduce_from(torch.where(own, target, target.new_zeros(())),
                         mesh, MODEL)
    nll = torch.log(sumexp) + gmax - target
    return (nll * valid).sum(), valid.sum()
