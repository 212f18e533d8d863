"""The LM family on a (pod, data, model) mesh: tensor parallelism and FSDP by
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

The model axis cuts attention by a head plan (``head_plan``), never
inside a head. With G = n_heads / n_kv query heads a KV head and M model
ranks:

- M <= n_kv: M must divide n_kv, and rank m holds KV heads [m K/M,
  (m+1) K/M) and their G K/M query heads (the even cut);
- M > n_kv: M must be a multiple of n_kv. Each KV head is replicated over
  the R = M / n_kv consecutive model ranks that share it, and its G query
  heads are cut over those R ranks as evenly as whole heads allow, lower
  ranks first: Qwen3-14B and Scout at M = 16 hold 3, 2, 3, 2, ... query
  heads over one KV head; ChatGLM3-6B 2 (each KV head on 8 ranks);
  Qwen2-72B 4; DBRX 3.

Every rank's query heads are then a multiple of its KV heads (the flash
kernels' GQA). Where KV heads are replicated, ``param_specs`` writes
a ``sharding.Blocks`` entry for the leaves it touches: q's columns and
bias and o's rows by the rank's query heads, k's and v's columns and
biases by its KV head. The rest of the model axis keeps the even rule:
M must divide the vocabulary, the FFN width and the expert count
(``check_tp`` raises otherwise, with the reason, as it does for a model
axis the plan cannot place: M = 3 over n_kv = 2). The JAX package's
``guard_divisible`` keeps the cut on q, k, v and o wherever the column
count divides, and GSPMD splits heads mid-head: the same function.

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
  shared expert's partial output joins the same sum over ``model``;
- a replicated KV head's k and v weights and biases are read through
  ``copy_to`` over the ranks that share it (``kv_in_region``, over
  ``SubAxis("model", R)``): each rank's gradient of them is the part of
  its own query heads, and the sum over the R ranks is the head's.

Batches: the entry points take the whole batch and each rank reads its
block over the data axes, ``pod`` and ``data`` (``data_block``, the JAX
package's ``data_spec``; the whole batch where they do not divide it, as
JAX's guard replicates it). The decode cache is the rank's block by
``lm_batch_specs``: [L, B / (pod data), S, Hkv_rank, hd], Hkv_rank the
rank's KV heads (1 under replication). FSDP cuts over ``data`` alone:
the parameters are replicated over ``pod``.

The gradient convention: each rank differentiates the global loss
through ``reduce_from``s whose backward is the identity, so its gradients
are its own part's; a leaf whole over the data axes is then summed over
them (``optim.adam``'s mesh step; an FSDP leaf over ``pod``), an FSDP
leaf arrives summed over ``data`` by its gather's reduce-scatter, a
replicated KV head's by its ``copy_to``, and a leaf whole over ``model``
needs no sum (its gradient is computed alike on every model rank). The
clip counts a replicated block on its first rank only
(``optim.adam.replica_mask``).

``constrain`` stays the identity: the JAX cells' ``"residual"`` spec
(Megatron sequence parallelism) changes memory per rank, not the
function.
"""
from __future__ import annotations

import dataclasses
import functools
import re

import torch

from repro_torch.distributed import sharding as shx
from repro_torch.distributed.collectives import (all_gather, all_reduce,
                                                 copy_to, gather_tree,
                                                 gather_weight, owned_rows,
                                                 reduce_from,
                                                 reduce_scatter_grad)

MODEL, DATA = "model", "data"


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Each model rank's query and KV heads: ``q[m]`` and ``kv[m]`` are
    [start, stop) in heads for model index m; ``R`` ranks share a KV head
    (1 where M <= n_kv)."""
    q: tuple
    kv: tuple
    R: int


@functools.lru_cache(maxsize=None)
def head_plan(n_heads: int, n_kv: int, M: int) -> HeadPlan:
    """The head plan of ``n_heads`` query and ``n_kv`` KV heads over M
    model ranks (the module docstring's rule); raises where it cannot
    place them, with the reason."""
    if n_heads % n_kv:
        raise ValueError(f"{n_heads} query heads are no whole KV groups "
                         f"of {n_kv}")
    G = n_heads // n_kv
    if M <= n_kv:
        if n_kv % M:
            raise ValueError(f"model={M} must divide n_kv={n_kv} (M <= "
                             f"n_kv cuts whole KV heads evenly)")
        k = n_kv // M
        return HeadPlan(q=tuple((m * k * G, (m + 1) * k * G)
                                for m in range(M)),
                        kv=tuple((m * k, (m + 1) * k) for m in range(M)),
                        R=1)
    if M % n_kv:
        raise ValueError(f"model={M} must be a multiple of n_kv={n_kv} "
                         f"(M > n_kv replicates each KV head over M / n_kv "
                         f"ranks)")
    R = M // n_kv
    if G < R:
        raise ValueError(f"model={M} leaves ranks with no query head: "
                         f"{G} query heads a KV head over {R} ranks")
    base, extra = divmod(G, R)
    q, kv = [], []
    for m in range(M):
        g, j = divmod(m, R)
        lo = g * G + j * base + min(j, extra)
        q.append((lo, lo + base + (j < extra)))
        kv.append((g, g + 1))
    return HeadPlan(q=tuple(q), kv=tuple(kv), R=R)


def plan_of(cfg, mesh) -> HeadPlan:
    """``head_plan`` of ``cfg``'s heads on ``mesh``'s model axis."""
    return head_plan(cfg.n_heads, cfg.n_kv, mesh.size(MODEL))


def check_tp(cfg, mesh):
    """Raise unless the model axis can place ``cfg``: the head plan
    (``head_plan``), and M dividing every other width it cuts."""
    M = mesh.size(MODEL)
    if M == 1:
        return
    try:
        plan_of(cfg, mesh)
    except ValueError as e:
        raise ValueError(f"{cfg.name}: tensor parallelism over model={M}: "
                         f"{e}") from None
    widths = {"vocab": cfg.vocab}
    if cfg.is_moe:
        widths["n_experts"] = cfg.n_experts
        if cfg.n_shared_experts:
            widths["shared d_ff"] = cfg.d_ff * cfg.n_shared_experts
    else:
        widths["d_ff"] = cfg.d_ff
    for name, n in widths.items():
        if n % M:
            raise ValueError(f"{cfg.name}: tensor parallelism over "
                             f"model={M} needs M to divide {name}={n}")


def fsdp_on(params, cfg, mesh) -> bool:
    """Whether ``params`` hold FSDP blocks (q's d_model dim cut over
    data)."""
    return (mesh.size(DATA) > 1
            and params["layers"][0]["attn"]["q"]["w"].shape[0]
            != cfg.d_model)


# the leaves the head plan cuts: (path regex, which heads, which dim of
# the leaf counted from its last)
_HEAD_LEAVES = ((re.compile(r"attn/q/[wb]$"), "q", -1),
                (re.compile(r"attn/[kv]/[wb]$"), "kv", -1),
                (re.compile(r"attn/o/w$"), "q", -2))


def _head_blocks(spec, path, cfg, plan):
    """``spec`` with its ``model`` entry made the plan's ``Blocks`` where
    ``path`` is a leaf the head plan cuts."""
    key = "/".join(str(p) for p in path)
    for rx, which, dim in _HEAD_LEAVES:
        if rx.search(key):
            heads = plan.q if which == "q" else plan.kv
            n = cfg.n_heads if which == "q" else cfg.n_kv
            entries = list(spec)
            entries[dim] = shx.Blocks(
                MODEL, tuple((lo * cfg.hd, hi * cfg.hd) for lo, hi in heads),
                n * cfg.hd)
            return shx.Spec(*entries)
    return spec


def param_specs(tree, cfg, mesh, fsdp: bool = True, prefix=()):
    """The Spec of every leaf of an LM parameter tree (or of its subtree at
    ``prefix``, e.g. ``("layers", 3)``) by ``lm_rules``: FSDP where
    ``fsdp`` and D divides d_model; where the head plan replicates KV
    heads (M > n_kv), q, k, v (and biases) and o cut by its ``Blocks``."""
    check_tp(cfg, mesh)
    on = fsdp and cfg.d_model % mesh.size(DATA) == 0
    specs = shx.spec_tree(tree, shx.lm_rules(on), prefix=prefix)
    plan = plan_of(cfg, mesh)
    if plan.R == 1:                 # the even cut of lm_rules
        return specs
    return shx._map(lambda path, spec: _head_blocks(spec, path, cfg, plan),
                    specs, path=tuple(prefix))


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


def kv_in_region(attn: dict, mesh, R: int) -> dict:
    """A layer's k and v weights and biases as a model rank reads a KV
    head it shares with R - 1 other ranks: through ``copy_to`` over them
    (``SubAxis("model", R)``), which sums the parts of the gradient that
    each rank's query heads give."""
    if R == 1:
        return attn
    sub = shx.SubAxis(MODEL, R)
    return dict(attn, **{k: {n: copy_to(t, mesh, sub)
                             for n, t in attn[k].items()}
                         for k in ("k", "v")})


def rank_attention(attn: dict, acfg, mesh):
    """(a layer's attention weights as this model rank reads them, the
    ``AttnConfig`` of its heads by the head plan). qk-norm's scales are
    whole but act on the rank's heads only, so each rank's gradient of
    them is a part; they are read through ``copy_to``, which sums those
    parts over ``model``. A replicated KV head's weights go through
    ``kv_in_region``."""
    M = mesh.size(MODEL)
    if M == 1:
        return attn, acfg
    if "q_norm" in attn:
        attn = dict(attn, **{k: {"scale": copy_to(attn[k]["scale"], mesh,
                                                    MODEL)}
                             for k in ("q_norm", "k_norm")})
    R = head_plan(acfg.n_heads, acfg.n_kv, M).R
    return kv_in_region(attn, mesh, R), local_attn_cfg(acfg, mesh)


def local_attn_cfg(acfg, mesh):
    """The attention config of this model rank's heads (``head_plan``)."""
    M = mesh.size(MODEL)
    if M == 1:
        return acfg
    plan = head_plan(acfg.n_heads, acfg.n_kv, M)
    i = mesh.index(MODEL)
    return dataclasses.replace(acfg, n_heads=plan.q[i][1] - plan.q[i][0],
                               n_kv=plan.kv[i][1] - plan.kv[i][0])


def data_block(t, mesh):
    """(this rank's block of ``t`` along dim 0 over the data axes, ``pod``
    and ``data`` (the JAX package's ``data_spec``), split): the whole
    ``t``, split False, where they do not divide its batch (the JAX
    package's ``guard_divisible`` replicates it; every data rank then
    computes the whole batch)."""
    D = mesh.size(shx.DATA_AXES)
    if D == 1 or t.shape[0] % D:
        return t, D == 1
    n = t.shape[0] // D
    i = mesh.index(shx.DATA_AXES)
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
