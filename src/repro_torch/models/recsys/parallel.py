"""The recsys family on a (data, model) mesh: the row-sharded tables of
``recsys_rules``, the port's counterpart of what GSPMD does for the JAX
package's ``models/recsys`` when its cells take a mesh.

Placement (``param_specs``, ``place_params``): every leaf by
``distributed.sharding.recsys_rules``, through ``guard_divisible``. The
CTR configs' fused table, Wide&Deep's wide table and BERT4Rec's item
table are cut by rows over ``model``; the towers, the cross layers, the
position table and BERT4Rec's encoder are whole on every rank. Every
padded table divides: the CTR tables are padded to a multiple of
``ROW_PAD`` (4,096) rows, BERT4Rec's to a multiple of 4,096 too. A rank
holds whole rows of a table, so a table the model axis does not divide
raises (``guard_divisible`` would replicate it under GSPMD; that is not
ported). The Adam moments follow their parameters (``place_opt``).

Batches: every entry point takes the whole batch, and each rank reads its
block over the data axes by ``recsys_batch_specs`` (``batch_block``); a
batch the data axes do not divide is whole on every data rank, as JAX's
guard replicates it.

The forward, Megatron's way:

- a CTR lookup on a table block is the EmbeddingBag kernel on that block
  (``sharded_bag``): each slot is shifted into the block's rows, a slot
  another rank holds keeps weight 0 and reads a row of the block spread
  by its id (``local_slots``), and the partial bags are summed over
  ``model`` (``reduce_from``, whose backward is the identity: each rank's
  backward kernel writes its own block's dense gradient). A slot outside
  the whole table stays outside the block on every rank, so its bag is
  NaN as on one process;
- BERT4Rec's item lookup is the vocab-parallel one
  (``collectives.owned_rows`` summed over ``model``); its Cloze scores
  are taken on each rank's own rows of the positive and negative items
  and the **scores** summed over ``model``, the masked positions'
  hidden states entering through ``copy_to`` (Megatron's f), so that the
  encoder's gradient is the sum of every rank's part;
- the towers run on the rank's data block, alike on every model rank.

Losses are global means: each rank's share of the sum over the global
batch, the sum over ``data`` through ``reduce_from`` (``data_mean``), so
each rank's gradient is its own block's part and ``optim.adam``'s mesh
step sums the leaves whole over ``data`` (every leaf of the family) once,
the clip counting each block once.

Top-k over a cut set (``merge_topk``): each rank takes its own top-k, the
k winners (scores and global ids) are all-gathered over the axis and the
top-k taken again. BERT4Rec's ``serve_sharded`` does it over ``model``
(each rank scores its item rows); both families' retrieval over ``data``
(each data rank scores its block of the candidates).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shx
from repro_torch.distributed.collectives import (all_gather, all_reduce,
                                                 gather_tree, reduce_from)

# the batch's axes are the data axes, ``pod`` and ``data`` (those the mesh
# has), as ``recsys_batch_specs`` cuts it: the collectives take the tuple
MODEL, DATA = "model", shx.DATA_AXES


def param_specs(tree, mesh):
    """The Spec of every leaf of a whole recsys parameter tree by
    ``recsys_rules`` after ``guard_divisible``; raises where the model
    axis does not divide a table's rows."""
    specs = shx.spec_tree(tree, shx.recsys_rules())
    guarded = shx.guard_divisible(specs, tree, mesh)

    def check(path, spec, kept):
        if tuple(spec) != tuple(kept):
            raise ValueError(
                f"{'/'.join(map(str, path))}: model={mesh.size(MODEL)} does "
                f"not divide its rows (a rank holds whole rows of a table; "
                f"the guard's replication of a table is not ported)")

    shx._map(check, specs, guarded)
    return guarded


def specs_by_path(params, mesh) -> dict:
    """{path: Spec} of placed ``params`` (this rank's blocks), paths as
    ``optim.adam.leaves`` writes them (``tables/fused``)."""
    out = {}

    def note(path, spec):
        out["/".join(str(p) for p in path)] = spec

    shx._map(note, shx.spec_tree(params, shx.recsys_rules()))
    return out


def place_params(tree, mesh):
    """This rank's blocks of a whole recsys parameter tree, each a tensor
    of its own."""
    return shx.place(tree, param_specs(tree, mesh), mesh)


def unplace_params(blocks, mesh):
    """The whole tree from every rank's blocks (``place_params``'
    inverse), on every rank."""
    return gather_tree(blocks, shx.spec_tree(blocks, shx.recsys_rules()),
                       mesh)


def place_opt(opt, mesh):
    """This rank's blocks of a whole Adam state: the moments as their
    parameters (the JAX package's ``opt_spec_tree``), the count whole."""
    return {"m": place_params(opt["m"], mesh),
            "v": place_params(opt["v"], mesh), "count": opt["count"]}


def batch_block(batch: dict, mesh):
    """(this rank's block of every entry of ``batch`` over the data axes
    by ``recsys_batch_specs``, split): the whole batch, split False, where
    the data axes do not divide its leading dim (``guard_divisible``
    replicates it)."""
    specs = shx.guard_divisible(shx.recsys_batch_specs(mesh, batch), batch,
                                mesh)
    block = {k: shx.shard_block(v, specs[k], mesh) for k, v in batch.items()}
    split = mesh.size(DATA) == 1 or all(s[0] is not None
                                        for s in specs.values())
    return block, split


def data_block(t, mesh):
    """``batch_block`` of one tensor: (its block, split)."""
    block, split = batch_block({"t": t}, mesh)
    return block["t"], split


def data_mean(total, count, split: bool, mesh):
    """The global mean from this rank's ``total`` (a sum over its block,
    differentiable) and ``count`` (a tensor): the totals summed over
    ``data`` by ``reduce_from`` (each rank's gradient its own block's
    part), the counts by an all-reduce, both over the data ranks' copies
    where the batch is whole on each (not ``split``)."""
    rep = 1 if split else mesh.size(DATA)
    total = reduce_from(total, mesh, DATA) / rep
    count = all_reduce(count.detach().clone(), mesh, axis=DATA) // rep
    return total / count.clamp_min(1)


def local_slots(shifted, weights, rows: int, mesh):
    """A table's slots as this model rank's block of ``rows`` rows reads
    them: (int32 indices into the block, f32 weights). ``shifted`` are
    indices into the whole table (rows * M rows; negative ones count from
    the end). A slot the block holds keeps its weight (1 where
    ``weights`` is None); a slot another rank holds weighs 0 and reads
    row ``index % rows``, spread over the block (pointed at one row they
    would make it one hot key in the backward's sort and combine); a
    slot outside the whole table reads row ``rows``, outside the block,
    so its bag is NaN on every rank, as on one process."""
    V = rows * mesh.size(MODEL)
    g = shifted.long()
    g = torch.where(g < 0, g + V, g)
    bad = (g < 0) | (g >= V)
    local = g - mesh.index(MODEL) * rows
    own = (local >= 0) & (local < rows)
    idx = torch.where(own, local, torch.where(bad, rows, g % rows))
    w = (torch.ones(shifted.shape, device=shifted.device)
         if weights is None else weights)
    return idx.to(torch.int32), torch.where(own, w, w.new_zeros(()))


def sharded_bag(bag, block, shifted, weights, mesh):
    """The EmbeddingBag of a table cut by rows over ``model``: ``bag``
    (``ops.embedding_bag`` or its plain version) on this rank's
    ``block`` with ``local_slots``, summed over ``model``; [B, F, d], the
    same on every model rank."""
    return reduce_from(bag(block, *local_slots(shifted, weights,
                                                block.shape[0], mesh)),
                       mesh, MODEL)


def merge_topk(vals, ids, k: int, mesh, axis: str):
    """The top-k of a set cut over ``axis`` from each rank's own top-k
    (``vals`` [B, k] and their global ``ids``): the winners all-gathered
    over the axis, [B, n k], and the top-k taken again; (scores, ids),
    the same on every rank of the axis."""
    if mesh.size(axis) == 1:
        return vals, ids
    av = all_gather(vals.contiguous(), mesh, axis, dim=1)
    ai = all_gather(ids.contiguous(), mesh, axis, dim=1)
    fv, fi = torch.topk(av, k, dim=-1)
    return fv, torch.gather(ai, 1, fi)


def cut_topk(scores_fn, cand, k: int, mesh):
    """Two-stage top-k over candidates cut over ``data``: this rank's
    block of ``cand`` (its leading dim over the data axes), scored by
    ``scores_fn`` -> [B, N / D], its top-k, their positions made global,
    then ``merge_topk`` over ``data``. A candidate set the data axes do
    not divide is whole on every rank, and its top-k final."""
    block, split = data_block(cand, mesh)
    vals, idx = torch.topk(scores_fn(block), k, dim=-1)
    if not split or mesh.size(DATA) == 1:
        return vals, idx
    return merge_topk(vals, idx + mesh.index(DATA) * block.shape[0], k,
                      mesh, DATA)
