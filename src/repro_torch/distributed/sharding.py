"""Partition rules: parameter and batch specs per model family, copied
from the JAX package's ``distributed/sharding.py`` as data.

A ``Spec`` is a tuple with ``PartitionSpec``'s meaning: one entry per
dim, each an axis name, a tuple of names, or ``None`` (replicated).
Rules are (path-regex, Spec) tables matched against the flattened
parameter path (first match wins; default replicated). The mesh axes are
(pod, data, model): ``pod`` and ``data`` are data parallel, ``model``
tensor/expert/table parallel.

JAX hands a tree of specs to GSPMD, which places every leaf and inserts
the collectives. PyTorch runs one process per rank: ``shard_block`` cuts
this rank's block of a leaf, ``place`` every leaf of a tree, and the code
that reads a sharded leaf calls the collectives itself
(``distributed/collectives.py``). The port places SpeedyFeed's pure data
parallelism (the row-sharded cache and the user side of a batch), the
LM family by ``lm_rules`` and ``lm_batch_specs``
(``models/lm_parallel.py``), the recsys family by ``recsys_rules``
and ``recsys_batch_specs`` (``models/recsys/parallel.py``: the CTR
tables and BERT4Rec's item table cut by rows over ``model``, the towers
whole, the batch over the data axes), and DimeNet by ``gnn_rules`` and
``gnn_batch_specs`` (``models/gnn/dimenet.py``: the parameters whole,
the edges and triplets over every axis).

A spec entry may also be ``Blocks``: a dim cut over one axis into blocks
of the entry's own bounds, which may differ in length and which ranks
may share (the LM family's head plan, ``models/lm_parallel.py``, where
an even cut over ``model`` would split a head: query heads cut unevenly
by KV group, a KV head replicated over the ranks that share it).
``shard_block``, ``block_shape``, ``global_shape`` and
``collectives.gather_tree`` read it; every other family's specs hold
axis names only, and their even path is unchanged.

A mesh is anything with ``axis_names``, a ``shape`` mapping each axis to
its size and, for ``shard_block``, a ``rank`` (``launch/mesh.py:Mesh``).
A ``SubAxis`` names the groups of consecutive ranks along one axis
(``Mesh.group_of`` takes it as it takes an axis name).
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple

DATA_AXES = ("pod", "data")     # present subset used automatically


class Spec(tuple):
    """``PartitionSpec``: ``Spec("data", None)``, ``Spec()`` replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Blocks:
    """A spec entry: one dim of ``size`` cut over ``axis``, the rank at
    index i along the axis holding [bounds[i][0], bounds[i][1]). Blocks
    may differ in length; ranks whose bounds are equal hold the same
    block (a replica), and the first of them is its ``owner``."""
    axis: str
    bounds: tuple
    size: int

    def block(self, i: int) -> tuple:
        return self.bounds[i]

    def owner(self, i: int) -> bool:
        return self.bounds.index(self.bounds[i]) == i


@dataclasses.dataclass(frozen=True)
class SubAxis:
    """The groups of ``size`` consecutive ranks along ``axis`` (rank i of
    the axis in group i // size, at index i % size in it): the ranks that
    share a replicated block of a ``Blocks`` cut."""
    axis: str
    size: int


class Sharding(NamedTuple):
    """``NamedSharding``: a spec on a mesh."""
    mesh: object
    spec: Spec


# ---------------------------------------------------------------------------
# activation specs: launchers register names, models call ``constrain``.
# The port places activations explicitly (the pipeline cuts its encode
# batch by rank), so ``constrain`` returns its input; the registry keeps
# the names a launcher set, as JAX's does.
# ---------------------------------------------------------------------------

_ACTIVATION_SPECS: dict = {}


def set_activation_specs(specs: dict):
    """specs: {name: Spec}. Pass {} to clear."""
    _ACTIVATION_SPECS.clear()
    _ACTIVATION_SPECS.update(specs)


def constrain(x, name: str):
    del name
    return x


# ---------------------------------------------------------------------------
# trees: dicts, lists and tuples (NamedTuples too); a Spec is a leaf
# ---------------------------------------------------------------------------

def _map(fn, tree, *rest, path=()):
    if isinstance(tree, (Spec, Sharding)) or tree is None:
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, *(r[i] for r in rest), path=path + (i,))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):             # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *rest_leaves)`` over a tree, Specs and Shardings as
    leaves."""
    return _map(lambda _, *leaves: fn(*leaves), tree, *rest)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def data_spec(mesh, *dims):
    """Spec with the batch dim over the present data axes; the rest as
    given."""
    present = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    return Spec(present if present else None, *dims)


def spec_tree(params, rules, default=Spec(), prefix=()):
    """Match flattened param paths against (regex, spec) rules; ``prefix``
    is the path of ``params`` in its whole tree (a subtree's leaves match
    by their whole path)."""
    compiled = [(re.compile(r), s) for r, s in rules]

    def match(path, leaf):
        s = "/".join(str(p) for p in path)
        for rx, spec in compiled:
            if rx.search(s):
                return _fit(spec, leaf)
        return default

    return _map(match, params, path=tuple(prefix))


def _fit(spec, leaf):
    """Pad a spec with Nones to the leaf rank (specs are right-anchored on
    the trailing dims, since stacked-layer params add a leading L dim)."""
    ndim = len(_shape(leaf))
    pad = ndim - len(spec)
    if pad < 0:
        return Spec(*spec[-ndim:]) if ndim else Spec()
    return Spec(*([None] * pad + list(spec)))


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axes_size(mesh, axes) -> int:
    size = 1
    for a in _axes(axes):
        size *= mesh.shape[a]
    return size


def guard_divisible(specs, tree, mesh):
    """Per-leaf spec sanitizer: a dim whose size the product of its mesh
    axes does not divide falls back to replicated (a ``Blocks`` entry is
    kept). ``tree`` supplies the shapes and matches ``specs``
    structurally."""
    def fix(spec, leaf):
        shape = _shape(leaf)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        return Spec(*(axes if isinstance(axes, Blocks) or (
            axes is not None and shape[i] % _axes_size(mesh, axes) == 0)
            else None for i, axes in enumerate(dims[:len(shape)])))

    return tree_map(fix, specs, tree)


def batch_specs(mesh, batch_like):
    """Dim-0 data-parallel specs for a batch tree, with the divisibility
    guard (a leaf whose leading dim does not divide is replicated)."""
    specs = tree_map(lambda leaf: data_spec(mesh) if _shape(leaf) else Spec(),
                     batch_like)
    return guard_divisible(specs, batch_like, mesh)


def named(mesh, specs):
    """A tree of Specs -> the same tree of ``Sharding(mesh, spec)``."""
    return tree_map(lambda s: Sharding(mesh, s), specs)


def global_shape(shape, spec, mesh) -> tuple:
    """The whole leaf's shape from the shape of one rank's block."""
    def whole(d, n):
        entry = spec[d] if d < len(spec) else None
        if isinstance(entry, Blocks):
            return entry.size
        return n * (_axes_size(mesh, entry) if entry is not None else 1)

    return tuple(whole(d, n) for d, n in enumerate(shape))


def dim_range(entry, size: int, mesh) -> tuple:
    """[start, stop) of this rank's block of a dim of ``size`` under the
    spec ``entry`` (an axis name, a tuple of them, a ``Blocks``, or None
    for the whole dim); raises where an even cut does not divide."""
    if entry is None:
        return 0, size
    coords = _coords(mesh)
    if isinstance(entry, Blocks):
        if size != entry.size:
            raise ValueError(f"a dim of {size} under blocks of a dim of "
                             f"{entry.size}")
        return entry.block(coords[entry.axis])
    names = _axes(entry)
    blocks, index = 1, 0
    for a in names:
        blocks *= mesh.shape[a]
        index = index * mesh.shape[a] + coords[a]
    if size % blocks:
        raise ValueError(f"dim of {size} does not divide into {blocks} "
                         f"blocks over {names}")
    n = size // blocks
    return index * n, (index + 1) * n


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's block of a leaf of ``shape`` under
    ``spec``."""
    def length(d, n):
        entry = spec[d] if d < len(spec) else None
        if isinstance(entry, Blocks):
            lo, hi = dim_range(entry, n, mesh)
            return hi - lo
        return n // _axes_size(mesh, entry) if entry is not None else n

    return tuple(length(d, n) for d, n in enumerate(shape))


def _coords(mesh) -> dict:
    """This rank's index along each axis (row-major over ``axis_names``)."""
    out, r = {}, mesh.rank
    for a in reversed(mesh.axis_names):
        out[a] = r % mesh.shape[a]
        r //= mesh.shape[a]
    return out


def place(tree, specs, mesh):
    """Every leaf of ``tree`` cut to this rank's block by its spec in
    ``specs`` (a tree of the same layout), each block a tensor of its own
    (a copy, so the whole can be freed); a leaf the spec does not shard
    is kept as it is."""
    def cut(spec, leaf):
        block = shard_block(leaf, spec, mesh)
        return block if block is leaf else block.clone(
            memory_format=_contiguous(block))

    return tree_map(cut, specs, tree)


def _contiguous(t):
    import torch
    return torch.contiguous_format if isinstance(t, torch.Tensor) else None


def shard_block(x, spec, mesh):
    """This rank's block of the leaf ``x`` under ``spec``: a view (a
    narrow of each sharded dim) of a tensor or array; ``x`` itself when
    the spec shards nothing. The port's counterpart of ``device_put``
    with a ``NamedSharding``."""
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        try:
            lo, hi = dim_range(axes, _shape(x)[d], mesh)
        except ValueError as e:
            raise ValueError(f"dim {d}: {e}") from None
        x = x[(slice(None),) * d + (slice(lo, hi),)]
    return x


# ---------------------------------------------------------------------------
# per-family rule tables
# ---------------------------------------------------------------------------

def lm_rules(fsdp: bool = False):
    dp = "data" if fsdp else None
    return [
        # attention: column-parallel qkv, row-parallel o
        (r"attn/q/w$", Spec(dp, "model")),
        (r"attn/[kv]/w$", Spec(dp, "model")),
        (r"attn/o/w$", Spec("model", dp)),
        (r"attn/[qkv]/b$", Spec("model")),
        (r"attn/o/b$", Spec()),
        # dense mlp: column-parallel up/gate, row-parallel down
        (r"ffn/(gate|up)/w$", Spec(dp, "model")),
        (r"ffn/down/w$", Spec("model", dp)),
        (r"shared/(gate|up)/w$", Spec(dp, "model")),
        (r"shared/down/w$", Spec("model", dp)),
        # moe: experts over model axis
        (r"moe/router$", Spec()),
        (r"moe/w[13]$", Spec("model", dp, None)),
        (r"moe/w2$", Spec("model", None, dp)),
        # embeddings: vocab-sharded; head column-parallel
        (r"embed/table$", Spec("model", dp)),
        (r"^head/w$", Spec(dp, "model")),
        # norms replicated
        (r"ln", Spec()),
        (r"_norm", Spec()),
    ]


def lm_batch_specs(mesh, kind: str):
    """The LM family's batch specs: tokens and labels over the data axes;
    a decode step's cache [L, B, S, Hkv, hd] with B over the data axes and
    the KV heads over ``model`` (the JAX package's table, whose cells'
    ``_cache_spec`` puts S over ``model`` in the dry-run instead; the
    port's per-head attention needs whole heads on a rank). Where model >
    n_kv a rank's cache holds the KV head it shares with other ranks (the
    head plan, ``models/lm_parallel.py``; ``lm.init_cache(mesh=)``)."""
    present = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    if kind == "train":
        return {"tokens": data_spec(mesh), "labels": data_spec(mesh)}
    if kind == "prefill":
        return {"tokens": data_spec(mesh)}
    if kind == "decode":
        return {"token": data_spec(mesh),
                "cache": {k: Spec(None, present, None, "model", None)
                          for k in ("k", "v")},
                "index": Spec()}
    raise ValueError(kind)


def recsys_rules():
    return [
        (r"tables/fused$", Spec("model", None)),     # row-sharded big table
        (r"wide/fused$", Spec("model", None)),
        (r"item_emb/table$", Spec("model", None)),
        (r"(bot|top|deep|mlp)/l\d+/w$", Spec()),     # small towers replicated
        (r"cross/\d+/w$", Spec()),
        (r".*", Spec()),
    ]


def recsys_batch_specs(mesh, keys):
    """The recsys family's batch specs: every key over the data axes."""
    return {k: data_spec(mesh) for k in keys}


def gnn_rules():
    # node/edge model params are small -> replicated
    return [(r".*", Spec())]


def gnn_batch_specs(mesh, batch_like):
    """The GNN family's batch specs: every edge (``edge_*``) and triplet
    (``trip_*``) array cut over every mesh axis along dim 0 (the message
    passing is an additive scatter), every node array whole."""
    all_axes = tuple(mesh.axis_names)

    def spec(path, leaf):
        if str(path[0]).startswith(("edge_", "trip_")):
            return Spec(all_axes)
        return Spec()

    return _map(spec, batch_like)


def speedyfeed_rules(tp: bool = False):
    """SpeedyFeed PLM sharding. ``tp=False`` (default): the 110M-param
    encoder is replicated and the encode batch shards over every mesh
    axis, pure data parallelism, the paper's own setup. ``tp=True`` is
    the Megatron layout of the JAX package's measured baseline."""
    if not tp:
        return [(r".*", Spec())]
    return [
        (r"plm/layers/attn/[qkv]/w$", Spec(None, "model")),
        (r"plm/layers/attn/[qkv]/b$", Spec("model")),
        (r"plm/layers/attn/o/w$", Spec("model", None)),
        (r"plm/layers/ffn_up/w$", Spec(None, "model")),
        (r"plm/layers/ffn_up/b$", Spec("model")),
        (r"plm/layers/ffn_down/w$", Spec("model", None)),
        (r"plm/(tok|pos)_emb/table$", Spec("model", None)),
        (r"plm/(seg|freq)_emb/table$", Spec()),     # tiny tables: replicate
        (r".*", Spec()),
    ]


def speedyfeed_cache_spec(mesh):
    return {"emb": data_spec(mesh, None), "written_step": data_spec(mesh)}


def speedyfeed_batch_specs(mesh, batch_like):
    """Centralized-batch specs: the merged news set (``news_*``) stays
    replicated (it feeds a global argsort over the whole set), the
    per-user history side shards its leading dim over every mesh axis;
    the divisibility guard replicates what does not divide."""
    all_ax = tuple(mesh.axis_names)

    def spec(path, leaf):
        if str(path[-1]).startswith("news_"):
            return Spec()
        return Spec(all_ax) if _shape(leaf) else Spec()

    return guard_divisible(_map(spec, batch_like), batch_like, mesh)
