"""What a step costs, counted on meta tensors: the port's counterpart of
the JAX package's ``launch/hlo_analysis.py``.

The JAX package lowers a cell through XLA and reads FLOPs and bytes from
the optimized HLO, resolving loop trip counts on the way. An eager
PyTorch step has no HLO: it is Python calling aten ops and the
hand-written kernels. So the step runs once on meta tensors (shapes and
dtypes, no storage, no arithmetic) under ``OpCounter``, a
``TorchDispatchMode`` that sees every aten op of the forward and the
backward; Python's layer loops run out, so there are no trip counts to
recover. Each kernel's meta route (``kernels/ops.py``) records the
kernel's ``work()`` here instead of its inner ops.

Counted:

* FLOPs by dtype: matmul-class ops by ``torch.utils.flop_counter``'s
  per-op formulas (hlo_analysis counts dots only), in their first
  operand's dtype, plus the work of each kernel whose ``op_class`` is
  ``"matmul"`` (flash and bus attention's products). A gather-sum
  kernel's adds (the EmbeddingBag, the PQ scan) are not counted, as no
  gather's or elementwise op's are; the breakdown keeps them.
* bytes, a no-reuse model (XLA's own metric is one too), by these rules:

  - an op counts its tensor inputs plus its outputs, an input passed
    twice once, an input broadcast along a stride-0 axis by its distinct
    elements;
  - views and aliases count 0, and so does an allocation (``empty``);
  - a gather (``index_select``, ``embedding``, ``index.Tensor``,
    ``gather``) counts its indices plus twice its output (the rows read,
    then written), never its whole source;
  - an accumulating scatter (``index_add_``, ``index_put_`` with
    ``accumulate``, ``scatter_add_``, the embedding's dense backward)
    counts src plus indices plus the rows it touches, read and written;
    a copying one (``index_copy_``, ``scatter_``, ``index_put_``) writes
    those rows once; an out-of-place one also copies its whole self;
  - an operand that is also the output (in place) counts once read and
    once written; an ``out=`` tensor, a copy's, a fill's or a zero's
    destination is written and not read;
  - a kernel counts its work's bytes.

* ``quad_bytes``: outputs whose two trailing dims are both >= 1024
  (hlo_analysis's ``_quad_bytes``), the [.., Sq, Sk] tiles of attention
  on a plain path, which a flash kernel keeps on chip.
* peak live bytes: the step's arguments plus every storage created while
  it runs, each from its first appearance until it is freed, by storage
  identity.
* a breakdown by op class: ``matmul``, ``gather/scatter``,
  ``elementwise`` (every other op that moves bytes), each kernel as
  ``kernel:<route>`` and each collective as ``collective:<kind>``.
* collectives, on a mesh: each collective of ``distributed/collectives.py``
  on meta tensors records its kind, result bytes and group size g
  (``add_collective``). Its wire bytes a rank are hlo_analysis's ring
  formulas: an all-gather result·(g−1)/g, an all-reduce
  2·result·(g−1)/g, a reduce-scatter result·(g−1), an all-to-all
  result·(g−1)/g, a point-to-point transfer its result; its operand
  bytes by the same
  module's convention (result/g, result, result·g, result, result). Its
  HBM bytes are twice its result, as hlo_analysis counts them. The wire
  bytes of the groups that lie in one node are kept apart
  (``coll_wire_in_node``): NVLink carries them, InfiniBand the rest
  (``launch/roofline.py``).
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

GATHERS = {aten.index_select, aten.embedding, aten.index, aten.gather}
ACCUMULATING_SCATTERS = {aten.index_add_, aten.index_add, aten.scatter_add_,
                         aten.scatter_add, aten.embedding_dense_backward}
COPYING_SCATTERS = {aten.index_copy_, aten.index_copy, aten.scatter_,
                    aten.scatter}
# index_put accumulates or copies by its ``accumulate`` argument
INDEX_PUTS = {aten.index_put_, aten.index_put, aten._index_put_impl_}
# ops that move no bytes: an alias that is not a view by its schema, and
# allocations whose contents are undefined
FREE = {aten._unsafe_view, aten.empty, aten.empty_strided, aten.new_empty,
        aten.new_empty_strided, aten.empty_like}
# ops that write their destination (argument 0) without reading it
WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
# the shortest trailing dims of an attention-quadratic tensor
QUAD_DIM = 1024
# a collective's (wire, operand) bytes a rank from its result's r and its
# group's size g: hlo_analysis's ring formulas and operand convention
COLLECTIVE_BYTES = {
    "all-gather": lambda r, g: (r * (g - 1) / g, r / g),
    "all-reduce": lambda r, g: (2 * r * (g - 1) / g, r),
    "reduce-scatter": lambda r, g: (r * (g - 1), r * g),
    "all-to-all": lambda r, g: (r * (g - 1) / g, r),
    "collective-permute": lambda r, g: (r, r),
}


def nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t``: an axis of stride 0 (a
    broadcast) is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _gather_indices(packet, args) -> list:
    """The index tensors of a gather."""
    if packet is aten.index:
        return [i for i in args[1] if i is not None]
    return [args[1]] if packet is aten.embedding else [args[2]]


def _scatter_bytes(func, args, kwargs, out: torch.Tensor) -> int:
    """A scatter's bytes by the module's rules: src, its indices, the
    rows it touches (read and written when it accumulates, else written),
    and, out of place, its self copied into ``out``."""
    packet = func._overloadpacket
    if packet in INDEX_PUTS:
        self, indices, src = args[:3]
        idx = [i for i in indices if i is not None]
        rows = 1
        for s in (*torch.broadcast_shapes(*(i.shape for i in idx)),
                  *self.shape[len(indices):]):
            rows *= s
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                              False)
    elif packet is aten.embedding_dense_backward:
        self, (src, i) = None, args[:2]
        idx, rows, accumulate = [i], src.numel(), True
    elif packet in (aten.scatter_add_, aten.scatter_add, aten.scatter_,
                    aten.scatter):
        # (self, dim, index, src | value): a row per index element
        self, idx = args[0], [args[2]]
        src = args[3] if len(args) > 3 else kwargs.get("src")
        if not isinstance(src, torch.Tensor):
            src = None
        rows, accumulate = args[2].numel(), packet in ACCUMULATING_SCATTERS
    else:
        # index_add / index_copy: (self, dim, index, source)
        self, idx = args[0], [args[2]]
        src = args[3] if len(args) > 3 else kwargs["source"]
        rows, accumulate = src.numel(), packet in ACCUMULATING_SCATTERS
    n = (nbytes(src) if src is not None else 0) \
        + sum(nbytes(i) for i in idx) \
        + (2 if accumulate else 1) * rows * out.element_size()
    if not func._schema.is_mutable:
        n += nbytes(out) + (nbytes(self) if self is not None else 0)
    return n


class OpCounter(TorchDispatchMode):
    """Count the aten ops and kernels run under it (see the module's
    docstring). ``args`` are the step's arguments: their tensors are live
    from the start. ``add_kernel`` is called by the kernels' meta routes.
    Read ``result()`` after the step."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = collections.defaultdict(float)      # by dtype
        self.bytes = 0.0
        self.quad_bytes = 0.0
        self.breakdown = collections.defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        self.coll_wire = collections.defaultdict(float)    # by kind
        self.coll_count = collections.defaultdict(int)
        self.coll_operand_total = 0.0
        self.coll_wire_in_node = 0.0
        self._live = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        for t in _tensors(args):
            self._track(t)
        self.args_bytes = self.live_bytes

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += self._live[key]
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live_bytes -= self._live.pop(key)

    def _add(self, cls: str, flops: float, n_bytes: float, dtype=None,
             matmul: bool = True):
        row = self.breakdown[cls]
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += n_bytes
        self.bytes += n_bytes
        if flops and matmul:
            self.flops[dtype] += flops

    def add_kernel(self, route, work: dict):
        """Record a kernel's meta call: its route (a kernel's name, or the
        pair a backward launches) and its ``work()``."""
        name = route if isinstance(route, str) else "+".join(route)
        self._add(f"kernel:{name}", work["flops"], work["bytes"],
                  work["dtype"], work["op_class"] == "matmul")

    def add_collective(self, kind: str, result_bytes: int, group: int,
                       in_node: bool = False):
        """Record a collective's meta call (``distributed/collectives.py``):
        its kind, its result's bytes, its group's size and whether the
        group lies in one node."""
        wire, operand = COLLECTIVE_BYTES[kind](result_bytes, group)
        self.coll_wire[kind] += wire
        self.coll_count[kind] += 1
        self.coll_operand_total += operand
        if in_node:
            self.coll_wire_in_node += wire
        self._add(f"collective:{kind}", 0.0, 2 * result_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        packet = func._overloadpacket
        if func.is_view or packet in FREE:
            return out
        dest = kwargs.get("out")
        written = sum(nbytes(t) for t in outs)
        for t in outs:
            if t.dim() >= 2 and min(t.shape[-2:]) >= QUAD_DIM:
                self.quad_bytes += nbytes(t)
        if packet in GATHERS:
            self._add("gather/scatter", 0.0, 2 * written + sum(
                nbytes(i) for i in _gather_indices(packet, args)))
            return out
        if packet in ACCUMULATING_SCATTERS or packet in COPYING_SCATTERS \
                or packet in INDEX_PUTS:
            self._add("gather/scatter", 0.0,
                      _scatter_bytes(func, args, kwargs, outs[0]))
            return out
        ins = [t for t in _tensors((args, kwargs)) if t is not dest]
        if packet in WRITE_ONLY:
            ins = ins[1:]
        ins = list({id(t): t for t in ins}.values())
        n = sum(nbytes(t) for t in ins) + written
        if packet in flop_registry:
            dtype = str(ins[0].dtype)[6:] if ins else "float32"
            self._add("matmul", float(flop_registry[packet](
                *args, **kwargs, out_val=out)), n, dtype)
        else:
            self._add("elementwise", 0.0, n)
        return out

    def result(self) -> dict:
        """The counts: ``flops`` (total) and ``flops_by_dtype``, ``bytes``,
        ``quad_bytes``, ``peak_bytes`` (live), ``args_bytes``, the
        ``breakdown`` by op class, and the collectives' ``coll_wire`` and
        ``coll_count`` by kind, ``coll_wire_total``,
        ``coll_wire_in_node`` and ``coll_operand_total``."""
        return {"flops": sum(self.flops.values()),
                "flops_by_dtype": dict(self.flops), "bytes": self.bytes,
                "quad_bytes": self.quad_bytes, "peak_bytes": self.peak_bytes,
                "args_bytes": self.args_bytes,
                "breakdown": {k: dict(v) for k, v in self.breakdown.items()},
                "coll_wire": dict(self.coll_wire),
                "coll_count": dict(self.coll_count),
                "coll_wire_total": sum(self.coll_wire.values()),
                "coll_wire_in_node": self.coll_wire_in_node,
                "coll_operand_total": self.coll_operand_total}
