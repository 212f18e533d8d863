"""Fused EmbeddingBag (gather plus weighted sum over the bag) and its
gradient with respect to the table: the plain PyTorch versions and the
CUDA kernels' wrappers (``csrc/embedding_bag.cu``).

``out[b, f] = sum_n weights[b, f, n] * table[idx[b, f, n]]`` for a table
[V, d], idx [B, F, nnz] int32 and weights [B, F, nnz] f32 or None (all
ones), giving [B, F, d] in the table's dtype. The sum is taken in f32 and
rounded once to the table's dtype.

An index reads its row as ``jnp.take`` does in the JAX package's
reference (``kernels/ref.py``): a negative index counts from the end,
and an index outside [-V, V) reads a row of NaN, so its bag's output is
NaN even where its weight is 0. (The Pallas kernel clamps such an index
to a valid row instead; the port follows the reference.)

The backward is the transpose of that read, as ``jax.vjp`` of the JAX
package's XLA lookup gives it: ``g[r] = sum of weights * dout`` over the
slots that name row r, a dense [V, d] gradient whose rows no slot names
are 0; a slot outside [-V, V) adds nothing. The kernel sums in f32 in a
fixed order (a stable sort of the slots by row, then fixed chunks), so
it repeats bit for bit.

``work`` and ``bwd_work`` count what the forward and the backward must
do, whichever kernels do it; the meta routes (``embedding_bag_meta``,
``embedding_bag_bwd_meta``) run the card's checks on meta tensors and
return that count beside outputs of the card's shapes and dtypes.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_device, check_meta

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = CudaKernel("embedding_bag", "embedding_bag.cu", {
    "embedding_bag": [_P, _P, _P, _P, _L, _I, _L, _I, _I],
    "embedding_bag_bwd_keys": [_P, _P, _L, _L],
    "embedding_bag_bwd": [_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I],
})
# sorted slots in a chunk of the backward's first pass, which one group
# of lanes walks: a row's n slots spread over about n / BWD_CHUNK groups,
# at the cost of two partial rows of scratch a chunk
BWD_CHUNK = 32
_MAX_ROWS = 2 ** 31 - 1  # the backward's keys and slots are 32-bit
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _wrap(idx, V: int):
    """(row indices clamped into the table, mask of the out-of-range ones):
    negative indices count from the end."""
    i = idx.long()
    i = torch.where(i < 0, i + V, i)
    bad = (i < 0) | (i >= V)
    return i.clamp(0, V - 1), bad


def take_rows(table, idx):
    """``jnp.take(table, idx, axis=0)``: rows [..., d], negative indices
    counting from the end, a row of NaN for an index outside [-V, V)."""
    i, bad = _wrap(idx, table.shape[0])
    return table[i].masked_fill(bad[..., None], float("nan"))


def embedding_bag_plain(table, idx, weights=None):
    """table: [V, d]; idx: [B, F, nnz]; weights: [B, F, nnz] or None ->
    [B, F, d] in the table's dtype, summed in f32."""
    i, bad = _wrap(idx, table.shape[0])
    rows = table[i].float()                                 # [B, F, nnz, d]
    if weights is not None:
        rows = rows * weights.float()[..., None]
    out = rows.sum(dim=-2).masked_fill(bad.any(dim=-1, keepdim=True),
                                       float("nan"))
    return out.to(table.dtype)


def embedding_bag_bwd_plain(dout, idx, weights, num_rows: int):
    """The table's gradient: dout [B, F, d], idx [B, F, nnz], weights
    [B, F, nnz] or None -> [num_rows, d] in dout's dtype, by ``index_add_``
    in f32 (in f64 when dout is f64), a slot outside [-V, V) adding
    nothing."""
    acc = torch.float64 if dout.dtype == torch.float64 else torch.float32
    i, bad = _wrap(idx, num_rows)
    d = dout.shape[-1]
    src = dout.to(acc)[..., None, :].expand(*idx.shape, d)
    if weights is not None:
        src = src * weights.to(acc)[..., None]
    src = src.masked_fill(bad[..., None], 0.0)
    g = torch.zeros((num_rows, d), dtype=acc, device=dout.device)
    g.index_add_(0, i.reshape(-1), src.reshape(-1, d))
    return g.to(dout.dtype)


def work(V: int, d: int, B: int, F: int, nnz: int, dtype,
         weighted: bool, distinct_rows: int | None = None) -> dict:
    """What the forward must do: ``flops``, a multiply and an add for each
    of the B F nnz slots' d elements, in the table's ``dtype``;
    ``op_class`` ``"gather/scatter"``: a gather's weighted sum, no product;
    ``bytes``, each input read once and the output written once: the
    table's distinct rows the slots name (a row below 32 B costs one 32 B
    sector), the int32 indices and f32 weights, then the [B, F, d]
    output. ``distinct_rows`` is what the data names; without it (on
    meta, where there is no data) every slot counts as a row of its own,
    at most V."""
    e, slots = dtype.itemsize, B * F * nnz
    rows = min(slots, V) if distinct_rows is None else distinct_rows
    return {"flops": 2.0 * slots * d, "dtype": str(dtype)[6:],
            "op_class": "gather/scatter",
            "bytes": float(rows * max(d * e, 32) + slots * 4 * (1 + weighted)
                           + B * F * d * e)}


def bwd_work(V: int, d: int, B: int, F: int, nnz: int, dtype,
             weighted: bool) -> dict:
    """What the table's gradient must do: ``flops``, a multiply and an add
    for each slot's d elements, in dout's ``dtype``; ``op_class``
    ``"gather/scatter"``: a scatter-add; ``bytes``, dout, the
    indices and the weights read once, then the dense [V, d] gradient
    written once."""
    e, slots = dtype.itemsize, B * F * nnz
    return {"flops": 2.0 * slots * d, "dtype": str(dtype)[6:],
            "op_class": "gather/scatter",
            "bytes": float(B * F * d * e + slots * 4 * (1 + weighted)
                           + V * d * e)}


def embedding_bag_meta(table, idx, weights=None):
    """The forward's meta route: (out, ``"embedding_bag"``, ``work``), after
    the card's checks; launches nothing."""
    check_meta(table)
    out = _forward_plan(table, idx, weights)
    (V, d), (B, F, nnz) = table.shape, idx.shape
    return out, "embedding_bag", work(V, d, B, F, nnz, table.dtype,
                                      weights is not None)


def embedding_bag_bwd_meta(dout, idx, weights, num_rows: int):
    """The backward's meta route: (the [num_rows, d] gradient,
    ``"embedding_bag_bwd"``, ``bwd_work``), after the card's checks;
    launches nothing."""
    check_meta(dout)
    _backward_plan(dout, idx, weights, num_rows)
    grad = torch.empty((num_rows, dout.shape[-1]), dtype=dout.dtype,
                       device=dout.device)
    return grad, "embedding_bag_bwd", bwd_work(
        num_rows, dout.shape[-1], *idx.shape, dout.dtype, weights is not None)


def _forward_plan(table, idx, weights):
    """The card's checks for a forward, and its output. The card and the
    meta route share it."""
    if table.dim() != 2 or idx.dim() != 3:
        raise ValueError(f"expected table [V, d] and idx [B, F, nnz], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    tensors = [("idx", idx)]
    if weights is not None:
        if weights.dtype != torch.float32 or weights.shape != idx.shape:
            raise TypeError(f"weights must be float32 of idx's shape "
                            f"{tuple(idx.shape)}, got {weights.dtype} "
                            f"{tuple(weights.shape)}")
        tensors.append(("weights", weights))
    for name, t in [("table", table)] + tensors:
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    V, d = table.shape
    B, F, nnz = idx.shape
    out = torch.empty((B, F, d), dtype=table.dtype, device=table.device)
    if out.numel() and V == 0:
        raise ValueError("an empty table has no rows to gather")
    return out


def embedding_bag_cuda(table, idx, weights=None):
    """Launch the CUDA kernel; same contract as ``embedding_bag_plain``.
    Raises on anything the kernel does not take."""
    check_device(table)
    out = _forward_plan(table, idx, weights)
    if out.numel() == 0:
        return out
    (V, d), (B, F, nnz) = table.shape, idx.shape
    KERNEL.launch("embedding_bag", table.device, table.data_ptr(),
                  idx.data_ptr(),
                  weights.data_ptr() if weights is not None else None,
                  out.data_ptr(), V, d, B * F, nnz, _DTYPES[table.dtype])
    return out


def _backward_plan(dout, idx, weights, num_rows: int):
    """The card's checks for a backward. The card and the meta route share
    it."""
    if dout.dim() != 3 or idx.dim() != 3 or dout.shape[:2] != idx.shape[:2]:
        raise ValueError(f"expected dout [B, F, d] and idx [B, F, nnz], got "
                         f"{tuple(dout.shape)} and {tuple(idx.shape)}")
    if dout.dtype not in _DTYPES:
        raise TypeError(f"dout must be float32 or bfloat16, got "
                        f"{dout.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not 0 < num_rows <= _MAX_ROWS:
        raise ValueError(f"the backward takes 1 to {_MAX_ROWS} rows, got "
                         f"{num_rows}")
    tensors = [("dout", dout), ("idx", idx)]
    if weights is not None:
        if weights.dtype != torch.float32 or weights.shape != idx.shape:
            raise TypeError(f"weights must be float32 of idx's shape "
                            f"{tuple(idx.shape)}, got {weights.dtype} "
                            f"{tuple(weights.shape)}")
        tensors.append(("weights", weights))
    for name, t in tensors:
        if t.device != dout.device:
            raise ValueError(f"{name} is on {t.device}, dout on "
                             f"{dout.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.numel() > _MAX_ROWS:
        raise ValueError(f"the backward takes at most {_MAX_ROWS} index "
                         f"slots, got {idx.numel()}")


def embedding_bag_bwd_cuda(dout, idx, weights, num_rows: int):
    """Launch the backward kernels; same contract as
    ``embedding_bag_bwd_plain`` for dout in float32 or bfloat16 (the
    table's dtype). Raises on anything the kernels do not take."""
    check_device(dout)
    _backward_plan(dout, idx, weights, num_rows)
    d, n, nnz = dout.shape[-1], idx.numel(), idx.shape[-1]
    grad = torch.zeros((num_rows, d), dtype=dout.dtype, device=dout.device)
    if n == 0 or d == 0:
        return grad
    keys = torch.empty(n, dtype=torch.int32, device=dout.device)
    KERNEL.launch("embedding_bag_bwd_keys", dout.device, idx.data_ptr(),
                  keys.data_ptr(), n, num_rows)
    sorted_keys, perm = torch.sort(keys, stable=True)
    del keys
    partial = torch.empty(2 * -(-n // BWD_CHUNK) * d, dtype=torch.float32,
                          device=dout.device)
    KERNEL.launch("embedding_bag_bwd", dout.device, sorted_keys.data_ptr(),
                  perm.data_ptr(), dout.data_ptr(),
                  weights.data_ptr() if weights is not None else None,
                  grad.data_ptr(), partial.data_ptr(), n, num_rows, d, nnz,
                  BWD_CHUNK, _DTYPES[dout.dtype])
    return grad
