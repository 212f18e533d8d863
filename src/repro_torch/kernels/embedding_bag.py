"""Fused EmbeddingBag (gather plus weighted sum over the bag): the plain
PyTorch version and the CUDA kernel's wrapper (``csrc/embedding_bag.cu``).

``out[b, f] = sum_n weights[b, f, n] * table[idx[b, f, n]]`` for a table
[V, d], idx [B, F, nnz] int32 and weights [B, F, nnz] f32 or None (all
ones), giving [B, F, d] in the table's dtype. The sum is taken in f32 and
rounded once to the table's dtype.

An index reads its row as ``jnp.take`` does in the JAX package's
reference (``kernels/ref.py``): a negative index counts from the end,
and an index outside [-V, V) reads a row of NaN, so its bag's output is
NaN even where its weight is 0. (The Pallas kernel clamps such an index
to a valid row instead; the port follows the reference.)
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_device

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = CudaKernel("embedding_bag", "embedding_bag.cu", {
    "embedding_bag": [_P, _P, _P, _P, _L, _I, _L, _I, _I],
})
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


def embedding_bag_cuda(table, idx, weights=None):
    """Launch the CUDA kernel; same contract as ``embedding_bag_plain``.
    Raises on anything the kernel does not take."""
    check_device(table)
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
    if out.numel() == 0:
        return out
    if V == 0:
        raise ValueError("an empty table has no rows to gather")
    KERNEL.launch("embedding_bag", table.device, table.data_ptr(),
                  idx.data_ptr(),
                  weights.data_ptr() if weights is not None else None,
                  out.data_ptr(), V, d, B * F, nnz, _DTYPES[table.dtype])
    return out
