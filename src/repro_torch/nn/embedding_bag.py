"""EmbeddingBag in plain PyTorch: the reference layouts of the recsys
path.

  * fixed multi-hot: indices [..., nnz] with optional weights (0 = a
    padded slot); ``embedding_bag`` reduces over the trailing axis by sum,
    mean or max.
  * flat/offsets: torch-style ragged bags (indices [N] with segment ids);
    ``offsets_to_fixed`` turns them into the fixed layout on the host.

Rows are read as the JAX package's ``jnp.take`` reads them (negative
indices count from the end, an index outside [-V, V) reads NaN). The
fused gather plus weighted sum of the recsys models goes through
``kernels.ops.embedding_bag`` (the CUDA kernel on the card); this module
is the plain path, as it is in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.embedding_bag import take_rows


def embedding_bag(table, indices, weights=None, *, mode: str = "sum"):
    """table: [V, d]; indices: [..., nnz]; weights: optional [..., nnz].

    Reduces over the trailing ``nnz`` axis. Padded slots should carry
    weight 0 (or index into a zero row). Returns [..., d].
    """
    emb = take_rows(table, indices)                     # [..., nnz, d]
    if weights is not None:
        emb = emb * weights[..., None].to(emb.dtype)
    if mode == "sum":
        return emb.sum(dim=-2)
    if mode == "mean":
        denom = (weights.sum(-1, keepdim=True).clamp_min(1e-9)
                 if weights is not None else max(indices.shape[-1], 1e-9))
        return emb.sum(dim=-2) / denom
    if mode == "max":
        if weights is not None:
            emb = torch.where(weights[..., None] > 0, emb,
                              torch.tensor(float("-inf"), dtype=emb.dtype,
                                           device=emb.device))
        return emb.amax(dim=-2)
    raise ValueError(mode)


def embedding_bag_flat(table, indices, segment_ids, num_segments: int,
                       weights=None):
    """torch-style ragged bags: indices [N], segment_ids [N] -> [B, d].

    A gather, then a scatter-add by segment; a segment id outside
    [0, num_segments) is dropped, as ``jax.ops.segment_sum`` drops it.
    """
    emb = take_rows(table, indices)                     # [N, d]
    if weights is not None:
        emb = emb * weights[:, None].to(emb.dtype)
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < num_segments)
    out = torch.zeros((num_segments, table.shape[1]), dtype=emb.dtype,
                      device=emb.device)
    return out.index_add_(0, seg[keep], emb[keep])


def offsets_to_fixed(indices: np.ndarray, offsets: np.ndarray, nnz: int,
                     pad_index: int = 0):
    """Host-side conversion: (indices [N], offsets [B]) -> ([B, nnz],
    [B, nnz]).

    Returns the padded index matrix and a float weight mask. Bags longer
    than ``nnz`` are truncated.
    """
    B = len(offsets)
    out = np.full((B, nnz), pad_index, dtype=np.int32)
    w = np.zeros((B, nnz), dtype=np.float32)
    ends = np.append(offsets[1:], len(indices))
    for b in range(B):
        seg = indices[offsets[b]:ends[b]][:nnz]
        out[b, :len(seg)] = seg
        w[b, :len(seg)] = 1.0
    return out, w
