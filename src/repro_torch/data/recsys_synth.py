"""Synthetic recsys data: Criteo-like CTR batches (a learnable click rule)
and BERT4Rec item sequences with Cloze masking.

The draws are the JAX package's numpy ``Generator`` calls, in its order,
so one seed gives the same batch in both packages; the arrays then go to
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import check_device


def _to(arrays: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def ctr_batch(rng: np.random.Generator, *, batch: int, n_dense: int,
              vocab_sizes, nnz: int = 1, learnable: bool = True,
              device="cuda"):
    """{sparse_idx [B, F, nnz] int32, sparse_w [B, F, nnz] f32 (ones),
    label [B] f32, dense [B, n_dense] f32 (when n_dense)} on ``device``."""
    device = check_device(device)
    F = len(vocab_sizes)
    idx = np.stack([rng.integers(0, v, size=(batch, nnz))
                    for v in vocab_sizes], axis=1).astype(np.int32)
    w = np.ones((batch, F, nnz), np.float32)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32) \
        if n_dense else None
    if learnable:
        # click depends on a linear rule over (hashed) feature parities
        signal = sum(((idx[:, f, 0] % 7) - 3) * ((-1) ** f)
                     for f in range(F)).astype(np.float32)
        if dense is not None:
            signal = signal + 2.0 * dense[:, 0]
        p = 1 / (1 + np.exp(-signal / max(F ** 0.5, 1)))
        label = (rng.random(batch) < p).astype(np.float32)
    else:
        label = rng.integers(0, 2, batch).astype(np.float32)
    out = {"sparse_idx": idx, "sparse_w": w, "label": label}
    if dense is not None:
        out["dense"] = dense
    return _to(out, device)


def bert4rec_batch(rng: np.random.Generator, *, batch: int, seq_len: int,
                   n_items: int, n_mask: int, n_neg: int, mask_token: int,
                   markov: bool = True, device="cuda"):
    """Sequences from a block-markov item process (so Cloze is
    learnable): {tokens, mask_pos, labels, mask_valid, neg} on
    ``device``."""
    device = check_device(device)
    if markov:
        n_blocks = 8
        block = rng.integers(0, n_blocks, batch)
        per = max(n_items // n_blocks, 1)
        toks = (block[:, None] * per
                + rng.integers(0, per, (batch, seq_len)) + 1)
        toks = np.minimum(toks, n_items - 1)
    else:
        toks = rng.integers(1, n_items, (batch, seq_len))
    toks = toks.astype(np.int32)
    mask_pos = np.stack([rng.choice(seq_len, n_mask, replace=False)
                         for _ in range(batch)]).astype(np.int32)
    labels = np.take_along_axis(toks, mask_pos, axis=1)
    masked = toks.copy()
    np.put_along_axis(masked, mask_pos, mask_token, axis=1)
    neg = rng.integers(1, n_items, (batch, n_mask, n_neg)).astype(np.int32)
    return _to({"tokens": masked, "mask_pos": mask_pos, "labels": labels,
                "mask_valid": np.ones((batch, n_mask), bool), "neg": neg},
               device)
