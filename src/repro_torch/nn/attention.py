"""Scaled-dot-product attention with GQA grouping (plain PyTorch).

Masked logits are filled with a finite -1e30, by hand: a fully-masked
row then averages V uniformly, as the JAX reference does, where
``F.scaled_dot_product_attention`` with a boolean mask returns 0.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def sdpa(q, k, v, *, causal: bool, mask=None, q_offset: int | None = None):
    """q: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D]; Hq % Hkv == 0.

    mask: optional [B, Sk] (key validity) or [B, Sq, Sk] boolean mask.
    ``q_offset``: absolute position of q's first row for causal masking
    when Sq != Sk.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * D ** -0.5
    if causal:
        off = q_offset if q_offset is not None else Sk - Sq
        qpos = torch.arange(Sq, device=q.device)[:, None] + off
        kpos = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(qpos >= kpos), NEG_INF)
    if mask is not None:
        if mask.dim() == 2:       # [B, Sk]
            m = mask[:, None, None, None, :]
        else:                     # [B, Sq, Sk]
            m = mask[:, None, None, :, :]
        logits = logits.masked_fill(~m, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, Hq, D)
