"""Centralized news encoding (§4.1.1): gather -> dedup -> encode -> dispatch.

All news in a mini-batch (user histories and candidates) are merged into
one deduplicated set, so each article is encoded once; embeddings are
then dispatched back to their original positions. Pads dispatch the
dummy vector.

The merged set has a static capacity ``m_cap``: ids past it map to the
pad slot and are counted. The host loader (``data/batching.py``) does
the same dedup off the device and ships index-mapped batches, so the
in-graph ``gather_dedup`` serves tests and raw-id pipelines.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MergedSet(NamedTuple):
    ids: torch.Tensor        # [m_cap] sorted unique ids, 0-padded
    inv_hist: torch.Tensor   # [B, L] positions into ids
    inv_cand: torch.Tensor   # [B, C] or None
    overflow: torch.Tensor   # scalar: distinct ids dropped (capacity)


def _invert(uniq, ids):
    pos = torch.searchsorted(uniq, ids).clamp(0, uniq.shape[0] - 1)
    return torch.where(uniq[pos] == ids, pos, 0)   # miss -> pad slot


def unique_sized(flat, size: int):
    """``jnp.unique(flat, size=size, fill_value=0)``: the ``size``
    smallest distinct values of ``flat`` in ascending order, zeros after
    them if there are fewer, in a tensor of static size (no host sync):
    sort, mark where a value changes, number the changes by a cumsum and
    scatter each distinct value into its slot; the values past ``size``
    go to a spare slot that is cut off."""
    s = torch.sort(flat).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    slot = torch.cumsum(first, 0) - 1
    slot = torch.where(first & (slot < size), slot, size)
    out = torch.zeros(size + 1, dtype=flat.dtype, device=flat.device)
    return out.scatter_(0, slot, s)[:size]


def gather_dedup(hist_ids, cand_ids=None, *, m_cap: int) -> MergedSet:
    """hist_ids: [B, L]; cand_ids: optional [B, C]; 0 = pad everywhere.

    Slot 0 of the merged set is always the pad id, even when no input id
    is 0, so that overflow maps somewhere inert. As in the JAX package,
    ``unique_sized`` keeps the m_cap smallest distinct ids and pads with
    zeros at the end; the result is then sorted so the zeros come first.
    """
    parts = [torch.zeros(1, dtype=hist_ids.dtype, device=hist_ids.device),
             hist_ids.reshape(-1)]
    if cand_ids is not None:
        parts.append(cand_ids.reshape(-1))
    flat = torch.cat(parts)
    uniq = torch.sort(unique_sized(flat, m_cap)).values
    inv_hist = _invert(uniq, hist_ids)
    inv_cand = _invert(uniq, cand_ids) if cand_ids is not None else None
    miss = uniq[torch.searchsorted(uniq, flat).clamp(0, m_cap - 1)] != flat
    overflow = (miss & (flat != 0)).sum()
    return MergedSet(uniq, inv_hist, inv_cand, overflow)


def dispatch(emb_m, inv):
    """emb_m: [M, d] merged-set embeddings -> [..., d] at original
    positions."""
    return emb_m[inv]
