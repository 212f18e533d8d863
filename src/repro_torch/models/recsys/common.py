"""Shared recsys substrate: sparse-feature embedding stacks.

Embedding tables are the hot path: [V, d] tables read by fixed multi-hot
lookups. ``lookup`` goes through ``kernels.ops.embedding_bag``, the CUDA
kernel on the card (its plain version on the CPU), for the fused table
and the per-field tables alike; on a mesh, through the same kernel on
this rank's block of the fused table (``parallel.sharded_bag``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import embedding_bag_plain
from repro_torch.nn import init_embedding, normal_init

from . import parallel as rp

_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class SparseSpec:
    n_fields: int
    vocab_sizes: tuple      # per-field rows
    embed_dim: int
    nnz: int = 1            # multi-hot width (static, padded)

    @property
    def total_rows(self) -> int:
        return sum(self.vocab_sizes)


def uniform_vocab(n_fields: int, vocab: int) -> tuple:
    return tuple([vocab] * n_fields)


def criteo_like_vocab(n_fields: int = 26, *, scale: float = 1.0) -> tuple:
    """Long-tailed per-field vocab sizes shaped like Criteo's 26 fields."""
    base = [7912889, 33823, 17139, 7339, 20046, 4, 7105, 1382, 63, 5554114,
            582469, 245828, 11, 2209, 10667, 104, 4, 968, 15, 8165896,
            2675940, 7156453, 302516, 12022, 97, 35][:n_fields]
    while len(base) < n_fields:
        base.append(10000)
    return tuple(max(4, int(v * scale)) for v in base)


ROW_PAD = 4096   # fused tables are padded to a multiple of this (the JAX
                 # package's mesh divisibility); pad rows are dead


def padded_rows(total: int) -> int:
    return -(-total // ROW_PAD) * ROW_PAD


def init_tables(gen: torch.Generator, spec: SparseSpec,
                param_dtype=torch.float32, *, fused: bool = True):
    """One fused [padded_rows(sum V_f), d] table, read through per-field
    row offsets, or one table per field (``{"f0": {"table": ...}, ...}``).
    Drawn from ``gen`` on its device."""
    if fused:
        return {"fused": normal_init(gen, (padded_rows(spec.total_rows),
                                           spec.embed_dim), 0.02,
                                     param_dtype)}
    return {f"f{i}": init_embedding(gen, spec.vocab_sizes[i], spec.embed_dim,
                                    dtype=param_dtype)
            for i in range(spec.n_fields)}


@functools.lru_cache(maxsize=None)
def _offsets(spec: SparseSpec, device: torch.device) -> torch.Tensor:
    off = [0]
    for v in spec.vocab_sizes[:-1]:
        off.append(off[-1] + v)
    return torch.tensor(off, dtype=torch.int32, device=device)


def field_offsets(spec: SparseSpec, device="cpu") -> torch.Tensor:
    """Each field's first row in the fused table, int32 [F] on ``device``
    (made once per spec and device, so a forward copies nothing to the
    card)."""
    return _offsets(spec, torch.device(device))


def lookup(tables, spec: SparseSpec, idx, weights=None, *,
           impl: str = "kernel", mesh=None):
    """idx: [B, F, nnz] per-field local int32 indices; weights: [B, F, nnz]
    f32 or None -> [B, F, d].

    The fused layout shifts the indices by the per-field offsets into the
    single table. ``impl="kernel"`` goes through ``ops.embedding_bag``
    (the CUDA kernel on the card); ``impl="plain"`` calls its plain
    version on whatever device the tensors are on, only as the reference
    a card run holds the kernel against. With ``mesh`` the fused table is
    this rank's block of rows over ``model``, and the lookup the bag on
    that block summed over ``model`` (``parallel.sharded_bag``).
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown lookup impl: {impl!r}")
    bag = ops.embedding_bag if impl == "kernel" else embedding_bag_plain
    if "fused" in tables:
        shifted = idx + field_offsets(spec, idx.device)[None, :, None]
        if mesh is not None:
            return rp.sharded_bag(bag, tables["fused"], shifted, weights,
                                  mesh)
        return bag(tables["fused"], shifted, weights)
    if mesh is not None:
        raise ValueError("on a mesh the tables are fused (recsys_rules "
                         "cuts tables/fused by rows)")
    outs = [bag(tables[f"f{i}"]["table"], idx[:, i:i + 1].contiguous(),
                None if weights is None
                else weights[:, i:i + 1].contiguous())
            for i in range(spec.n_fields)]
    return torch.cat(outs, dim=1)


def bce_loss(logits, labels, *, mesh=None, split: bool = True):
    """Binary cross-entropy on logits [B] vs labels [B] in {0, 1}. With
    ``mesh``: this rank's data block's, and the loss and accuracy the
    global batch's means (``parallel.data_mean``; ``split`` False where
    the block is the whole batch)."""
    lf = logits.float()
    per = (torch.clamp_min(lf, 0) - lf * labels
           + torch.log1p(torch.exp(-lf.abs())))
    hit = ((lf > 0) == (labels > 0.5)).float()
    if mesh is None:
        loss, acc = torch.mean(per), hit.mean()
    else:
        n = torch.tensor(per.numel(), device=per.device)
        loss = rp.data_mean(per.sum(), n, split, mesh)
        acc = rp.data_mean(hit.sum().detach(), n, split, mesh)
    return loss, {"bce": loss, "acc": acc}
