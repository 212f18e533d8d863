"""Shared recsys substrate: sparse-feature embedding stacks.

Embedding tables are the hot path: [V, d] tables read by fixed multi-hot
lookups. ``lookup`` goes through ``kernels.ops.embedding_bag``, the CUDA
kernel on the card (its plain version on the CPU), for the fused table
and the per-field tables alike.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import embedding_bag_plain
from repro_torch.nn import init_embedding, normal_init

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
           impl: str = "kernel"):
    """idx: [B, F, nnz] per-field local int32 indices; weights: [B, F, nnz]
    f32 or None -> [B, F, d].

    The fused layout shifts the indices by the per-field offsets into the
    single table. ``impl="kernel"`` goes through ``ops.embedding_bag``
    (the CUDA kernel on the card); ``impl="plain"`` calls its plain
    version on whatever device the tensors are on, only as the reference
    a card run holds the kernel against.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown lookup impl: {impl!r}")
    bag = ops.embedding_bag if impl == "kernel" else embedding_bag_plain
    if "fused" in tables:
        shifted = idx + field_offsets(spec, idx.device)[None, :, None]
        return bag(tables["fused"], shifted, weights)
    outs = [bag(tables[f"f{i}"]["table"], idx[:, i:i + 1].contiguous(),
                None if weights is None
                else weights[:, i:i + 1].contiguous())
            for i in range(spec.n_fields)]
    return torch.cat(outs, dim=1)


def bce_loss(logits, labels):
    """Binary cross-entropy on logits [B] vs labels [B] in {0, 1}."""
    lf = logits.float()
    loss = torch.mean(torch.clamp_min(lf, 0) - lf * labels
                      + torch.log1p(torch.exp(-lf.abs())))
    acc = ((lf > 0) == (labels > 0.5)).float().mean()
    return loss, {"bce": loss, "acc": acc}
