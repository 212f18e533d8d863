"""Entry points for the hand-written kernels, dispatched on the device.

A tensor on the CPU takes the kernel's plain PyTorch version (this is
how the tests run). A CUDA tensor launches the CUDA kernel, or raises:
a device that is not sm_90, a missing ``nvcc``, a failed build or a
failed launch is an error, never a reason to run something else.

Bus attention and flash attention are differentiable: each goes through
one ``torch.autograd.Function`` on every device, whose forward and
backward are the CUDA kernels on the card and their plain versions on
the CPU. The EmbeddingBag kernel has no backward (the JAX package gives
its Pallas kernel no VJP): on the card ``embedding_bag`` raises when an
input requires grad, rather than return an output that autograd cannot
reach.
"""
from __future__ import annotations

import torch

from . import bus_attention as _bus
from . import embedding_bag as _ebag
from . import flash_attention as _flash
from . import pq_scoring as _pq
from ._build import build

# kernel name -> (library, C symbol whose launches it counts)
KERNELS = {"bus_attention": (_bus.KERNEL, "bus_attention_fwd"),
           "bus_attention_bwd": (_bus.KERNEL, "bus_attention_bwd"),
           "pq_lut_scores": (_pq.KERNEL, "pq_lut_scores"),
           "flash_attention": (_flash.KERNEL, "flash_attention_fwd"),
           "flash_attention_wgmma": (_flash.KERNEL_WGMMA,
                                     "flash_attention_fwd_wgmma"),
           "flash_attention_bwd_dq": (_flash.KERNEL,
                                      "flash_attention_bwd_dq"),
           "flash_attention_bwd_dkv": (_flash.KERNEL,
                                       "flash_attention_bwd_dkv"),
           "flash_attention_bwd_dq_wgmma": (
               _flash.KERNEL_BWD_WGMMA, "flash_attention_bwd_dq_wgmma"),
           "flash_attention_bwd_dkv_wgmma": (
               _flash.KERNEL_BWD_WGMMA, "flash_attention_bwd_dkv_wgmma"),
           "embedding_bag": (_ebag.KERNEL, "embedding_bag")}

FLASH_BLOCK = 128      # the JAX wrapper's default tile; the routing rule reads it


def flash_attention_supported(seq_len: int) -> bool:
    """Whether ``nn.attention`` routes a self-attention call of this length
    to the flash kernel: the JAX package's rule (S divides into the
    default block, clamped to S, and is a multiple of 8), so both packages
    route the same calls. The CUDA kernel itself takes any length."""
    return seq_len % 8 == 0 and seq_len % min(FLASH_BLOCK, seq_len) == 0


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> o. Saves q/k/v, o and lse and recomputes the
    probabilities in the backward (the JAX package's custom VJP,
    ``kernels/ops.py``); the gradients come back in the primal dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            o, lse = _flash.flash_attention_fwd_plain(q, k, v, causal)
        else:
            o, lse = _flash.flash_attention_cuda(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        bwd = (_flash.flash_attention_bwd_plain if q.device.type == "cpu"
               else _flash.flash_attention_bwd_cuda)
        return (*bwd(q, k, v, o, lse, do, ctx.causal), None)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D] in q's
    dtype, differentiable. The CUDA kernels' tiles are their own, so the
    TPU wrapper's ``block_q``/``block_k`` are not taken."""
    return _FlashAttention.apply(q, k, v, causal)


class _BusAttention(torch.autograd.Function):
    """(q, k, v, kv_mask) -> o. Saves q/k/v and recomputes the softmax in
    the backward (the JAX package's custom VJP, ``kernels/ops.py``); the
    mask gets no gradient, the others come back in the primal dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        ctx.save_for_backward(q, k, v, kv_mask)
        if q.device.type == "cpu":
            return _bus.bus_attention_plain(q, k, v, kv_mask)
        return _bus.bus_attention_cuda(q, k, v, kv_mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = _bus.bus_attention_bwd_plain(q, k, v, kv_mask, do)
        else:
            dq, dk, dv = _bus.bus_attention_bwd_cuda(q, k, v, kv_mask, do)
        return dq, dk, dv, None


def bus_attention(q, k, v, kv_mask, *, block_m: int = 8):
    """q: [M, K, S, H, D]; k/v: [M, K, Sk, H, D]; kv_mask: [M, K, Sk].
    ``block_m`` is kept for parity with the TPU wrapper, which padded M to
    a block multiple; a CUDA grid needs no padding, so it is unused."""
    del block_m
    return _BusAttention.apply(q, k, v, kv_mask)


def pq_lut_scores(lut, codes, valid=None, *, block_n: int = 128,
                  variant: str = "auto"):
    """lut: [B, M, K]; codes: [Bc, N, M]; valid: [Bv, N] -> [B, N] f32.
    ``block_n`` and ``variant`` are kept for parity with the TPU wrapper
    (candidate block, one-hot vs gather scoring); on the card both
    variants are this one kernel, whose block size is its own."""
    del block_n
    if variant not in ("auto", "onehot", "gather"):
        raise ValueError(f"unknown pq scan variant: {variant!r}")
    if lut.device.type == "cpu":
        return _pq.pq_lut_scores_plain(lut, codes, valid)
    return _pq.pq_lut_scores_cuda(lut, codes, valid)


def embedding_bag(table, idx, weights=None):
    """table: [V, d]; idx: [B, F, nnz] int32; weights: [B, F, nnz] f32 or
    None (all ones) -> [B, F, d] in the table's dtype. On a CUDA tensor
    this is forward only: a table or weights that require grad raise."""
    if table.device.type == "cpu":
        return _ebag.embedding_bag_plain(table, idx, weights)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (table, weights)):
        raise NotImplementedError(
            "embedding_bag on the card is forward only: the kernel has no "
            "backward, so a table or weights that require grad would lose "
            "their gradient")
    return _ebag.embedding_bag_cuda(table, idx, weights)


def _libraries():
    return list({id(lib): lib for lib, _ in KERNELS.values()}.values())


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: lib.launches[sym] for name, (lib, sym) in KERNELS.items()}


def reset_launch_counts():
    for lib in _libraries():
        lib.launches.clear()


def build_all():
    """Build every kernel library now, one ``nvcc`` per source, started
    together; returns the compilers' output by library name."""
    libs = _libraries()
    build(libs)
    for lib in libs:
        lib.lib()
    return {lib.name: lib.build_log for lib in libs}
