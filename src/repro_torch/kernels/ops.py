"""Entry points for the hand-written kernels, dispatched on the device.

A tensor on the CPU takes the kernel's plain PyTorch version (this is
how the tests run). A CUDA tensor launches the CUDA kernel, or raises:
a device that is not sm_90, a missing ``nvcc``, a failed build or a
failed launch is an error, never a reason to run something else.

Bus attention, flash attention and the EmbeddingBag are differentiable:
each goes through one ``torch.autograd.Function`` on every device, whose
forward and backward are the CUDA kernels on the card and their plain
versions on the CPU. The EmbeddingBag's backward gives the table's
gradient (the JAX package trains through XLA's take, whose transpose is a
dense scatter-add; its Pallas kernel has no VJP). Its weights are batch
data that no JAX cell differentiates: on every device ``embedding_bag``
raises when they require grad, rather than drop their gradient.

A meta tensor takes each kernel's meta route, a device branch like the
CPU's: the card's checks and route choice, then outputs of the card's
shapes and dtypes and no launch. It records the route and the kernel's
``work()`` in each active counter (``launch/op_analysis.py``), which is
how the dry-run counts a step that runs through the kernels without a
card. ``launch_counts()`` does not move.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from . import bus_attention as _bus
from . import embedding_bag as _ebag
from . import flash_attention as _flash
from . import pq_scoring as _pq
from ._build import build

# kernel name -> (library, C symbol whose launches it counts)
KERNELS = {**_bus.ROUTES,
           **{name: (_pq.KERNEL, name) for name in _pq.ROUTES},
           "flash_attention": (_flash.KERNEL, "flash_attention_fwd"),
           "flash_attention_wgmma": (_flash.KERNEL_WGMMA,
                                     "flash_attention_fwd_wgmma"),
           "flash_attention_tf32": (_flash.KERNEL_TF32,
                                    "flash_attention_fwd_tf32"),
           "flash_attention_bwd_dq": (_flash.KERNEL,
                                      "flash_attention_bwd_dq"),
           "flash_attention_bwd_dkv": (_flash.KERNEL,
                                       "flash_attention_bwd_dkv"),
           "flash_attention_bwd_dq_wgmma": (
               _flash.KERNEL_BWD_WGMMA, "flash_attention_bwd_dq_wgmma"),
           "flash_attention_bwd_dkv_wgmma": (
               _flash.KERNEL_BWD_WGMMA, "flash_attention_bwd_dkv_wgmma"),
           "flash_attention_bwd_dq_tf32": (
               _flash.KERNEL_BWD_TF32, "flash_attention_bwd_dq_tf32"),
           "flash_attention_bwd_dkv_tf32": (
               _flash.KERNEL_BWD_TF32, "flash_attention_bwd_dkv_tf32"),
           "embedding_bag": (_ebag.KERNEL, "embedding_bag"),
           "embedding_bag_bwd": (_ebag.KERNEL, "embedding_bag_bwd")}

FLASH_BLOCK = 128      # the JAX wrapper's default tile; the routing rule reads it


def _counted(out, route, work):
    """``out``, after recording a meta call's route (a kernel name, or the
    backward's pair) and its ``work`` in each active dispatch mode that
    counts kernels (one with ``add_kernel``: ``op_analysis.OpCounter``)."""
    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "add_kernel"):
            mode.add_kernel(route, work)
    return out


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
        elif q.device.type == "meta":
            o, lse = _counted(*_flash.flash_attention_meta(q, k, v, causal))
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
        if q.device.type == "meta":
            return (*_counted(*_flash.flash_attention_bwd_meta(
                q, k, v, o, lse, do, ctx.causal)), None)
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
        if q.device.type == "meta":
            return _counted(*_bus.bus_attention_meta(q, k, v, kv_mask))
        return _bus.bus_attention_cuda(q, k, v, kv_mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = _bus.bus_attention_bwd_plain(q, k, v, kv_mask, do)
        elif q.device.type == "meta":
            dq, dk, dv = _counted(*_bus.bus_attention_bwd_meta(
                q, k, v, kv_mask, do))
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
    variants are the kernel ``pq_scoring.pq_route`` picks by shape, whose
    tiles are its own."""
    del block_n
    if variant not in ("auto", "onehot", "gather"):
        raise ValueError(f"unknown pq scan variant: {variant!r}")
    if lut.device.type == "cpu":
        return _pq.pq_lut_scores_plain(lut, codes, valid)
    if lut.device.type == "meta":
        return _counted(*_pq.pq_lut_scores_meta(lut, codes, valid))
    return _pq.pq_lut_scores_cuda(lut, codes, valid)


class _EmbeddingBag(torch.autograd.Function):
    """(table, idx, weights) -> [B, F, d]. Saves idx and the weights; the
    backward gives the table's dense gradient, idx and the weights none."""

    @staticmethod
    def forward(ctx, table, idx, weights):
        ctx.save_for_backward(idx, weights)
        ctx.num_rows = table.shape[0]
        if table.device.type == "cpu":
            return _ebag.embedding_bag_plain(table, idx, weights)
        if table.device.type == "meta":
            return _counted(*_ebag.embedding_bag_meta(table, idx, weights))
        return _ebag.embedding_bag_cuda(table, idx, weights)

    @staticmethod
    def backward(ctx, dout):
        idx, weights = ctx.saved_tensors
        if dout.device.type == "meta":
            return (_counted(*_ebag.embedding_bag_bwd_meta(
                dout.contiguous(), idx, weights, ctx.num_rows)), None, None)
        bwd = (_ebag.embedding_bag_bwd_plain if dout.device.type == "cpu"
               else _ebag.embedding_bag_bwd_cuda)
        return bwd(dout.contiguous(), idx, weights, ctx.num_rows), None, None


def embedding_bag(table, idx, weights=None):
    """table: [V, d]; idx: [B, F, nnz] int32; weights: [B, F, nnz] f32 or
    None (all ones) -> [B, F, d] in the table's dtype, differentiable in
    the table. Weights that require grad raise under autograd, on every
    device: no JAX cell differentiates them, and nothing computes their
    gradient."""
    if (torch.is_grad_enabled() and weights is not None
            and weights.requires_grad):
        raise NotImplementedError(
            "embedding_bag has no backward for the weights: only the "
            "table gets a gradient")
    return _EmbeddingBag.apply(table, idx, weights)


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
