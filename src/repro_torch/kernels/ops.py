"""Entry points for the hand-written kernels, dispatched on the device.

A tensor on the CPU takes the kernel's plain PyTorch version (this is
how the tests run). A CUDA tensor launches the CUDA kernel, or raises:
a device that is not sm_90, a missing ``nvcc``, a failed build or a
failed launch is an error, never a reason to run something else.
"""
from __future__ import annotations

from . import bus_attention as _bus
from . import pq_scoring as _pq
from ._build import build

KERNELS = {"bus_attention": _bus.KERNEL, "pq_lut_scores": _pq.KERNEL}


def bus_attention(q, k, v, kv_mask, *, block_m: int = 8):
    """q: [M, K, S, H, D]; k/v: [M, K, Sk, H, D]; kv_mask: [M, K, Sk].
    ``block_m`` is kept for parity with the TPU wrapper, which padded M to
    a block multiple; a CUDA grid needs no padding, so it is unused."""
    del block_m
    if q.device.type == "cpu":
        return _bus.bus_attention_plain(q, k, v, kv_mask)
    return _bus.bus_attention_cuda(q, k, v, kv_mask)


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


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: kern.launches for name, kern in KERNELS.items()}


def reset_launch_counts():
    for kern in KERNELS.values():
        kern.launches = 0


def build_all():
    """Build every kernel's library now, one ``nvcc`` per source, started
    together; returns the compilers' output by kernel name."""
    build(KERNELS.values())
    for kern in KERNELS.values():
        kern.lib()
    return {name: kern.build_log for name, kern in KERNELS.items()}
