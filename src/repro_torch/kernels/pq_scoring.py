"""PQ asymmetric-distance LUT scan: the plain PyTorch version and the
CUDA kernel's wrapper (``csrc/pq_scoring.cu``).

``out[b, n] = sum_m lut[b, m, codes[min(b, Bc-1), n, m]]``; with
``valid`` [Bv, N], invalid slots score -inf (padded-CSR gathers carry
unwritten tail slots that must never win a top-k).

A code indexes its table row as numpy indexing does, so a negative int32
code counts from the end; a code outside [-K, K) makes its slot's score
NaN, as the JAX package's reference gather does (``take_along_axis``
fills out-of-range reads with NaN). A payload read against the wrong
codebook thus shows up in the scores on every device.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_device

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("pq_scoring", "pq_scoring.cu", {
    "pq_lut_scores": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _I,
                      _I, _P],
})
_CODE_BYTES = {torch.uint8: 1, torch.int32: 4}
_MAX_SMEM = 232448


def pq_lut_scores_plain(lut, codes, valid=None):
    """lut: [B, M, K]; codes: [Bc, N, M] (Bc in {1, B}) -> [B, N] f32."""
    B, _, K = lut.shape
    Bc, N, M = codes.shape
    idx = codes.long()          # uint8 indices would be read as a bool mask
    idx = torch.where(idx < 0, idx + K, idx)
    bad = ((idx < 0) | (idx >= K)).expand(B, N, M).permute(0, 2, 1)
    idx = idx.clamp(0, K - 1).expand(B, N, M).permute(0, 2, 1)  # [B, M, N]
    scores = torch.gather(lut.float(), 2, idx).masked_fill(
        bad, float("nan")).sum(dim=1)                           # [B, N]
    if valid is not None:
        scores = scores.masked_fill(~valid.bool(), float("-inf"))
    return scores


def pq_lut_scores_cuda(lut, codes, valid=None):
    """Launch the CUDA kernel; same contract as ``pq_lut_scores_plain``.
    Raises on anything the kernel does not take."""
    check_device(lut)
    if lut.dim() != 3 or codes.dim() != 3:
        raise ValueError("expected lut [B, M, K] and codes [Bc, N, M]")
    B, M, K = lut.shape
    Bc, N, Mc = codes.shape
    if Mc != M or Bc not in (1, B):
        raise ValueError(f"codes {tuple(codes.shape)} vs lut "
                         f"{tuple(lut.shape)}")
    if lut.dtype != torch.float32:
        raise TypeError(f"lut must be float32, got {lut.dtype}")
    if codes.dtype not in _CODE_BYTES:
        raise TypeError(f"codes must be uint8 or int32, got {codes.dtype}")
    if 4 * M * K > _MAX_SMEM:
        raise ValueError(f"a [{M}, {K}] table does not fit shared memory")
    tensors = [("lut", lut), ("codes", codes)]
    Bv = 1
    if valid is not None:
        Bv, Nv = valid.shape
        if valid.dtype != torch.bool or Nv != N or Bv not in (1, B):
            raise ValueError(f"valid must be bool [1|{B}, {N}], got "
                             f"{valid.dtype} {tuple(valid.shape)}")
        tensors.append(("valid", valid))
    for name, t in tensors:
        if t.device != lut.device:
            raise ValueError(f"{name} is on {t.device}, lut on {lut.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((B, N), dtype=torch.float32, device=lut.device)
    if out.numel() == 0:
        return out
    KERNEL.launch("pq_lut_scores", lut.device, lut.data_ptr(),
                  codes.data_ptr(),
                  valid.data_ptr() if valid is not None else None,
                  out.data_ptr(), B, M, K, N, Bc, Bv,
                  _CODE_BYTES[codes.dtype])
    return out
