"""BusLM segment + bus attention, forward and backward: the plain PyTorch
versions and the CUDA kernels' wrappers (``csrc/bus_attention.cu``).

For each (news, segment, head), S queries attend over Sk = S + K keys:
the segment's own tokens plus the K bus proxies (the [CLS] rows of every
segment of the same news). Masked keys are filled with -1e30 and the
softmax is max-subtracted in f32, so a segment whose keys are all masked
averages v uniformly over its Sk keys. The backward recomputes the
softmax from q/k/v with the forward's arithmetic; the mask gets no
gradient.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_device

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("bus_attention", "bus_attention.cu", {
    "bus_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          ctypes.c_float, _P],
    "bus_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, ctypes.c_float, _P],
})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def bus_attention_plain(q, k, v, kv_mask):
    """q: [M, K, S, H, D]; k/v: [M, K, Sk, H, D]; kv_mask: [M, K, Sk] bool
    -> [M, K, S, H, D] in q's dtype (f32 math)."""
    s = torch.einsum("mkshd,mkthd->mkhst", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    s = s.masked_fill(~kv_mask[:, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("mkhst,mkthd->mkshd", p, v.float())
    return o.to(q.dtype)


def bus_attention_bwd_plain(q, k, v, kv_mask, do):
    """(dq, dk, dv) of ``bus_attention_plain`` for the output gradient
    ``do`` [M, K, S, H, D], in the primal dtypes (f32 math):
    ds = where(mask, p * (dp - rowsum(p * dp)), 0) * scale."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    scale = q.shape[-1] ** -0.5
    keep = kv_mask[:, :, None, None, :]
    s = torch.einsum("mkshd,mkthd->mkhst", qf, kf) * scale
    p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
    dv = torch.einsum("mkhst,mkshd->mkthd", p, dof)
    dp = torch.einsum("mkshd,mkthd->mkhst", dof, vf)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = torch.where(keep, p * (dp - delta), 0.0) * scale
    dq = torch.einsum("mkhst,mkthd->mkshd", ds, kf)
    dk = torch.einsum("mkhst,mkshd->mkthd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, kv_mask, *more):
    """Validate what the kernels take; returns (M, K, S, Sk, H, D)."""
    check_device(q)
    if q.dim() != 5 or k.dim() != 5 or kv_mask.dim() != 3:
        raise ValueError("expected q/k/v [M, K, S|Sk, H, D], mask [M, K, Sk]")
    M, K, S, H, D = q.shape
    Sk = k.shape[2]
    if k.shape != (M, K, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if kv_mask.shape != (M, K, Sk) or kv_mask.dtype != torch.bool:
        raise ValueError(f"kv_mask must be bool {(M, K, Sk)}, got "
                         f"{kv_mask.dtype} {tuple(kv_mask.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_mask", kv_mask),
                    *more):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return M, K, S, Sk, H, D


def bus_attention_cuda(q, k, v, kv_mask):
    """Launch the CUDA forward; same contract as ``bus_attention_plain``.
    Raises on anything the kernel does not take."""
    M, K, S, Sk, H, D = _check(q, k, v, kv_mask)
    smem = 4 * (S * D + Sk * (D + 1) + Sk * D + S * Sk) + Sk
    if smem > 232448:
        raise ValueError(f"tile needs {smem} bytes of shared memory")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    KERNEL.launch("bus_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), kv_mask.data_ptr(), o.data_ptr(), M, K, S, Sk,
                  H, D, _DTYPES[q.dtype], float(D ** -0.5))
    return o


def bus_attention_bwd_cuda(q, k, v, kv_mask, do):
    """Launch the CUDA backward; same contract as
    ``bus_attention_bwd_plain``. Raises on anything the kernel does not
    take."""
    M, K, S, Sk, H, D = _check(q, k, v, kv_mask, ("do", do))
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {q.dtype} {tuple(q.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    smem = 4 * (2 * S * D + 2 * Sk * (D + 1) + 2 * S * Sk) + Sk
    if smem > 232448:
        raise ValueError(f"tile needs {smem} bytes of shared memory")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    KERNEL.launch("bus_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), kv_mask.data_ptr(), do.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), M, K, S, Sk,
                  H, D, _DTYPES[q.dtype], float(D ** -0.5))
    return dq, dk, dv
