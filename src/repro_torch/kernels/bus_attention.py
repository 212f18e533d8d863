"""BusLM segment + bus attention: the plain PyTorch version and the CUDA
kernel's wrapper (``csrc/bus_attention.cu``).

For each (news, segment, head), S queries attend over Sk = S + K keys:
the segment's own tokens plus the K bus proxies (the [CLS] rows of every
segment of the same news). Masked keys are filled with -1e30 and the
softmax is max-subtracted in f32, so a segment whose keys are all masked
averages v uniformly over its Sk keys.
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


def bus_attention_cuda(q, k, v, kv_mask):
    """Launch the CUDA kernel; same contract as ``bus_attention_plain``.
    Raises on anything the kernel does not take."""
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
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_mask", kv_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
