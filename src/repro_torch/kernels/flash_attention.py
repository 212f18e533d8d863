"""Flash attention forward (causal or not, GQA): the plain PyTorch version
and the CUDA kernel's wrapper (``csrc/flash_attention.cu``).

q: [B, Sq, Hq, D] attends over k/v: [B, Sk, Hkv, D], q-head h reading
kv head h // G (G = Hq // Hkv). Scores are scaled by D^-1/2 and, when
causal, filled with -1e30 above the diagonal offset ``q_off = Sk - Sq``
(query row i sits at key position i + q_off). The softmax is taken in
f32; the output comes back in q's dtype together with the row
logsumexp ``lse = m + log(max(l, 1e-30))`` ([B, Hq, Sq], f32), the only
statistic a backward pass needs. A causal call needs Sq <= Sk, so that
every row sees at least one key.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_device

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = CudaKernel("flash_attention", "flash_attention.cu", {
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            *([_L] * 12), _I, _I, ctypes.c_float, _P],
})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q, k, v, causal: bool):
    """Validate the shapes both versions take; returns (B, Sq, Sk, Hq, Hkv,
    D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if causal and Sq > Sk:
        raise ValueError(f"causal flash attention requires Sq <= Sk (rows "
                         f"need >= 1 key); got Sq={Sq}, Sk={Sk}")
    return B, Sq, Sk, Hq, Hkv, D


def flash_attention_fwd_plain(q, k, v, causal: bool = True):
    """(o [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] f32), f32 math:
    ``kernels/ref.py``'s formula with the kernel's lse."""
    B, Sq, Sk, Hq, Hkv, D = check_shapes(q, k, v, causal)
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * D ** -0.5
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0]                        # [B, Hkv, G, Sq]
    return o.reshape(B, Sq, Hq, D).to(q.dtype), lse.reshape(B, Hq, Sq)


def flash_attention_cuda(q, k, v, causal: bool = True):
    """Launch the CUDA forward; same contract as
    ``flash_attention_fwd_plain``. q/k/v may be strided views as long as
    their last axis is contiguous. Raises on anything the kernel does not
    take."""
    check_device(q)
    B, Sq, Sk, Hq, Hkv, D = check_shapes(q, k, v, causal)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"head dim {D} is not a multiple of 16 in [16, 128]")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    o = torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    KERNEL.launch("flash_attention_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  B, Sq, Sk, Hq, Hkv, D, *strides, int(causal),
                  _DTYPES[q.dtype], float(D ** -0.5))
    return o, lse
