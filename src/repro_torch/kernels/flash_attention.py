"""Flash attention (causal or not, GQA), forward and backward: the plain
PyTorch versions and the CUDA kernels' wrappers
(``csrc/flash_attention.cu``).

q: [B, Sq, Hq, D] attends over k/v: [B, Sk, Hkv, D], q-head h reading
kv head h // G (G = Hq // Hkv). Scores are scaled by D^-1/2 and, when
causal, filled with -1e30 above the diagonal offset ``q_off = Sk - Sq``
(query row i sits at key position i + q_off). The softmax is taken in
f32; the output comes back in q's dtype together with the row
logsumexp ``lse = m + log(max(l, 1e-30))`` ([B, Hq, Sq], f32), the only
statistic a backward pass needs. A causal call needs Sq <= Sk, so that
every row sees at least one key.

The backward (FlashAttention-2) takes the saved q, k, v, o, lse and the
cotangent dO, and recomputes the probabilities ``p = exp(s - lse)``
rather than storing them: ``delta = rowsum(dO * O)`` (f32), ``ds = p *
(dO v^T - delta)``, ``dq = ds k * scale``, ``dk = ds^T q * scale``,
``dv = p^T dO``. dq comes back in q's dtype; dk and dv are summed over
each kv head's group of q heads in f32 and come back in k's and v's.
The checks hold a bf16 kernel's f32 gradients before that cast, as the
TPU kernel writes dk and dv, against plain's: ``_bwd_plain_f32`` and
``_bwd_cuda_as_written`` return them.

Two CUDA forwards, chosen by ``forward_route`` from the dtype and head
dim before any launch: bf16 at a head dim in ``WGMMA_HEAD_DIMS`` goes to
the Hopper kernel (``csrc/flash_attention_wgmma.cu``: TMA and wgmma,
which reads q/k/v through TMA and so needs 16-byte-aligned bases and
strides), everything else to the SIMT kernel (``csrc/flash_attention.cu``,
f32 arithmetic). Each counts its launches under its own symbol. The
backward has the same two routes, chosen by ``backward_route``: a dq and a
dk/dv kernel each, Hopper (``csrc/flash_attention_bwd_wgmma.cu``, which
also reads dO through TMA and writes f32 gradients, cast here) or SIMT
(``csrc/flash_attention.cu``, which writes the inputs' dtype).
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
    # q, k, v, dO, lse, delta, dq, B, Sq, Sk, Hq, Hkv, D, 15 strides,
    # causal, dtype, scale, stream
    "flash_attention_bwd_dq": [*([_P] * 7), *([_I] * 6), *([_L] * 15),
                               _I, _I, ctypes.c_float, _P],
    # q, k, v, dO, lse, delta, dk, dv, B, Sq, Sk, Hq, Hkv, D, 18 strides,
    # causal, dtype, scale, stream
    "flash_attention_bwd_dkv": [*([_P] * 8), *([_I] * 6), *([_L] * 18),
                                _I, _I, ctypes.c_float, _P],
})
# the Hopper forward: q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, 12 strides,
# causal, scale, stream
KERNEL_WGMMA = CudaKernel("flash_attention_wgmma", "flash_attention_wgmma.cu",
                          {"flash_attention_fwd_wgmma": [
                              *([_P] * 5), *([_I] * 6), *([_L] * 12), _I,
                              ctypes.c_float, _P]})
# the Hopper backward: q, k, v, dO, lse, delta, then dq (B, Sq, Sk, Hq,
# Hkv, D, 15 strides) or dk, dv (the same, 18 strides); causal, scale,
# stream. dq, dk and dv are f32
KERNEL_BWD_WGMMA = CudaKernel(
    "flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma.cu", {
        "flash_attention_bwd_dq_wgmma": [*([_P] * 7), *([_I] * 6),
                                         *([_L] * 15), _I, ctypes.c_float,
                                         _P],
        "flash_attention_bwd_dkv_wgmma": [*([_P] * 8), *([_I] * 6),
                                          *([_L] * 18), _I, ctypes.c_float,
                                          _P]})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 128)


def forward_route(dtype, head_dim: int) -> str:
    """Which CUDA forward takes a call, by the name its launches count
    under in ``ops.KERNELS``: ``"flash_attention_wgmma"`` (the Hopper
    kernel) for bf16 at a head dim in WGMMA_HEAD_DIMS, else
    ``"flash_attention"`` (the SIMT kernel; f32 stays on f32 arithmetic: a
    tf32 product would miss the f32 tolerance)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "flash_attention_wgmma"
    return "flash_attention"


def backward_route(dtype, head_dim: int) -> tuple:
    """Which CUDA backward takes a call: the names its dq and dk/dv
    launches count under in ``ops.KERNELS`` (each also its C symbol).
    The rule is ``forward_route``'s: the Hopper pair
    (``"flash_attention_bwd_dq_wgmma"``, ``"flash_attention_bwd_dkv_wgmma"``)
    for bf16 at a head dim in WGMMA_HEAD_DIMS, else the SIMT pair
    (``"flash_attention_bwd_dq"``, ``"flash_attention_bwd_dkv"``)."""
    if forward_route(dtype, head_dim) == "flash_attention_wgmma":
        return "flash_attention_bwd_dq_wgmma", "flash_attention_bwd_dkv_wgmma"
    return "flash_attention_bwd_dq", "flash_attention_bwd_dkv"


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


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) of ``flash_attention_fwd_plain``'s output for the
    cotangent ``do`` [B, Sq, Hq, D], from the saved o and lse ([B, Hq,
    Sq], f32): p is recomputed from lse, as the kernels do, all in f32,
    then cast to q's, k's and v's dtypes. An explicit function (not
    autograd over the forward), so the tests hold the function the CUDA
    kernels implement."""
    dq, dk, dv = _bwd_plain_f32(q, k, v, o, lse, do, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_plain_f32(q, k, v, o, lse, do, causal: bool = True):
    """``flash_attention_bwd_plain``'s f32 (dq, dk, dv) before the cast."""
    B, Sq, Sk, Hq, Hkv, D = check_shapes(q, k, v, causal)
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    dog = do.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    delta = (dog * o.float().reshape(B, Sq, Hkv, G, D)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]          # [B, Hkv, G, Sq, 1]
    # scale, mask, then p = exp(s - lse), in place: two [.., Sq, Sk] f32
    # tensors are live at a time (p and ds)
    p = torch.einsum("bqkgd,bskd->bkgqs", qg, kf).mul_(scale)
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
                >= torch.arange(Sk, device=q.device)[None, :])
        p.masked_fill_(~keep, NEG_INF)
    p.sub_(lse.reshape(B, Hkv, G, Sq, 1)).exp_()
    ds = torch.einsum("bqkgd,bskd->bkgqs", dog, vf).sub_(delta).mul_(p)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    # the sums over g fold each kv head's group of q heads, in f32
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dq.reshape(B, Sq, Hq, D), dk, dv


def _check_kernel_inputs(q, k, v, causal, **more):
    """What both CUDA wrappers require of q/k/v and of the extra
    [B, Sq, Hq, D] tensors ``more`` (o, dO); returns check_shapes'."""
    check_device(q)
    shapes = check_shapes(q, k, v, causal)
    D = shapes[-1]
    named = {"q": q, "k": k, "v": v, **more}
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in named.values()):
        raise TypeError("unsupported dtypes " + "/".join(
            f"{n}={t.dtype}" for n, t in named.items()))
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"head dim {D} is not a multiple of 16 in [16, 128]")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name in more and t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} is not q's "
                             f"{tuple(q.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    return shapes


def flash_attention_cuda(q, k, v, causal: bool = True):
    """Launch the CUDA forward that ``forward_route`` picks; same contract
    as ``flash_attention_fwd_plain``. q/k/v may be strided views as long
    as their last axis is contiguous (and, on the Hopper route, TMA can
    read them: ``_check_tma``). Raises on anything the kernel does not
    take."""
    B, Sq, Sk, Hq, Hkv, D = _check_kernel_inputs(q, k, v, causal)
    wgmma = forward_route(q.dtype, D) == "flash_attention_wgmma"
    if wgmma:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)
    o = torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    if wgmma:
        strides = [s for t in (q, k, v) for s in _tma_strides(t)]
        KERNEL_WGMMA.launch("flash_attention_fwd_wgmma", q.device, *ptrs, B,
                            Sq, Sk, Hq, Hkv, D, *strides, *o.stride()[:3],
                            int(causal), float(D ** -0.5))
    else:
        strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
        KERNEL.launch("flash_attention_fwd", q.device, *ptrs, B, Sq, Sk, Hq,
                      Hkv, D, *strides, int(causal), _DTYPES[q.dtype],
                      float(D ** -0.5))
    return o, lse


def _check_tma(name, t):
    """TMA reads t: it needs a 16-byte-aligned base and byte strides that
    are multiples of 16 (a dim of size 1 is never stepped over)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned (address % 16 = "
                         f"{t.data_ptr() % 16}): TMA cannot read it")
    for dim in range(3):
        if t.shape[dim] > 1 and (t.stride(dim) * t.element_size()) % 16:
            raise ValueError(f"{name}'s stride {t.stride(dim)} on dim {dim} "
                             f"is not a multiple of 16 bytes: TMA cannot "
                             f"read it")


def _tma_strides(t):
    """t's (batch, seq, head) element strides, with a dim of size 1 given
    one TMA takes (its stride is never used): the tensor's extent, rounded
    up to 8 elements."""
    extent = -(-max(s * n for s, n in zip(t.stride(), t.shape)) // 8) * 8
    return [s if n > 1 else extent for s, n in zip(t.stride()[:3],
                                                   t.shape[:3])]


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True):
    """Launch the CUDA backward that ``backward_route`` picks (its dq
    kernel, then its dk/dv kernel); same contract as
    ``flash_attention_bwd_plain``. q/k/v/o/dO may be strided views with a
    contiguous last axis (on the Hopper route, TMA must be able to read
    q, k, v and dO: ``_check_tma``); lse is [B, Hq, Sq] f32. delta =
    rowsum(dO * O) is one f32 torch expression here, as the JAX package
    computes it outside its kernels. Raises on anything the kernels do not
    take."""
    dq, dk, dv = _bwd_cuda_as_written(q, k, v, o, lse, do, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_cuda_as_written(q, k, v, o, lse, do, causal: bool = True):
    """``flash_attention_bwd_cuda``'s (dq, dk, dv) before its cast, as the
    route's kernels write them: f32 from the Hopper pair, the inputs'
    dtype from the SIMT pair."""
    B, Sq, Sk, Hq, Hkv, D = _check_kernel_inputs(q, k, v, causal, o=o,
                                                 do=do)
    if (lse.dtype != torch.float32 or lse.shape != (B, Hq, Sq)
            or lse.device != q.device):
        raise ValueError(f"lse must be [B, Hq, Sq] f32 on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    dq_sym, dkv_sym = backward_route(q.dtype, D)
    wgmma = dq_sym.endswith("_wgmma")
    if wgmma:
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            _check_tma(name, t)
    lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    out = torch.float32 if wgmma else q.dtype
    dq = torch.empty(B, Sq, Hq, D, dtype=out, device=q.device)
    dk = torch.empty(B, Sk, Hkv, D, dtype=out, device=q.device)
    dv = torch.empty(B, Sk, Hkv, D, dtype=out, device=q.device)
    if dq.numel():
        dims = (B, Sq, Sk, Hq, Hkv, D)
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        if wgmma:
            lib, tail = KERNEL_BWD_WGMMA, (int(causal), float(D ** -0.5))
            strides = [s for t in (q, k, v, do) for s in _tma_strides(t)]
        else:
            lib = KERNEL
            tail = (int(causal), _DTYPES[q.dtype], float(D ** -0.5))
            strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
        lib.launch(dq_sym, q.device, *ptrs, dq.data_ptr(), *dims, *strides,
                   *dq.stride()[:3], *tail)
        lib.launch(dkv_sym, q.device, *ptrs, dk.data_ptr(), dv.data_ptr(),
                   *dims, *strides, *dk.stride()[:3], *dv.stride()[:3],
                   *tail)
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv
