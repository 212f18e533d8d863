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

Three CUDA forwards, chosen by ``forward_route`` from the dtype and head
dim before any launch, each counting its launches under its own symbol:
at a head dim in ``TENSOR_CORE_HEAD_DIMS`` (64, 128), bf16 goes to the
Hopper kernel (``csrc/flash_attention_wgmma.cu``: TMA and wgmma, which
reads q/k/v through TMA and so needs 16-byte-aligned bases and strides)
and f32 to the 3xTF32 kernel (``csrc/flash_attention_tf32.cu``: wgmma
on f32 operands split into tf32 hi + lo, k and v split first into a
scratch the wrapper allocates, ``tf32_planes_bytes``); every other head
dim goes to the SIMT kernel (``csrc/flash_attention.cu``, f32 arithmetic
on the CUDA cores). The backward has three routes by the same rule,
chosen by ``backward_route``, each a dq and a dk/dv kernel: Hopper
(``csrc/flash_attention_bwd_wgmma.cu``, bf16 at those head dims; it also
reads dO through TMA), 3xTF32 (``csrc/flash_attention_bwd_tf32.cu``, f32
at those head dims; each call first splits the tensors its kernel
streams, k and v or q and dO, into tf32 hi and lo planes in a scratch
the wrapper allocates, ``tf32_bwd_planes_bytes``, reading them as
float4, so they need 16-byte-aligned bases and strides) or SIMT
(``csrc/flash_attention.cu``, every other head dim in either dtype,
writing the inputs' dtype). The Hopper and 3xTF32 pairs write f32
gradients, cast here.

``work`` counts what the forward or the backward must do, whichever
kernel does it; the meta routes (``flash_attention_meta``,
``flash_attention_bwd_meta``) run the card's checks and route choice on
meta tensors and return that count beside outputs of the card's shapes
and dtypes.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_device, check_meta

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
# the 3xTF32 forward: q, k, v, o, lse, the k/v planes' scratch and its
# bytes, B, Sq, Sk, Hq, Hkv, D, 12 strides, causal, scale, stream
KERNEL_TF32 = CudaKernel("flash_attention_tf32", "flash_attention_tf32.cu",
                         {"flash_attention_fwd_tf32": [
                             *([_P] * 6), _L, *([_I] * 6), *([_L] * 12), _I,
                             ctypes.c_float, _P]})
TF32_KEY_TILE = 32     # kBK in csrc/flash_attention_tf32.cu
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
# the 3xTF32 backward: q, k, v, dO, lse, delta, then dq (or dk, dv), the
# planes' scratch and its bytes, B, Sq, Sk, Hq, Hkv, D, 15 strides (18),
# causal, scale, stream. dq, dk and dv are f32
KERNEL_BWD_TF32 = CudaKernel(
    "flash_attention_bwd_tf32", "flash_attention_bwd_tf32.cu", {
        "flash_attention_bwd_dq_tf32": [*([_P] * 8), _L, *([_I] * 6),
                                        *([_L] * 15), _I, ctypes.c_float,
                                        _P],
        "flash_attention_bwd_dkv_tf32": [*([_P] * 9), _L, *([_I] * 6),
                                         *([_L] * 18), _I, ctypes.c_float,
                                         _P]})
TF32_BWD_TILE = 32     # kTile in csrc/flash_attention_bwd_tf32.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORE_HEAD_DIMS = (64, 128)
# the forward's routes, by the names their launches count under
FORWARD_ROUTES = ("flash_attention", "flash_attention_wgmma",
                  "flash_attention_tf32")
# the backward's routes, each the pair of names its dq and dk/dv launches
# count under: SIMT, Hopper, 3xTF32
BWD_SIMT = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
BWD_WGMMA = ("flash_attention_bwd_dq_wgmma", "flash_attention_bwd_dkv_wgmma")
BWD_TF32 = ("flash_attention_bwd_dq_tf32", "flash_attention_bwd_dkv_tf32")
BACKWARD_ROUTES = (BWD_SIMT, BWD_WGMMA, BWD_TF32)


def forward_route(dtype, head_dim: int) -> str:
    """Which CUDA forward takes a call, by the name its launches count
    under in ``ops.KERNELS``: at a head dim in TENSOR_CORE_HEAD_DIMS,
    ``"flash_attention_wgmma"`` (wgmma on bf16 tiles) for bf16 and
    ``"flash_attention_tf32"`` (wgmma in 3xTF32, f32 accuracy on the
    tensor cores) for f32; ``"flash_attention"`` (the SIMT kernel) at
    every other head dim."""
    if head_dim in TENSOR_CORE_HEAD_DIMS:
        if dtype == torch.bfloat16:
            return "flash_attention_wgmma"
        if dtype == torch.float32:
            return "flash_attention_tf32"
    return "flash_attention"


def backward_route(dtype, head_dim: int) -> tuple:
    """Which CUDA backward takes a call: the names its dq and dk/dv
    launches count under in ``ops.KERNELS`` (each also its C symbol). The
    forward's rule: at a head dim in TENSOR_CORE_HEAD_DIMS, the Hopper pair
    (``BWD_WGMMA``) for bf16 and the 3xTF32 pair (``BWD_TF32``) for f32;
    the SIMT pair (``BWD_SIMT``) at every other head dim."""
    if head_dim in TENSOR_CORE_HEAD_DIMS:
        if dtype == torch.bfloat16:
            return BWD_WGMMA
        if dtype == torch.float32:
            return BWD_TF32
    return BWD_SIMT


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


def flash_attention_cuda(q, k, v, causal: bool = True, *,
                         route: str | None = None):
    """Launch the CUDA forward that ``forward_route`` picks; same contract
    as ``flash_attention_fwd_plain``. q/k/v may be strided views as long
    as their last axis is contiguous (and, on the Hopper route, their
    bases and strides are 16-byte aligned: ``_check_tma``).
    ``route`` names a forward instead (to time one against another on the
    same inputs); it raises if that kernel does not take the call, as
    the picked route does for anything its kernel does not take."""
    check_device(q)
    route, (B, Sq, Sk, Hq, Hkv, D), o, lse = _forward_plan(q, k, v, causal,
                                                           route)
    if o.numel() == 0:
        return o, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    if route == "flash_attention_wgmma":
        strides = [s for t in (q, k, v) for s in _tma_strides(t)]
        KERNEL_WGMMA.launch("flash_attention_fwd_wgmma", q.device, *ptrs, B,
                            Sq, Sk, Hq, Hkv, D, *strides, *o.stride()[:3],
                            int(causal), float(D ** -0.5))
    else:
        strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
        if route == "flash_attention_tf32":
            planes = torch.empty(tf32_planes_bytes(B, Sk, Hkv, D),
                                 dtype=torch.uint8, device=q.device)
            KERNEL_TF32.launch("flash_attention_fwd_tf32", q.device, *ptrs,
                               planes.data_ptr(), planes.numel(), B, Sq, Sk,
                               Hq, Hkv, D, *strides, int(causal),
                               float(D ** -0.5))
        else:
            KERNEL.launch("flash_attention_fwd", q.device, *ptrs, B, Sq, Sk,
                          Hq, Hkv, D, *strides, int(causal),
                          _DTYPES[q.dtype], float(D ** -0.5))
    return o, lse


def visible_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs a head of one batch row scores: all Sq Sk, or,
    causal, query i (at key position i + Sk - Sq) sees keys 0 to it."""
    if not causal:
        return Sq * Sk
    return Sq * (Sk - Sq) + Sq * (Sq + 1) // 2


def work(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int, dtype,
         causal: bool, backward: bool = False) -> dict:
    """What the forward (or the backward) must do, whichever kernel does
    it: ``flops``, 2 D for each product of a visible (query, key) pair,
    two products forward (q k^T, p v) and five backward (s, dv, dp, dq,
    dk); their ``dtype``, the inputs'; ``op_class`` ``"matmul"``: the
    products count as a matmul's do; ``bytes``, each input read once and
    each output written once: q, k and v, then o and the f32 lse
    (forward); q, k, v, o, lse and dO, then dq, dk and dv in the inputs'
    dtype (backward). The [Sq, Sk] scores never reach memory."""
    e = dtype.itemsize
    q, kv, lse = B * Sq * Hq * D * e, B * Sk * Hkv * D * e, B * Hq * Sq * 4
    pairs = B * Hq * visible_pairs(Sq, Sk, causal)
    if backward:
        return {"flops": 10.0 * D * pairs, "dtype": str(dtype)[6:],
                "op_class": "matmul", "bytes": float(4 * q + 4 * kv + lse)}
    return {"flops": 4.0 * D * pairs, "dtype": str(dtype)[6:],
            "op_class": "matmul", "bytes": float(2 * q + 2 * kv + lse)}


def _forward_plan(q, k, v, causal, route=None):
    """The card's checks and route for a forward, and its outputs: (route,
    dims, o, lse). ``route`` names a forward instead of the picked one (it
    raises if that kernel does not take the call). The card and the meta
    route share it."""
    B, Sq, Sk, Hq, Hkv, D = _check_kernel_inputs(q, k, v, causal)
    picked = forward_route(q.dtype, D)
    if route is None:
        route = picked
    elif route not in FORWARD_ROUTES:
        raise ValueError(f"unknown flash forward route {route!r}")
    elif route != "flash_attention" and route != picked:
        raise ValueError(f"{route} does not take {q.dtype} at head dim {D}")
    if route == "flash_attention_wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)
    o = torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    return route, (B, Sq, Sk, Hq, Hkv, D), o, lse


def flash_attention_meta(q, k, v, causal: bool = True):
    """The forward's meta route: ((o, lse), route name, ``work``), after
    the card's checks; launches nothing."""
    check_meta(q)
    route, dims, o, lse = _forward_plan(q, k, v, causal)
    return (o, lse), route, work(*dims, q.dtype, causal)


def tf32_planes_bytes(B: int, Sk: int, Hkv: int, D: int) -> int:
    """Scratch the 3xTF32 forward splits k and v into: per (b, kv head,
    tile of TF32_KEY_TILE keys), K and V^T as tf32 hi and lo planes."""
    tiles = -(-Sk // TF32_KEY_TILE)
    return B * Hkv * tiles * 4 * TF32_KEY_TILE * D * 4


def _check_tma(name, t, reader: str = "TMA"):
    """TMA (or another 16-byte ``reader``) reads t: it needs a
    16-byte-aligned base and byte strides that are multiples of 16 (a dim
    of size 1 is never stepped over)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned (address % 16 = "
                         f"{t.data_ptr() % 16}): {reader} cannot read it")
    for dim in range(3):
        if t.shape[dim] > 1 and (t.stride(dim) * t.element_size()) % 16:
            raise ValueError(f"{name}'s stride {t.stride(dim)} on dim {dim} "
                             f"is not a multiple of 16 bytes: {reader} "
                             f"cannot read it")


def _tma_strides(t):
    """t's (batch, seq, head) element strides, with a dim of size 1 given
    one TMA takes (its stride is never used): the tensor's extent, rounded
    up to 8 elements."""
    extent = -(-max(s * n for s, n in zip(t.stride(), t.shape)) // 8) * 8
    return [s if n > 1 else extent for s, n in zip(t.stride()[:3],
                                                   t.shape[:3])]


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True, *,
                             route: tuple | None = None):
    """Launch the CUDA backward that ``backward_route`` picks (its dq
    kernel, then its dk/dv kernel); same contract as
    ``flash_attention_bwd_plain``. q/k/v/o/dO may be strided views with a
    contiguous last axis (on the Hopper route TMA must be able to read q,
    k, v and dO, on the 3xTF32 route the split's float4 loads: 16-byte
    aligned, ``_check_tma``); lse is [B, Hq, Sq] f32. delta = rowsum(dO *
    O) is one f32 torch expression here, as the JAX package computes it
    outside its kernels. ``route`` names a backward pair instead (one of
    BACKWARD_ROUTES, to time one against another on the same inputs); it
    raises if that pair does not take the call, as the picked route does
    for anything its kernels do not take."""
    dq, dk, dv = _bwd_cuda_as_written(q, k, v, o, lse, do, causal,
                                      route=route)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_bwd_planes_bytes(B: int, Sq: int, Sk: int, Hq: int, Hkv: int,
                          D: int) -> tuple:
    """Scratch the 3xTF32 backward splits its streamed tensors into, per
    (b, head, tile of TF32_BWD_TILE rows) four tf32 planes (hi and lo of
    two tensors): (the dq call's, K and V; the dk/dv call's, Q and dO).
    The wrapper allocates the larger once; the calls use it in turn."""
    per_tile = 4 * TF32_BWD_TILE * D * 4
    return (B * Hkv * -(-Sk // TF32_BWD_TILE) * per_tile,
            B * Hq * -(-Sq // TF32_BWD_TILE) * per_tile)


def _bwd_cuda_as_written(q, k, v, o, lse, do, causal: bool = True, *,
                         route: tuple | None = None):
    """``flash_attention_bwd_cuda``'s (dq, dk, dv) before its cast, as the
    route's kernels write them: f32 from the Hopper and 3xTF32 pairs, the
    inputs' dtype from the SIMT pair."""
    check_device(q)
    (dq_sym, dkv_sym), (B, Sq, Sk, Hq, Hkv, D) = _backward_plan(
        q, k, v, o, lse, do, causal, route)
    simt = (dq_sym, dkv_sym) == BWD_SIMT
    lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    out = q.dtype if simt else torch.float32
    dq = torch.empty(B, Sq, Hq, D, dtype=out, device=q.device)
    dk = torch.empty(B, Sk, Hkv, D, dtype=out, device=q.device)
    dv = torch.empty(B, Sk, Hkv, D, dtype=out, device=q.device)
    if dq.numel():
        dims = (B, Sq, Sk, Hq, Hkv, D)
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
        tail = (int(causal), float(D ** -0.5))
        dq_args, dkv_args = [dq.data_ptr()], [dk.data_ptr(), dv.data_ptr()]
        if simt:
            lib, tail = KERNEL, (int(causal), _DTYPES[q.dtype], tail[1])
        elif dq_sym == BWD_WGMMA[0]:
            lib = KERNEL_BWD_WGMMA
            strides = [s for t in (q, k, v, do) for s in _tma_strides(t)]
        else:
            lib = KERNEL_BWD_TF32
            planes = torch.empty(max(tf32_bwd_planes_bytes(*dims)),
                                 dtype=torch.uint8, device=q.device)
            dq_args += [planes.data_ptr(), planes.numel()]
            dkv_args += [planes.data_ptr(), planes.numel()]
        lib.launch(dq_sym, q.device, *ptrs, *dq_args, *dims, *strides,
                   *dq.stride()[:3], *tail)
        lib.launch(dkv_sym, q.device, *ptrs, *dkv_args, *dims, *strides,
                   *dk.stride()[:3], *dv.stride()[:3], *tail)
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def _backward_plan(q, k, v, o, lse, do, causal, route=None):
    """The card's checks and route for a backward: (the route's pair of
    names, dims). ``route`` names a pair instead of the picked one (the
    SIMT pair takes any call; another raises where it is not the pick).
    The card and the meta route share it."""
    B, Sq, Sk, Hq, Hkv, D = _check_kernel_inputs(q, k, v, causal, o=o,
                                                 do=do)
    if (lse.dtype != torch.float32 or lse.shape != (B, Hq, Sq)
            or lse.device != q.device):
        raise ValueError(f"lse must be [B, Hq, Sq] f32 on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    picked = backward_route(q.dtype, D)
    if route is None:
        route = picked
    elif tuple(route) not in BACKWARD_ROUTES:
        raise ValueError(f"unknown flash backward route {route!r}")
    elif tuple(route) not in (BWD_SIMT, picked):
        raise ValueError(f"{route} does not take {q.dtype} at head dim {D}")
    route = tuple(route)
    if route != BWD_SIMT:
        reader = "TMA" if route == BWD_WGMMA else "the split's float4 load"
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            _check_tma(name, t, reader)
    return route, (B, Sq, Sk, Hq, Hkv, D)


def flash_attention_bwd_meta(q, k, v, o, lse, do, causal: bool = True):
    """The backward's meta route: ((dq, dk, dv) in the primal dtypes, the
    route's pair of names, ``work``), after the card's checks; launches
    nothing."""
    check_meta(q)
    route, (B, Sq, Sk, Hq, Hkv, D) = _backward_plan(q, k, v, o, lse, do,
                                                    causal)
    grads = (torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=q.device),
             torch.empty(B, Sk, Hkv, D, dtype=k.dtype, device=q.device),
             torch.empty(B, Sk, Hkv, D, dtype=v.dtype, device=q.device))
    return grads, route, work(B, Sq, Sk, Hq, Hkv, D, q.dtype, causal,
                              backward=True)
