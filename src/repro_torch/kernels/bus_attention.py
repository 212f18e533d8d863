"""BusLM segment + bus attention, forward and backward: the plain PyTorch
versions and the CUDA kernels' wrappers (``csrc/bus_attention.cu``).

For each (news, segment, head), S queries attend over Sk = S + K keys:
the segment's own tokens plus the K bus proxies (the [CLS] rows of every
segment of the same news). Masked keys are filled with -1e30 and the
softmax is max-subtracted in f32, so a segment whose keys are all masked
averages v uniformly over its Sk keys. The backward recomputes the
softmax from q/k/v with the forward's arithmetic; the mask gets no
gradient.

Two CUDA routes, chosen by ``bus_route`` from the shape: the tensor-core
kernels (``csrc/bus_attention.cu``, products in 3xTF32) take head dims in
``KERNEL_HEAD_DIMS``, S <= 32 queries and Sk <= 40 keys a segment (every
bucket of the SpeedyFeed configs: S in {8, 16, 24, 32}, Sk = S + 3) with
q/k/v/do on 16-byte-aligned bases; the SIMT kernels
(``csrc/bus_attention_simt.cu``) take any other shape whose tile fits in
a block's shared memory. Anything else raises.

``work`` counts what the function must do, whichever kernel does it; the
meta routes (``bus_attention_meta``, ``bus_attention_bwd_meta``) run the
card's checks and route choice on meta tensors and return that count
beside outputs of the card's shapes.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_device, check_meta

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P]
KERNEL = CudaKernel("bus_attention", "bus_attention.cu", {
    "bus_attention_fwd": _FWD_ARGS, "bus_attention_bwd": _BWD_ARGS})
KERNEL_SIMT = CudaKernel("bus_attention_simt", "bus_attention_simt.cu", {
    "bus_attention_fwd_simt": _FWD_ARGS, "bus_attention_bwd_simt": _BWD_ARGS})
# kernel name, as ops.KERNELS counts its launches -> (library, C symbol)
ROUTES = {"bus_attention": (KERNEL, "bus_attention_fwd"),
          "bus_attention_bwd": (KERNEL, "bus_attention_bwd"),
          "bus_attention_simt": (KERNEL_SIMT, "bus_attention_fwd_simt"),
          "bus_attention_bwd_simt": (KERNEL_SIMT, "bus_attention_bwd_simt")}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_MAX_S, KERNEL_MAX_SK = 32, 40
SMEM_BYTES = 232448            # shared memory a block can have on an H100


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


def bus_route(S: int, Sk: int, D: int) -> tuple:
    """Which CUDA kernels take a segment of S queries over Sk keys at head
    dim D: the names their forward and backward launches count under in
    ``ops.KERNELS`` (``ROUTES``). The tensor-core pair
    (``"bus_attention"``, ``"bus_attention_bwd"``) for one or two m16 row
    blocks of queries, at most five 8-key tiles and a head dim it is
    built for; else the SIMT pair (``"bus_attention_simt"``,
    ``"bus_attention_bwd_simt"``)."""
    if D in KERNEL_HEAD_DIMS and 1 <= S <= KERNEL_MAX_S \
            and 1 <= Sk <= KERNEL_MAX_SK:
        return "bus_attention", "bus_attention_bwd"
    return "bus_attention_simt", "bus_attention_bwd_simt"


def simt_smem_bytes(S: int, Sk: int, D: int, backward: bool) -> int:
    """Shared memory a SIMT block needs for one tile: q (and do), k and v
    (k, and in the backward v, padded by a column) and the [S, Sk]
    probabilities (and ds) in f32, plus the mask bytes."""
    n = 2 if backward else 1
    pad = D + 1 if backward else D
    return 4 * (n * S * D + Sk * (D + 1) + Sk * pad + n * S * Sk) + Sk


def _check(q, k, v, kv_mask, *more):
    """Validate what the kernels take; returns (M, K, S, Sk, H, D)."""
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


def _route(name, S, Sk, D, backward, tensors):
    """The library and C symbol of the route's kernel ``name`` (from
    ``bus_route``), after what that kernel needs of its inputs: 16-byte
    aligned bases on the tensor-core route, a tile that fits in shared
    memory on the SIMT one."""
    if name.endswith("_simt"):
        smem = simt_smem_bytes(S, Sk, D, backward)
        if smem > SMEM_BYTES:
            raise ValueError(f"bus attention: a SIMT tile at S={S}, Sk={Sk}, "
                             f"D={D} needs {smem} bytes of shared memory")
    else:
        for tname, t in tensors:
            if t.data_ptr() % 16:
                raise ValueError(f"{tname} is not 16-byte aligned (the "
                                 f"tensor-core kernels copy rows 16 bytes "
                                 f"at a time)")
    return ROUTES[name]


def work(M: int, K: int, S: int, Sk: int, H: int, D: int, dtype,
         backward: bool = False) -> dict:
    """What the forward (or the backward) must do, whichever kernel does
    it: ``flops``, 2 D for each product of a (query, key) pair, two
    products forward (q k^T, p v) and five backward (s, dv, dp, dq, dk);
    their ``dtype``, the inputs'; ``op_class`` ``"matmul"``: the products
    count as a matmul's do; ``bytes``, each input read once and each
    output written once: q, k, v and the mask, then o (forward); q, k, v,
    the mask and dO, then dq, dk and dv (backward)."""
    e = dtype.itemsize
    q, kv, mask = M * K * S * H * D * e, M * K * Sk * H * D * e, M * K * Sk
    pairs = M * K * H * S * Sk
    if backward:
        return {"flops": 10.0 * D * pairs, "dtype": str(dtype)[6:],
                "op_class": "matmul", "bytes": float(3 * q + 4 * kv + mask)}
    return {"flops": 4.0 * D * pairs, "dtype": str(dtype)[6:],
            "op_class": "matmul", "bytes": float(2 * q + 2 * kv + mask)}


def _forward_plan(q, k, v, kv_mask):
    """The card's checks and route for a forward, and its output: ((lib,
    C symbol), route name, dims, o). The card and the meta route share it."""
    M, K, S, Sk, H, D = _check(q, k, v, kv_mask)
    name = bus_route(S, Sk, D)[0]
    lib_sym = _route(name, S, Sk, D, False, (("q", q), ("k", k), ("v", v)))
    return lib_sym, name, (M, K, S, Sk, H, D), torch.empty_like(q)


def _backward_plan(q, k, v, kv_mask, do):
    """``_forward_plan`` for the backward: ((lib, C symbol), route name,
    dims, (dq, dk, dv))."""
    M, K, S, Sk, H, D = _check(q, k, v, kv_mask, ("do", do))
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {q.dtype} {tuple(q.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    name = bus_route(S, Sk, D)[1]
    lib_sym = _route(name, S, Sk, D, True,
                     (("q", q), ("k", k), ("v", v), ("do", do)))
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return lib_sym, name, (M, K, S, Sk, H, D), grads


def bus_attention_meta(q, k, v, kv_mask):
    """The forward's meta route: (o, route name, ``work``), after the
    card's checks; launches nothing."""
    check_meta(q)
    _, name, dims, o = _forward_plan(q, k, v, kv_mask)
    return o, name, work(*dims, q.dtype)


def bus_attention_bwd_meta(q, k, v, kv_mask, do):
    """The backward's meta route: ((dq, dk, dv), route name, ``work``),
    after the card's checks; launches nothing."""
    check_meta(q)
    _, name, dims, grads = _backward_plan(q, k, v, kv_mask, do)
    return grads, name, work(*dims, q.dtype, backward=True)


def bus_attention_cuda(q, k, v, kv_mask):
    """Launch the CUDA forward that ``bus_route`` picks; same contract as
    ``bus_attention_plain``. Raises on anything the kernel does not take."""
    check_device(q)
    (lib, sym), _, (M, K, S, Sk, H, D), o = _forward_plan(q, k, v, kv_mask)
    if o.numel() == 0:
        return o
    lib.launch(sym, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               kv_mask.data_ptr(), o.data_ptr(), M, K, S, Sk, H, D,
               _DTYPES[q.dtype], float(D ** -0.5))
    return o


def bus_attention_bwd_cuda(q, k, v, kv_mask, do):
    """Launch the CUDA backward that ``bus_route`` picks; same contract as
    ``bus_attention_bwd_plain``. Raises on anything the kernel does not
    take."""
    check_device(q)
    (lib, sym), _, (M, K, S, Sk, H, D), (dq, dk, dv) = _backward_plan(
        q, k, v, kv_mask, do)
    if q.numel() == 0:
        return dq, dk, dv
    lib.launch(sym, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               kv_mask.data_ptr(), do.data_ptr(), dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), M, K, S, Sk, H, D,
               _DTYPES[q.dtype], float(D ** -0.5))
    return dq, dk, dv
