"""PQ asymmetric-distance LUT scan: the plain PyTorch version and the
CUDA kernels' wrapper (``csrc/pq_scoring.cu``).

``out[b, n] = sum_m lut[b, m, codes[min(b, Bc-1), n, m]]``; with
``valid`` [Bv, N], invalid slots score -inf (padded-CSR gathers carry
unwritten tail slots that must never win a top-k).

A code indexes its table row as numpy indexing does, so a negative int32
code counts from the end; a code outside [-K, K) makes its slot's score
NaN, as the JAX package's reference gather does (``take_along_axis``
fills out-of-range reads with NaN). A payload read against the wrong
codebook thus shows up in the scores on every device.

Two CUDA kernels, chosen by ``pq_route`` before any launch and each
counted under its own name in ``ops.KERNELS``: the tiled scan
(``"pq_lut_scores"``: uint8 codes, M in {8, 16}, K a power of two, a
16-byte-aligned codes base; every serving path's shape) and the general
scan (``"pq_lut_scores_general"``: everything else). ``tiled_plan``
gives the tiled scan's work split, which the kernel recomputes from the
same numbers.

``work`` counts what a scan must do, whichever kernel does it; the meta
route (``pq_lut_scores_meta``) runs the card's checks and route choice
on meta tensors (a meta tensor's ``data_ptr()`` is 0, so aligned) and
returns that count beside an output of the card's shape.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_device, check_meta

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = CudaKernel("pq_scoring", "pq_scoring.cu", {
    # lut, codes, valid, out, B, M, K, N, Bc, Bv, QG, W, stream
    "pq_lut_scores": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _I, _P],
    # lut, codes, valid, out, B, M, K, N, Bc, Bv, code bytes, stream
    "pq_lut_scores_general": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I,
                              _P],
})
ROUTES = ("pq_lut_scores", "pq_lut_scores_general")
_CODE_BYTES = {torch.uint8: 1, torch.int32: 4}
_MAX_SMEM = 232448
TILE_THREADS = 256       # the tiled scan's block
PER_THREAD = 4           # candidates a thread scores in a unit
TILE_N = TILE_THREADS * PER_THREAD
GROUP_BYTES = 48 * 1024  # query tables a tiled block holds when Bc == 1
# units a scan keeps to fill the card (132 SMs x 3 resident blocks, and
# some): shared codes are scored against fewer queries a unit when larger
# groups would leave fewer units
FILL_UNITS = 512
TILED_M = (8, 16)


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


def pq_route(M: int, K: int, code_dtype, codes_addr: int) -> str:
    """Which CUDA kernel takes a scan, by its counter name in
    ``ops.KERNELS``: the tiled scan for uint8 codes at M in TILED_M, K a
    power of two up to 256 and a table of at most GROUP_BYTES, from a
    16-byte-aligned base; the general scan for everything else."""
    tiled = (code_dtype == torch.uint8 and M in TILED_M
             and 1 <= K <= 256 and K & (K - 1) == 0
             and 4 * M * K <= GROUP_BYTES and codes_addr % 16 == 0)
    return "pq_lut_scores" if tiled else "pq_lut_scores_general"


def tiled_plan(B: int, M: int, K: int, N: int, Bc: int,
               valid_addr: int | None = None) -> dict:
    """The tiled scan's work split. A unit is (query group, tile of TILE_N
    candidates), a thread scoring PER_THREAD consecutive candidates
    against every query of the group; a group is one query when each has
    its own codes (Bc == B > 1), else as many queries as GROUP_BYTES of
    tables hold, all scored against each shared code tile, but no more
    than leave FILL_UNITS units (a small shared scan runs one query a
    unit and reads its codes from L2 again). ``vec``, the width of the
    score stores and valid loads: 4 when N % 4 == 0 and valid (if any)
    is 4-byte aligned, else 1."""
    tiles = -(-N // TILE_N)
    qg = 1 if Bc == B > 1 else max(1, min(
        B, GROUP_BYTES // (4 * M * K), B * tiles // FILL_UNITS))
    groups = -(-B // qg)
    vec = 4 if N % 4 == 0 and (valid_addr is None or valid_addr % 4 == 0) \
        else 1
    return {"qg": qg, "groups": groups, "tiles": tiles,
            "units": groups * tiles, "vec": vec}


def work(B: int, M: int, K: int, N: int, Bc: int, code_bytes: int,
         Bv: int = 0) -> dict:
    """What a scan must do, whichever kernel does it: ``flops``, one f32
    add for each of the M table reads of each (query, candidate);
    ``op_class`` ``"gather/scatter"``: a gather's sum, no product;
    ``bytes``, each input read once and the output written once: the B
    tables, the Bc code rows, the Bv valid rows (0 without ``valid``),
    then the [B, N] f32 scores."""
    return {"flops": float(B * N * M), "dtype": "float32",
            "op_class": "gather/scatter",
            "bytes": float(4 * B * M * K + Bc * N * M * code_bytes + Bv * N
                           + 4 * B * N)}


def _plan(lut, codes, valid, route):
    """The card's checks and route for a scan, and its output: (route,
    (B, M, K, N, Bc, Bv: valid's rows, 1 without it), out). ``route``
    names a kernel instead of the picked one (it raises if that kernel
    does not take the shape). The card and the meta route share it."""
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
    picked = pq_route(M, K, codes.dtype, codes.data_ptr())
    if route is None:
        route = picked
    elif route not in ROUTES:
        raise ValueError(f"unknown pq route {route!r}")
    elif route == "pq_lut_scores" and picked != route:
        raise ValueError(f"the tiled scan does not take uint8/int32 codes "
                         f"of this shape or alignment: {codes.dtype} "
                         f"{tuple(codes.shape)}, K={K}")
    out = torch.empty((B, N), dtype=torch.float32, device=lut.device)
    return route, (B, M, K, N, Bc, Bv), out


def pq_lut_scores_meta(lut, codes, valid=None):
    """The scan's meta route: (out, route name, ``work``), after the
    card's checks; launches nothing."""
    check_meta(lut)
    route, (B, M, K, N, Bc, _), out = _plan(lut, codes, valid, None)
    return out, route, work(B, M, K, N, Bc, _CODE_BYTES[codes.dtype],
                            0 if valid is None else valid.shape[0])


def pq_lut_scores_cuda(lut, codes, valid=None, *, route: str | None = None):
    """Launch the CUDA kernel ``pq_route`` picks; same contract as
    ``pq_lut_scores_plain``. ``route`` names a kernel instead (to time one
    against the other on the same inputs); it raises if that kernel does
    not take the shape. Raises on anything the kernels do not take."""
    check_device(lut)
    route, (B, M, K, N, Bc, Bv), out = _plan(lut, codes, valid, route)
    if out.numel() == 0:
        return out
    ptrs = (lut.data_ptr(), codes.data_ptr(),
            valid.data_ptr() if valid is not None else None, out.data_ptr())
    if route == "pq_lut_scores":
        plan = tiled_plan(B, M, K, N, Bc,
                          valid.data_ptr() if valid is not None else None)
        KERNEL.launch(route, lut.device, *ptrs, B, M, K, N, Bc, Bv,
                      plan["qg"], plan["vec"])
    else:
        KERNEL.launch(route, lut.device, *ptrs, B, M, K, N, Bc, Bv,
                      _CODE_BYTES[codes.dtype])
    return out
