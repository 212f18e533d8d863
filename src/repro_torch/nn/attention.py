"""Attention: GQA/MHA, causal or not, qk-norm, chunked-local windows,
and single-token decode against a KV cache.

Masked logits are filled with a finite -1e30, by hand: a fully-masked
row then averages V uniformly, as the JAX reference does, where
``F.scaled_dot_product_attention`` with a boolean mask returns 0.

``attention`` routes an unmasked, unwindowed call whose length
``kernels.ops.flash_attention_supported`` accepts to the flash kernel
(the CUDA kernel on the card, its plain version on the CPU), as the JAX
package routes it to its Pallas kernel. An unmasked chunked-local call
(iRoPE's local layers) goes to the same kernel, each hard chunk a causal
sequence of its own (``chunked_flash``), where the JAX package runs XLA's
``chunked_sdpa``: the same function. Every other call, and every decode
step, is plain PyTorch.

Under tensor parallelism (``models/lm_parallel.py``) a rank runs both
on its own heads: the caller passes an ``AttnConfig`` of the rank's
``n_heads / M`` query and ``n_kv / M`` KV heads and the rank's column
blocks of q, k, v (and row block of o), and ``reduce`` sums the o
projection's partial products over the model axis before the o bias is
added, once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd_plain

from .core import dense, init_dense, init_rmsnorm, rmsnorm
from .rope import apply_rope, rope_cos_sin

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    out_bias: bool = False
    qk_norm: bool = False
    rope_fraction: float = 1.0       # 0.0 disables rope (NoPE layers)
    rope_theta: float = 10000.0
    causal: bool = True
    chunk_size: Optional[int] = None  # chunked-local attention window
    block_q: Optional[int] = None     # query-blocked plain attention
    dtype: str = "float32"


def init_attention(gen: torch.Generator, cfg: AttnConfig,
                   param_dtype=torch.float32):
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "q": init_dense(gen, d, hq * hd, use_bias=cfg.qkv_bias, stddev=0.02,
                        dtype=param_dtype),
        "k": init_dense(gen, d, hk * hd, use_bias=cfg.qkv_bias, stddev=0.02,
                        dtype=param_dtype),
        "v": init_dense(gen, d, hk * hd, use_bias=cfg.qkv_bias, stddev=0.02,
                        dtype=param_dtype),
        "o": init_dense(gen, hq * hd, d, use_bias=cfg.out_bias, stddev=0.02,
                        dtype=param_dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(gen, hd, param_dtype)
        p["k_norm"] = init_rmsnorm(gen, hd, param_dtype)
    return p


def sdpa(q, k, v, *, causal: bool, mask=None, q_offset: int | None = None):
    """q: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D]; Hq % Hkv == 0.

    mask: optional [B, Sk] (key validity) or [B, Sq, Sk] boolean mask.
    ``q_offset``: absolute position of q's first row for causal masking
    when Sq != Sk.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * D ** -0.5
    if causal:
        off = q_offset if q_offset is not None else Sk - Sq
        qpos = torch.arange(Sq, device=q.device)[:, None] + off
        kpos = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(qpos >= kpos), NEG_INF)
    if mask is not None:
        if mask.dim() == 2:       # [B, Sk]
            m = mask[:, None, None, None, :]
        else:                     # [B, Sq, Sk]
            m = mask[:, None, None, :, :]
        logits = logits.masked_fill(~m, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, Hq, D)


def blocked_sdpa(q, k, v, *, causal: bool, mask=None, block_q: int = 512):
    """Attention one query block at a time, so only a [B, block_q, H, Sk]
    logit tile is live; the same numbers as ``sdpa``. Requires
    S % block_q == 0."""
    S = q.shape[1]
    outs = [sdpa(q[:, i:i + block_q], k, v, causal=causal, mask=mask,
                 q_offset=i) for i in range(0, S, block_q)]
    return torch.cat(outs, dim=1)


def chunked_sdpa(q, k, v, *, chunk: int, mask=None):
    """Causal attention within hard chunks of ``chunk`` tokens (cost
    O(S * chunk)). Requires S % chunk == 0; mask: optional [B, S]."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    n = S // chunk
    mc = None if mask is None else mask.reshape(B * n, chunk)
    out = sdpa(q.reshape(B * n, chunk, Hq, D),
               k.reshape(B * n, chunk, Hkv, D),
               v.reshape(B * n, chunk, Hkv, D), causal=True, mask=mc)
    return out.reshape(B, S, Hq, D)


def chunked_flash(q, k, v, *, chunk: int):
    """``chunked_sdpa``'s function on the flash kernel: the B x S/chunk
    hard chunks as a batch of causal sequences [B S/chunk, chunk, H, D]
    (views: the projections are contiguous), rope already applied at
    absolute positions. Requires S % chunk == 0; takes no mask."""
    B, S, Hq, D = q.shape
    n = S // chunk

    def split(t):
        return t.reshape(B * n, chunk, t.shape[2], D)

    return ops.flash_attention(split(q), split(k), split(v),
                               causal=True).reshape(B, S, Hq, D)


def _project(params, x, cfg: AttnConfig, positions):
    """q [B, S, Hq, D], k/v [B, S, Hkv, D]: projections, qk-norm, rope."""
    B, S, _ = x.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = dense(params["q"], x).reshape(B, S, hq, hd)
    k = dense(params["k"], x).reshape(B, S, hk, hd)
    v = dense(params["v"], x).reshape(B, S, hk, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.rope_fraction > 0.0:
        d_rot = int(hd * cfg.rope_fraction)
        d_rot -= d_rot % 2
        cos, sin = rope_cos_sin(positions, d_rot, theta=cfg.rope_theta)
        q = apply_rope(q, cos, sin, fraction=cfg.rope_fraction)
        k = apply_rope(k, cos, sin, fraction=cfg.rope_fraction)
    return q, k, v


def _out(params, out, reduce=None):
    """The o projection of the heads' output [..., H hd]: ``dense``, or
    with ``reduce`` (a row-parallel block of o) the product summed by
    ``reduce``, then the bias, once."""
    if reduce is None:
        return dense(params["o"], out)
    y = reduce(out @ params["o"]["w"])
    b = params["o"].get("b")
    return y if b is None else y + b


def attention(params, x, cfg: AttnConfig, *, positions=None, mask=None,
              impl: str = "kernel", reduce=None):
    """Self-attention over x: [B, S, d_model] -> [B, S, d_model].

    An unmasked call with no chunked-local window, whose S passes
    ``ops.flash_attention_supported``, goes to the flash kernel: with
    ``impl="kernel"`` through the device dispatch of ``kernels.ops``,
    with ``impl="plain"`` to the kernel's plain version on whatever device
    x is on (only as the reference a card run holds the kernel against).
    An unmasked chunked-local call (S a multiple of the chunk and longer)
    goes to the flash kernel chunk by chunk (``chunked_flash``) with
    ``impl="kernel"``, and to ``chunked_sdpa`` with ``impl="plain"``.
    Masked calls and other lengths take plain attention under either
    impl, as in the JAX package. ``reduce``: see the module docstring.
    """
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown attn impl: {impl!r}")
    B, S, _ = x.shape
    chunked_local = (cfg.chunk_size is not None and cfg.causal
                     and S > cfg.chunk_size and S % cfg.chunk_size == 0)
    flash = (mask is None and not chunked_local
             and ops.flash_attention_supported(S))
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project(params, x, cfg, positions)
    if flash and impl == "kernel":
        out = ops.flash_attention(q, k, v, causal=cfg.causal)
    elif flash:
        out = flash_attention_fwd_plain(q, k, v, cfg.causal)[0]
    elif chunked_local and mask is None and impl == "kernel":
        out = chunked_flash(q, k, v, chunk=cfg.chunk_size)
    elif chunked_local:
        out = chunked_sdpa(q, k, v, chunk=cfg.chunk_size, mask=mask)
    elif (cfg.block_q is not None and S > cfg.block_q
          and S % cfg.block_q == 0):
        out = blocked_sdpa(q, k, v, causal=cfg.causal, mask=mask,
                           block_q=cfg.block_q)
    else:
        out = sdpa(q, k, v, causal=cfg.causal, mask=mask)
    return _out(params, out.reshape(B, S, cfg.n_heads * cfg.head_dim),
                reduce)


# ---------------------------------------------------------------------------
# decode: one new token against a KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, *, device):
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_kv_cache_q8(batch: int, max_len: int, cfg: AttnConfig, *,
                     device):
    """int8 values with per-token, per-head f32 absmax scales."""
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_s": torch.zeros(shape[:3], dtype=torch.float32, device=device)}


def _q8(x):
    """x: [B, 1, H, D] -> (int8 values, [B, 1, H] f32 scales). The scale
    ``max(|x|, 1e-8) / 127`` and the division are in x's dtype; rounding
    is half to even."""
    s = x.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(x / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s.float()


def _dq8(q, s, dtype):
    return (q.float() * s[..., None]).to(dtype)


def decode_attention(params, x, cache, cache_index, cfg: AttnConfig, *,
                     reduce=None):
    """One token against a KV cache. x: [B, 1, d]; cache: ``{k, v}``
    [B, S_max, Hkv, D] or the int8 layout ``{k_q, k_s, v_q, v_s}``;
    cache_index: the number of valid entries already in the cache (an int
    or a 0-d tensor). Returns (out [B, 1, d], cache).

    The new k/v are written into ``cache`` in place, and the same tensors
    come back: copying a cache of many GB on every step, as a functional
    update would, costs more than the step. The write lands at slot
    ``min(cache_index, S_max - 1)``, as ``jax.lax.dynamic_update_slice``
    clamps its start. A chunked-local layer attends over the trailing
    ``chunk_size`` slots that end at cache_index; a global one over the
    whole cache, masked to the first cache_index + 1 slots. ``reduce``:
    see the module docstring (the cache then holds the rank's KV heads).
    """
    B = x.shape[0]
    hq, hk, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    idx = int(cache_index)
    pos = torch.full((B, 1), idx, dtype=torch.int32, device=x.device)
    q, k, v = _project(params, x, cfg, pos)
    quant = "k_q" in cache
    S_max = cache["k_q" if quant else "k"].shape[1]
    slot = min(max(idx, 0), S_max - 1)
    if quant:
        (kq, ks), (vq, vs) = _q8(k), _q8(v)
        cache["k_q"][:, slot] = kq[:, 0]
        cache["k_s"][:, slot] = ks[:, 0]
        cache["v_q"][:, slot] = vq[:, 0]
        cache["v_s"][:, slot] = vs[:, 0]

        def read(start, w):
            end = start + w
            return (_dq8(cache["k_q"][:, start:end],
                         cache["k_s"][:, start:end], q.dtype),
                    _dq8(cache["v_q"][:, start:end],
                         cache["v_s"][:, start:end], q.dtype))
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)

        def read(start, w):
            return (cache["k"][:, start:start + w].to(q.dtype),
                    cache["v"][:, start:start + w].to(q.dtype))

    if cfg.chunk_size is not None and cfg.chunk_size < S_max:
        w = cfg.chunk_size
        start = min(max(idx + 1 - w, 0), S_max - w)
    else:
        w, start = S_max, 0
    kw, vw = read(start, w)
    valid = (torch.arange(w, device=x.device) + start <= idx)[None, :]
    out = sdpa(q, kw, vw, causal=False, mask=valid.expand(B, w))
    return _out(params, out.reshape(B, 1, hq * hd), reduce), cache
