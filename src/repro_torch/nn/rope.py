"""Rotary position embeddings: standard (NeoX halves) and partial-fraction
(ChatGLM's 2D rotary, fraction 0.5)."""
from __future__ import annotations

import torch


def rope_freqs(dim: int, *, theta: float = 10000.0, device=None):
    """Inverse frequencies for a (sub-)dimension ``dim`` (must be even)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions, dim: int, *, theta: float = 10000.0):
    """cos/sin tables for integer ``positions`` [...] -> [..., dim/2] f32."""
    inv = rope_freqs(dim, theta=theta, device=positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, *, fraction: float = 1.0):
    """Rotate the leading ``fraction`` of the head dim of ``x``.

    x: [..., S, H, D]; cos/sin: [..., S, d_rot/2], broadcast over H. The
    first and second halves of the rotated part are the pairs (NeoX), not
    interleaved elements. cos/sin are cast to x's dtype before the
    products, as the JAX package does: in bf16 that rounding changes the
    result.
    """
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    x1, x2 = x[..., :d_rot // 2], x[..., d_rot // 2:d_rot]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, x[..., d_rot:]],
                     dim=-1)


def positions_for_decode(cache_len, batch: int, device=None):
    """Positions for a single-token decode step: [B, 1], all ``cache_len``."""
    return torch.full((batch, 1), int(cache_len), dtype=torch.int32,
                      device=device)
