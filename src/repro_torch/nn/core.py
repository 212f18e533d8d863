"""Substrate layers: initializers, dense, MLP, layernorm, rmsnorm,
embedding.

Parameters are nested dicts of tensors, in the JAX package's layout:
a dense weight is ``[in, out]`` and is applied as ``x @ w``. Initializers
draw from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math

import torch


def normal_init(gen: torch.Generator, shape, stddev: float = 0.02,
                dtype=torch.float32):
    """Drawn in f32, then cast (as the JAX package does)."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            .mul_(stddev).to(dtype))


def xavier_init(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (u * (2 * limit) - limit).to(dtype)


def init_dense(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = True, stddev: float | None = None,
               dtype=torch.float32):
    if stddev is None:
        w = xavier_init(gen, (in_dim, out_dim), dtype)
    else:
        w = normal_init(gen, (in_dim, out_dim), stddev, dtype)
    p = {"w": w}
    if use_bias:
        p["b"] = torch.zeros(out_dim, dtype=dtype, device=gen.device)
    return p


def dense(params, x, *, dtype=None):
    """x @ w (+ b). With ``dtype``, w, x and b are cast to it first."""
    w, b = params["w"], params.get("b")
    if dtype is not None:
        w, x = w.to(dtype), x.to(dtype)
        b = None if b is None else b.to(dtype)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def init_mlp(gen: torch.Generator, dims, *, use_bias: bool = True,
             dtype=torch.float32):
    """Plain MLP stack (the recsys towers): ``{"l0": dense, ...}``, layer
    i mapping dims[i] -> dims[i + 1]."""
    return {f"l{i}": init_dense(gen, dims[i], dims[i + 1], use_bias=use_bias,
                                dtype=dtype)
            for i in range(len(dims) - 1)}


def mlp(params, x, *, act=torch.relu, final_act=None, dtype=None):
    """``act`` after every layer but the last, ``final_act`` (if any)
    after the last."""
    n = len(params)
    for i in range(n):
        x = dense(params[f"l{i}"], x, dtype=dtype)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def init_layernorm(gen: torch.Generator, dim: int):
    return {"scale": torch.ones(dim, device=gen.device),
            "bias": torch.zeros(dim, device=gen.device)}


def layernorm(params, x, *, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def init_rmsnorm(gen: torch.Generator, dim: int, dtype=torch.float32):
    return {"scale": torch.ones(dim, dtype=dtype, device=gen.device)}


def rmsnorm(params, x, *, eps: float = 1e-6):
    """RMS norm in f32, returned in x's dtype."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, dim: int, *,
                   stddev: float = 0.02, dtype=torch.float32):
    return {"table": normal_init(gen, (vocab, dim), stddev, dtype)}


def embed(params, ids, *, dtype=None):
    """Rows of the table; with ``dtype``, cast to it (the gathered rows
    only: casting before or after the gather gives the same values)."""
    rows = params["table"][ids]
    return rows if dtype is None else rows.to(dtype)
