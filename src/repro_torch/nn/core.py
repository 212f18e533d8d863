"""Substrate layers: initializers, dense, layernorm, embedding.

Parameters are nested dicts of tensors, in the JAX package's layout:
a dense weight is ``[in, out]`` and is applied as ``x @ w``. Initializers
draw from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math

import torch


def normal_init(gen: torch.Generator, shape, stddev: float = 0.02):
    return torch.randn(shape, generator=gen, device=gen.device) * stddev


def xavier_init(gen: torch.Generator, shape):
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (2 * limit) - limit


def init_dense(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = True, stddev: float | None = None):
    if stddev is None:
        w = xavier_init(gen, (in_dim, out_dim))
    else:
        w = normal_init(gen, (in_dim, out_dim), stddev)
    p = {"w": w}
    if use_bias:
        p["b"] = torch.zeros(out_dim, device=gen.device)
    return p


def dense(params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


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


def init_embedding(gen: torch.Generator, vocab: int, dim: int, *,
                   stddev: float = 0.02):
    return {"table": normal_init(gen, (vocab, dim), stddev)}


def embed(params, ids):
    return params["table"][ids]
