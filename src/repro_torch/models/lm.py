"""Generic transformer LM, the dense members of the LM family:

  qwen3-14b    dense, GQA(kv=8), qk_norm, RoPE
  chatglm3-6b  dense, GQA(kv=2), partial (2D) RoPE, QKV bias
  qwen2-72b    dense, GQA(kv=8), QKV bias

Pre-norm blocks (rmsnorm), SwiGLU FFN, a Python loop over the layers
(``params["layers"]`` is a list of per-layer dicts, the layout
``bridge.params_from_jax`` makes of the JAX package's stacked layers).
The MoE members (dbrx-132b, llama4-scout with its chunked-local iRoPE)
need ``nn/moe.py`` and are not ported yet: their configs raise.

Entry points: ``init``, ``forward``, and for serving ``prefill``,
``init_cache`` and ``decode_step``. Prefill's causal self-attention goes
through the flash kernel (``nn.attention``); a decode step attends over
the KV cache in plain PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import check_device
from repro_torch.nn import (AttnConfig, attention, decode_attention, dense,
                            embed, init_attention, init_dense,
                            init_embedding, init_kv_cache, init_kv_cache_q8,
                            init_rmsnorm, rmsnorm)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 1e6
    # MoE (not ported yet)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_impl: str = "gather"
    # iRoPE / chunked-local attention (llama4; not ported yet)
    chunk_size: Optional[int] = None
    global_every: Optional[int] = None
    attn_block_q: Optional[int] = None
    remat: bool = False
    loss_chunk: int = 0
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def attn_cfg(self, *, local: bool = False) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.hd, qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_fraction=0.0 if (self.global_every and not local)
            else self.rope_fraction,
            rope_theta=self.rope_theta, causal=True,
            chunk_size=self.chunk_size if local else None,
            block_q=self.attn_block_q)

    def param_count(self) -> int:
        d, f, L, hd = self.d_model, self.d_ff, self.n_layers, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        if self.is_moe:
            ffn = 3 * d * f * (self.n_experts + self.n_shared_experts) \
                + d * self.n_experts
        else:
            ffn = 3 * d * f
        return L * (attn + ffn + 2 * d) + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        attn = d * (self.n_heads * self.hd) + 2 * d * (self.n_kv * self.hd) \
            + (self.n_heads * self.hd) * d
        ffn = 3 * d * f * (self.top_k + self.n_shared_experts) \
            + d * self.n_experts
        return L * (attn + ffn + 2 * d) + 2 * self.vocab * d + d


def _require_dense(cfg: LMConfig):
    if cfg.is_moe or cfg.global_every:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers and chunked-local iRoPE (nn/moe.py) "
            f"are not ported yet; they come after LM training and the "
            f"recsys family (ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_swiglu(gen, d, f, param_dtype):
    return {name: init_dense(gen, a, b, use_bias=False, stddev=0.02,
                             dtype=param_dtype)
            for name, a, b in (("gate", d, f), ("up", d, f), ("down", f, d))}


def _init_layer(gen, cfg: LMConfig, param_dtype):
    return {"attn": init_attention(gen, cfg.attn_cfg(local=True), param_dtype),
            "ln1": init_rmsnorm(gen, cfg.d_model, param_dtype),
            "ln2": init_rmsnorm(gen, cfg.d_model, param_dtype),
            "ffn": _init_swiglu(gen, cfg.d_model, cfg.d_ff, param_dtype)}


def init(gen: torch.Generator, cfg: LMConfig, param_dtype=torch.float32):
    """Parameters drawn from ``gen`` on its device (the generator's device
    is where they live)."""
    _require_dense(cfg)
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                dtype=param_dtype),
        "head": init_dense(gen, cfg.d_model, cfg.vocab, use_bias=False,
                           stddev=0.02, dtype=param_dtype),
        "ln_f": init_rmsnorm(gen, cfg.d_model, param_dtype),
        "layers": [_init_layer(gen, cfg, param_dtype)
                   for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _swiglu(p, x):
    return dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))


def _block(layer, x, cfg: LMConfig, impl: str):
    x = x + attention(layer["attn"], rmsnorm(layer["ln1"], x),
                      cfg.attn_cfg(local=True), impl=impl)
    return x + _swiglu(layer["ffn"], rmsnorm(layer["ln2"], x))


def backbone(params, cfg: LMConfig, tokens, *, impl: str = "kernel"):
    """tokens: [B, S] -> (hidden [B, S, d] before the head, aux). ``aux``
    is the MoE balance loss of the JAX package, 0 for a dense config."""
    _require_dense(cfg)
    x = embed(params["embed"], tokens, dtype=cfg.torch_dtype)
    for layer in params["layers"]:
        x = _block(layer, x, cfg, impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["ln_f"], x), aux


def forward(params, cfg: LMConfig, tokens, *, impl: str = "kernel"):
    """tokens: [B, S] -> (logits [B, S, V] in the config's dtype, aux).
    ``impl`` as in ``nn.attention``: ``"plain"`` only for reference runs."""
    x, aux = backbone(params, cfg, tokens, impl=impl)
    return dense(params["head"], x, dtype=cfg.torch_dtype), aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(params, cfg: LMConfig, tokens, *, impl: str = "kernel"):
    """Full causal forward over tokens [B, S]; returns the last position's
    logits [B, V]. As in the JAX package, the [B, S, V] logits exist
    first (10 GB in bf16 at B=1, S=32,768, V=151,936); the last row is
    copied out so they are freed on return."""
    logits, _ = forward(params, cfg, tokens, impl=impl)
    return logits[:, -1].clone()


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, quant: bool = False, device="cuda"):
    """KV cache [L, B, S_max, Hkv, hd] for k and v (or, with ``quant``,
    int8 values plus per-token, per-head f32 scales, half the bytes a
    decode step reads). Each layer has its own storage: the tensors are
    allocated at full size, never broadcast views, because decode writes
    them in place. ``device`` defaults to the card and raises without
    one; pass ``device="cpu"`` for the CPU."""
    device = check_device(device)
    # one layer's layout from nn.attention (meta tensors: shapes and dtypes
    # only), allocated for every layer
    layer = (init_kv_cache_q8(batch, max_len, cfg.attn_cfg(), device="meta")
             if quant else init_kv_cache(batch, max_len, cfg.attn_cfg(),
                                         dtype, device="meta"))
    return {name: torch.zeros((cfg.n_layers, *t.shape), dtype=t.dtype,
                              device=device)
            for name, t in layer.items()}


def decode_step(params, cfg: LMConfig, token, cache, cache_index):
    """One decode step. token: [B, 1] ids; cache: ``init_cache``'s dict of
    [L, ...] tensors; cache_index: the number of valid entries (int).
    Returns (logits [B, V], cache). Each layer writes its new k/v into
    its slice of ``cache`` in place, so the returned cache is the same
    tensors, updated: no step copies the cache."""
    _require_dense(cfg)
    x = embed(params["embed"], token, dtype=cfg.torch_dtype)
    acfg = cfg.attn_cfg(local=True)
    for i, layer in enumerate(params["layers"]):
        cache_l = {name: t[i] for name, t in cache.items()}
        h, _ = decode_attention(layer["attn"], rmsnorm(layer["ln1"], x),
                                cache_l, cache_index, acfg)
        x = x + h
        x = x + _swiglu(layer["ffn"], rmsnorm(layer["ln2"], x))
    x = rmsnorm(params["ln_f"], x)
    logits = dense(params["head"], x, dtype=cfg.torch_dtype)
    return logits[:, -1], cache
