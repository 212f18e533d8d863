"""PLM news encoder substrate (UniLM-like bidirectional transformer).

Same architecture and parameter layout as the JAX package, with one
difference: ``params["layers"]`` is a list of per-layer dicts, where the
JAX tree stacks the layers on a leading axis for ``lax.scan``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import (dense, embed, init_dense, init_embedding,
                            init_layernorm, layernorm, normal_init)


@dataclasses.dataclass(frozen=True)
class PLMConfig:
    vocab: int = 30522
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    max_len: int = 512           # positions
    n_segments: int = 3          # BusLM K (title/abstract/body); 1 = no split
    seg_len: int = 32            # tokens per segment
    max_freq: int = 32           # OBoW frequency embedding vocab
    use_freq_embedding: bool = True
    news_dim: int = 64           # final news embedding dim
    use_bus: bool = True
    dtype: str = "float32"
    remat: bool = False          # recompute each layer in the backward


def init_plm(gen: torch.Generator, cfg: PLMConfig):
    p = {
        "tok_emb": init_embedding(gen, cfg.vocab, cfg.d_model),
        "pos_emb": init_embedding(gen, cfg.max_len, cfg.d_model),
        "seg_emb": init_embedding(gen, max(cfg.n_segments, 2), cfg.d_model),
        "emb_ln": init_layernorm(gen, cfg.d_model),
        # two-level attention pooling (paper Appendix Eq. 9-14)
        "pool_tok": _init_addattn(gen, cfg.d_model),
        "pool_seg": _init_addattn(gen, cfg.d_model),
        "out_proj": init_dense(gen, cfg.d_model, cfg.news_dim, use_bias=True),
    }
    if cfg.use_freq_embedding:
        p["freq_emb"] = init_embedding(gen, cfg.max_freq, cfg.d_model)
    p["layers"] = [_init_layer(gen, cfg) for _ in range(cfg.n_layers)]
    return p


def _init_addattn(gen, dim):
    return {"proj": init_dense(gen, dim, dim, use_bias=True),
            "query": normal_init(gen, (dim,), 0.02)}


def _init_layer(gen, cfg: PLMConfig):
    d, f = cfg.d_model, cfg.d_ff
    attn = {name: init_dense(gen, d, d, use_bias=True, stddev=0.02)
            for name in ("q", "k", "v", "o")}
    return {
        "attn": attn,
        "ln1": init_layernorm(gen, d),
        "ffn_up": init_dense(gen, d, f, use_bias=True, stddev=0.02),
        "ffn_down": init_dense(gen, f, d, use_bias=True, stddev=0.02),
        "ln2": init_layernorm(gen, d),
    }


def additive_attention(p, h, mask=None):
    """Eq. 9-11 / 12-14: softmax(q^T tanh(W h + b)) weighted sum over axis -2.

    h: [..., N, d]; mask: [..., N] bool. Returns [..., d]. Masked scores
    are filled with -1e30 (a row with nothing valid, e.g. a pad news,
    averages uniformly).
    """
    a = torch.einsum("...nd,d->...n", torch.tanh(dense(p["proj"], h).float()),
                     p["query"].float())
    if mask is not None:
        a = a.masked_fill(~mask, -1e30)
    w = torch.softmax(a, dim=-1).to(h.dtype)
    return torch.einsum("...n,...nd->...d", w, h)


def embed_inputs(p, cfg: PLMConfig, tokens, freq=None):
    """tokens: [B, K, S] -> [B, K, S, d] summed embeddings."""
    B, K, S = tokens.shape
    dev = tokens.device
    h = embed(p["tok_emb"], tokens)
    h = h + embed(p["pos_emb"], torch.arange(S, device=dev))[None, None]
    h = h + embed(p["seg_emb"], torch.arange(K, device=dev))[None, :, None]
    if cfg.use_freq_embedding and freq is not None:
        h = h + embed(p["freq_emb"], freq.clamp(0, cfg.max_freq - 1))
    return layernorm(p["emb_ln"], h)


def ffn(layer, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(layer["ffn_up"], x), approximate="tanh")
    return dense(layer["ffn_down"], h)
