"""BusLM — the paper's economic news encoder (§4.1.3, Appendix A.1.1).

The news article is split into K segments [B, K, S]. Each transformer
layer attends with queries from the segment and keys/values from
[segment, bus], where the bus is the K segments' [CLS] rows (Eq. 6-8), so
attention costs O(K * S * (S + K)) instead of O(N^2). The final embedding
uses two-level additive attention pooling (Eq. 9-14).

The bus attention itself is ``kernels.ops.bus_attention``: the CUDA
kernels (forward and backward) on the card, their plain versions on the
CPU. With ``cfg.remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``), so only the layer inputs are kept.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.bus_attention import bus_attention_plain
from repro_torch.nn import dense, layernorm, sdpa

from .plm import PLMConfig, additive_attention, embed_inputs, ffn

_BUS_IMPLS = {"kernel": ops.bus_attention, "plain": bus_attention_plain}


def _bus_attention_layer(layer, h, mask, cfg: PLMConfig, impl: str):
    """One BusLM layer. h: [M, K, S, d]; mask: [M, K, S] bool."""
    M, K, S, d = h.shape
    nh = cfg.n_heads
    hd = d // nh
    ap = layer["attn"]

    use_bus = cfg.use_bus and K > 1
    if use_bus:
        bus = h[:, :, 0, :]                                   # [M, K, d]
        bus_b = bus[:, None].expand(M, K, K, d)               # per segment
        kv_in = torch.cat([h, bus_b], dim=2)                  # [M, K, S+K, d]
        seg_valid = mask.any(dim=-1)                          # [M, K]
        bus_mask = seg_valid[:, None].expand(M, K, K)
        kv_mask = torch.cat([mask, bus_mask], dim=2)          # [M, K, S+K]
    else:
        kv_in, kv_mask = h, mask

    Sk = kv_in.shape[2]
    q = dense(ap["q"], h)
    k = dense(ap["k"], kv_in)
    v = dense(ap["v"], kv_in)

    if use_bus:
        out = _BUS_IMPLS[impl](
            q.reshape(M, K, S, nh, hd), k.reshape(M, K, Sk, nh, hd),
            v.reshape(M, K, Sk, nh, hd), kv_mask.contiguous())
    else:
        out = sdpa(q.reshape(M * K, S, nh, hd), k.reshape(M * K, Sk, nh, hd),
                   v.reshape(M * K, Sk, nh, hd), causal=False,
                   mask=kv_mask.reshape(M * K, Sk))
    out = dense(ap["o"], out.reshape(M, K, S, d))

    h = layernorm(layer["ln1"], h + out)
    h = layernorm(layer["ln2"], h + ffn(layer, h))
    return h


def buslm_encode(params, cfg: PLMConfig, tokens, freq=None, mask=None,
                 impl: str = "kernel"):
    """Encode news articles. tokens: [M, K, S] -> [M, news_dim].

    Valid (non-pad) tokens are ``tokens != 0``; pass ``mask`` to override.
    ``impl="kernel"`` goes through the device dispatch of ``kernels.ops``;
    ``impl="plain"`` runs the plain PyTorch bus attention on whatever
    device the tensors are on, only as the reference a card run holds the
    kernel against.
    """
    if impl not in _BUS_IMPLS:
        raise ValueError(f"unknown attn impl: {impl!r}")
    if mask is None:
        mask = tokens != 0
    h = embed_inputs(params, cfg, tokens, freq)               # [M, K, S, d]
    for layer in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_bus_attention_layer, layer, h, mask, cfg, impl,
                           use_reentrant=False)
        else:
            h = _bus_attention_layer(layer, h, mask, cfg, impl)

    # two-level pooling: tokens -> segment vectors -> news embedding
    v_seg = additive_attention(params["pool_tok"], h, mask)   # [M, K, d]
    seg_valid = mask.any(dim=-1)                              # [M, K]
    e = additive_attention(params["pool_seg"], v_seg, seg_valid)  # [M, d]
    return dense(params["out_proj"], e)


def plm_flops(cfg: PLMConfig, n_news: int) -> float:
    """Analytic encode FLOPs (fwd) for the roofline/napkin math."""
    K, S, d, f, L = (cfg.n_segments, cfg.seg_len, cfg.d_model, cfg.d_ff,
                     cfg.n_layers)
    Sk = S + (K if (cfg.use_bus and K > 1) else 0)
    per_layer = (
        4 * K * S * d * d * 2            # qkv+o projections (k,v on Sk~S)
        + 2 * K * S * Sk * d * 2         # logits + weighted sum
        + 2 * K * S * d * f * 2          # ffn
    )
    return n_news * L * per_layer
