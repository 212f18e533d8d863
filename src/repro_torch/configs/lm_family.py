"""The LM family's configurations and its serving entry points.

The five configs carry the exact widths of the JAX package's
``configs/lm_family.py``. The dense three (Qwen3-14B, ChatGLM3-6B,
Qwen2-72B) serve here; DBRX and Llama-4-Scout need MoE and chunked-local
iRoPE, and ``models.lm`` raises for them. ``make_fn`` is the counterpart
of a JAX ``Cell.make_fn`` with no mesh; the XLA dry-run machinery
(``Cell``, ``abstract_args``) has no counterpart in the port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

QWEN3_14B = lm.LMConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv=8,
    head_dim=128, d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
    remat=True, loss_chunk=512)

CHATGLM3_6B = lm.LMConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32, n_kv=2,
    head_dim=128, d_ff=13696, vocab=65024, qkv_bias=True,
    rope_fraction=0.5, rope_theta=1e4,       # 2D/partial rotary
    remat=True, loss_chunk=512)

QWEN2_72B = lm.LMConfig(
    name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64, n_kv=8,
    head_dim=128, d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1e6,
    remat=True, loss_chunk=512)

DBRX_132B = lm.LMConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv=8,
    head_dim=128, d_ff=10752, vocab=100352, n_experts=16, top_k=4,
    moe_impl="ep", rope_theta=5e5, remat=True, loss_chunk=512)

LLAMA4_SCOUT = lm.LMConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv=8, head_dim=128, d_ff=8192, vocab=202048, n_experts=16, top_k=1,
    n_shared_experts=1, moe_impl="ep", chunk_size=8192, global_every=4,
    rope_theta=5e5, remat=True, loss_chunk=512)

CONFIGS = {c.name: c for c in (QWEN3_14B, CHATGLM3_6B, QWEN2_72B, DBRX_132B,
                               LLAMA4_SCOUT)}


def reduced_lm(cfg: lm.LMConfig) -> lm.LMConfig:
    """The JAX package's reduced smoke size: 2 layers (one super-block for
    iRoPE), d 64, 4/2 heads of 16, d_ff 128, vocab 512, f32."""
    ge = cfg.global_every
    return dataclasses.replace(
        cfg, n_layers=ge or 2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512,
        n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 4),
        chunk_size=8 if cfg.chunk_size else None,
        moe_impl="gather" if cfg.is_moe else cfg.moe_impl,
        remat=False, loss_chunk=0, dtype="float32")


def make_fn(cfg: lm.LMConfig, kind: str):
    """The serving step of ``kind`` for ``cfg``, run without autograd:
    ``prefill``: (params, tokens [B, S]) -> last-position logits [B, V];
    ``decode``: (params, token [B, 1], cache, cache_index) -> (logits,
    cache), the cache updated in place. ``train`` waits for the LM
    training slice."""
    if kind == "prefill":
        fn = lambda p, t: lm.prefill(p, cfg, t)              # noqa: E731
    elif kind == "decode":
        fn = lambda p, t, c, i: lm.decode_step(p, cfg, t, c, i)  # noqa: E731
    elif kind == "train":
        raise NotImplementedError("LM training (lm_loss, the Adam step and "
                                  "the flash backward kernels) is not "
                                  "ported yet")
    else:
        raise ValueError(f"unknown LM step kind: {kind!r}")
    return torch.no_grad()(fn)
