"""The LM family's configurations and its train and serving entry points.

The five configs carry the exact widths of the JAX package's
``configs/lm_family.py``. The dense three (Qwen3-14B, ChatGLM3-6B,
Qwen2-72B) train and serve here; DBRX and Llama-4-Scout need MoE and
chunked-local iRoPE, and ``models.lm`` raises for them. ``make_fn`` is
the counterpart of a JAX ``Cell.make_fn`` with no mesh; the XLA dry-run
machinery (``Cell``, ``abstract_args``) has no counterpart in the port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import optim
from repro_torch.models import lm

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

TRAIN_OPT = optim.AdamConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0)
TRAIN_SCHEDULE = optim.linear_warmup_cosine(3e-4, 200, 10000)
# train_4k cut to one 80 GB card: depth 40 -> 8 and batch 256 -> 2 (the
# full Qwen3-14B's 177 GB of bf16 parameters and gradients and f32
# moments do not fit); the shape chip_smoke.py and profile --lm-train run
ONE_CARD_TRAIN = dict(n_layers=8, batch=2)

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


def train_batch(cfg: lm.LMConfig, batch: int, seq: int,
                generator: torch.Generator, device="cuda") -> dict:
    """A train batch from ``generator`` (on ``device``): tokens [batch,
    seq] uniform over the vocabulary; labels the tokens shifted left by
    one, -100 (ignored) at the last position."""
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                         device=device)
    ignore = torch.full((batch, 1), -100, dtype=toks.dtype, device=device)
    return {"tokens": toks, "labels": torch.cat([toks[:, 1:], ignore], 1)}


def make_fn(cfg: lm.LMConfig, kind: str):
    """The step of ``kind`` for ``cfg``:
    ``train``: (params, opt_state, {tokens, labels} [B, S]) -> (params,
    opt_state, metrics), ``lm_loss`` and its Adam step (the JAX cell's
    ``TRAIN_OPT`` and ``TRAIN_SCHEDULE``), parameters and moments updated
    in place;
    ``prefill``: (params, tokens [B, S]) -> last-position logits [B, V];
    ``decode``: (params, token [B, 1], cache, cache_index) -> (logits,
    cache), the cache updated in place. The serving steps run without
    autograd."""
    if kind == "train":
        return optim.make_train_step(lambda p, b: lm.lm_loss(p, cfg, b),
                                     TRAIN_OPT, TRAIN_SCHEDULE)
    if kind == "prefill":
        fn = lambda p, t: lm.prefill(p, cfg, t)              # noqa: E731
    elif kind == "decode":
        fn = lambda p, t, c, i: lm.decode_step(p, cfg, t, c, i)  # noqa: E731
    else:
        raise ValueError(f"unknown LM step kind: {kind!r}")
    return torch.no_grad()(fn)
