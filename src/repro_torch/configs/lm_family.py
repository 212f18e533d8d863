"""The LM family's configurations and its train and serving entry points.

The five configs carry the exact widths of the JAX package's
``configs/lm_family.py``, and all five train and serve through
``make_fn``: the dense three (Qwen3-14B, ChatGLM3-6B, Qwen2-72B), and
the MoE two (DBRX-132B; Llama-4-Scout with its chunked-local iRoPE),
whose ``moe_impl="ep"`` runs ``nn.moe_gather`` on one card, as the JAX
package does with no mesh. ``make_fn`` is the counterpart of a JAX
``Cell.make_fn`` with no mesh, and ``archs()`` gives the registry's five
arches (``configs.get_arch``), each with its four cells and the JAX
package's reduced smoke; the XLA dry-run machinery (``abstract_args``)
has no counterpart in the port.

One 80 GB card holds neither MoE config whole (264 and 218 GB of bf16
weights), so each serves on the card at a cut depth
(``ONE_CARD_SERVE``), at full width; training them waits for more than
one card (an Adam step keeps 12 bytes a parameter: 39 GB for one DBRX
layer, 106 GB for one Scout super-block).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import optim
from repro_torch.device import check_device
from repro_torch.models import lm

from .base import Arch, Cell, assert_finite

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
# the MoE configs' serving cuts for one 80 GB card, in bf16 (full width):
#   dbrx-132b 40 -> 6 layers: 6 x 6.52 GB + 2.47 GB of embedding and head
#     = 41.6 GB. A prefill at B=1, S=32,768 adds 6.6 GB of logits and
#     the MoE transients at C = 10,240 (E C = 163,840 rows): 2.0 GB for
#     x_e and 3.5 GB each for h1, h3 and their product.
#   llama4-scout 48 -> 8 layers, two super-blocks (6 chunked-local, 2
#     global): 8 x 4.40 GB + 4.14 GB = 39.4 GB; its prefill logits are
#     13.2 GB.
ONE_CARD_SERVE = {"dbrx-132b": 6, "llama4-scout-17b-a16e": 8}

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


def one_card_serve(cfg: lm.LMConfig) -> lm.LMConfig:
    """An MoE config at its one-card serving depth (``ONE_CARD_SERVE``),
    every width kept."""
    return dataclasses.replace(cfg, n_layers=ONE_CARD_SERVE[cfg.name])


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


# ---------------------------------------------------------------------------
# the registry's arches (configs.get_arch)
# ---------------------------------------------------------------------------

LONG_500K_SKIP = ("pure full-attention arch: long_500k requires "
                  "sub-quadratic attention (DESIGN.md §5)")


def lm_arch(cfg: lm.LMConfig, *, sub_quadratic: bool = False,
            notes: str = "") -> Arch:
    """The four LM_SHAPES cells of ``cfg``; long_500k carries a skip for a
    full-attention arch. ``meta``: the JAX cell's ``model_flops``,
    ``params`` and ``active_params``."""
    cells = {}
    act = cfg.active_param_count()
    for shape, shp in LM_SHAPES.items():
        kind = shp["kind"]
        if kind == "train":
            mf = 6 * act * shp["batch"] * shp["seq"]
        elif kind == "prefill":
            mf = 2 * act * shp["batch"] * shp["seq"]
        else:
            mf = 2 * act * shp["batch"]
        skip = (LONG_500K_SKIP if shape == "long_500k" and not sub_quadratic
                else None)
        cells[shape] = Cell(
            arch=cfg.name, shape=shape, kind=kind,
            make_fn=functools.partial(make_fn, cfg, kind), skip=skip,
            meta={"model_flops": float(mf), "params": cfg.param_count(),
                  "active_params": act})
    return Arch(name=cfg.name, family="lm", config=cfg, cells=cells,
                smoke=functools.partial(_smoke, cfg), notes=notes)


def _smoke(cfg: lm.LMConfig, device="cuda"):
    """The JAX package's reduced smoke (``reduced_lm``) on ``device``, with
    torch draws: one Adam step (TRAIN_OPT, no schedule) on [4, 32] tokens,
    then one decode step on a 32-slot f32 cache."""
    device = check_device(device)
    r = reduced_lm(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init(gen, r)
    step = optim.make_train_step(lambda p, b: lm.lm_loss(p, r, b), TRAIN_OPT)
    toks = torch.randint(0, r.vocab, (4, 32), generator=gen, device=device)
    params, _, metrics = step(params, optim.adam_init(params),
                              {"tokens": toks, "labels": toks})
    assert_finite(metrics["loss"], f"{cfg.name} train loss")
    assert_finite(params, f"{cfg.name} params after step")
    cache = lm.init_cache(r, 4, 32, torch.float32, device=device)
    logits, cache = make_fn(r, "decode")(params, toks[:, :1], cache, 0)
    assert logits.shape == (4, r.vocab)
    assert_finite(logits, f"{cfg.name} decode logits")
    return {"loss": float(metrics["loss"]), "vocab": r.vocab}


def archs():
    return [
        lm_arch(QWEN3_14B, notes="GQA kv=8, qk_norm"),
        lm_arch(CHATGLM3_6B, notes="GQA kv=2, partial (2D) RoPE, QKV bias"),
        lm_arch(QWEN2_72B, notes="GQA kv=8, QKV bias"),
        lm_arch(DBRX_132B, notes="MoE 16e top-4 (fine-grained); experts "
                                 "through nn.moe_gather on one card"),
        lm_arch(LLAMA4_SCOUT, sub_quadratic=True,
                notes="MoE 16e top-1 + shared expert; iRoPE chunked-local "
                      "attention (sub-quadratic) -> long_500k runs. "
                      "Early-fusion multimodal frontend is a stub: "
                      "input_specs provide token ids (text backbone only)."),
    ]
