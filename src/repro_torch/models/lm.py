"""Generic transformer LM covering the LM family's five configs:

  qwen3-14b    dense, GQA(kv=8), qk_norm, RoPE
  chatglm3-6b  dense, GQA(kv=2), partial (2D) RoPE, QKV bias
  qwen2-72b    dense, GQA(kv=8), QKV bias
  dbrx-132b    MoE 16e top-4, GQA(kv=8)
  llama4-scout MoE 16e top-1 + shared expert, iRoPE (3 chunked-local layers
               + 1 global NoPE layer per super-block)

Pre-norm blocks (rmsnorm), SwiGLU FFN or MoE (``nn.moe``), a Python loop
over the layers (``params["layers"]`` is a list of per-layer dicts, the
layout ``bridge.params_from_jax`` makes of the JAX package's stacked
layers). With ``global_every = ge`` layer i is chunked-local with rope
unless ``i % ge == ge - 1``, which is global and NoPE: the JAX package's
super-blocks of ge layers, laid flat.

Entry points: ``init``, ``forward``, ``lm_loss`` (train), and for
serving ``prefill``, ``init_cache`` and ``decode_step``. Causal
self-attention goes through the flash kernel (``nn.attention``), forward
and backward, over the whole sequence on a global layer and chunk by
chunk on a chunked-local one; a decode step attends over the KV cache in
plain PyTorch (a local layer over the trailing ``chunk_size`` slots).
With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` when
gradients are on: only its input is kept, and the backward runs it again
(the JAX package remats a super-block at a time: the same values).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.device import check_device
from repro_torch.nn import (AttnConfig, MoEConfig, attention,
                            decode_attention, dense, embed, init_attention,
                            init_dense, init_embedding, init_kv_cache,
                            init_kv_cache_q8, init_moe, init_rmsnorm,
                            moe_dense, moe_gather, rmsnorm)


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
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_impl: str = "gather"          # dense | gather | ep (gather here)
    # iRoPE / chunked-local attention (llama4)
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

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         n_experts=self.n_experts, top_k=self.top_k)

    def is_local(self, i: int) -> bool:
        """Whether layer i is chunked-local (rope, ``chunk_size``): every
        layer but the last of each ``global_every`` super-block, which is
        global and NoPE. Without ``global_every``, every layer (and with
        no ``chunk_size`` a local layer attends globally)."""
        ge = self.global_every
        return not ge or i % ge != ge - 1

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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_swiglu(gen, d, f, param_dtype):
    return {name: init_dense(gen, a, b, use_bias=False, stddev=0.02,
                             dtype=param_dtype)
            for name, a, b in (("gate", d, f), ("up", d, f), ("down", f, d))}


def _init_layer(gen, cfg: LMConfig, param_dtype):
    p = {"attn": init_attention(gen, cfg.attn_cfg(local=True), param_dtype),
         "ln1": init_rmsnorm(gen, cfg.d_model, param_dtype),
         "ln2": init_rmsnorm(gen, cfg.d_model, param_dtype)}
    if cfg.is_moe:
        p["moe"] = init_moe(gen, cfg.moe_cfg(), param_dtype)
        if cfg.n_shared_experts:
            p["shared"] = _init_swiglu(gen, cfg.d_model,
                                       cfg.d_ff * cfg.n_shared_experts,
                                       param_dtype)
    else:
        p["ffn"] = _init_swiglu(gen, cfg.d_model, cfg.d_ff, param_dtype)
    return p


def init(gen: torch.Generator, cfg: LMConfig, param_dtype=torch.float32):
    """Parameters drawn from ``gen`` on its device (the generator's device
    is where they live)."""
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


def _ffn_or_moe(layer, hn, cfg: LMConfig):
    """The layer's FFN on hn -> (y, aux): the SwiGLU (aux 0.0), or the
    MoE (``moe_dense`` with ``moe_impl="dense"``, else ``moe_gather``:
    the JAX package's ``"ep"`` with no mesh) plus the shared expert."""
    if not cfg.is_moe:
        return _swiglu(layer["ffn"], hn), 0.0
    moe = moe_dense if cfg.moe_impl == "dense" else moe_gather
    y, aux = moe(layer["moe"], hn, cfg.moe_cfg())
    if cfg.n_shared_experts:
        y = y + _swiglu(layer["shared"], hn)
    return y, aux


def _block(layer, x, cfg: LMConfig, impl: str, local: bool = True):
    """One pre-norm layer -> (x, aux); ``local`` as ``cfg.is_local``."""
    x = x + attention(layer["attn"], rmsnorm(layer["ln1"], x),
                      cfg.attn_cfg(local=local), impl=impl)
    y, aux = _ffn_or_moe(layer, rmsnorm(layer["ln2"], x), cfg)
    return x + y, aux


def backbone(params, cfg: LMConfig, tokens, *, impl: str = "kernel"):
    """tokens: [B, S] -> (hidden [B, S, d] before the head, aux). ``aux``
    is the MoE balance loss summed over the layers (f32), 0 for a dense
    config."""
    x = embed(params["embed"], tokens, dtype=cfg.torch_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params["layers"]):
        args = (layer, x, cfg, impl, cfg.is_local(i))
        x, a = (checkpoint(_block, *args, use_reentrant=False) if remat
                else _block(*args))
        aux = aux + a
    return rmsnorm(params["ln_f"], x), aux


def forward(params, cfg: LMConfig, tokens, *, impl: str = "kernel"):
    """tokens: [B, S] -> (logits [B, S, V] in the config's dtype, aux).
    ``impl`` as in ``nn.attention``: ``"plain"`` only for reference runs."""
    x, aux = backbone(params, cfg, tokens, impl=impl)
    with record_function("lm.head"):
        logits = dense(params["head"], x, dtype=cfg.torch_dtype)
    return logits, aux


def _nll(head, x, labels):
    """x: [..., d]; labels: ints, negative = ignore -> (nll_sum f32,
    count)."""
    logits = dense(head, x).float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum(), valid.sum()


AUX_WEIGHT = 0.01      # the JAX lm_loss's weight of the MoE balance loss


def lm_loss(params, cfg: LMConfig, batch, *, impl: str = "kernel"):
    """batch: {tokens [B, S], labels [B, S] (-100 = ignore)} -> (loss +
    AUX_WEIGHT * aux, {"lm_loss", "moe_aux"}). ``impl`` as in
    ``forward``.

    With ``loss_chunk`` set (S a multiple of it and longer), the head and
    the cross entropy run chunk by chunk along the sequence, each chunk
    under checkpoint when gradients are on, so only one chunk's [B, chunk,
    V] f32 logits are ever live, forward or backward."""
    x, aux = backbone(params, cfg, batch["tokens"], impl=impl)
    labels = batch["labels"]
    S, c = x.shape[1], cfg.loss_chunk
    if c and S % c == 0 and S > c:
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.long, device=x.device)
        for i in range(0, S, c):
            args = (params["head"], x[:, i:i + c], labels[:, i:i + c])
            ds, dk = (checkpoint(_nll, *args, use_reentrant=False)
                      if torch.is_grad_enabled() else _nll(*args))
            nll_sum, count = nll_sum + ds, count + dk
    else:
        nll_sum, count = _nll(params["head"], x, labels)
    loss = nll_sum / count.clamp_min(1)
    return loss + AUX_WEIGHT * aux, {"lm_loss": loss, "moe_aux": aux}


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
    tensors, updated: no step copies the cache. A chunked-local layer
    (``cfg.is_local``) attends over the trailing ``chunk_size`` slots, a
    global one over the whole cache, as in the JAX package; the MoE
    routes the step's B tokens as one call (its own capacity)."""
    x = embed(params["embed"], token, dtype=cfg.torch_dtype)
    for i, layer in enumerate(params["layers"]):
        cache_l = {name: t[i] for name, t in cache.items()}
        h, _ = decode_attention(layer["attn"], rmsnorm(layer["ln1"], x),
                                cache_l, cache_index,
                                cfg.attn_cfg(local=cfg.is_local(i)))
        x = x + h
        y, _ = _ffn_or_moe(layer, rmsnorm(layer["ln2"], x), cfg)
        x = x + y
    x = rmsnorm(params["ln_f"], x)
    logits = dense(params["head"], x, dtype=cfg.torch_dtype)
    return logits[:, -1], cache
