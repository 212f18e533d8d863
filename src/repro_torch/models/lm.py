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

Each entry point takes ``mesh=``: on a (pod, data, model) mesh of ranks
(``launch/mesh.py``; ``pod`` optional) the parameters are this rank's
blocks (``lm_parallel.place_params``, by ``lm_rules`` and the head
plan), the batch is cut over ``pod`` and ``data``, the layers run tensor
parallel over ``model`` with FSDP over ``data``, the MoE expert parallel
(``moe_impl="ep"`` -> ``nn.moe_ep_partial``, as the JAX package's
``_ffn_or_moe`` sends it to ``moe_ep`` given a mesh), and the cross
entropy vocab-parallel (``models/lm_parallel.py`` says how).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.device import check_device
from repro_torch.distributed.collectives import (all_gather, all_reduce,
                                                 copy_to, reduce_from)
from repro_torch.distributed.sharding import DATA_AXES
from repro_torch.nn import (AttnConfig, MoEConfig, attention,
                            decode_attention, dense, embed, init_attention,
                            init_dense, init_embedding, init_kv_cache,
                            init_kv_cache_q8, init_moe, init_rmsnorm,
                            moe_dense, moe_ep_partial, moe_gather, rmsnorm)

from . import lm_parallel as tp


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
    moe_impl: str = "gather"          # dense | gather | ep (a mesh's)
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


def init(gen: torch.Generator, cfg: LMConfig, param_dtype=torch.float32,
         *, place=None):
    """Parameters drawn from ``gen`` on its device (the generator's device
    is where they live). ``place(path, subtree)``, where given, is applied
    to the embedding, the head, the final norm and each layer as soon as
    it is drawn (``lm_parallel.place_params``: a rank keeps its blocks,
    and at most one whole layer is ever live); the draws are the same."""
    keep = place or (lambda path, tree: tree)
    return {
        "embed": keep(("embed",), init_embedding(
            gen, cfg.vocab, cfg.d_model, dtype=param_dtype)),
        "head": keep(("head",), init_dense(
            gen, cfg.d_model, cfg.vocab, use_bias=False, stddev=0.02,
            dtype=param_dtype)),
        "ln_f": keep(("ln_f",), init_rmsnorm(gen, cfg.d_model,
                                             param_dtype)),
        "layers": [keep(("layers", i), _init_layer(gen, cfg, param_dtype))
                   for i in range(cfg.n_layers)],
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


# ---------------------------------------------------------------------------
# the mesh path (lm_parallel's module docstring)
# ---------------------------------------------------------------------------

def _ffn_or_moe_mesh(layer, hn, cfg: LMConfig, mesh):
    """The layer's FFN on a model rank: ``hn`` is whole over ``model``,
    through ``copy_to``; the partial outputs of the row blocks (the
    experts' and the shared expert's together) summed once over
    ``model``."""
    if not cfg.is_moe:
        return reduce_from(_swiglu(layer["ffn"], hn), mesh), 0.0
    if cfg.moe_impl != "ep":
        raise ValueError(f"{cfg.name}: on a mesh the experts run expert "
                         f"parallel (moe_impl='ep'), got {cfg.moe_impl!r}")
    y, aux = moe_ep_partial(layer["moe"], hn, cfg.moe_cfg(), mesh)
    if cfg.n_shared_experts:
        y = y + _swiglu(layer["shared"], hn)
    return reduce_from(y, mesh), aux


def _block_mesh(layer, specs, x, cfg: LMConfig, impl: str, local: bool,
                mesh):
    """``_block`` on a model rank: the layer's FSDP blocks gathered first
    (under the caller's checkpoint, so again in the backward), the
    rank's heads by the head plan (``tp.rank_attention``) and its FFN
    columns, one sum over ``model`` each; the partial outputs of
    unequal head counts sum as even ones do."""
    layer = tp.gather_fsdp(layer, specs, mesh)
    attn, acfg = tp.rank_attention(layer["attn"], cfg.attn_cfg(local=local),
                                   mesh)
    x = x + attention(attn, copy_to(rmsnorm(layer["ln1"], x), mesh), acfg,
                      impl=impl, reduce=lambda y: reduce_from(y, mesh))
    y, aux = _ffn_or_moe_mesh(layer, copy_to(rmsnorm(layer["ln2"], x),
                                             mesh), cfg, mesh)
    return x + y, aux


def _backbone_mesh(params, cfg: LMConfig, tokens, impl: str, mesh):
    """-> (hidden [B/D, S, d] of this rank's batch block, aux, the
    parameters' specs)."""
    tokens, _ = tp.data_block(tokens, mesh)
    fsdp = tp.fsdp_on(params, cfg, mesh)
    specs = tp.param_specs(params, cfg, mesh, fsdp)
    x = tp.embed_vp(params["embed"]["table"], tokens, mesh, cfg.torch_dtype,
                    fsdp)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (layer, ls) in enumerate(zip(params["layers"], specs["layers"])):
        args = (layer, ls, x, cfg, impl, cfg.is_local(i), mesh)
        x, a = (checkpoint(_block_mesh, *args, use_reentrant=False) if remat
                else _block_mesh(*args))
        aux = aux + a
    return rmsnorm(params["ln_f"], x), aux, specs


def _last_logits_mesh(params, specs, x, cfg: LMConfig, mesh):
    """The last position's logits of hidden x [B, S, d], whole over the
    vocabulary: each model rank's columns, gathered over ``model``."""
    with record_function("lm.head"):
        part = tp.head_logits(params["head"]["w"], x[:, -1], mesh,
                              cfg.torch_dtype, "data" in specs["head"]["w"])
    return all_gather(part, mesh, "model", dim=-1)


def _lm_loss_mesh(params, cfg: LMConfig, batch, impl: str, mesh):
    x, aux, specs = _backbone_mesh(params, cfg, batch["tokens"], impl, mesh)
    labels, split = tp.data_block(batch["labels"], mesh)
    x = copy_to(x, mesh)
    fsdp = "data" in specs["head"]["w"]
    if tp.head_by_rows(labels.numel(), cfg, mesh, fsdp):
        w = params["head"]["w"]            # the rows cross, not the head

        def nll(w, x, labels):
            return tp.nll_vp(tp.head_logits(w, x, mesh, fsdp=True), labels,
                             mesh)
    else:
        w = tp.gather_fsdp(params["head"], specs["head"], mesh)["w"]

        def nll(w, x, labels):
            return tp.nll_vp(x @ w, labels, mesh)
    nll_sum, count = _chunked_nll(nll, w, x, labels, cfg.loss_chunk)
    # the global sum over the data axes (each rank's gradient its own
    # part's); a batch they do not divide is whole on every data rank:
    # 1/D of each
    rep = 1 if split else mesh.size(DATA_AXES)
    nll_sum = reduce_from(nll_sum, mesh, DATA_AXES) / rep
    count = all_reduce(count.clone(), mesh, axis=DATA_AXES) // rep
    loss = nll_sum / count.clamp_min(1)
    return loss + AUX_WEIGHT * aux, {"lm_loss": loss, "moe_aux": aux}


def backbone(params, cfg: LMConfig, tokens, *, impl: str = "kernel",
             mesh=None):
    """tokens: [B, S] -> (hidden [B, S, d] before the head, aux). ``aux``
    is the MoE balance loss summed over the layers (f32), 0 for a dense
    config. With ``mesh``: this rank's batch block [B/D, S, d], and aux
    summed over the layers of each layer's mean over the data shards."""
    if mesh is not None:
        return _backbone_mesh(params, cfg, tokens, impl, mesh)[:2]
    x = embed(params["embed"], tokens, dtype=cfg.torch_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params["layers"]):
        args = (layer, x, cfg, impl, cfg.is_local(i))
        x, a = (checkpoint(_block, *args, use_reentrant=False) if remat
                else _block(*args))
        aux = aux + a
    return rmsnorm(params["ln_f"], x), aux


def forward(params, cfg: LMConfig, tokens, *, impl: str = "kernel",
            mesh=None):
    """tokens: [B, S] -> (logits [B, S, V] in the config's dtype, aux).
    ``impl`` as in ``nn.attention``: ``"plain"`` only for reference runs.
    With ``mesh``: this rank's batch block's logits, gathered over
    ``model`` (a serving read: the gather carries no gradient)."""
    if mesh is not None:
        x, aux, specs = _backbone_mesh(params, cfg, tokens, impl, mesh)
        w = tp.gather_fsdp(params["head"], specs["head"], mesh)["w"]
        part = dense({"w": w}, x, dtype=cfg.torch_dtype)
        return all_gather(part, mesh, "model", dim=-1), aux
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


def _chunked_nll(nll, w, x, labels, c: int):
    """``nll(w, x, labels)`` over the sequence, chunk by chunk under
    checkpoint when ``c`` divides S (and is shorter), else at once."""
    S = x.shape[1]
    if not (c and S % c == 0 and S > c):
        return nll(w, x, labels)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.long, device=x.device)
    for i in range(0, S, c):
        args = (w, x[:, i:i + c], labels[:, i:i + c])
        ds, dk = (checkpoint(nll, *args, use_reentrant=False)
                  if torch.is_grad_enabled() else nll(*args))
        nll_sum, count = nll_sum + ds, count + dk
    return nll_sum, count


def lm_loss(params, cfg: LMConfig, batch, *, impl: str = "kernel",
            mesh=None):
    """batch: {tokens [B, S], labels [B, S] (-100 = ignore)} -> (loss +
    AUX_WEIGHT * aux, {"lm_loss", "moe_aux"}). ``impl`` as in
    ``forward``.

    With ``loss_chunk`` set (S a multiple of it and longer), the head and
    the cross entropy run chunk by chunk along the sequence, each chunk
    under checkpoint when gradients are on, so only one chunk's [B, chunk,
    V] f32 logits are ever live, forward or backward.

    With ``mesh``: the whole batch in, each rank's block read; the loss
    over the whole batch (the same on every rank), the cross entropy
    vocab-parallel over ``model``; each rank's gradients are its own
    part's (``models/lm_parallel.py``), which ``make_fn``'s mesh step
    sums."""
    if mesh is not None:
        return _lm_loss_mesh(params, cfg, batch, impl, mesh)
    x, aux = backbone(params, cfg, batch["tokens"], impl=impl)
    nll_sum, count = _chunked_nll(lambda w, x, labels: _nll({"w": w}, x,
                                                            labels),
                                  params["head"]["w"], x, batch["labels"],
                                  cfg.loss_chunk)
    loss = nll_sum / count.clamp_min(1)
    return loss + AUX_WEIGHT * aux, {"lm_loss": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(params, cfg: LMConfig, tokens, *, impl: str = "kernel",
            mesh=None):
    """Full causal forward over tokens [B, S]; returns the last position's
    logits [B, V]. As in the JAX package, the [B, S, V] logits exist
    first (10 GB in bf16 at B=1, S=32,768, V=151,936); the last row is
    copied out so they are freed on return. With ``mesh``: this rank's
    batch block's [B/D, V], the head applied to the last position only
    (each rank's vocabulary columns, gathered over ``model``)."""
    if mesh is not None:
        x, _, specs = _backbone_mesh(params, cfg, tokens, impl, mesh)
        return _last_logits_mesh(params, specs, x, cfg, mesh)
    logits, _ = forward(params, cfg, tokens, impl=impl)
    return logits[:, -1].clone()


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, quant: bool = False, device="cuda",
               mesh=None):
    """KV cache [L, B, S_max, Hkv, hd] for k and v (or, with ``quant``,
    int8 values plus per-token, per-head f32 scales, half the bytes a
    decode step reads). Each layer has its own storage: the tensors are
    allocated at full size, never broadcast views, because decode writes
    them in place. ``device`` defaults to the card and raises without
    one; pass ``device="cpu"`` for the CPU. With ``mesh``: this rank's
    block by ``lm_batch_specs``, [L, B/D, S_max, Hkv_rank, hd], D the
    product of the data axes (``pod``, ``data``; the whole batch where D
    does not divide it) and Hkv_rank the rank's KV heads by the head plan
    (1 where a KV head is replicated over the ranks that share it)."""
    device = check_device(device)
    acfg = cfg.attn_cfg()
    if mesh is not None:
        tp.check_tp(cfg, mesh)
        acfg = tp.local_attn_cfg(acfg, mesh)
        D = mesh.size(DATA_AXES)
        batch = batch // D if batch % D == 0 else batch
    # one layer's layout from nn.attention (meta tensors: shapes and dtypes
    # only), allocated for every layer
    layer = (init_kv_cache_q8(batch, max_len, acfg, device="meta")
             if quant else init_kv_cache(batch, max_len, acfg, dtype,
                                         device="meta"))
    return {name: torch.zeros((cfg.n_layers, *t.shape), dtype=t.dtype,
                              device=device)
            for name, t in layer.items()}


def _decode_step_mesh(params, cfg: LMConfig, token, cache, cache_index,
                      mesh):
    token, _ = tp.data_block(token, mesh)
    fsdp = tp.fsdp_on(params, cfg, mesh)
    specs = tp.param_specs(params, cfg, mesh, fsdp)
    x = tp.embed_vp(params["embed"]["table"], token, mesh, cfg.torch_dtype,
                    fsdp)
    for i, (layer, ls) in enumerate(zip(params["layers"], specs["layers"])):
        layer = tp.gather_fsdp(layer, ls, mesh)
        cache_l = {name: t[i] for name, t in cache.items()}
        attn, acfg = tp.rank_attention(
            layer["attn"], cfg.attn_cfg(local=cfg.is_local(i)), mesh)
        h, _ = decode_attention(attn, copy_to(rmsnorm(layer["ln1"], x),
                                              mesh),
                                cache_l, cache_index, acfg,
                                reduce=lambda y: reduce_from(y, mesh))
        x = x + h
        y, _ = _ffn_or_moe_mesh(layer, copy_to(rmsnorm(layer["ln2"], x),
                                               mesh), cfg, mesh)
        x = x + y
    x = rmsnorm(params["ln_f"], x)
    return _last_logits_mesh(params, specs, x, cfg, mesh), cache


def decode_step(params, cfg: LMConfig, token, cache, cache_index, *,
                mesh=None):
    """One decode step. token: [B, 1] ids; cache: ``init_cache``'s dict of
    [L, ...] tensors; cache_index: the number of valid entries (int).
    Returns (logits [B, V], cache). Each layer writes its new k/v into
    its slice of ``cache`` in place, so the returned cache is the same
    tensors, updated: no step copies the cache. A chunked-local layer
    (``cfg.is_local``) attends over the trailing ``chunk_size`` slots, a
    global one over the whole cache, as in the JAX package; the MoE
    routes the step's B tokens as one call (its own capacity). With
    ``mesh``: the whole [B, 1] token batch in, this rank's block read;
    ``cache`` this rank's block (``init_cache(mesh=)``); logits [B/D, V],
    gathered over ``model``; the MoE on a data shard's tokens."""
    if mesh is not None:
        return _decode_step_mesh(params, cfg, token, cache, cache_index,
                                 mesh)
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
