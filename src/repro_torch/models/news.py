"""The news baselines (paper §5.1.3): NPA, NAML, LSTUR and NRMS.

Small text encoders (a CNN or self-attention over word embeddings) and
each method's user encoder, trained with the conventional workflow's
impression click loss (``core.click_loss``): the Table-3 baselines that
SpeedyFeed's PLM recommender is compared against.

Batch layout (``data.build_conventional_batch`` plus ``user_id``):
hist_tokens [B, L, K, S], hist_mask [B, L], cand_tokens [B, C, K, S],
label [B], cand_mask [B, C], user_id [B].

The parameter tree has the JAX package's keys, nesting and shapes, so
``bridge.params_from_jax`` carries a JAX ``init`` over unchanged: a CNN
weight is ``[width, d_in, d_out]`` as XLA's ``WIO`` (permuted to
``conv1d``'s ``[out, in, width]`` at the call), and NAML's ``view_cnn``
is a list. Masked scores are filled with -1e30, so a row with nothing
valid (a pad news, an all-pad view, an empty history) averages
uniformly, as the JAX package's do. NRMS's news and user attentions carry
a key mask, so they are plain attention, never the flash kernel.

The embedding tables are read with ``F.embedding``, whose backward on the
card sums a row's repeats in parallel pieces. Indexing (``nn.embed``)
sums them one after another on one row: ~97% of a conventional batch's
tokens are the pad, and at 512 users (5.0M tokens) its backward took
3.36 s against 55 ms on an H100, nearly all of a baseline's step.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.loss import click_loss
from repro_torch.core.plm import additive_attention
from repro_torch.nn import (AttnConfig, attention, dense, init_attention,
                            init_dense, init_embedding, normal_init)

NAMES = ("npa", "naml", "lstur", "nrms")


@dataclasses.dataclass(frozen=True)
class NewsBaselineConfig:
    name: str                  # npa | naml | lstur | nrms
    vocab: int = 30522
    n_users: int = 100_000
    d_word: int = 64
    d_news: int = 64
    n_heads: int = 4           # nrms
    cnn_width: int = 3
    n_views: int = 3           # naml: title/abstract/body == K segments
    dtype: str = "float32"


def _lookup(p, ids):
    """Rows ``ids`` of the table ``p`` (see the module docstring)."""
    return F.embedding(ids, p["table"])


def _init_addattn(gen, dim, param_dtype):
    return {"proj": init_dense(gen, dim, dim, dtype=param_dtype),
            "query": normal_init(gen, (dim,), 0.02, param_dtype)}


def _init_cnn(gen, d_in, d_out, width, param_dtype):
    return {"w": normal_init(gen, (width, d_in, d_out), 0.02, param_dtype),
            "b": torch.zeros(d_out, dtype=param_dtype, device=gen.device)}


def _cnn(p, x):
    """x: [N, S, d_in] -> [N, S, d_out]: ReLU of a 1-D cross-correlation
    with XLA's SAME padding ((width - 1) // 2 zeros on the left, the rest
    on the right)."""
    width = p["w"].shape[0]
    left = (width - 1) // 2
    xs = F.pad(x.transpose(1, 2), (left, width - 1 - left))
    y = F.conv1d(xs, p["w"].permute(2, 1, 0)).transpose(1, 2)
    return torch.relu(y + p["b"])


def _init_gru(gen, d_in, d_h, param_dtype):
    return {"wx": init_dense(gen, d_in, 3 * d_h, dtype=param_dtype),
            "wh": init_dense(gen, d_h, 3 * d_h, use_bias=False,
                             dtype=param_dtype)}


def _gru_scan(p, xs, h0, mask):
    """xs: [B, L, d]; h0: [B, d]; mask: [B, L] -> the final h [B, d]. A
    step whose mask is False keeps h, so gaps and a padded tail leave it
    where the last valid step put it."""
    h = h0
    for t in range(xs.shape[1]):
        xz, xr, xn = dense(p["wx"], xs[:, t]).chunk(3, dim=-1)
        hz, hr, hn = dense(p["wh"], h).chunk(3, dim=-1)
        z = torch.sigmoid(xz + hz)
        r = torch.sigmoid(xr + hr)
        n = torch.tanh(xn + r * hn)
        h = torch.where(mask[:, t, None], (1 - z) * n + z * h, h)
    return h


def _attn_cfg(cfg: NewsBaselineConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_news, n_heads=cfg.n_heads,
                      n_kv=cfg.n_heads, head_dim=cfg.d_news // cfg.n_heads,
                      qkv_bias=True, out_bias=True, rope_fraction=0.0,
                      causal=False)


def init(gen: torch.Generator, cfg: NewsBaselineConfig,
         param_dtype=torch.float32):
    """Random parameters on ``gen``'s device, in the JAX tree's layout."""
    p = {"word_emb": init_embedding(gen, cfg.vocab, cfg.d_word,
                                    dtype=param_dtype)}
    d = cfg.d_news
    if cfg.name == "nrms":
        acfg = _attn_cfg(cfg)
        p["news_attn"] = init_attention(gen, acfg, param_dtype)
        p["news_pool"] = _init_addattn(gen, d, param_dtype)
        p["user_attn"] = init_attention(gen, acfg, param_dtype)
        p["user_pool"] = _init_addattn(gen, d, param_dtype)
        p["word_proj"] = init_dense(gen, cfg.d_word, d, dtype=param_dtype)
    elif cfg.name == "naml":
        p["view_cnn"] = [_init_cnn(gen, cfg.d_word, d, cfg.cnn_width,
                                   param_dtype)
                         for _ in range(cfg.n_views)]
        p["word_pool"] = _init_addattn(gen, d, param_dtype)
        p["view_pool"] = _init_addattn(gen, d, param_dtype)
        p["user_pool"] = _init_addattn(gen, d, param_dtype)
    elif cfg.name == "npa":
        p["cnn"] = _init_cnn(gen, cfg.d_word, d, cfg.cnn_width, param_dtype)
        p["user_emb"] = init_embedding(gen, cfg.n_users, d,
                                       dtype=param_dtype)
        p["q_word"] = init_dense(gen, d, d, dtype=param_dtype)
        p["q_news"] = init_dense(gen, d, d, dtype=param_dtype)
        p["w_proj"] = init_dense(gen, d, d, dtype=param_dtype)
    elif cfg.name == "lstur":
        p["cnn"] = _init_cnn(gen, cfg.d_word, d, cfg.cnn_width, param_dtype)
        p["word_pool"] = _init_addattn(gen, d, param_dtype)
        p["user_emb"] = init_embedding(gen, cfg.n_users, d,
                                       dtype=param_dtype)
        p["gru"] = _init_gru(gen, d, d, param_dtype)
    else:
        raise ValueError(f"unknown news baseline {cfg.name!r}; have {NAMES}")
    return p


def encode_news(params, cfg: NewsBaselineConfig, tokens, user_vec=None):
    """tokens [..., K, S] -> news embeddings [..., d_news]. NPA's word
    query comes from ``user_vec`` [B, d] (each user's row repeated over
    its news, which lie user by user: B*L histories or B*C candidates)."""
    lead = tokens.shape[:-2]
    K, S = tokens.shape[-2:]
    if cfg.name == "naml":
        if K != cfg.n_views:
            raise ValueError(f"NAML takes {cfg.n_views} views, got K={K}")
        t = tokens.reshape(-1, K, S)
        views = []
        for j in range(cfg.n_views):
            w = _lookup(params["word_emb"], t[:, j])            # [N, S, dw]
            c = _cnn(params["view_cnn"][j], w)
            views.append(additive_attention(params["word_pool"], c,
                                            t[:, j] != 0))
        v = torch.stack(views, dim=1)                           # [N, K, d]
        e = additive_attention(params["view_pool"], v, (t != 0).any(-1))
        return e.reshape(lead + (cfg.d_news,))
    t = tokens.reshape(-1, K * S)
    mask = t != 0
    w = _lookup(params["word_emb"], t)
    if cfg.name == "nrms":
        h = dense(params["word_proj"], w)
        h = h + attention(params["news_attn"], h, _attn_cfg(cfg), mask=mask)
        e = additive_attention(params["news_pool"], h, mask)
    elif cfg.name == "npa":
        c = _cnn(params["cnn"], w)
        q = torch.tanh(dense(params["q_word"], user_vec))       # [B, d]
        qr = q.repeat_interleave(t.shape[0] // q.shape[0], dim=0)
        a = torch.einsum("nsd,nd->ns", c, qr).masked_fill(~mask, -1e30)
        e = torch.einsum("ns,nsd->nd", torch.softmax(a, dim=-1), c)
        e = dense(params["w_proj"], e)
    else:  # lstur
        c = _cnn(params["cnn"], w)
        e = additive_attention(params["word_pool"], c, mask)
    return e.reshape(lead + (cfg.d_news,))


def loss(params, cfg: NewsBaselineConfig, batch):
    """The impression click loss of one conventional batch:
    (loss, {"click_acc"})."""
    uvec = None
    if cfg.name in ("npa", "lstur"):
        uvec = _lookup(params["user_emb"], batch["user_id"])    # [B, d]
    theta = encode_news(params, cfg, batch["hist_tokens"], uvec)  # [B, L, d]
    cand = encode_news(params, cfg, batch["cand_tokens"], uvec)   # [B, C, d]
    mask = batch["hist_mask"]
    if cfg.name == "nrms":
        h = theta + attention(params["user_attn"], theta, _attn_cfg(cfg),
                              mask=mask)
        user = additive_attention(params["user_pool"], h, mask)
    elif cfg.name == "npa":
        q = torch.tanh(dense(params["q_news"], uvec))
        a = torch.einsum("bld,bd->bl", theta, q).masked_fill(~mask, -1e30)
        user = torch.einsum("bl,bld->bd", torch.softmax(a, dim=-1), theta)
    elif cfg.name == "lstur":
        user = _gru_scan(params["gru"], theta, uvec, mask)   # long + short
    else:  # naml
        user = additive_attention(params["user_pool"], theta, mask)
    return click_loss(user, cand, batch["label"], batch["cand_mask"])
