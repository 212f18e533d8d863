"""BERT4Rec [1904.06690]: a bidirectional transformer over item sequences
with masked-item (Cloze) prediction.

Its attention is masked by the sequences' padding, so ``nn.attention``
takes the plain path, as in the JAX package: BERT4Rec launches no
kernel. ``params["blocks"]`` is a list of per-block dicts (the JAX
package's layout, which ``bridge.params_from_jax`` carries over). The
JAX package's two-stage sharded serve (``serve_sharded``) waits for the
port's multi-GPU work.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.embedding_bag import take_rows
from repro_torch.nn import (AttnConfig, attention, dense, embed,
                            init_attention, init_dense, init_embedding,
                            init_layernorm, layernorm)


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str
    n_items: int
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: int = 256
    n_mask: int = 40          # static masked-position budget per sequence
    n_neg: int = 100          # sampled negatives per prediction
    dtype: str = "float32"

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(d_model=self.embed_dim, n_heads=self.n_heads,
                          n_kv=self.n_heads,
                          head_dim=self.embed_dim // self.n_heads,
                          qkv_bias=True, out_bias=True, rope_fraction=0.0,
                          causal=False)

    @property
    def mask_token(self) -> int:
        return self.n_items           # one extra row in the table


def padded_items(n: int) -> int:
    """Rows of the item table: the items, the mask token, padded to a
    multiple of 4096 as in the JAX package (dead pad rows)."""
    return -(-(n + 1) // 4096) * 4096


def init(gen: torch.Generator, cfg: Bert4RecConfig,
         param_dtype=torch.float32):
    """Parameters drawn from ``gen`` on its device."""
    d = cfg.embed_dim
    return {
        "item_emb": init_embedding(gen, padded_items(cfg.n_items), d,
                                   dtype=param_dtype),
        "pos_emb": init_embedding(gen, cfg.seq_len, d, dtype=param_dtype),
        "blocks": [{
            "attn": init_attention(gen, cfg.attn, param_dtype),
            "ln1": init_layernorm(gen, d),
            "up": init_dense(gen, d, cfg.d_ff, dtype=param_dtype),
            "down": init_dense(gen, cfg.d_ff, d, dtype=param_dtype),
            "ln2": init_layernorm(gen, d),
        } for _ in range(cfg.n_blocks)],
    }


def encode(params, cfg: Bert4RecConfig, tokens, mask=None):
    """tokens: [B, S] (0 = pad) -> hidden [B, S, d]."""
    if mask is None:
        mask = tokens != 0
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    h = embed(params["item_emb"], tokens) + embed(params["pos_emb"], pos)[None]
    for blk in params["blocks"]:
        a = attention(blk["attn"], h, cfg.attn, mask=mask)
        h = layernorm(blk["ln1"], h + a)
        f = dense(blk["down"], F.gelu(dense(blk["up"], h), approximate="tanh"))
        h = layernorm(blk["ln2"], h + f)
    return h


def loss(params, cfg: Bert4RecConfig, batch):
    """Cloze loss with sampled negatives.

    batch: tokens [B, S] (mask token at masked slots), mask_pos
    [B, n_mask], labels [B, n_mask] (true item ids), mask_valid
    [B, n_mask], neg [B, n_mask, n_neg] sampled negative item ids.
    """
    h = encode(params, cfg, batch["tokens"])
    pos_idx = batch["mask_pos"].long()[..., None].expand(-1, -1, h.shape[-1])
    hp = torch.gather(h, 1, pos_idx)                         # [B, m, d]
    table = params["item_emb"]["table"]
    pos_e = table[batch["labels"].long()]
    neg_e = table[batch["neg"].long()]
    pos = torch.einsum("bmd,bmd->bm", hp, pos_e).float()
    neg = torch.einsum("bmd,bmnd->bmn", hp, neg_e).float()
    logits = torch.cat([pos[..., None], neg], dim=-1)
    logp = torch.log_softmax(logits, dim=-1)[..., 0]
    valid = batch["mask_valid"]
    n = valid.sum().clamp_min(1)
    l = -(logp * valid).sum() / n
    acc = ((logits.argmax(-1) == 0) & valid).sum() / n
    return l, {"cloze_acc": acc}


def user_embedding(params, cfg: Bert4RecConfig, tokens):
    """Sequence representation at the final (mask-appended) position."""
    h = encode(params, cfg, tokens)
    lengths = (tokens != 0).sum(dim=1)
    idx = torch.clamp(lengths - 1, 0, cfg.seq_len - 1)
    return h[torch.arange(h.shape[0], device=h.device), idx]


def serve(params, cfg: Bert4RecConfig, batch, *, k: int = 100):
    """Score users against the full item table -> top-k (scores, ids)."""
    u = user_embedding(params, cfg, batch["tokens"])          # [B, d]
    scores = u @ params["item_emb"]["table"][:cfg.n_items].to(u.dtype).T
    return torch.topk(scores, k, dim=-1)


def retrieval(params, cfg: Bert4RecConfig, batch, cand_ids, *,
              k: int = 100):
    """retrieval_cand: one query against n candidate item ids; -> top-k
    (scores, positions in ``cand_ids``)."""
    u = user_embedding(params, cfg, batch["tokens"])          # [1, d]
    ce = take_rows(params["item_emb"]["table"], cand_ids)    # [N, d]
    return torch.topk(u @ ce.to(u.dtype).T, k, dim=-1)
