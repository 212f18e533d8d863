"""BERT4Rec [1904.06690]: a bidirectional transformer over item sequences
with masked-item (Cloze) prediction.

Its attention is masked by the sequences' padding, so ``nn.attention``
takes the plain path, as in the JAX package: BERT4Rec launches no
kernel. ``params["blocks"]`` is a list of per-block dicts (the JAX
package's layout, which ``bridge.params_from_jax`` carries over).

Every entry point takes ``mesh=``: on a (data, model) mesh the item
table is this rank's block of rows over ``model`` and the encoder whole;
the batch comes in whole and each rank encodes its data block, its item
lookup the vocab-parallel one; the Cloze loss sums each rank's scores
of its own item rows (``models/recsys/parallel.py``).
``serve_sharded`` is the JAX package's two-stage top-k over the item
rows: it never holds the [B, n_items] score matrix.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (copy_to, owned_rows,
                                                 reduce_from)
from repro_torch.kernels.embedding_bag import take_rows
from repro_torch.nn import (AttnConfig, attention, dense, embed,
                            init_attention, init_dense, init_embedding,
                            init_layernorm, layernorm)

from . import parallel as rp


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


def encode(params, cfg: Bert4RecConfig, tokens, mask=None, *, mesh=None):
    """tokens: [B, S] (0 = pad) -> hidden [B, S, d] (with ``mesh``: this
    rank's data block's)."""
    if mesh is not None:
        tokens = rp.data_block(tokens, mesh)[0]
        mask = None if mask is None else rp.data_block(mask, mesh)[0]
    return _encode(params, cfg, tokens, mask, mesh)


def _encode(params, cfg: Bert4RecConfig, tokens, mask, mesh):
    if mask is None:
        mask = tokens != 0
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    if mesh is None:
        items = embed(params["item_emb"], tokens)
    else:                                   # vocab-parallel
        items = reduce_from(owned_rows(params["item_emb"]["table"], tokens,
                                       mesh), mesh)
    h = items + embed(params["pos_emb"], pos)[None]
    for blk in params["blocks"]:
        a = attention(blk["attn"], h, cfg.attn, mask=mask)
        h = layernorm(blk["ln1"], h + a)
        f = dense(blk["down"], F.gelu(dense(blk["up"], h), approximate="tanh"))
        h = layernorm(blk["ln2"], h + f)
    return h


def loss(params, cfg: Bert4RecConfig, batch, *, mesh=None):
    """Cloze loss with sampled negatives.

    batch: tokens [B, S] (mask token at masked slots), mask_pos
    [B, n_mask], labels [B, n_mask] (true item ids), mask_valid
    [B, n_mask], neg [B, n_mask, n_neg] sampled negative item ids.

    With ``mesh``: each rank scores its data block's masked positions
    against its own rows of the positive and negative items (0 for the
    rows another rank holds), and the scores [B/D, m, 1 + n_neg] are
    summed over ``model``; the masked positions' hidden states enter
    through ``copy_to``, so each rank's encoder gradient is the sum of
    every rank's part. The loss and accuracy are the global batch's
    (``parallel.data_mean``): no [B, m, n_neg, d] tensor crosses ranks.
    """
    split = True
    if mesh is not None:
        batch, split = rp.batch_block(batch, mesh)
    h = _encode(params, cfg, batch["tokens"], None, mesh)
    pos_idx = batch["mask_pos"].long()[..., None].expand(-1, -1, h.shape[-1])
    hp = torch.gather(h, 1, pos_idx)                         # [B, m, d]
    table = params["item_emb"]["table"]
    if mesh is None:
        pos_e = table[batch["labels"].long()]
        neg_e = table[batch["neg"].long()]
        pos = torch.einsum("bmd,bmd->bm", hp, pos_e).float()
        neg = torch.einsum("bmd,bmnd->bmn", hp, neg_e).float()
        logits = torch.cat([pos[..., None], neg], dim=-1)
    else:
        ids = torch.cat([batch["labels"][..., None], batch["neg"]], -1).long()
        logits = reduce_from(torch.einsum(
            "bmd,bmnd->bmn", copy_to(hp, mesh),
            owned_rows(table, ids, mesh)), mesh).float()
    logp = torch.log_softmax(logits, dim=-1)[..., 0]
    valid = batch["mask_valid"]
    hit = (logits.argmax(-1) == 0) & valid
    if mesh is None:
        n = valid.sum().clamp_min(1)
        return -(logp * valid).sum() / n, {"cloze_acc": hit.sum() / n}
    n = valid.sum()
    return (rp.data_mean(-(logp * valid).sum(), n, split, mesh),
            {"cloze_acc": rp.data_mean(hit.sum().float(), n, split, mesh)})


def user_embedding(params, cfg: Bert4RecConfig, tokens, *, mesh=None):
    """Sequence representation at the final (mask-appended) position
    (with ``mesh``: this rank's data block's)."""
    if mesh is not None:
        tokens = rp.data_block(tokens, mesh)[0]
    return _user_embedding(params, cfg, tokens, mesh)


def _user_embedding(params, cfg: Bert4RecConfig, tokens, mesh):
    h = _encode(params, cfg, tokens, None, mesh)
    lengths = (tokens != 0).sum(dim=1)
    idx = torch.clamp(lengths - 1, 0, cfg.seq_len - 1)
    return h[torch.arange(h.shape[0], device=h.device), idx]


def serve(params, cfg: Bert4RecConfig, batch, *, k: int = 100):
    """Score users against the full item table -> top-k (scores, ids)."""
    u = user_embedding(params, cfg, batch["tokens"])          # [B, d]
    scores = u @ params["item_emb"]["table"][:cfg.n_items].to(u.dtype).T
    return torch.topk(scores, k, dim=-1)


def serve_sharded(params, cfg: Bert4RecConfig, batch, mesh, *,
                  k: int = 100, row_chunk: int = 1024):
    """``serve`` on a mesh whose ``model`` axis cuts the item table by
    rows, in two stages (the JAX package's): each model rank scores its
    V/M item rows against its data block's users, ``row_chunk`` users at
    a time ([row_chunk, V/M] scores live at once), masks its pad rows and
    the rows at or past ``n_items`` to -inf, and takes each chunk's top-k
    as global ids; the [B/D, k] winners are all-gathered over ``model``
    and the top-k taken again (``parallel.merge_topk``). -> this rank's
    batch block's (scores, item ids), the function of one process's
    ``serve`` (equal scores may come in another order)."""
    tokens = rp.data_block(batch["tokens"], mesh)[0]
    u = _user_embedding(params, cfg, tokens, mesh)            # [B/D, d]
    table = params["item_emb"]["table"]
    lo = mesh.index(rp.MODEL) * table.shape[0]
    dead = torch.arange(lo, lo + table.shape[0],
                        device=table.device) >= cfg.n_items
    vals, ids = [], []
    for uc in u.split(row_chunk):
        s = (uc @ table.to(uc.dtype).T).masked_fill_(dead, float("-inf"))
        v, i = torch.topk(s, k, dim=-1)
        vals.append(v)
        ids.append(i + lo)
        del s           # before the next chunk's scores are made
    return rp.merge_topk(torch.cat(vals), torch.cat(ids), k, mesh, rp.MODEL)


def retrieval(params, cfg: Bert4RecConfig, batch, cand_ids, *,
              k: int = 100, mesh=None):
    """retrieval_cand: one query against n candidate item ids; -> top-k
    (scores, positions in ``cand_ids``).

    With ``mesh`` (``cand_ids`` whole): every rank encodes the whole query
    batch; each data rank scores its block of the candidates, each model
    rank its own item rows of them (0 for the rows another rank holds,
    where one process reads NaN for an id outside the table), the scores
    summed over ``model``, then the top-k in two stages over ``data``
    (``parallel.cut_topk``); returns this rank's batch block."""
    table = params["item_emb"]["table"]
    if mesh is None:
        u = user_embedding(params, cfg, batch["tokens"])      # [1, d]
        ce = take_rows(table, cand_ids)                      # [N, d]
        return torch.topk(u @ ce.to(u.dtype).T, k, dim=-1)
    u = _user_embedding(params, cfg, batch["tokens"], mesh)

    def scores(ids):
        rows = owned_rows(table, ids.long(), mesh, dtype=u.dtype)
        return reduce_from(u @ rows.T, mesh)

    vals, pos = rp.cut_topk(scores, cand_ids, k, mesh)
    return rp.data_block(vals, mesh)[0], rp.data_block(pos, mesh)[0]
