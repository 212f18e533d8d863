"""The recsys family's configurations and its train and serving entry
points.

The four configs carry the exact widths of the JAX package's
``configs/recsys_family.py`` (Wide&Deep, DLRM-RM2, DCN-v2, BERT4Rec).
``make_fn`` is the counterpart of a JAX ``Cell.make_fn`` with no mesh,
for the train, serve and retrieval shapes; ``train`` is fixed to the JAX
cell's ``RS_OPT``. The XLA dry-run machinery (``Cell``, ``abstract_args``)
has no counterpart in the port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import check_device
from repro_torch.models.recsys import bert4rec, ctr
from repro_torch.models.recsys.common import SparseSpec, criteo_like_vocab
from repro_torch.optim import AdamConfig, make_train_step

RS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
}

RS_OPT = AdamConfig(lr=1e-3, grad_clip=1.0)
# BERT4Rec's train_batch on one 80 GB card: its gathered negatives at
# B=65,536 ([B, 40, 100, 64] f32) take 67 GB, so the card's step takes the
# batch as this many microbatches of 4,096, through RS_OPT with
# accum_steps set (the shape chip_smoke.py and profile run)
B4R_ONE_CARD_ACCUM = 16

WIDE_DEEP = ctr.CTRConfig(
    name="wide-deep",
    sparse=SparseSpec(n_fields=40, vocab_sizes=criteo_like_vocab(40),
                      embed_dim=32, nnz=2),
    n_dense=0, interaction="concat", mlp_dims=(1024, 512, 256), wide=True)

DLRM_RM2 = ctr.CTRConfig(
    name="dlrm-rm2",
    sparse=SparseSpec(n_fields=26, vocab_sizes=criteo_like_vocab(26),
                      embed_dim=64, nnz=1),
    n_dense=13, interaction="dot", mlp_dims=(),
    bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))

DCN_V2 = ctr.CTRConfig(
    name="dcn-v2",
    sparse=SparseSpec(n_fields=26, vocab_sizes=criteo_like_vocab(26),
                      embed_dim=16, nnz=1),
    n_dense=13, interaction="cross", mlp_dims=(1024, 1024, 512),
    n_cross_layers=3)

BERT4REC = bert4rec.Bert4RecConfig(
    name="bert4rec", n_items=3_000_000, embed_dim=64, n_blocks=2, n_heads=2,
    seq_len=200, d_ff=256, n_mask=40, n_neg=100)

CONFIGS = {c.name: c for c in (WIDE_DEEP, DLRM_RM2, DCN_V2, BERT4REC)}


def ctr_repr_dim(cfg: ctr.CTRConfig) -> int:
    """Width of ``ctr.user_repr`` (the retrieval candidates' width)."""
    F, d = cfg.sparse.n_fields, cfg.sparse.embed_dim
    if cfg.interaction == "dot":
        return cfg.bot_mlp[-1] + d
    return cfg.n_dense + F * d


def reduced_ctr(cfg: ctr.CTRConfig) -> ctr.CTRConfig:
    """The JAX package's smoke size (``_ctr_smoke``): 97 rows per field,
    d 8, towers (32, 16), bottom (16, 8), top (16, 8, 1); fields, nnz and
    the interaction as in ``cfg``."""
    return dataclasses.replace(
        cfg, sparse=SparseSpec(
            n_fields=cfg.sparse.n_fields,
            vocab_sizes=tuple([97] * cfg.sparse.n_fields),
            embed_dim=8, nnz=cfg.sparse.nnz),
        mlp_dims=(32, 16) if cfg.mlp_dims else (),
        bot_mlp=(16, 8) if cfg.bot_mlp else (),
        top_mlp=(16, 8, 1) if cfg.top_mlp else ())


def reduced_b4r(cfg: bert4rec.Bert4RecConfig) -> bert4rec.Bert4RecConfig:
    """The JAX package's smoke size (``_b4r_smoke``): 500 items, d 16,
    sequences of 24, d_ff 32, 4 masked positions, 8 negatives."""
    return dataclasses.replace(cfg, n_items=500, embed_dim=16, seq_len=24,
                               d_ff=32, n_mask=4, n_neg=8)


def make_fn(cfg, kind: str, *, device="cuda"):
    """The step of ``kind`` for ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU; without a GPU the default raises). The batch
    and the candidates are moved to ``device``; the parameters and the
    Adam state must already live there.

    ``train``: (params, opt_state, batch) -> (params, opt_state, metrics),
    the loss's Adam step with ``RS_OPT`` (the JAX cell's), parameters and
    moments updated in place. The CTR loss runs its lookups through the
    EmbeddingBag kernel and the table's gradient through its backward
    kernel; BERT4Rec's Cloze loss launches no kernel. Another
    ``AdamConfig`` (``accum_steps=B4R_ONE_CARD_ACCUM``) goes through
    ``optim.make_train_step`` over ``ctr.loss`` or ``bert4rec.loss``.
    The serving steps run without autograd. CTR configs: ``serve``:
    (params, batch) -> logits [B]; ``retrieval``: (params, batch, cand
    [N, ctr_repr_dim]) -> top-100 (scores, rows). BERT4Rec: ``serve``:
    (params, {"tokens"}) -> top-100 (scores, item ids) over the whole
    catalogue; ``retrieval``: (params, {"tokens"}, cand_ids [N]) ->
    top-100 (scores, positions in cand_ids).
    """
    is_ctr = isinstance(cfg, ctr.CTRConfig)
    mod = ctr if is_ctr else bert4rec
    if kind == "train":
        train = make_train_step(lambda p, b: mod.loss(p, cfg, b), RS_OPT)
    elif kind == "serve":
        fn = ((lambda p, b: ctr.forward(p, cfg, b)) if is_ctr   # noqa: E731
              else (lambda p, b: bert4rec.serve(p, cfg, b, k=100)))
    elif kind == "retrieval":
        fn = lambda p, b, c: mod.retrieval(p, cfg, b, c, k=100)  # noqa: E731
    else:
        raise ValueError(f"unknown recsys step kind: {kind!r}")
    device = check_device(device)

    if kind == "train":
        def train_step(params, opt_state, batch):
            return train(params, opt_state,
                         {k: v.to(device) for k, v in batch.items()})
        return train_step

    @torch.no_grad()
    def step(params, batch, *cand):
        batch = {k: v.to(device) for k, v in batch.items()}
        return fn(params, batch, *(c.to(device) for c in cand))

    return step
