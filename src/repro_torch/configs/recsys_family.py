"""The recsys family's configurations and its train and serving entry
points.

The four configs carry the exact widths of the JAX package's
``configs/recsys_family.py`` (Wide&Deep, DLRM-RM2, DCN-v2, BERT4Rec).
``make_fn`` is the counterpart of a JAX ``Cell.make_fn`` with no mesh,
for the train, serve and retrieval shapes; ``train`` is fixed to the JAX
cell's ``RS_OPT``. ``archs()`` gives the registry's four arches
(``configs.get_arch``), each with its four cells, their ``abstract_args``
(the JAX cells' shapes), ``concrete_args`` for the train and serve
cells (``data/recsys_synth.py``'s batches) and the JAX package's reduced
smoke.

``make_fn(cfg, kind, device=, mesh=)`` is the counterpart of a JAX
``Cell.make_fn(mesh)`` on a (data, model) mesh of ranks
(``launch/mesh.py``): the parameters placed by ``recsys_rules``
(``place_params``, ``place_opt``, or drawn by ``init_placed``), the
tables cut by rows over ``model``; ``models/recsys/parallel.py`` says
how the steps run there.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.data import recsys_synth
from repro_torch.device import check_device
from repro_torch.distributed import sharding as shx
from repro_torch.models.recsys import bert4rec, ctr
from repro_torch.models.recsys import parallel as rp
from repro_torch.models.recsys.common import SparseSpec, criteo_like_vocab
# a whole tree's (and its Adam state's) blocks on a mesh by recsys_rules
from repro_torch.models.recsys.parallel import (place_opt,  # noqa: F401
                                                place_params)
from repro_torch.optim import AdamConfig, adam_init, make_train_step

from .base import (F32, I32, Arch, Cell, abstract_opt, abstract_params,
                   assert_finite, meta, shard_abstract)

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


def init_placed(gen: torch.Generator, cfg, mesh,
                param_dtype=torch.float32):
    """``place_params(init(gen, cfg, param_dtype), mesh)``: the whole tree
    is drawn (the same draws as one process), this rank's blocks kept and
    the rest freed; ranks that share a card draw one at a time."""
    return place_params(_init(cfg)(gen, cfg, param_dtype), mesh)


def make_fn(cfg, kind: str, *, device="cuda", mesh=None):
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

    With ``mesh`` (in each rank of it, ``device`` the rank's): the same
    steps on this rank's blocks (``place_params``, ``place_opt``), the
    batch and the candidates whole, each rank reading its block over the
    data axes (``recsys_batch_specs``; what they do not divide whole).
    The train step sums the gradients over ``data`` and clips by the
    global norm (``optim.make_train_step(mesh=)``); serve and retrieval
    return this rank's batch block; BERT4Rec serves by
    ``bert4rec.serve_sharded``, as the JAX cell does on a mesh.
    """
    is_ctr = isinstance(cfg, ctr.CTRConfig)
    mod = ctr if is_ctr else bert4rec
    if kind == "train":
        train = make_train_step(
            lambda p, b: mod.loss(p, cfg, b, mesh=mesh), RS_OPT, mesh=mesh,
            specs=None if mesh is None else (
                lambda p: rp.specs_by_path(p, mesh)))
    elif kind == "serve":
        if is_ctr:
            fn = lambda p, b: ctr.forward(p, cfg, b, mesh=mesh)  # noqa: E731
        elif mesh is not None:
            fn = lambda p, b: bert4rec.serve_sharded(  # noqa: E731
                p, cfg, b, mesh, k=100)
        else:
            fn = lambda p, b: bert4rec.serve(p, cfg, b, k=100)  # noqa: E731
    elif kind == "retrieval":
        fn = lambda p, b, c: mod.retrieval(  # noqa: E731
            p, cfg, b, c, k=100, mesh=mesh)
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


# ---------------------------------------------------------------------------
# the registry's arches (configs.get_arch)
# ---------------------------------------------------------------------------

def _mlp_flops(dims, B):
    return sum(2 * B * a * b for a, b in zip(dims[:-1], dims[1:]))


def _ctr_flops(cfg: ctr.CTRConfig, shp) -> float:
    """Useful-model FLOPs per call (fwd; x3 for train), the JAX cell's."""
    B = shp.get("batch", 1)
    F, d = cfg.sparse.n_fields, cfg.sparse.embed_dim
    x0 = cfg.n_dense + F * d
    f = 0.0
    if cfg.interaction == "dot":
        f += _mlp_flops((cfg.n_dense,) + cfg.bot_mlp, B)
        n_vec = F + 1
        f += 2 * B * n_vec * n_vec * d
        f += _mlp_flops((n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1],)
                        + cfg.top_mlp, B)
    elif cfg.interaction == "cross":
        f += cfg.n_cross_layers * 2 * B * x0 * x0
        f += _mlp_flops((x0,) + cfg.mlp_dims, B)
    else:
        f += _mlp_flops((x0,) + cfg.mlp_dims + (1,), B)
    if shp["kind"] == "train":
        f *= 3
    if shp["kind"] == "retrieval":
        f += 2 * shp["n_cand"] * ctr_repr_dim(cfg)
    return f


def _b4r_flops(cfg: bert4rec.Bert4RecConfig, shp) -> float:
    kind, B = shp["kind"], shp.get("batch", 1)
    enc_flops = (cfg.n_blocks
                 * (8 * cfg.seq_len * cfg.embed_dim ** 2
                    + 4 * cfg.seq_len ** 2 * cfg.embed_dim
                    + 4 * cfg.seq_len * cfg.embed_dim * cfg.d_ff)) * B
    mf = enc_flops * (3 if kind == "train" else 1)
    if kind == "serve":
        mf += 2 * B * cfg.n_items * cfg.embed_dim
    if kind == "retrieval":
        mf += 2 * shp["n_cand"] * cfg.embed_dim
    return float(mf)


def _init(cfg):
    return ctr.init if isinstance(cfg, ctr.CTRConfig) else bert4rec.init


def _abstract_batch(cfg, kind: str, B: int) -> dict:
    """A batch of B on meta with the JAX cell's keys, shapes and dtypes
    (``_ctr_batch``, ``_b4r_train_batch``): the label only to train."""
    if isinstance(cfg, ctr.CTRConfig):
        F, nnz = cfg.sparse.n_fields, cfg.sparse.nnz
        b = {"sparse_idx": meta((B, F, nnz), I32),
             "sparse_w": meta((B, F, nnz), F32)}
        if cfg.n_dense:
            b["dense"] = meta((B, cfg.n_dense), F32)
        if kind == "train":
            b["label"] = meta((B,), F32)
        return b
    b = {"tokens": meta((B, cfg.seq_len), I32)}
    if kind == "train":
        m = (B, cfg.n_mask)
        b.update(mask_pos=meta(m, I32), labels=meta(m, I32),
                 mask_valid=meta(m, torch.bool),
                 neg=meta((*m, cfg.n_neg), I32))
    return b


def _abstract_args(cfg, shape: str, mesh=None, whole_batch: bool = False):
    """The cell's arguments on meta, as the JAX cell's ``args(mesh)``:
    parameters (and their Adam state to train) and the batch; retrieval
    also the 10^6 candidates (CTR: [N, ctr_repr_dim] f32; BERT4Rec: item
    ids [N] int32). With ``mesh``: one rank's blocks
    (``shard_abstract``): the parameters and moments by ``recsys_rules``,
    the batch over the data axes (the retrieval query whole), the
    candidates over the data axes; with ``whole_batch`` the batch and the
    candidates whole, as the mesh step takes them."""
    shp = RS_SHAPES[shape]
    kind = shp["kind"]
    params = abstract_params(functools.partial(_init(cfg), cfg=cfg))
    batch = _abstract_batch(cfg, kind, shp["batch"])
    cand = None
    if kind == "retrieval":
        cand = (meta((shp["n_cand"], ctr_repr_dim(cfg)), F32)
                if isinstance(cfg, ctr.CTRConfig)
                else meta((shp["n_cand"],), I32))
    opt = abstract_opt(params) if kind == "train" else None
    if mesh is not None:
        specs = rp.param_specs(params, mesh)
        if opt is not None:
            opt = dict(opt, m=shard_abstract(opt["m"], specs, mesh),
                       v=shard_abstract(opt["v"], specs, mesh))
        params = shard_abstract(params, specs, mesh)
        if whole_batch:          # as the mesh step takes them
            pass
        elif kind == "retrieval":
            cand = shard_abstract(cand, shx.guard_divisible(
                shx.data_spec(mesh), cand, mesh), mesh)
        else:
            batch = shard_abstract(batch, shx.guard_divisible(
                shx.recsys_batch_specs(mesh, batch), batch, mesh), mesh)
    if kind == "train":
        return (params, opt, batch)
    if kind == "serve":
        return (params, batch)
    return (params, batch, cand)


def _concrete_args(cfg, shape: str, device):
    """The train or serve cell's arguments at its shape on ``device``:
    parameters from a generator seeded with 0 (their Adam state to train),
    and ``recsys_synth``'s batch from seed 0 (the label only to train)."""
    shp = RS_SHAPES[shape]
    kind, B = shp["kind"], shp["batch"]
    params = _init(cfg)(torch.Generator(device=device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    if isinstance(cfg, ctr.CTRConfig):
        batch = recsys_synth.ctr_batch(
            rng, batch=B, n_dense=cfg.n_dense,
            vocab_sizes=cfg.sparse.vocab_sizes, nnz=cfg.sparse.nnz,
            device=device)
    else:
        batch = recsys_synth.bert4rec_batch(
            rng, batch=B, seq_len=cfg.seq_len, n_items=cfg.n_items,
            n_mask=cfg.n_mask, n_neg=cfg.n_neg, mask_token=cfg.mask_token,
            device=device)
    keys = _abstract_batch(cfg, kind, B)
    batch = {k: v for k, v in batch.items() if k in keys}
    if kind == "train":
        return (params, adam_init(params), batch)
    return (params, batch)


def recsys_arch(cfg, notes: str = "") -> Arch:
    """The four RS_SHAPES cells of ``cfg``; each cell's ``make_fn`` takes
    ``device`` and ``mesh`` as ``make_fn`` does, its ``abstract_args``
    ``mesh`` (a rank's blocks). The train and serve cells have
    ``concrete_args``; retrieval has none (its candidates have no builder
    in the port)."""
    is_ctr = isinstance(cfg, ctr.CTRConfig)
    cells = {}
    for shape, shp in RS_SHAPES.items():
        kind = shp["kind"]
        cell_meta = ({"model_flops": _ctr_flops(cfg, shp),
                      "embedding_rows": cfg.sparse.total_rows} if is_ctr
                     else {"model_flops": _b4r_flops(cfg, shp)})
        cells[shape] = Cell(
            arch=cfg.name, shape=shape, kind=kind,
            make_fn=functools.partial(make_fn, cfg, kind), meta=cell_meta,
            abstract_args=functools.partial(_abstract_args, cfg, shape),
            concrete_args=(functools.partial(_concrete_args, cfg, shape)
                           if kind != "retrieval" else None))
    smoke = _ctr_smoke if is_ctr else _b4r_smoke
    return Arch(name=cfg.name, family="recsys", config=cfg, cells=cells,
                smoke=functools.partial(smoke, cfg), notes=notes)


def _ctr_smoke(cfg: ctr.CTRConfig, device="cuda"):
    """The JAX package's reduced CTR smoke (``reduced_ctr``) on ``device``,
    with torch draws: one Adam step on B=32, the forward's logits and a
    top-8 retrieval against 64 candidates."""
    device = check_device(device)
    small = reduced_ctr(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = ctr.init(gen, small)
    B, F, nnz = 32, small.sparse.n_fields, small.sparse.nnz
    batch = {"sparse_idx": torch.randint(0, 97, (B, F, nnz), generator=gen,
                                         device=device, dtype=torch.int32),
             "sparse_w": torch.ones((B, F, nnz), device=device),
             "label": (torch.rand(B, generator=gen, device=device)
                       < 0.5).float()}
    if small.n_dense:
        batch["dense"] = torch.randn((B, small.n_dense), generator=gen,
                                     device=device)
    step = make_train_step(lambda p, b: ctr.loss(p, small, b), RS_OPT)
    params, _, metrics = step(params, adam_init(params), batch)
    assert_finite(metrics["loss"], f"{cfg.name} loss")
    with torch.no_grad():
        logits = ctr.forward(params, small, batch)
        assert logits.shape == (B,)
        assert_finite(logits, f"{cfg.name} logits")
        cand = torch.randn((64, ctr_repr_dim(small)), generator=gen,
                           device=device)
        sc, _ = ctr.retrieval(params, small, batch, cand, k=8)
    assert sc.shape == (B, 8)
    return {"loss": float(metrics["loss"])}


def _b4r_smoke(cfg: bert4rec.Bert4RecConfig, device="cuda"):
    """The JAX package's reduced BERT4Rec smoke (``reduced_b4r``) on
    ``device``, with torch draws: one Adam step on B=8, then a top-10
    serve over the catalogue."""
    device = check_device(device)
    small = reduced_b4r(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = bert4rec.init(gen, small)
    B, S, n_m, n_i = 8, small.seq_len, small.n_mask, small.n_items

    def ids(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    batch = {"tokens": ids((B, S), 1, n_i),
             "mask_pos": ids((B, n_m), 0, S),
             "labels": ids((B, n_m), 1, n_i),
             "mask_valid": torch.ones((B, n_m), dtype=torch.bool,
                                      device=device),
             "neg": ids((B, n_m, small.n_neg), 1, n_i)}
    step = make_train_step(lambda p, b: bert4rec.loss(p, small, b), RS_OPT)
    params, _, metrics = step(params, adam_init(params), batch)
    assert_finite(metrics["loss"], f"{cfg.name} loss")
    with torch.no_grad():
        sc, _ = bert4rec.serve(params, small, batch, k=10)
    assert sc.shape == (B, 10)
    return {"loss": float(metrics["loss"])}


def archs():
    return [
        recsys_arch(WIDE_DEEP,
                    notes="wide linear + deep MLP, concat interaction"),
        recsys_arch(DLRM_RM2,
                    notes="dot interaction; EmbeddingBag is the hot path"),
        recsys_arch(BERT4REC, notes="bidirectional seq rec; the "
                                    "SpeedyFeed-applicable arch"),
        recsys_arch(DCN_V2, notes="cross network v2 (full-rank)"),
    ]
