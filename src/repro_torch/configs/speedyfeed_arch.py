"""SpeedyFeed's production configuration (the JAX package's
``configs/speedyfeed_arch.py:PROD``), its Algorithm-1 train step and the
``"speedyfeed"`` trainer; the conventional workflow's batch
(``CONV_BATCH``, cut to one card as ``CONV_ONE_CARD``), its train step
and the ``"speedyfeed_conventional"`` trainer, the baseline of the
paper's speedup ladder. ``archs()`` gives the registry's ``speedyfeed``
arch (``configs.get_arch``): the JAX package's three cells, their
``abstract_args`` and its reduced smoke.

UniLMv2-base-scale PLM (12L x 768 x 12H), K=3 segments of 32 tokens,
user history L=100, news universe 1.2M (Table 2), cache gamma=20 /
beta=2e-3 (§A.3).

On a mesh every cell is pure data parallelism over every axis, as the
JAX cells lay it out: ``train_prod`` through ``make_sf_train_step(cfg,
mesh)`` (the cache by rows, the history side over every axis, the merged
set whole); ``train_conventional`` through ``make_conventional_step(cfg,
mesh)`` (the instance batch over every axis, the gradients summed in one
all-reduce a dtype); ``encode_bulk`` each rank's block of the news, no
collective. The JAX cell shards ``train_prod``'s Adam moments ZeRO-1
over ``data`` (``_zero1_spec``); the port keeps them whole on every rank
(``ZERO1_DEPARTURE``), and cuts the cache over every axis where the JAX
cell cuts it over the data axes.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import core, optim, training
from repro_torch.device import check_device
from repro_torch.distributed import sharding as shx
from repro_torch.distributed.collectives import all_reduce, reduce_from
from repro_torch.optim.adam import leaves, unflatten

from .base import (BF16, I32, Arch, Cell, abstract_opt, abstract_params,
                   assert_finite, meta, shard_abstract)

# paper §A.3: lr 8e-6 for the PLM, 1e-4 for everything else
SF_OPT = optim.AdamConfig(lr=1e-4, grad_clip=1.0,
                          group_lr_scales=(("plm", 0.08),))

PROD = core.make_config(
    vocab=30720,   # UniLM's 30 522 padded to /512
    n_layers=12, d_model=768, n_heads=12, d_ff=3072,
    n_segments=3, seg_len=32, news_dim=768,
    n_news=1_204_224,   # Table 2's 1 202 576 row-padded to /4096
    gamma=20, beta=2e-3, encode_budget=4096,
    batch_users=1024, hist_len=100, merged_cap=8192, n_neg=4, remat=True)

CONV_BATCH = dict(users=512, hist=100, cands=2)  # conventional baseline
# CONV_BATCH cut to one 80 GB card: 512 users encode 52,224 news a step,
# whose remat layer inputs alone are ~185 GB at PROD; 64 users (6,528
# news) ran out of memory on an H100 with 61 GB allocated, 11 GB more
# reserved and 7.2 GB asked for, so 32 users encode 3,264
CONV_ONE_CARD = dict(users=32, hist=100, cands=2)


def _sum_over_ranks(grads, p_leaves, mesh):
    """The gradients summed over the mesh's ranks in one all-reduce of a
    flat f32 buffer; each returned gradient is a view of it."""
    flat = torch.cat([(g if g is not None else torch.zeros_like(p))
                      .reshape(-1).float() for g, p in zip(grads, p_leaves)])
    all_reduce(flat, mesh)
    return [v.view_as(p).to(p.dtype) for v, p in
            zip(flat.split([p.numel() for p in p_leaves]), p_leaves)]


def make_sf_train_step(cfg: core.SpeedyFeedConfig, mesh=None):
    """``step_fn(params, opt, cache, step, rng, batch, *, u=None,
    neg_idx=None) -> (params, opt, cache, metrics)``:
    ``speedyfeed_forward``, its backward, then ``adam_update`` with
    ``SF_OPT``; parameters, moments and cache are updated in place.

    The non-finite guard: when the loss is not finite the update and the
    cache refresh are held on the device (``commit``), so parameters, all
    of the Adam state and the cache keep their old values;
    ``nonfinite_step`` reports it. ``u``/``neg_idx`` inject the step's
    random draws (tests feed the JAX package's).

    ``mesh`` (a data mesh): the forward's mesh path, then the gradients
    summed over the ranks before ``adam_update``, so parameters and
    moments stay replicated; the cache is this rank's row block. Every
    rank passes the whole batch and the same draws.
    """
    def step_fn(params, opt_state, cache, step, rng, batch, *, u=None,
                neg_idx=None):
        p_leaves = [p.requires_grad_() for _, p in leaves(params)]
        out = core.speedyfeed_forward(params, cfg, batch, cache, step, rng,
                                      u=u, neg_idx=neg_idx, mesh=mesh)
        grads = torch.autograd.grad(out.loss, p_leaves, allow_unused=True)
        if mesh is not None and mesh.world > 1:
            grads = _sum_over_ranks(grads, p_leaves, mesh)
        ok = torch.isfinite(out.metrics["loss"])
        params, opt_state, om = optim.adam_update(
            params, unflatten(params, grads), opt_state, SF_OPT, commit=ok)
        metrics = dict(out.metrics)
        metrics.update(om)
        metrics["nonfinite_step"] = 1.0 - ok.float()
        return params, opt_state, out.cache, metrics

    return step_fn


def _sf_init_state(cfg, gen: torch.Generator) -> training.TrainState:
    params, cache = core.speedyfeed_state(cfg, gen)
    return training.make_state(params, optim.adam_init(params), cache,
                               rng=gen)


@training.register_trainer("speedyfeed")
def make_sf_trainer(cfg=None, *, mesh=None, **kw) -> training.Trainer:
    """The Algorithm-1 Trainer (PROD unless ``cfg`` is given); ``kw`` goes
    to ``Trainer`` (e.g. ``device``). With ``mesh`` (a rank of
    ``launch.mesh.run_on_mesh``) it trains data-parallel: the step places
    the batch's user side by ``speedyfeed_batch_specs`` and the state by
    ``training.state_specs``."""
    return training.Trainer(cfg if cfg is not None else PROD,
                            make_step=make_sf_train_step,
                            init_fn=_sf_init_state, mesh=mesh, **kw)


ZERO1_DEPARTURE = (
    "Adam's moments whole on every rank: the JAX cell shards them ZeRO-1 "
    "over data (_zero1_spec); not ported")


def every_axis_block(t, mesh):
    """This rank's block of ``t`` along dim 0 over every mesh axis (pure
    data parallelism); raises where the ranks do not divide it."""
    return shx.shard_block(t, shx.Spec(tuple(mesh.axis_names)), mesh)


def conventional_loss(cfg: core.SpeedyFeedConfig, mesh=None):
    """``loss_fn(params, batch) -> (loss, {"click_acc"})``, the
    conventional workflow's loss as its step differentiates it. With
    ``mesh`` (the JAX cell's layout: pure data parallelism over every
    axis) the batch is whole and each rank encodes its block of the
    instances (``every_axis_block``); the loss is the mean of the ranks'
    means (the blocks are equal), the same on every rank, and each rank's
    gradient is its own share's (``reduce_from``), to be summed over
    every axis; the accuracy is averaged."""
    if mesh is None or mesh.world == 1:
        return lambda params, batch: core.conventional_forward(
            params, cfg, batch)
    R = mesh.world

    def mesh_loss(params, batch):
        block = {k: every_axis_block(v, mesh) for k, v in batch.items()}
        loss, m = core.conventional_forward(params, cfg, block)
        acc = all_reduce(m["click_acc"].detach().reshape(1).clone(), mesh)
        return reduce_from(loss / R, mesh, None), {"click_acc": acc[0] / R}

    return mesh_loss


def make_conventional_step(cfg: core.SpeedyFeedConfig, mesh=None):
    """``step(params, opt, batch) -> (params, opt, metrics)``:
    ``conventional_loss`` through ``optim.make_train_step`` with
    ``SF_OPT`` (metrics: ``loss``, ``grad_norm``, ``lr``, ``click_acc``).
    With ``mesh``: the parameters and Adam state whole on every rank, the
    batch whole, the gradients summed over every axis in one all-reduce
    a dtype (``optim.make_train_step(grad_axes=)``), as ``_sum_over_ranks``
    sums Algorithm 1's."""
    if mesh is None or mesh.world == 1:
        return optim.make_train_step(conventional_loss(cfg), SF_OPT)
    every, whole = tuple(mesh.axis_names), shx.Spec()
    return optim.make_train_step(
        conventional_loss(cfg, mesh), SF_OPT, mesh=mesh,
        specs=lambda p: {path: whole for path, _ in leaves(p)},
        grad_axes=lambda p: {path: every for path, _ in leaves(p)})


def _make_conventional_state_step(cfg, mesh=None):
    """The conventional step under the TrainState step contract: the cache
    travels untouched (the baseline re-encodes everything)."""
    raw = make_conventional_step(cfg, mesh)

    def step_fn(params, opt_state, cache, step, rng, batch):
        params, opt_state, metrics = raw(params, opt_state, batch)
        return params, opt_state, cache, metrics

    return step_fn


@training.register_trainer("speedyfeed_conventional")
def make_conventional_trainer(cfg=None, **kw) -> training.Trainer:
    """The conventional-workflow Trainer (PROD unless ``cfg`` is given;
    the state of ``make_sf_trainer``); ``kw`` goes to ``Trainer``. Its
    ``step`` takes ``data.build_conventional_batch``'s tensors."""
    return training.Trainer(cfg if cfg is not None else PROD,
                            make_step=_make_conventional_state_step,
                            init_fn=_sf_init_state, **kw)


# ---------------------------------------------------------------------------
# the registry's arch (configs.get_arch)
# ---------------------------------------------------------------------------

ENCODE_BULK_NEWS = 65536      # encode_bulk's batch of news


def _abstract_args(cfg: core.SpeedyFeedConfig, shape: str, mesh=None,
                   whole_batch: bool = False):
    """The cell's arguments on meta at ``cfg``, as the JAX cells give them:
    bf16 parameters (the JAX dry-run's ``param_dtype``); to train, their
    f32 Adam state, the cold cache, step 0, a seeded generator (the
    step's draws: a CPU generator draws for meta tensors too) and the
    batch: Algorithm 1's centralized one (merged_cap news, batch_users x
    hist_len) or the conventional workflow's at ``CONV_BATCH``;
    ``encode_bulk``: ENCODE_BULK_NEWS news' tokens and frequencies.

    With ``mesh``: one rank's blocks (``shard_abstract``), pure data
    parallelism: the parameters and moments whole (``ZERO1_DEPARTURE``),
    the cache's rows over every axis (``core.cache_shard``), and, unless
    ``whole_batch`` (the batch as the mesh step takes it), the history
    side (``speedyfeed_batch_specs``; the merged set whole), the
    conventional instances and the encode set over every axis."""
    params = abstract_params(lambda g: core.init_speedyfeed(g, cfg),
                             dtype=BF16)
    K, S = cfg.plm.n_segments, cfg.plm.seg_len
    cut = None           # dim 0 over every axis, where the batch is cut
    if mesh is not None and not whole_batch:
        cut = shx.Spec(tuple(mesh.axis_names))
    if shape == "encode_bulk":
        t = meta((ENCODE_BULK_NEWS, K, S), I32)
        if cut is not None:
            t = shard_abstract(t, cut, mesh)
        return (params, t, meta(t.shape, I32))
    if shape == "train_prod":
        M, B, L = cfg.merged_cap, cfg.batch_users, cfg.hist_len
        batch = {"news_tokens": meta((M, K, S), I32),
                 "news_freq": meta((M, K, S), I32),
                 "news_ids": meta((M,), I32),
                 "hist_inv": meta((B, L), I32),
                 "hist_mask": meta((B, L), torch.bool)}
    else:
        B, L, C = CONV_BATCH["users"], CONV_BATCH["hist"], CONV_BATCH["cands"]
        batch = {"hist_tokens": meta((B, L, K, S), I32),
                 "hist_freq": meta((B, L, K, S), I32),
                 "hist_mask": meta((B, L), torch.bool),
                 "cand_tokens": meta((B, C, K, S), I32),
                 "cand_freq": meta((B, C, K, S), I32),
                 "label": meta((B,), I32),
                 "cand_mask": meta((B, C), torch.bool)}
    cache = core.init_cache(cfg.cache, device="meta")
    if mesh is not None:
        rows = shx.Spec(tuple(mesh.axis_names))
        cache = shard_abstract(cache, type(cache)(rows, rows), mesh)
    if cut is not None:
        specs = (shx.speedyfeed_batch_specs(mesh, batch)
                 if shape == "train_prod" else {k: cut for k in batch})
        batch = shard_abstract(batch, specs, mesh)
    return (params, abstract_opt(params), cache, 0,
            torch.Generator().manual_seed(0), batch)


def _arch() -> Arch:
    """The JAX package's three cells at PROD: ``train_prod`` (the
    Algorithm-1 step), ``train_conventional`` (the baseline's step, under
    the TrainState contract) and ``encode_bulk`` (BusLM over 65,536
    news). ``meta``: the JAX cells' ``model_flops``; ``abstract_args``;
    no ``concrete_args``: the port's loader builds bucketed batches, not
    the cells' fixed shapes."""
    cfg = PROD
    n_conv = CONV_BATCH["users"] * (CONV_BATCH["hist"] + CONV_BATCH["cands"])
    enc = torch.no_grad()(
        lambda p, t, f: core.buslm_encode(p["plm"], cfg.plm, t, f))
    def enc_on(mesh):
        if mesh is None or mesh.world == 1:
            return enc
        return torch.no_grad()(lambda p, t, f: enc(
            p, every_axis_block(t, mesh), every_axis_block(f, mesh)))

    cells = {
        "train_prod": Cell(
            arch="speedyfeed", shape="train_prod", kind="train",
            make_fn=lambda device="cuda", mesh=None: make_sf_train_step(
                cfg, mesh),
            meta={"model_flops": 3 * core.plm_flops(
                cfg.plm, cfg.cache.encode_budget)},
            mesh_departure=ZERO1_DEPARTURE,
            abstract_args=functools.partial(_abstract_args, cfg,
                                            "train_prod")),
        "train_conventional": Cell(
            arch="speedyfeed", shape="train_conventional", kind="train",
            make_fn=lambda device="cuda", mesh=None:
            _make_conventional_state_step(cfg, mesh),
            meta={"model_flops": 3 * core.plm_flops(cfg.plm, n_conv)},
            abstract_args=functools.partial(_abstract_args, cfg,
                                            "train_conventional")),
        "encode_bulk": Cell(
            arch="speedyfeed", shape="encode_bulk", kind="serve",
            make_fn=lambda device="cuda", mesh=None: enc_on(mesh),
            meta={"model_flops": core.plm_flops(cfg.plm,
                                                ENCODE_BULK_NEWS)},
            abstract_args=functools.partial(_abstract_args, cfg,
                                            "encode_bulk")),
    }
    return Arch(name="speedyfeed", family="news", config=cfg, cells=cells,
                smoke=_smoke, notes="the paper's own architecture")


def _smoke(device="cuda"):
    """The JAX package's reduced smoke on ``device``, with torch draws: a
    2-layer PLM (d 32, 4 heads of 8, K=3 x S=8), three Algorithm-1 steps
    on one batch of 48 merged news and 4 users of 12 clicks."""
    device = check_device(device)
    cfg = core.make_config(vocab=500, n_layers=2, d_model=32, n_heads=4,
                           d_ff=64, n_segments=3, seg_len=8, news_dim=16,
                           n_news=300, encode_budget=16, batch_users=4,
                           hist_len=12, merged_cap=48, n_neg=3)
    gen = torch.Generator(device=device).manual_seed(0)
    params, cache = core.speedyfeed_state(cfg, gen)
    opt = optim.adam_init(params)
    step = make_sf_train_step(cfg)
    M, K, S = cfg.merged_cap, 3, 8

    def ids(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    batch = {"news_tokens": ids((M, K, S), 1, 500),
             "news_freq": ids((M, K, S), 0, 8),
             "news_ids": torch.arange(M, dtype=torch.int32, device=device),
             "hist_inv": ids((4, 12), 1, M),
             "hist_mask": torch.ones((4, 12), dtype=torch.bool,
                                     device=device)}
    losses = []
    for i in range(3):
        params, opt, cache, metrics = step(params, opt, cache, i, gen, batch)
        losses.append(float(metrics["loss"]))
    assert_finite(losses, "speedyfeed losses")
    return {"losses": losses, "reused_final": float(metrics["reused"])}


def archs():
    return [_arch()]
