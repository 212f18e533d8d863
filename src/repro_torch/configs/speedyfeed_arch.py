"""SpeedyFeed's production configuration (the JAX package's
``configs/speedyfeed_arch.py:PROD``), its Algorithm-1 train step and the
``"speedyfeed"`` trainer; the conventional workflow's batch
(``CONV_BATCH``, cut to one card as ``CONV_ONE_CARD``), its train step
and the ``"speedyfeed_conventional"`` trainer, the baseline of the
paper's speedup ladder. ``archs()`` gives the registry's ``speedyfeed``
arch (``configs.get_arch``): the JAX package's three cells and its
reduced smoke.

UniLMv2-base-scale PLM (12L x 768 x 12H), K=3 segments of 32 tokens,
user history L=100, news universe 1.2M (Table 2), cache gamma=20 /
beta=2e-3 (§A.3).
"""
from __future__ import annotations

import torch

from repro_torch import core, optim, training
from repro_torch.device import check_device
from repro_torch.optim.adam import leaves, unflatten

from .base import Arch, Cell, assert_finite

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


def make_sf_train_step(cfg: core.SpeedyFeedConfig):
    """``step_fn(params, opt, cache, step, rng, batch, *, u=None,
    neg_idx=None) -> (params, opt, cache, metrics)``:
    ``speedyfeed_forward``, its backward, then ``adam_update`` with
    ``SF_OPT``; parameters, moments and cache are updated in place.

    The non-finite guard: when the loss is not finite the update and the
    cache refresh are held on the device (``commit``), so parameters, all
    of the Adam state and the cache keep their old values;
    ``nonfinite_step`` reports it. ``u``/``neg_idx`` inject the step's
    random draws (tests feed the JAX package's).
    """
    def step_fn(params, opt_state, cache, step, rng, batch, *, u=None,
                neg_idx=None):
        p_leaves = [p.requires_grad_() for _, p in leaves(params)]
        out = core.speedyfeed_forward(params, cfg, batch, cache, step, rng,
                                      u=u, neg_idx=neg_idx)
        grads = torch.autograd.grad(out.loss, p_leaves, allow_unused=True)
        ok = torch.isfinite(out.loss)
        params, opt_state, om = optim.adam_update(
            params, unflatten(params, grads), opt_state, SF_OPT, commit=ok)
        metrics = dict(out.metrics)
        metrics.update(om)
        metrics["loss"] = out.loss.detach()
        metrics["nonfinite_step"] = 1.0 - ok.float()
        return params, opt_state, out.cache, metrics

    return step_fn


def _sf_init_state(cfg, gen: torch.Generator) -> training.TrainState:
    params, cache = core.speedyfeed_state(cfg, gen)
    return training.make_state(params, optim.adam_init(params), cache,
                               rng=gen)


@training.register_trainer("speedyfeed")
def make_sf_trainer(cfg=None, **kw) -> training.Trainer:
    """The Algorithm-1 Trainer (PROD unless ``cfg`` is given); ``kw`` goes
    to ``Trainer`` (e.g. ``device``)."""
    return training.Trainer(cfg if cfg is not None else PROD,
                            make_step=make_sf_train_step,
                            init_fn=_sf_init_state, **kw)


def make_conventional_step(cfg: core.SpeedyFeedConfig):
    """``step(params, opt, batch) -> (params, opt, metrics)``:
    ``conventional_forward``'s loss through ``optim.make_train_step`` with
    ``SF_OPT`` (metrics: ``loss``, ``grad_norm``, ``lr``, ``click_acc``)."""
    def loss_fn(params, batch):
        return core.conventional_forward(params, cfg, batch)

    return optim.make_train_step(loss_fn, SF_OPT)


def _make_conventional_state_step(cfg):
    """The conventional step under the TrainState step contract: the cache
    travels untouched (the baseline re-encodes everything)."""
    raw = make_conventional_step(cfg)

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


def _arch() -> Arch:
    """The JAX package's three cells at PROD: ``train_prod`` (the
    Algorithm-1 step), ``train_conventional`` (the baseline's step, under
    the TrainState contract) and ``encode_bulk`` (BusLM over 65,536
    news). ``meta``: the JAX cells' ``model_flops``."""
    cfg = PROD
    n_conv = CONV_BATCH["users"] * (CONV_BATCH["hist"] + CONV_BATCH["cands"])
    enc = torch.no_grad()(
        lambda p, t, f: core.buslm_encode(p["plm"], cfg.plm, t, f))
    cells = {
        "train_prod": Cell(
            arch="speedyfeed", shape="train_prod", kind="train",
            make_fn=lambda: make_sf_train_step(cfg),
            meta={"model_flops": 3 * core.plm_flops(
                cfg.plm, cfg.cache.encode_budget)}),
        "train_conventional": Cell(
            arch="speedyfeed", shape="train_conventional", kind="train",
            make_fn=lambda: _make_conventional_state_step(cfg),
            meta={"model_flops": 3 * core.plm_flops(cfg.plm, n_conv)}),
        "encode_bulk": Cell(
            arch="speedyfeed", shape="encode_bulk", kind="serve",
            make_fn=lambda: enc,
            meta={"model_flops": core.plm_flops(cfg.plm,
                                                ENCODE_BULK_NEWS)}),
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
