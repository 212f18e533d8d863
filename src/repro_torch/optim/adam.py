"""Adam(W) with parameter-group learning rates and global-norm clipping.

Paper training recipe (§A.3): Adam, lr 8e-6 for the PLM group and 1e-4
for the rest, expressed as path-prefix learning-rate groups. Paths join
the tree's keys and list indices with "/", e.g. ``plm/layers/0/attn/q/w``.

JAX's arrays are immutable; here the update runs in place, to bound its
memory (a 14B-parameter LM has leaves of 778M elements, 3.1 GB in f32):
gradients are scaled in place by the clip, and the parameters and both
moments are updated in place, one row chunk of at most ``CHUNK``
elements at a time, so that at most two f32 temporaries of a chunk are
live. Every leaf is updated, as in the JAX package: a leaf whose gradient
is ``None`` counts as a zero gradient, so its moments still decay and it
still moves.

``make_train_step`` builds a step over any loss (the JAX package's
generic factory), with gradient accumulation over microbatches. The int8
compressed reduction across data-parallel replicas waits for multi-GPU:
``adam_update`` raises if a configuration asks for it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

# elements per row chunk of the in-place update (2^26: 268 MB in f32)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0                  # 0 disables
    # path-prefix -> lr multiplier (e.g. ("plm", 8e-6/1e-4))
    group_lr_scales: tuple = ()             # tuple of (prefix, scale)
    accum_steps: int = 1                    # microbatches per step
    dp_compression: Optional[str] = None    # only None is ported


def leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def unflatten(like, values):
    """A tree shaped like ``like`` holding ``values`` in ``leaves`` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)
    return build(like)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def adam_init(params):
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    first = next(leaves(params))[1]
    return {"m": zeros, "v": tree_map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def _lr_scale(path: str, cfg: AdamConfig) -> float:
    for prefix, scale in cfg.group_lr_scales:
        if path.startswith(prefix):
            return float(scale)
    return 1.0


def _row_chunks(t: torch.Tensor):
    """Views of ``t`` along its first axis of at most ``CHUNK`` elements
    each (one view of a 0-d or small tensor)."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        yield t
        return
    rows = max(1, CHUNK // max(t[0].numel(), 1))
    yield from t.split(rows)


def clip_by_global_norm(grads: list, max_norm: float):
    """Scale ``grads`` (a list of tensors) in place by min(1, max_norm /
    max(norm, 1e-9)), the scale cast to each gradient's dtype, as the JAX
    package does; returns the global norm (f32). The sum of squares runs
    by row chunks, so no f32 copy of a whole leaf is made. A tensor that
    appears twice in the list (autograd may hand one to two leaves) is
    scaled once."""
    gn = torch.sqrt(sum(c.float().square().sum() for g in grads
                        for c in _row_chunks(g)))
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    seen = set()
    for g in grads:
        if g.data_ptr() not in seen:
            seen.add(g.data_ptr())
            g.mul_(scale.to(g.dtype))
    return gn


def _writable(g):
    """g, or a copy of it where autograd handed a broadcast view (a zero
    stride: the gradient of a plain sum), which cannot be scaled in
    place."""
    if g is not None and any(st == 0 and n > 1
                             for st, n in zip(g.stride(), g.shape)):
        return g.contiguous()
    return g


def _put(dst, new, commit):
    """dst <- new, in place (``new`` is scratch); with ``commit`` (a bool
    0-d tensor) dst keeps its value where commit is False."""
    if commit is not None:
        torch.where(commit, new, dst, out=new)
    dst.copy_(new)


@torch.no_grad()
def adam_update(params, grads, state, cfg: AdamConfig,
                lr_schedule: Callable | None = None, *, commit=None):
    """One step. ``grads`` has the tree layout of ``params`` (a leaf may be
    ``None``); the clip scales them in place. Updates ``params`` and
    ``state``'s moments in place, row chunk by row chunk, and returns
    (params, new state, metrics). ``commit`` (a bool scalar tensor) holds
    the parameters, both moments and the step count at their old values
    when False: the trainer's non-finite guard, decided on the device."""
    if cfg.dp_compression is not None:
        raise NotImplementedError(
            "the compressed data-parallel reduction is not ported")
    count = state["count"] + 1
    lr_t = lr_schedule(count) if lr_schedule else cfg.lr
    p_leaves = list(leaves(params))
    g_by_path = dict(leaves(grads))
    gs = [_writable(g_by_path.get(path)) for path, _ in p_leaves]
    if cfg.grad_clip > 0:
        gnorm = clip_by_global_norm([g for g in gs if g is not None],
                                    cfg.grad_clip)
    else:
        gnorm = torch.zeros((), device=count.device)
    b1, b2 = cfg.b1, cfg.b2
    countf = count.float()
    bc1 = 1 - b1 ** countf
    bc2 = 1 - b2 ** countf
    ms, vs = dict(leaves(state["m"])), dict(leaves(state["v"]))
    for (path, p), g in zip(p_leaves, gs):
        if g is None:                 # a zero gradient, with no storage
            g = p.new_zeros(()).expand_as(p)
        lr = lr_t * _lr_scale(path, cfg)
        for pc, gc, mc, vc in zip(*map(_row_chunks, (p, g, ms[path],
                                                     vs[path]))):
            # the JAX package's arithmetic, in f32, on two temporaries
            t1 = torch.mul(mc, b1).add_(gc, alpha=1 - b1)          # m'
            t2 = torch.mul(vc, b2).addcmul_(gc, gc, value=1 - b2)  # v'
            _put(mc, t1, commit)
            _put(vc, t2, commit)
            # from the committed moments (p is held where commit is False)
            torch.div(vc, bc2, out=t2).sqrt_().add_(cfg.eps)
            torch.div(mc, bc1, out=t1).div_(t2)
            if cfg.weight_decay:
                t1.add_(pc, alpha=cfg.weight_decay)
            t1.mul_(lr).neg_().add_(pc)                    # p - lr * step
            _put(pc, t1, commit)
    if commit is not None:
        count = torch.where(commit, count, state["count"])
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr_t}


def make_train_step(loss_fn, cfg: AdamConfig, lr_schedule=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss's gradients, then ``adam_update``; parameters and moments
    are updated in place. ``loss_fn(params, batch)`` returns a loss or
    (loss, metrics). metrics: ``loss``, ``grad_norm``, ``lr`` and the
    loss's own.

    With ``accum_steps > 1`` the batch's leading axis is split into that
    many microbatches; their gradients are summed in f32 and divided by
    ``accum_steps``, the loss is their mean, and the loss's own metrics
    are the last microbatch's (the JAX package's ``lax.scan``)."""
    n = cfg.accum_steps

    def grads_of(params, flat, batch):
        with torch.enable_grad():
            out = loss_fn(params, batch)
            loss, metrics = out if isinstance(out, tuple) else (out, {})
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), metrics, grads

    def step(params, opt_state, batch):
        flat = [p.requires_grad_() for _, p in leaves(params)]
        if n > 1:
            B = len(next(iter(batch.values())))
            if B % n:
                raise ValueError(f"batch of {B} does not split into "
                                 f"{n} microbatches")
            mbs = [{k: v[i * (B // n):(i + 1) * (B // n)]
                    for k, v in batch.items()} for i in range(n)]
            acc = [None] * len(flat)
            loss = 0.0
            for mb in mbs:
                l_mb, metrics, grads = grads_of(params, flat, mb)
                loss = loss + l_mb
                for i, g in enumerate(grads):
                    if g is None:
                        continue
                    if acc[i] is None:
                        acc[i] = g.float() if g.dtype != torch.float32 \
                            else g.clone()
                    else:
                        acc[i].add_(g)
                del grads
            grads = [None if a is None else a.div_(n) for a in acc]
            loss = loss / n
        else:
            loss, metrics, grads = grads_of(params, flat, batch)
        params, opt_state, om = adam_update(
            params, unflatten(params, grads), opt_state, cfg, lr_schedule)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step
