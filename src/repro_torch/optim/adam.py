"""Adam(W) with parameter-group learning rates and global-norm clipping.

Paper training recipe (§A.3): Adam, lr 8e-6 for the PLM group and 1e-4
for the rest, expressed as path-prefix learning-rate groups. Paths join
the tree's keys and list indices with "/", e.g. ``plm/layers/0/attn/q/w``.

The update runs in place on the parameters and the moments (under
``torch.no_grad``). Every leaf is updated, as in the JAX package: a leaf
whose gradient is ``None`` counts as a zero gradient, so its moments
still decay and it still moves. Gradient accumulation and int8 gradient
compression are not ported: ``adam_update`` raises if a configuration
asks for them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


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
    accum_steps: int = 1                    # only 1 is ported
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


def clip_by_global_norm(grads: list, max_norm: float):
    """grads: list of tensors -> (clipped list, global norm), with
    scale = min(1, max_norm / max(norm, 1e-9)) in f32."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], gn


@torch.no_grad()
def adam_update(params, grads, state, cfg: AdamConfig,
                lr_schedule: Callable | None = None, *, commit=None):
    """One step. ``grads`` has the tree layout of ``params`` (a leaf may be
    ``None``). Updates ``params`` and ``state``'s moments in place and
    returns (params, new state, metrics). ``commit`` (a bool scalar
    tensor) holds the parameters, both moments and the step count at their
    old values when False: the trainer's non-finite guard, decided on the
    device."""
    if cfg.accum_steps != 1 or cfg.dp_compression is not None:
        raise NotImplementedError(
            "gradient accumulation and compressed reduction are not ported")
    count = state["count"] + 1
    lr_t = lr_schedule(count) if lr_schedule else cfg.lr
    p_leaves = list(leaves(params))
    g_by_path = dict(leaves(grads))
    gs = [g_by_path.get(path) for path, _ in p_leaves]
    gs = [torch.zeros_like(p) if g is None else g
          for g, (_, p) in zip(gs, p_leaves)]
    if cfg.grad_clip > 0:
        gs, gnorm = clip_by_global_norm(gs, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), device=count.device)
    b1, b2 = cfg.b1, cfg.b2
    countf = count.float()
    bc1 = 1 - b1 ** countf
    bc2 = 1 - b2 ** countf
    ms, vs = dict(leaves(state["m"])), dict(leaves(state["v"]))
    for (path, p), g in zip(p_leaves, gs):
        m, v = ms[path], vs[path]
        gf = g.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf.square()
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.float()
        p_new = (p.float() - lr_t * _lr_scale(path, cfg) * step).to(p.dtype)
        if commit is not None:
            p_new = torch.where(commit, p_new, p)
            m_new = torch.where(commit, m_new, m)
            v_new = torch.where(commit, v_new, v)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
    if commit is not None:
        count = torch.where(commit, count, state["count"])
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr_t}
