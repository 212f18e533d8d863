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
generic factory), with gradient accumulation over microbatches.

On a mesh (``launch/mesh.py``) ``make_train_step(..., mesh=, specs=)``
takes each leaf's placement (``specs(params)``: {path: Spec}): it sums
over the data axes (``pod`` and ``data``, those present) the gradients
of the leaves those axes do not cut (one all-reduce of their
concatenation; the loss gives each rank its own part's gradient, and an
FSDP leaf's arrives summed by its gather's reduce-scatter), or over the
axes ``grad_axes(params)`` names for each leaf where the model says
where its gradients are partial (DimeNet's edges over every axis), clips
by the global norm over every block of the mesh
(each block counted on one rank only, ``replica_mask``: a norm taken on
each rank alone would clip each rank by another factor, and the replicas
of a leaf would part), and Adam updates each rank's blocks in place.

``compressed_all_reduce`` is the JAX package's ``compressed_psum`` on a
data mesh: int8 gradients with error feedback, one int32 sum and one max
of the scales across the ranks. As in JAX, no trainer calls it;
``adam_update`` raises where a configuration asks for ``dp_compression``
(the JAX update ignores the field).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.distributed.collectives import all_reduce
from repro_torch.distributed.sharding import DATA_AXES, Blocks

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
    """A tree shaped like ``like`` holding ``values`` in ``leaves`` order.
    (A module-level helper, not a recursive closure: such a closure is a
    reference cycle, and would keep ``values``, a step's gradients, alive
    until Python's cycle collector ran.)"""
    return _build(like, iter(values))


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return [_build(v, it) for v in node]
    return next(it)


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


def _axes_of(spec) -> set:
    out = set()
    for entry in spec:
        if isinstance(entry, Blocks):
            out.add(entry.axis)
        elif entry is not None:
            out.update((entry,) if isinstance(entry, str) else entry)
    return out


def replica_mask(specs: list, mesh) -> list:
    """Per leaf, whether this rank counts its block in a global norm: the
    first rank along every mesh axis the leaf's spec does not cut (where
    the block is repeated), and the owner of a block that ranks of a
    ``Blocks`` cut share (an LM KV head replicated over the model ranks
    of its group), so each block counts once."""
    return [all(mesh.index(a) == 0 for a in mesh.axis_names
                if a not in _axes_of(s))
            and all(e.owner(mesh.index(e.axis)) for e in s
                    if isinstance(e, Blocks)) for s in specs]


def data_grad_axes(spec, mesh) -> tuple:
    """The axes a leaf's gradient is summed over by default: the data
    axes present (``pod``, ``data``) that its ``spec`` does not cut."""
    cut = _axes_of(spec)
    return tuple(a for a in DATA_AXES if a in mesh.axis_names
                 and a not in cut)


def sync_grads(grads: list, params: list, specs: list, mesh,
               axes: list | None = None) -> list:
    """Each leaf's gradient summed over its axes (``axes``, one tuple a
    leaf; by default ``data_grad_axes`` of its spec), in one all-reduce
    of the concatenation of the leaves that share their axes and dtype (a
    missing gradient counts as zeros); a leaf with no axis of size above
    1 as it is."""
    if axes is None:
        axes = [data_grad_axes(s, mesh) for s in specs]
    grads = list(grads)
    todo = [i for i, a in enumerate(axes) if mesh.size(tuple(a)) > 1]
    for i in todo:
        if grads[i] is None:
            grads[i] = torch.zeros_like(params[i])
    groups = {}
    for i in todo:
        groups.setdefault((tuple(axes[i]), grads[i].dtype), []).append(i)
    for (ax, _), idx in sorted(groups.items(), key=str):
        flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                          mesh, axis=ax)
        at = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[at:at + n].view(grads[i].shape)
            at += n
    return grads


def clip_by_global_norm(grads: list, max_norm: float, *, mesh=None,
                        counted: list | None = None):
    """Scale ``grads`` (a list of tensors) in place by min(1, max_norm /
    max(norm, 1e-9)), the scale cast to each gradient's dtype, as the JAX
    package does; returns the global norm (f32). The sum of squares runs
    by row chunks, so no f32 copy of a whole leaf is made. A tensor that
    appears twice in the list (autograd may hand one to two leaves) is
    scaled once. With ``mesh``, ``grads`` are this rank's blocks and the
    squares of those ``counted`` marks (``replica_mask``) are summed over
    the whole mesh: the norm of the whole gradient, the same on every
    rank."""
    if counted is None:
        counted = [True] * len(grads)
    gn = sum(c.float().square().sum() for g, n in zip(grads, counted)
             if n for c in _row_chunks(g))
    if not torch.is_tensor(gn):
        gn = torch.zeros((), device=grads[0].device)
    if mesh is not None:
        gn = all_reduce(gn.reshape(1).clone(), mesh)[0]
    gn = torch.sqrt(gn)
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
                lr_schedule: Callable | None = None, *, commit=None,
                mesh=None, specs: dict | None = None):
    """One step. ``grads`` has the tree layout of ``params`` (a leaf may be
    ``None``); the clip scales them in place. Updates ``params`` and
    ``state``'s moments in place, row chunk by row chunk, and returns
    (params, new state, metrics). ``commit`` (a bool scalar tensor) holds
    the parameters, both moments and the step count at their old values
    when False: the trainer's non-finite guard, decided on the device.
    With ``mesh`` and ``specs`` ({path: Spec}), ``params`` are this
    rank's blocks and the clip takes the global norm over the mesh."""
    if cfg.dp_compression is not None:
        raise NotImplementedError(
            "adam_update does not apply dp_compression: reduce the "
            "gradients with compressed_all_reduce before it")
    count = state["count"] + 1
    lr_t = lr_schedule(count) if lr_schedule else cfg.lr
    p_leaves = list(leaves(params))
    g_by_path = dict(leaves(grads))
    gs = [_writable(g_by_path.get(path)) for path, _ in p_leaves]
    if cfg.grad_clip > 0:
        counted = (replica_mask([specs[path] for path, _ in p_leaves], mesh)
                   if mesh is not None else [True] * len(gs))
        gnorm = clip_by_global_norm(
            [g for g in gs if g is not None], cfg.grad_clip, mesh=mesh,
            counted=[n for g, n in zip(gs, counted) if g is not None])
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


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback (the cross-pod reduction)
# ---------------------------------------------------------------------------

def quantize_int8(x):
    """(q int8, scale f32 scalar): x ~ q * scale, |q| <= 127."""
    scale = x.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_all_reduce(grads, mesh, residual):
    """The mean of ``grads`` over ``mesh``'s ranks through int8, with
    error feedback: each rank quantises ``g + residual`` at its own scale
    and keeps what the int8 codes lost as its next residual; the codes
    are summed as int32 and rescaled by the largest rank's scale (a
    conservative shared scale), over n. ``grads`` and ``residual`` are
    trees of the same layout (``residual`` f32, zeros to start). One
    int32 sum and one max of the scales for the whole tree. Returns
    (reduced grads, new residual), the counterpart of ``compressed_psum``.
    """
    flat = [g for _, g in leaves(grads)]
    res = [r for _, r in leaves(residual)]
    gf = [g.to(torch.float32) + r for g, r in zip(flat, res)]
    qs, scales = zip(*(quantize_int8(x) for x in gf))
    err = [x - dequantize_int8(q, s) for x, q, s in zip(gf, qs, scales)]
    summed = all_reduce(torch.cat([q.reshape(-1).to(torch.int32)
                                   for q in qs]), mesh)
    shared = all_reduce(torch.stack(scales), mesh, op="max")
    out, at = [], 0
    for g, s in zip(flat, shared):
        q = summed[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
        out.append((q.to(torch.float32) * s / mesh.world).to(g.dtype))
    return unflatten(grads, out), unflatten(residual, err)


def make_train_step(loss_fn, cfg: AdamConfig, lr_schedule=None, *,
                    mesh=None, specs: Callable | None = None,
                    grad_axes: Callable | None = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss's gradients, then ``adam_update``; parameters and moments
    are updated in place. ``loss_fn(params, batch)`` returns a loss or
    (loss, metrics). metrics: ``loss``, ``grad_norm``, ``lr`` and the
    loss's own.

    With ``accum_steps > 1`` the batch's leading axis is split into that
    many microbatches; their gradients are summed in f32 and divided by
    ``accum_steps``, the loss is their mean, and the loss's own metrics
    are the last microbatch's (the JAX package's ``lax.scan``).

    With ``mesh``, ``params`` are this rank's blocks, ``specs(params)``
    gives {path: Spec}, and the step is the mesh's (module docstring):
    ``sync_grads`` (over ``grad_axes(params)``' {path: axes} where given,
    else the data axes), then the global-norm clip and Adam on the
    blocks."""
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
        spec_of = None
        if mesh is not None:
            spec_of = specs(params)
            paths = [path for path, _ in leaves(params)]
            axes = None
            if grad_axes is not None:
                axes_of = grad_axes(params)
                axes = [axes_of[path] for path in paths]
            grads = sync_grads(grads, flat, [spec_of[p] for p in paths],
                               mesh, axes)
        params, opt_state, om = adam_update(
            params, unflatten(params, grads), opt_state, cfg, lr_schedule,
            mesh=mesh, specs=spec_of)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step
