"""Carry weights, training state and index state from the JAX package
into the port.

The functions take plain numpy arrays (the caller converts the JAX
arrays, e.g. ``jax.tree.map(np.asarray, tree)``), so this module needs
neither framework's arrays beyond torch.

The two packages lay out a stack of layers differently: JAX keeps one
``layers`` dict whose leaves carry a leading ``n_layers`` axis (from
``jax.vmap``, scanned by ``jax.lax.scan``), the port a list of per-layer
dicts. ``split_layers`` and ``stack_layers`` are the one conversion in
each direction; ``params_from_jax`` and the checkpoint code
(``training/state.py``, whose files are JAX's layout) both use them. A
JAX checkpoint directory is read by ``training.state.restore_state``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache import CacheState
from repro_torch.serving.snapshot import IndexSnapshot
from repro_torch.training.state import TrainState


def tensor_from_jax(leaf, device="cuda") -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) -> a tensor.

    numpy has no bfloat16 of its own: JAX's bf16 arrays come as
    ``ml_dtypes.bfloat16``, which torch cannot read. They go through
    float32, which holds every bf16 value, to ``torch.bfloat16``: exact.
    """
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.as_tensor(np.array(arr)).to(device)


def split_layers(tree):
    """JAX's layout -> the port's: every ``layers`` dict of stacked leaves
    (a leading ``n_layers`` axis) becomes a list of per-layer dicts whose
    leaves index that axis (views, not copies). Other dicts and list nodes
    keep their shape; leaves are numpy arrays or tensors."""
    def conv(node, *, stacked=False):
        if isinstance(node, dict):
            if stacked:
                return [conv(_index(node, i)) for i in range(_leading(node))]
            return {k: conv(v, stacked=(k == "layers")) for k, v in
                    node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return node

    return conv(tree)


def stack_layers(tree):
    """The port's layout -> JAX's, the inverse of ``split_layers``: every
    ``layers`` list of per-layer dicts becomes one dict whose leaves stack
    the layers' on a new leading axis (``torch.stack`` for tensors, a copy
    on their device; ``np.stack`` for arrays). Other nodes keep their
    shape, and their leaves are the tree's own."""
    def conv(node, *, stacked=False):
        if isinstance(node, dict):
            return {k: conv(v, stacked=(k == "layers")) for k, v in
                    node.items()}
        if isinstance(node, list):
            if stacked:
                return _stack(node)
            return [conv(v) for v in node]
        return node

    return conv(tree)


def _stack(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack([t.detach() for t in items])
    return np.stack([np.asarray(t) for t in items])


def _map_leaves(fn, node):
    if isinstance(node, dict):
        return {k: _map_leaves(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_leaves(fn, v) for v in node]
    return fn(node)


def params_from_jax(tree, device="cuda"):
    """A JAX parameter tree (dicts and lists of numpy leaves) -> the port's
    tree.

    Dense weights keep their ``[in, out]`` layout and every leaf its dtype
    (bf16 included). A stacked ``layers`` subtree (a leading ``n_layers``
    axis from ``jax.vmap``, as in the PLM and the LM) is split into a list
    of per-layer dicts (``split_layers``). A list node (DCN-v2's
    ``cross``, BERT4Rec's ``blocks``) stays a list, each element carried
    over in turn.
    """
    return _map_leaves(lambda leaf: tensor_from_jax(leaf, device),
                       split_layers(tree))


def lm_params_from_jax(tree, cfg, mesh, device="cuda", fsdp: bool = True):
    """A JAX LM parameter tree (numpy leaves, stacked layers) -> this
    rank's blocks on ``mesh``: ``params_from_jax``'s whole tree, placed by
    ``lm_rules(fsdp)`` (``models.lm_parallel.place_params``). Gathered
    back (``unplace_params``) the blocks are the whole tree bit for
    bit."""
    from repro_torch.models.lm_parallel import place_params
    return place_params(params_from_jax(tree, device), cfg, mesh, fsdp)


def lm_cache_from_jax(cache, device="cuda") -> dict:
    """A JAX LM KV cache (``models/lm.py:init_cache``'s dict of stacked
    [L, ...] arrays, as numpy) -> the port's cache dict: ``{k, v}`` or the
    int8 layout ``{k_q, k_s, v_q, v_s}``, each layer with its own
    storage (JAX's broadcast cache is copied out)."""
    keys = set(cache)
    if keys not in ({"k", "v"}, {"k_q", "k_s", "v_q", "v_s"}):
        raise ValueError(f"not an LM KV cache: keys {sorted(keys)}")
    return {k: tensor_from_jax(v, device) for k, v in cache.items()}


def opt_from_jax(opt, device="cuda") -> dict:
    """A JAX Adam state ``{"m", "v", "count"}`` (numpy leaves) of any
    model -> the port's: the moment trees have the params' layout, so
    they convert as ``params_from_jax`` converts the params (stacked
    ``layers`` split into lists, list nodes kept), and a bridged
    ``(params, opt)`` pair continues in ``optim.adam_update``."""
    return {"m": params_from_jax(opt["m"], device),
            "v": params_from_jax(opt["v"], device),
            "count": torch.as_tensor(np.array(opt["count"]),
                                     dtype=torch.int32).to(device)}


def _leading(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return int((node.shape if isinstance(node, torch.Tensor)
                else np.shape(node))[0])


def _index(node, i):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return (node if isinstance(node, torch.Tensor) else np.asarray(node))[i]


def state_from_jax(params, opt, cache, step: int, *, seed: int = 0,
                   device="cuda") -> TrainState:
    """A JAX training state -> the port's TrainState.

    ``params``: the parameter tree; ``opt``: the Adam state ``{"m", "v",
    "count"}``, whose moment trees have the params' layout (so their
    stacked ``layers`` split into lists too); ``cache``: ``(emb,
    written_step)``. The step draws' generator is seeded with ``seed`` on
    ``device`` (JAX's PRNG key has no torch counterpart).
    """
    device = torch.device(device)
    emb, written_step = cache
    return TrainState(
        params=params_from_jax(params, device),
        opt=opt_from_jax(opt, device),
        cache=CacheState(
            torch.as_tensor(np.array(emb)).to(device),
            torch.as_tensor(np.array(written_step),
                            dtype=torch.int32).to(device)),
        step=int(step),
        rng=torch.Generator(device=device).manual_seed(seed))


def snapshot_from_arrays(*, version: int, kind: str, dim: int, ntotal: int,
                         nprobe: int, metric: str, cent_unit, cent_raw,
                         list_ids, payload, lens, pq_centers=None,
                         pq_rot=None, device="cuda") -> IndexSnapshot:
    """A port IndexSnapshot of the IVF kinds from a JAX snapshot's arrays
    (numpy): the same quantizers, lists and codes, so both packages score
    identical candidates."""
    if kind not in ("ivf-flat", "ivf-pq"):
        raise ValueError(f"snapshot_from_arrays takes IVF kinds, got {kind!r}")
    device = torch.device(device)

    def t(x, dtype=None):
        if x is None:
            return None
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    return IndexSnapshot(
        version=version, kind=kind, dim=dim, ntotal=ntotal, device=device,
        nprobe=nprobe, metric=metric,
        cent_unit=t(cent_unit, torch.float32), cent_raw=t(cent_raw,
                                                          torch.float32),
        list_ids=t(list_ids, torch.int32), payload=t(payload),
        lens=t(lens, torch.int32), pq_centers=t(pq_centers, torch.float32),
        pq_rot=t(pq_rot, torch.float32))
