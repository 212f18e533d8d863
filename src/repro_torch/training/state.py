"""TrainState: what the training runtime threads through every step, and
its checkpoints.

``step`` is a host integer (the step draws need no device value) and
``rng`` the generator on the device from which each step takes its cache
gate and negatives. Parameters, Adam moments and the cache are updated in
place by the step; the state's tuple is rebuilt each step with the next
``step``.

On disk a state is the JAX package's layout, ``{params, opt, cache: {emb,
written_step}, step}`` with JAX's stacked ``layers`` arrays, so the same
keys, shapes, dtypes and bytes (and so the same checksums) as a JAX
checkpoint of the same state. JAX keeps a PRNG key ``rng`` (uint32[2])
that a torch generator has no form of: the port writes its generator's
``get_state()`` bytes under ``torch_rng`` instead. Each package restores
the other's checkpoints: the key the other package wrote is ignored, and
the restoring state keeps its own generator or key (``CKPT_OPTIONAL``).
Legacy checkpoints that named the cache timestamp ``age`` restore through
``CKPT_ALIASES``.

On a data mesh (``state_specs``: JAX's layout, pure data parallelism)
the parameters, moments, step and generator are replicated and the
cache is row-sharded. ``save_state(..., shardings=)`` gathers the cache
rows to rank 0, which writes the same files as one device would, while
the others wait at a barrier; ``restore_state(..., shardings=)`` reads
them and keeps each rank's block. So a checkpoint moves between one
device, a mesh and the JAX package unchanged.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import CacheState
from repro_torch.distributed import sharding as shx
from repro_torch.distributed.collectives import barrier, gather_to_rank0

# legacy (pre-Trainer) on-disk names, keyed by the current flattened key
CKPT_ALIASES = {"cache::written_step": "cache::age"}
# leaves absent from legacy checkpoints and from the other package's:
# restored states keep the init value
CKPT_OPTIONAL = ("step", "rng", "torch_rng")
# the bytes of a generator's ``get_state()`` on each device type (CPU:
# mt19937's state; CUDA: Philox's seed and offset)
GEN_STATE_BYTES = {"cpu": 5056, "cuda": 16}


class TrainState(NamedTuple):
    params: Any               # parameter tree (dicts and lists of tensors)
    opt: Any                  # Adam state {"m", "v", "count"}
    cache: CacheState         # news-embedding cache (emb, written_step)
    step: int                 # global step
    rng: torch.Generator      # the step draws' generator, on the device


def make_state(params, opt, cache, *, step: int = 0,
               rng: torch.Generator | None = None) -> TrainState:
    if rng is None:
        rng = torch.Generator(device=cache.emb.device).manual_seed(0)
    return TrainState(params, opt, cache, int(step), rng)


def to_ckpt_tree(state: TrainState) -> dict:
    """The on-disk checkpoint layout of a TrainState (see the module
    docstring). The stacked ``layers`` leaves are new tensors on the
    state's device; every other leaf is the state's own."""
    from repro_torch.bridge import stack_layers
    return {"params": stack_layers(state.params),
            "opt": stack_layers(state.opt),
            "cache": {"emb": state.cache.emb,
                      "written_step": state.cache.written_step},
            "step": np.int32(state.step),
            "torch_rng": state.rng.get_state()}


def _generator(saved, like: torch.Generator) -> torch.Generator:
    """A generator on ``like``'s device holding the ``saved`` state bytes;
    ``like`` itself where the checkpoint holds none (a JAX checkpoint)."""
    if saved is None:
        return like
    saved = torch.from_numpy(np.array(saved, dtype=np.uint8))
    gen = torch.Generator(device=like.device)
    want = gen.get_state().numel()
    if saved.numel() != want:
        kind = {n: dev for dev, n in GEN_STATE_BYTES.items()}.get(
            saved.numel(), "unknown")
        raise ValueError(
            f"the checkpoint's generator state is {saved.numel()} bytes (a "
            f"{kind} generator's) but this state's generator is on "
            f"{like.device} ({want} bytes): a generator's state does not "
            f"move between device types; restore into a state on the "
            f"device the checkpoint was written from")
    gen.set_state(saved)
    return gen


def from_ckpt_tree(tree: dict, step: int, like: TrainState) -> TrainState:
    """A restored checkpoint tree (host arrays) -> a TrainState on
    ``like``'s device, the ``layers`` split into per-layer lists. The
    directory step is authoritative (legacy checkpoints have no step
    leaf)."""
    from repro_torch.bridge import opt_from_jax, params_from_jax
    device = like.cache.emb.device
    cache = CacheState(
        torch.from_numpy(tree["cache"]["emb"]).to(device),
        torch.from_numpy(tree["cache"]["written_step"]).to(device))
    return TrainState(params_from_jax(tree["params"], device),
                      opt_from_jax(tree["opt"], device), cache, int(step),
                      _generator(tree["torch_rng"], like.rng))


def _gathered(state: TrainState, shardings: TrainState):
    """The state with its cache rows gathered from every rank, on rank 0;
    None on the others (``state_specs`` replicates the rest)."""
    mesh = shardings.cache.emb.mesh
    cache = CacheState(*(gather_to_rank0(t, mesh) if s.spec and
                         s.spec[0] is not None else t
                         for t, s in zip(state.cache, shardings.cache)))
    return state._replace(cache=cache) if mesh.rank == 0 else None


def save_state(ckpt_dir: str, step: int, state: TrainState, *,
               writer: "ckpt.AsyncCheckpointer | None" = None, keep: int = 3,
               shardings: TrainState | None = None):
    """Write ``state`` at ``step`` (through ``writer`` when given). With
    ``shardings`` (``state_shardings`` of the whole state) every rank
    calls this: rank 0 gathers the cache rows and writes, the others wait
    at a barrier until it has."""
    mesh = None
    if shardings is not None:
        mesh = shardings.cache.emb.mesh
        state = _gathered(state, shardings)
    if state is not None:
        tree = to_ckpt_tree(state)
        if writer is not None:
            writer.save(step, tree)
        else:
            ckpt.save(ckpt_dir, step, tree, keep=keep)
    if mesh is not None:
        barrier(mesh)


def _ckpt_shardings(shardings: TrainState) -> dict:
    """``shardings`` in the checkpoint's layout (``to_ckpt_tree``): each
    ``layers`` list's specs stacked on a leading replicated dim."""
    def stacked(node, is_layers=False):
        if isinstance(node, dict):
            return {k: stacked(v, k == "layers") for k, v in node.items()}
        if isinstance(node, list):
            if is_layers:
                return shx.tree_map(lambda s: shx.Sharding(
                    s.mesh, shx.Spec(None, *s.spec)), node[0])
            return [stacked(v) for v in node]
        return node

    return {"params": stacked(shardings.params),
            "opt": stacked(shardings.opt),
            "cache": {"emb": shardings.cache.emb,
                      "written_step": shardings.cache.written_step},
            "step": shardings.step, "torch_rng": None}


def restore_state(ckpt_dir: str, like: TrainState, step: int | None = None,
                  *, shardings: TrainState | None = None
                  ) -> tuple[int, TrainState]:
    """Restore a TrainState written by either package (the current layout,
    or the legacy ``{params, opt, cache: {emb, age}}`` one) into ``like``'s
    structure and device. The one reader of a checkpoint directory in the
    port, JAX's included.

    A port checkpoint's generator state is restored too (a CPU generator's
    into a CPU state, a CUDA one's into a CUDA state; across device types
    ``ValueError``); a checkpoint without one keeps ``like``'s generator.

    ``shardings`` (``state_shardings`` of the whole state): ``like`` is
    this rank's placed state (``Trainer.init_state`` on a mesh), and each
    rank keeps its block of every leaf. The files are the same either way,
    so a one-device checkpoint lands on a mesh and a mesh's on one device.
    """
    like_tree = to_ckpt_tree(like)
    like_tree["torch_rng"] = None        # any size: the device's own
    kw = dict(aliases=CKPT_ALIASES, missing_ok=CKPT_OPTIONAL)
    if shardings is None:
        step, tree = ckpt.restore(ckpt_dir, like_tree, step, **kw)
    else:
        placed = _ckpt_shardings(shardings)

        def whole(s, leaf):
            if s is None or all(a is None for a in s.spec):
                return leaf
            shape = shx.global_shape(tuple(leaf.shape), s.spec, s.mesh)
            return torch.empty(shape, dtype=leaf.dtype, device="meta")

        step, tree = ckpt.restore_sharded(
            ckpt_dir, shx.tree_map(whole, placed, like_tree), placed, step,
            **kw)
    return step, from_ckpt_tree(tree, step, like)


# ---------------------------------------------------------------------------
# mesh placement
# ---------------------------------------------------------------------------

def state_specs(like: TrainState, mesh) -> TrainState:
    """Specs for a SpeedyFeed TrainState (``like`` the whole state) on
    ``mesh``: pure data parallelism by ``speedyfeed_rules(tp=False)``,
    parameters and moments replicated, the cache row-sharded over the
    data axes (``speedyfeed_cache_spec``), step and generator replicated;
    the divisibility guard replicates a cache whose rows the data axes do
    not divide."""
    params_spec = shx.spec_tree(like.params, shx.speedyfeed_rules())
    opt_spec = {"m": params_spec, "v": params_spec, "count": shx.Spec()}
    cs = shx.speedyfeed_cache_spec(mesh)
    specs = TrainState(params_spec, opt_spec,
                       CacheState(cs["emb"], cs["written_step"]),
                       shx.Spec(), shx.Spec())
    return shx.guard_divisible(specs, like, mesh)


def state_shardings(like: TrainState, mesh) -> TrainState:
    """``Sharding(mesh, spec)`` for each leaf of ``like`` (see
    ``state_specs``)."""
    return shx.named(mesh, state_specs(like, mesh))


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """This rank's part of a whole state: every sharded leaf cut to its
    block (a copy, so the whole can be freed), the rest as they are."""
    def place(s, leaf):
        block = shx.shard_block(leaf, s.spec, s.mesh)
        return block.clone() if block is not leaf else leaf

    return shx.tree_map(place, shardings, state)
