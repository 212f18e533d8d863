"""Training runtime: TrainState, the bucketed Trainer, the
host-to-device prefetcher and the state's checkpoints.

Batches arrive on the device from a background thread (the
``DevicePrefetcher`` over the ``DynamicBatcher``), each at its own
seg-length bucket, so a short-segment batch runs a short step. Step
metrics stay on the device in a ``MetricsBuffer`` and are fetched in one
transfer every ``log_every`` steps: the step loop never waits on the
device in between. Checkpoints keep the JAX package's on-disk layout
(``{params, opt, cache}`` with stacked ``layers``, ``cache::age``
accepted as a legacy alias of ``cache::written_step``), so a checkpoint
written by either package restores in the other. On a data mesh
(``Trainer(mesh=)``) each rank trains on the batch rank 0 loaded, with
its row block of the cache.
"""
from .prefetch import STREAM_END, DevicePrefetcher, PrefetchedBatch
from .registry import get_trainer, register_trainer, registered_trainers
from .state import (CKPT_ALIASES, CKPT_OPTIONAL, TrainState, from_ckpt_tree,
                    make_state, place_state, restore_state, save_state,
                    state_shardings, state_specs, to_ckpt_tree)
from .trainer import MetricsBuffer, Trainer, TrainResult

__all__ = ["STREAM_END", "DevicePrefetcher", "PrefetchedBatch",
           "get_trainer", "register_trainer", "registered_trainers",
           "CKPT_ALIASES", "CKPT_OPTIONAL", "TrainState", "from_ckpt_tree",
           "make_state", "place_state", "restore_state", "save_state",
           "state_shardings", "state_specs", "to_ckpt_tree",
           "MetricsBuffer", "Trainer", "TrainResult"]
