"""Training runtime: TrainState, the bucketed Trainer and the
host-to-device prefetcher.

Batches arrive on the device from a background thread (the
``DevicePrefetcher`` over the ``DynamicBatcher``), each at its own
seg-length bucket, so a short-segment batch runs a short step. Step
metrics stay on the device in a ``MetricsBuffer`` and are fetched in one
transfer every ``log_every`` steps: the step loop never waits on the
device in between. Checkpoints are not ported yet.
"""
from .prefetch import STREAM_END, DevicePrefetcher, PrefetchedBatch
from .registry import get_trainer, register_trainer, registered_trainers
from .state import TrainState, make_state
from .trainer import MetricsBuffer, NonFiniteLossError, Trainer, TrainResult

__all__ = ["STREAM_END", "DevicePrefetcher", "PrefetchedBatch",
           "get_trainer", "register_trainer", "registered_trainers",
           "TrainState", "make_state", "MetricsBuffer", "NonFiniteLossError",
           "Trainer", "TrainResult"]
