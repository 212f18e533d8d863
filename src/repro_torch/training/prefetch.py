"""Host-to-device input pipeline (double-buffered prefetch).

While step N runs, the next batch is assembled by the DynamicBatcher's
threads and copied to the device by this prefetcher's thread; the
bounded queue lets at most ``depth`` batches be in flight.

The copies are queued on the CUDA stream that was current when the
prefetcher started (the stream the step runs on), from pinned host
memory with ``non_blocking``: the copy of batch N+1 is queued behind the
work already queued, and the step that reads it is queued after the
copy, so the stream orders every read after its copy and no event is
needed.

The prefetcher also owns epoch turnover: on ``EPOCH_END`` it stops the
exhausted batcher and starts the next epoch's, so the consumer sees one
uninterrupted batch stream.

On a data mesh only rank 0 runs a prefetcher; ``broadcast_batch`` hands
each of its batches to every rank.

Obs: the ``prefetch.h2d`` fault site fires before each copy (its
exception reaches ``get`` with its own type), the copy is timed as the
``prefetch_h2d`` span, ``prefetch_queue_depth`` gauges the batches
waiting on the device, and ``prefetch_thread_leaks_total`` counts
producers abandoned by ``stop``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import warnings

import torch

from repro_torch import data, obs
from repro_torch.device import check_device
from repro_torch.resilience import faults

# producer finished cleanly (max_epochs reached, queue drained); distinct
# from None, which means timeout
STREAM_END = data.Sentinel("STREAM_END")


@dataclasses.dataclass
class PrefetchedBatch:
    bucket: int          # seg-length bucket
    arrays: dict         # batch tensors on the device
    stats: dict | None   # host-side loader stats (data efficiency etc.)
    epoch: int = 0


class DevicePrefetcher:
    """Background thread: DynamicBatcher -> device tensors -> bounded queue.

    ``make_batcher(epoch)`` must return a started DynamicBatcher; a fresh
    one is created per epoch with the epoch index available for reseeding.
    ``device`` defaults to the card, like ``Trainer``, and raises without
    one; pass ``device="cpu"`` to keep the batches on the CPU.
    """

    def __init__(self, make_batcher, *, depth: int = 2,
                 max_epochs: int | None = None, device="cuda",
                 poll: float = 0.25):
        self._make = make_batcher
        self._max_epochs = max_epochs
        self._device = check_device(device)
        self._poll = poll
        self._stream = None
        self._q = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._finished = threading.Event()
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        # device-ready batches waiting for the step thread: 0 at steady
        # state means the consumer is input-bound, == depth means the
        # producer keeps ahead (what double buffering is for)
        self._g_depth = obs.gauge("prefetch_queue_depth")

    def start(self) -> "DevicePrefetcher":
        if self._device.type == "cuda":
            self._stream = torch.cuda.current_stream(self._device)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _to_device(self, item: dict) -> dict:
        arrays = {k: torch.from_numpy(v) for k, v in item.items()}
        if self._stream is None:
            return arrays
        with torch.cuda.stream(self._stream):
            return {k: v.pin_memory().to(self._device, non_blocking=True)
                    for k, v in arrays.items()}

    def _run(self):
        epoch = 0
        batcher = None
        try:
            batcher = self._make(epoch)
            while not self._stop.is_set():
                item = batcher.get(timeout=self._poll)
                if item is None:               # timeout: loader still busy
                    continue
                if item is data.EPOCH_END:
                    batcher.stop()
                    batcher = None
                    epoch += 1
                    if self._max_epochs is not None \
                            and epoch >= self._max_epochs:
                        return
                    batcher = self._make(epoch)
                    continue
                stats = item.pop("_stats", None)
                bucket = int(item.pop("_bucket",
                                      (stats or {}).get("seg_len", 0)))
                faults.fire("prefetch.h2d", step=epoch)
                with obs.span("prefetch_h2d"):
                    arrays = self._to_device(item)
                pb = PrefetchedBatch(bucket, arrays, stats, epoch)
                while not self._stop.is_set():
                    try:
                        self._q.put(pb, timeout=0.1)   # backpressure
                        self._g_depth.set(self._q.qsize())
                        break
                    except queue.Full:
                        continue
        except BaseException as e:      # surfaced on the consumer side
            self._error = e
        finally:
            if batcher is not None:
                batcher.stop()
            self._finished.set()

    def get(self, timeout: float = 30.0):
        """Next device batch; ``STREAM_END`` once the producer finished
        cleanly and the queue drained; ``None`` only on timeout (producer
        alive but slow). Raises the producer's error, if any."""
        end = time.monotonic() + timeout
        while True:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            try:
                pb = self._q.get(timeout=0.05)
                self._g_depth.set(self._q.qsize())
                return pb
            except queue.Empty:
                if self._finished.is_set() and self._q.empty():
                    if self._error is not None:   # a crash is not a clean
                        continue                  # end: re-loop raises it
                    return STREAM_END
                if time.monotonic() >= end:
                    return None

    def stop(self, timeout: float = 5.0):
        """Shut the producer down. Never raises (safe in ``finally``);
        producer errors surface through ``get``. A producer that does not
        join within ``timeout`` is left as a daemon thread, never silently:
        the leak is counted (``prefetch_thread_leaks_total``) and warned
        about, so a supervisor restarting the trainer can see threads pile
        up."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                obs.counter("prefetch_thread_leaks_total").inc()
                warnings.warn(
                    f"prefetch producer thread did not stop within "
                    f"{timeout}s and was abandoned (daemon)", stacklevel=2)
            self._thread = None


def broadcast_batch(pb, mesh):
    """Rank 0's ``get`` result on every rank of ``mesh``: a
    ``PrefetchedBatch`` (its tensors on each rank's device), ``STREAM_END``
    or ``None``. Rank 0 passes its own; the others pass None. The layout
    (keys, shapes, dtypes, bucket, stats) goes as one pickled object, then
    each tensor by a broadcast."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import broadcast
    head = [None]
    if mesh.rank == 0:
        head[0] = ("end",) if pb is STREAM_END else ("none",) \
            if pb is None else (
                "batch", pb.bucket, pb.stats, pb.epoch,
                [(k, tuple(v.shape), v.dtype) for k, v in pb.arrays.items()])
    dist.broadcast_object_list(head, src=0, group=mesh.group)
    kind = head[0][0]
    if kind != "batch":
        return STREAM_END if kind == "end" else None
    _, bucket, stats, epoch, layout = head[0]
    arrays = {k: broadcast(pb.arrays[k] if mesh.rank == 0 else torch.empty(
        shape, dtype=dtype, device=mesh.device), mesh)
        for k, shape, dtype in layout}
    return PrefetchedBatch(bucket, arrays, stats, epoch)
