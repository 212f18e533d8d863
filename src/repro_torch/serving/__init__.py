"""Two-stage ANN retrieval: IVF-Flat / IVF-PQ over padded-CSR device
storage, versioned snapshots (device-sharded across a list of devices in
``sharded``), an online delta tier, the service with its degraded mode,
and the continuous-batching request front end (RequestScheduler + the
open-loop Poisson load harness in loadgen)."""
from . import loadgen
from .builder import IndexBuilder
from .index import (PAD_ID, FlatIndex, IVFConfig, IVFFlatIndex, IVFPQIndex,
                    make_index)
from .online import (DeltaBuffer, DeltaOverflowError, DeltaView, hybrid_search,
                     ingest_from_cache, merge_topk_dedup)
from .pq import (PQCodebook, PQConfig, fit_kmeans, kmeans, kmeans_minibatch,
                 opq_train, pq_decode, pq_encode, pq_lut, pq_search, pq_train,
                 sample_rows)
from .scheduler import (DeadlineExceededError, RequestCancelledError,
                        RequestScheduler, ScheduledRequest, bucket_for,
                        pow2_buckets)
from .service import BackpressureError, RetrievalService, ServiceView
from .sharded import (ShardedIndexSnapshot, shard_mesh, shard_snapshot,
                      unshard_snapshot)
from .snapshot import IndexSnapshot, empty_snapshot, snapshot_from_index
from .store import EmbeddingStore
from .tune import TuneResult, autotune, tune_service

__all__ = ["loadgen", "IndexBuilder", "PAD_ID", "FlatIndex", "IVFConfig",
           "IVFFlatIndex", "IVFPQIndex", "make_index", "DeltaBuffer",
           "DeltaOverflowError", "DeltaView", "hybrid_search",
           "ingest_from_cache", "merge_topk_dedup", "PQCodebook",
           "PQConfig", "fit_kmeans", "kmeans", "kmeans_minibatch",
           "opq_train", "pq_decode", "pq_encode", "pq_lut", "pq_search",
           "pq_train", "sample_rows", "DeadlineExceededError",
           "RequestCancelledError", "RequestScheduler", "ScheduledRequest",
           "bucket_for", "pow2_buckets", "BackpressureError",
           "RetrievalService", "ServiceView", "ShardedIndexSnapshot",
           "shard_mesh", "shard_snapshot", "unshard_snapshot", "IndexSnapshot",
           "empty_snapshot", "snapshot_from_index", "EmbeddingStore",
           "TuneResult", "autotune", "tune_service"]
