"""Two-stage ANN retrieval: IVF-Flat / IVF-PQ over padded-CSR device
storage, versioned snapshots, an online delta tier, and the service."""
from .builder import IndexBuilder
from .index import (PAD_ID, FlatIndex, IVFConfig, IVFFlatIndex, IVFPQIndex,
                    make_index)
from .online import DeltaBuffer, DeltaView, hybrid_search, merge_topk_dedup
from .pq import (PQCodebook, PQConfig, fit_kmeans, kmeans, kmeans_minibatch,
                 pq_decode, pq_encode, pq_lut, pq_search, pq_train,
                 sample_rows)
from .service import RetrievalService, ServiceView
from .snapshot import IndexSnapshot, empty_snapshot, snapshot_from_index
from .store import EmbeddingStore

__all__ = ["IndexBuilder", "PAD_ID", "FlatIndex", "IVFConfig",
           "IVFFlatIndex", "IVFPQIndex", "make_index", "DeltaBuffer",
           "DeltaView", "hybrid_search", "merge_topk_dedup", "PQCodebook",
           "PQConfig", "fit_kmeans", "kmeans", "kmeans_minibatch",
           "pq_decode", "pq_encode", "pq_lut", "pq_search", "pq_train",
           "sample_rows", "RetrievalService", "ServiceView",
           "IndexSnapshot", "empty_snapshot", "snapshot_from_index",
           "EmbeddingStore"]
