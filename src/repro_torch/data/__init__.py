"""Host-side data (numpy): synthetic corpus and click log, OBoW
refinement, tokenizer, the pre-tokenized news store, the dynamic batcher
that builds centralized batches and the conventional workflow's batch;
synthetic recsys batches (``recsys_synth``)."""
from . import batching, recsys_synth
from .batching import (EPOCH_END, DynamicBatcher, LoaderConfig, NewsStore,
                       Sentinel, bucket_for, build_centralized_batch,
                       build_conventional_batch, default_buckets,
                       synth_centralized_batch)
from .news_synth import (ClickLog, NewsCorpus, click_share_topk,
                         make_click_log, make_corpus)
from .refine import CorpusStats, build_corpus_stats

__all__ = ["batching", "recsys_synth", "EPOCH_END", "DynamicBatcher",
           "LoaderConfig", "NewsStore", "Sentinel", "bucket_for",
           "build_centralized_batch", "build_conventional_batch",
           "default_buckets", "synth_centralized_batch", "ClickLog",
           "NewsCorpus", "click_share_topk", "make_click_log", "make_corpus",
           "CorpusStats", "build_corpus_stats"]
