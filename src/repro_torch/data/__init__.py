"""Host-side data (numpy): synthetic corpus and click log, OBoW
refinement, tokenizer, the pre-tokenized news store."""
from .batching import LoaderConfig, NewsStore, default_buckets
from .news_synth import ClickLog, NewsCorpus, make_click_log, make_corpus
from .refine import CorpusStats, build_corpus_stats

__all__ = ["LoaderConfig", "NewsStore", "default_buckets", "ClickLog",
           "NewsCorpus", "make_click_log", "make_corpus", "CorpusStats",
           "build_corpus_stats"]
