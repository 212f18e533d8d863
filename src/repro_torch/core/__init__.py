"""SpeedyFeed core: PLM/BusLM news encoder, cache, centralized set, user
model, losses, the Algorithm-1 pipeline and the conventional workflow."""
from .buslm import buslm_encode, plm_flops
from .cache import (NEVER, CacheConfig, CachePlan, CacheState, RowShard,
                    assemble_embeddings, cache_plan, cache_refresh,
                    cache_shard, init_cache)
from .centralized import MergedSet, dispatch, gather_dedup
from .loss import ar_loss, click_loss, sample_negatives
from .pipeline import (SpeedyFeedConfig, StepOut, conventional_forward,
                       init_speedyfeed, make_config, speedyfeed_forward,
                       speedyfeed_state)
from .plm import (PLMConfig, additive_attention, embed_inputs, ffn,
                  init_plm)
from .user_model import (UserModelConfig, attentive_user,
                         attentive_user_causal, init_user_model,
                         user_embeddings)

__all__ = ["buslm_encode", "plm_flops", "NEVER", "CacheConfig", "CachePlan",
           "CacheState", "RowShard", "assemble_embeddings", "cache_plan",
           "cache_refresh", "cache_shard", "init_cache", "MergedSet",
           "dispatch", "gather_dedup", "ar_loss",
           "click_loss", "sample_negatives", "SpeedyFeedConfig", "StepOut",
           "conventional_forward", "init_speedyfeed", "make_config",
           "speedyfeed_forward", "speedyfeed_state", "PLMConfig",
           "additive_attention", "embed_inputs", "ffn", "init_plm",
           "UserModelConfig",
           "attentive_user", "attentive_user_causal", "init_user_model",
           "user_embeddings"]
