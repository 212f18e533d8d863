"""SpeedyFeed core: PLM/BusLM news encoder, user model, configuration."""
from .buslm import buslm_encode, plm_flops
from .cache import CacheConfig
from .pipeline import SpeedyFeedConfig, init_speedyfeed, make_config
from .plm import (PLMConfig, additive_attention, embed_inputs, ffn,
                  init_plm)
from .user_model import UserModelConfig, attentive_user, init_user_model

__all__ = ["buslm_encode", "plm_flops", "CacheConfig", "SpeedyFeedConfig",
           "init_speedyfeed", "make_config", "PLMConfig",
           "additive_attention", "embed_inputs", "ffn", "init_plm",
           "UserModelConfig", "attentive_user", "init_user_model"]
