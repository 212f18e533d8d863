"""Plain PyTorch substrate: dense, norms, embedding, rope, attention."""
from .attention import (NEG_INF, AttnConfig, attention, blocked_sdpa,
                        chunked_sdpa, decode_attention, init_attention,
                        init_kv_cache, init_kv_cache_q8, sdpa)
from .core import (dense, embed, init_dense, init_embedding, init_layernorm,
                   init_rmsnorm, layernorm, normal_init, rmsnorm,
                   xavier_init)
from .rope import apply_rope, positions_for_decode, rope_cos_sin, rope_freqs

__all__ = ["NEG_INF", "AttnConfig", "attention", "blocked_sdpa",
           "chunked_sdpa", "decode_attention", "init_attention",
           "init_kv_cache", "init_kv_cache_q8", "sdpa", "dense", "embed",
           "init_dense", "init_embedding", "init_layernorm", "init_rmsnorm",
           "layernorm", "normal_init", "rmsnorm", "xavier_init",
           "apply_rope", "positions_for_decode", "rope_cos_sin",
           "rope_freqs"]
