"""Plain PyTorch substrate: dense, MLP, norms, embedding, EmbeddingBag,
rope, attention, mixture of experts."""
from .attention import (NEG_INF, AttnConfig, attention, blocked_sdpa,
                        chunked_flash, chunked_sdpa, decode_attention,
                        init_attention, init_kv_cache, init_kv_cache_q8,
                        sdpa)
from .core import (dense, embed, init_dense, init_embedding, init_layernorm,
                   init_mlp, init_rmsnorm, layernorm, mlp, normal_init,
                   rmsnorm, xavier_init)
from .embedding_bag import embedding_bag, embedding_bag_flat, offsets_to_fixed
from .moe import (MoEConfig, capacity_for, init_moe, moe_dense, moe_ep,
                  moe_ep_partial, moe_gather)
from .rope import apply_rope, positions_for_decode, rope_cos_sin, rope_freqs

__all__ = ["NEG_INF", "AttnConfig", "attention", "blocked_sdpa",
           "chunked_flash", "chunked_sdpa", "decode_attention", "init_attention",
           "init_kv_cache", "init_kv_cache_q8", "sdpa", "dense", "embed",
           "init_dense", "init_embedding", "init_layernorm", "init_mlp",
           "init_rmsnorm", "layernorm", "mlp", "normal_init", "rmsnorm",
           "xavier_init", "embedding_bag", "embedding_bag_flat",
           "offsets_to_fixed", "MoEConfig", "capacity_for", "init_moe",
           "moe_dense", "moe_ep", "moe_ep_partial", "moe_gather",
           "apply_rope", "positions_for_decode", "rope_cos_sin",
           "rope_freqs"]
