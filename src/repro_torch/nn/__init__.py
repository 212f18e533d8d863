"""Plain PyTorch substrate: dense, layernorm, embedding, attention."""
from .attention import NEG_INF, sdpa
from .core import (dense, embed, init_dense, init_embedding, init_layernorm,
                   layernorm, normal_init, xavier_init)

__all__ = ["NEG_INF", "sdpa", "dense", "embed", "init_dense",
           "init_embedding", "init_layernorm", "layernorm", "normal_init",
           "xavier_init"]
