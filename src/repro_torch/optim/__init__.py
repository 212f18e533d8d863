"""Adam with per-group learning rates and global-norm clipping, and the
learning-rate schedules."""
from .adam import AdamConfig, adam_init, adam_update, clip_by_global_norm
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = ["AdamConfig", "adam_init", "adam_update", "clip_by_global_norm",
           "constant", "cosine_decay", "linear_warmup_cosine"]
