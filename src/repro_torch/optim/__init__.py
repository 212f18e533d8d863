"""Adam with per-group learning rates and global-norm clipping, the
generic train step, and the learning-rate schedules."""
from .adam import (AdamConfig, adam_init, adam_update, clip_by_global_norm,
                   make_train_step)
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = ["AdamConfig", "adam_init", "adam_update", "clip_by_global_norm",
           "make_train_step",
           "constant", "cosine_decay", "linear_warmup_cosine"]
