"""Adam with per-group learning rates and global-norm clipping, the
generic train step, the int8 compressed reduction and the learning-rate
schedules."""
from .adam import (AdamConfig, adam_init, adam_update, clip_by_global_norm,
                   compressed_all_reduce, dequantize_int8, make_train_step,
                   quantize_int8)
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = ["AdamConfig", "adam_init", "adam_update", "clip_by_global_norm",
           "compressed_all_reduce", "dequantize_int8", "make_train_step",
           "quantize_int8",
           "constant", "cosine_decay", "linear_warmup_cosine"]
