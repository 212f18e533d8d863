from .ckpt import (AsyncCheckpointer, CheckpointCorruptError, all_steps,
                   latest_step, restore, restore_sharded, save)
