"""Host-side control plane (the loader's work-stealing queue, the
straggler monitor, elastic mesh planning), the partition rules, and the
collectives a mesh runs."""
from .sharding import (DATA_AXES, Sharding, Spec, batch_specs, constrain,
                       data_spec, gnn_batch_specs, gnn_rules,
                       guard_divisible, lm_batch_specs,
                       lm_rules, named, place, recsys_batch_specs,
                       recsys_rules, set_activation_specs, shard_block,
                       spec_tree, speedyfeed_batch_specs,
                       speedyfeed_cache_spec, speedyfeed_rules)
from .straggler import StepTimeMonitor, WorkStealingQueue, plan_elastic_mesh

__all__ = ["DATA_AXES", "Sharding", "Spec", "batch_specs", "constrain",
           "data_spec", "gnn_batch_specs", "gnn_rules", "guard_divisible",
           "lm_batch_specs", "lm_rules", "named", "place", "recsys_batch_specs", "recsys_rules",
           "set_activation_specs", "shard_block", "spec_tree",
           "speedyfeed_batch_specs", "speedyfeed_cache_spec",
           "speedyfeed_rules", "StepTimeMonitor", "WorkStealingQueue",
           "plan_elastic_mesh"]
