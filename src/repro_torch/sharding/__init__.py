from repro_torch.sharding.ctx import (assign, axis_rules, batch_axes,
                                      batch_local, current_mesh,
                                      current_rules, gather_weight,
                                      local_heads, local_part,
                                      logical_to_mesh, lookup,
                                      placements_for, put_rows, reshape,
                                      shard)
from repro_torch.sharding.plan import (ShardingPlan, make_plan,
                                       param_partition_specs)
from repro_torch.sharding.layout import (batch_sharding, cache_sharding,
                                         distribute, distribute_cache,
                                         distribute_like, distribute_model,
                                         distribute_rows, distribute_tree,
                                         step_layout, whole)
