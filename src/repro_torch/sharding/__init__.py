from repro_torch.sharding.ctx import (axis_rules, batch_axes, batch_local,
                                      current_mesh, gather_weight,
                                      local_heads, local_part, lookup,
                                      current_rules, logical_to_mesh,
                                      placements_for, put_rows, reshape,
                                      shard)
from repro_torch.sharding.plan import (ShardingPlan, make_plan,
                                       param_partition_specs)
from repro_torch.sharding.layout import (batch_sharding, distribute,
                                         distribute_like, distribute_model,
                                         distribute_tree, step_layout, whole)
