from repro_torch.sharding.ctx import (axis_rules, batch_axes, batch_local,
                                      current_mesh, gather_weight,
                                      local_heads, lookup,
                                      current_rules, logical_to_mesh,
                                      placements_for, put_rows, reshape,
                                      shard)
from repro_torch.sharding.plan import (ShardingPlan, make_plan,
                                       param_partition_specs)
