from myscaledb_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_axis
from myscaledb_tpu_torch.parallel.ops import (sharded_distance_topk,
                                              sharded_group_aggregate,
                                              sharded_topn)

__all__ = ["Mesh", "make_mesh", "shard_axis", "sharded_distance_topk",
           "sharded_group_aggregate", "sharded_topn"]
