"""The parallel layer: 1-D row splits (partition.py), the shard-parallel
host setup (dist_setup.py), and the sharded solve path: the mesh and its
collectives (comm.py), halo plans (halo.py), the sharded operators,
shrinking, the replicated tail and the sharded pCG (sharded.py), and
multi-process runs over torch.distributed (multihost.py)."""
from saena_tpu_torch.parallel.partition import (
    equal_row_split,
    nnz_balanced_split,
    subset_split,
)
from saena_tpu_torch.parallel.comm import Mesh, make_mesh
from saena_tpu_torch.parallel.halo import HaloPlan, build_halo_plan
from saena_tpu_torch.parallel.sharded import (
    ShardedEll,
    ShardedHierarchy,
    ShardedLevel,
    shard_hierarchy,
    sharded_solve_pCG,
)

__all__ = ["equal_row_split", "nnz_balanced_split", "subset_split", "Mesh",
           "make_mesh", "HaloPlan", "build_halo_plan", "ShardedEll",
           "ShardedLevel", "ShardedHierarchy", "shard_hierarchy",
           "sharded_solve_pCG"]
