"""Host-side parallel setup: 1-D row splits (partition.py) and the
shard-parallel hierarchy setup (dist_setup.py), thread-pool code with no
collective. The sharded device path waits for torch.distributed."""
from saena_tpu_torch.parallel.partition import (
    equal_row_split,
    nnz_balanced_split,
    subset_split,
)

__all__ = ["equal_row_split", "nnz_balanced_split", "subset_split"]
