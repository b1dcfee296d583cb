"""Multi-process execution over ``torch.distributed``.

The reference scales across nodes through MPI ranks; the JAX package
through ``jax.distributed`` and a mesh over every host's devices. Here each
process (rank) holds k consecutive shards of one global mesh, and the
mesh's collectives cross ranks through ``torch.distributed`` (comm.py):
gloo for CPU tensors, NCCL for the card. Every rank runs the same host
setup and the same program, as with ``mpirun -np P``:

    from saena_tpu_torch.parallel.multihost import init_distributed, global_mesh
    init_distributed("tcp://localhost:29500", world_size=2, rank=r)
    mesh = global_mesh(shards_per_rank=4)        # 8 shards, 4 on each rank
    sh, splits = shard_hierarchy(info, opts, mesh)
    u, *_ = sharded_solve_pCG(sh, splits, rhs, mesh)

Nothing tells a process of a cluster: the caller gives the address, the
world size and the rank (or sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE and
RANK for ``init_method=None``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from saena_tpu_torch.parallel.comm import Mesh


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group: ``backend`` "nccl" for the card, "gloo" for
    CPU tensors (None: NCCL when CUDA is available, else gloo). With NCCL
    the rank takes card ``rank % device_count``."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if world_size is not None:
        kw = dict(world_size=world_size, rank=rank)
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def global_mesh(shards_per_rank: int = 1, device=None) -> Mesh:
    """A mesh over every rank's shards: ``shards_per_rank`` on each, on
    ``device`` (the rank's card unless named)."""
    return Mesh(shards_per_rank * dist.get_world_size(), device,
                group=dist.group.WORLD)


def scaling_efficiency(nnz_per_s_n: float, nnz_per_s_1: float,
                       n_devices: int) -> float:
    """Weak-scaling efficiency nnz/s(N) / (N * nnz/s(1)); BASELINE.md's
    multi-host target is >= 0.8."""
    return nnz_per_s_n / (n_devices * nnz_per_s_1)
