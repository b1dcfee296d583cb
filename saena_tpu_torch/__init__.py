"""saena_tpu_torch: the saena_tpu algebraic multigrid solver on PyTorch and
CUDA.

The same host setup as saena_tpu (numpy/scipy and native C++ kernels),
device levels as torch tensors, and the pCG + V-cycle solve in PyTorch
(replayed as CUDA graphs on the card), with three hand-written
CUDA kernels for Hopper: the DIA stencil SpMV and its fused smoother update
(csrc/dia_spmv.cu), and the strip and strip8 gather SpMVs
(csrc/strip_spmv.cu, csrc/strip8_spmv.cu) that carry the mid-level
operators and the structural transfers on the card. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.

  core/      host COO assembly and boundary removal
  amg/       hierarchy setup and solve: strength, aggregation, RAP, eig,
             smoothers, V-cycle, the Krylov and stationary solvers, and
             their loops as CUDA graph replays (graphs.py)
  _native/   C++ host kernels of the setup (MIS(1), strength, SpGEMM, the
             strip/strip8 planners, the GR codec), built with g++ at first use
  parallel/  the shard-parallel host setup (dist_setup), row splits, and the
             sharded solve: mesh and collectives (comm), halo plans,
             sharded operators, shrinking and the replicated tail
             (sharded), multi-process runs over torch.distributed
             (multihost)
  ops/       device formats (DIA, ELL, dense, BSR, strip, strip8), the
             format picker, structural transfers and the kernels' wrappers
  csrc/      CUDA sources, built with nvcc at first use
  io/        matrix files (.mtx, .bin, .sbin) and Nektar++ session meshes
  api.py     Matrix / AMG; vector.py Vector; config.py Options
  profiling.py  per-level matvec, V-cycle and pCG timings, traces
  oracles.py    scipy baselines of solves and products
"""
import os as _os

# libgomp's default ACTIVE wait policy spin-burns a core whenever the native
# OpenMP kernels run beside the setup's worker threads; PASSIVE costs the
# kernels nothing. It must be set before any OpenMP runtime initializes,
# torch's included.
_os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

from saena_tpu_torch.config import Options
from saena_tpu_torch.api import AMG, Matrix, Vector
from saena_tpu_torch import generators

__all__ = ["Options", "Matrix", "Vector", "AMG", "generators"]
