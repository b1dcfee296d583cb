"""Structural smoothed-aggregation transfer operators.

The SA prolongator is P = (I - omega Q A) P_t (ref SA(),
saena_object_setup1.cpp:8-254), so its matvec splits into the tentative
operator P_t (one nonzero per fine row) and one matvec with the level's own
A, which already has its fastest format:

    P x = g - wq * (A g),          g = P_t x
    R r = P_t^T (r - A (wq * r))   [A symmetric, R = P^T]

with wq = omega * diag(Q). P_t and P_t^T go to the gather formats (strip,
strip8 or BSR, by estimated time); A is the level's object itself, not a
copy. Setup takes this path only for a numerically symmetric A (the port of
saena_tpu/ops/transfers.py).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch.amg.prolongation import tentative_prolongator
from saena_tpu_torch.ops.formats import (
    BSR_STREAM_BPS,
    gather_time_estimate,
    pad_to,
    pick_gather_format,
    to_device,
)
from saena_tpu_torch.ops.strip8_spmv import (
    strip8_from_csr,
    strip8_time_estimate,
)
from saena_tpu_torch.ops.strip_spmv import strip_from_csr, strip_time_estimate


class SmoothedP:
    """P = (I - omega Q A) P_t applied structurally."""

    def __init__(self, Pt, A, wq, shape, nnz):
        self.Pt, self.A, self.wq = Pt, A, wq
        self.shape, self.nnz = tuple(shape), int(nnz)

    @property
    def dtype(self):
        return self.Pt.dtype

    @property
    def n_pad(self) -> int:
        return self.Pt.n_pad

    @property
    def device(self) -> torch.device:
        return self.wq.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        g = self.Pt.matvec(x)
        return g - self.wq * self.A.matvec(g).to(g.dtype)


class SmoothedR:
    """R = P^T = P_t^T (I - omega A Q) applied structurally (A symmetric)."""

    def __init__(self, PtT, A, wq, shape, nnz):
        self.PtT, self.A, self.wq = PtT, A, wq
        self.shape, self.nnz = tuple(shape), int(nnz)

    @property
    def dtype(self):
        return self.PtT.dtype

    @property
    def n_pad(self) -> int:
        return self.PtT.n_pad

    @property
    def device(self) -> torch.device:
        return self.wq.device

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        z = r - self.A.matvec(self.wq * r).to(r.dtype)
        return self.PtT.matvec(z)


_SYM_MEMO = "_saena_torch_symmetric"


def is_symmetric(A: sp.spmatrix, rtol: float = 1e-12) -> bool:
    """Numerical symmetry check, memoized on the matrix object keyed by
    (shape, nnz); coarsen_tail pre-seeds it on Galerkin products of
    symmetric operators."""
    key = (A.shape, A.nnz)
    tok = getattr(A, _SYM_MEMO, None)
    if tok is not None and tok[0] == key:
        return tok[1]
    D = (A - A.T).tocoo()
    if D.nnz == 0:
        sym = True
    else:
        scale = np.abs(A.data).max() if A.nnz else 1.0
        sym = bool(np.abs(D.data).max() <= rtol * scale)
    mark_symmetric(A, sym)
    return sym


def mark_symmetric(A: sp.spmatrix, sym: bool = True) -> None:
    try:
        setattr(A, _SYM_MEMO, ((A.shape, A.nnz), sym))
    except AttributeError:
        pass


def device_bytes(M) -> int:
    """Bytes of every tensor a device operator holds."""
    seen, total, stack = set(), 0, [M]
    while stack:
        obj = stack.pop()
        if isinstance(obj, torch.Tensor):
            if id(obj) not in seen:
                seen.add(id(obj))
                total += obj.numel() * obj.element_size()
        elif isinstance(obj, (tuple, list)):
            stack.extend(obj)
        elif hasattr(obj, "__dict__"):
            stack.extend(vars(obj).values())
    return total


def _strip_time(M_csr: sp.csr_matrix, dtype) -> float:
    """Least estimated matvec seconds over the gather formats; below the
    picker's 4096-nnz floor, strip against strip8 directly."""
    if M_csr.nnz >= 4096:
        return gather_time_estimate(M_csr, dtype)
    return min(strip_time_estimate(M_csr, dtype),
               strip8_time_estimate(M_csr, dtype))


def _strip_build(M_csr: sp.csr_matrix, dtype, device, timer=None):
    if M_csr.nnz >= 4096:
        builder = pick_gather_format(M_csr, dtype)
        if builder is not None:
            return builder(M_csr, dtype, device, timer=timer)
    if strip8_time_estimate(M_csr, dtype) < strip_time_estimate(M_csr, dtype):
        return strip8_from_csr(M_csr, dtype, device, timer=timer)
    return strip_from_csr(M_csr, dtype, device, timer=timer)


def build_structural(agg: np.ndarray, n_coarse: int, wq_host: np.ndarray,
                     Adev, P_nnz: int, dtype_l, dtype_next, device=None,
                     timer=None):
    """(SmoothedP, SmoothedR) from the aggregation map and the smoothing
    diagonal; ``agg`` is the post-RCM map when reordering ran. Pt and PtT
    take the fastest gather format by estimate."""
    device = Adev.device if device is None else torch.device(device)
    n = agg.size
    Pt_csr = tentative_prolongator(agg, n_coarse)
    Pt = _strip_build(Pt_csr, dtype_l, device, timer=timer)
    PtT = _strip_build(Pt_csr.T.tocsr(), dtype_next, device, timer=timer)
    wq = to_device(np.pad(wq_host, (0, pad_to(n) - n)), dtype_l, device, timer)
    P = SmoothedP(Pt=Pt, A=Adev, wq=wq, shape=(n, n_coarse), nnz=P_nnz)
    R = SmoothedR(PtT=PtT, A=Adev, wq=wq, shape=(n_coarse, n), nnz=P_nnz)
    return P, R


def structural_estimate(agg: np.ndarray, n_coarse: int, Adev, dtype_l) -> float:
    """Estimated seconds of one R and one P apply on the structural path:
    the Pt and PtT gather matvecs plus two A matvecs at the stream rate."""
    Pt_csr = tentative_prolongator(agg, n_coarse)
    t_Pt = _strip_time(Pt_csr, dtype_l)
    t_PtT = _strip_time(Pt_csr.T.tocsr(), dtype_l)
    if not np.isfinite(t_Pt) or not np.isfinite(t_PtT):
        return float("inf")
    return t_Pt + t_PtT + 2 * device_bytes(Adev) / BSR_STREAM_BPS
