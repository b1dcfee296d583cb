"""1-D row partitioning (host, setup-time).

The reference's nnz-balanced repartition builds an nprocs^2-bucket histogram
of nnz and picks row splitters so each rank holds ~nnz_g/nprocs nonzeros
(saena_matrix_repart.cpp:3-326), switching to equal-row splitting when the
matrix is dense enough (repart_row, :1220). Here the split is computed
directly from the row-nnz prefix sum — the matrix is host-resident at setup,
so no histogram approximation is needed.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def equal_row_split(n: int, d: int) -> np.ndarray:
    """split[i] = first row of device i; len d+1 (ref repartition_row)."""
    base = n // d
    rem = n % d
    counts = np.full(d, base, dtype=np.int64)
    counts[:rem] += 1
    return np.concatenate([[0], np.cumsum(counts)])


def subset_split(A: sp.csr_matrix, d_total: int, d_active: int,
                 repart_thre: float = 0.1,
                 switch_repart: bool = True) -> np.ndarray:
    """nnz-balanced split over only the FIRST ``d_active`` devices, padded to
    ``d_total + 1`` boundaries with empty trailing blocks. This is the
    device-subset analog of processor shrinking (ref shrink_cpu,
    saena_matrix_shrink.cpp:167: entries gather onto the leading ranks and
    the rest go inactive) — inactive devices hold zero rows and contribute
    zero work and zero halo volume."""
    d_active = max(1, min(d_active, d_total))
    inner = nnz_balanced_split(A, d_active, repart_thre, switch_repart)
    if d_active == d_total:
        return inner
    pad = np.full(d_total - d_active, A.shape[0], dtype=np.int64)
    return np.concatenate([inner, pad])


def nnz_balanced_split(A: sp.csr_matrix, d: int, repart_thre: float = 0.1,
                       switch_repart: bool = True) -> np.ndarray:
    """Row split with ~equal nnz per device. When ``switch_repart`` is on,
    falls back to equal rows when density >= repart_thre (the reference's
    repart_row switch, saena_object_setup2.cpp:292-298, gated exactly like
    its ``switch_repart && density >= repart_thre``); tiny matrices always
    split by rows."""
    n = A.shape[0]
    density = A.nnz / max(1, n * n)
    if (switch_repart and density >= repart_thre) or n < 4 * d:
        return equal_row_split(n, d)
    csum = np.concatenate([[0], np.cumsum(np.diff(A.tocsr().indptr))])
    targets = (np.arange(1, d) * (A.nnz / d))
    inner = np.searchsorted(csum, targets)
    split = np.concatenate([[0], inner, [n]]).astype(np.int64)
    # enforce monotonicity (degenerate empty blocks allowed, like the
    # reference's active_minor ranks)
    return np.maximum.accumulate(split)
