"""Galerkin triple product, filtering, and sparsification (host, setup time).

The reference computes Ac = R*A*P with a ring-pipelined distributed SpGEMM
(triple_mat_mult / matmat_CSC, saena_object_setup_matmat.cpp). Setup runs
on the host here, so the product is a host sparse matmul: the native
Gustavson kernel (_native/spgemm.cpp), torch's CPU kernel without a
toolchain.

filter_lump(): diagonal lumping of small entries (ref
saena_object_setup2.cpp:852-918): dropped off-diagonal values are added to
the diagonal so row sums are preserved. Threshold schedule: filter_thre *
10^(filter_rate*(lvl - filter_start)), capped at filter_max (ref
saena_object.h:203-210).

sparsify_majid(): stochastic sparsifier keeping entries with probability
proportional to val^2, diagonal always kept (ref saena_object_sparsify.cpp).
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch import _native


def _torch_csr(M: sp.csr_matrix) -> torch.Tensor:
    M = M.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)),
        torch.from_numpy(M.indices.astype(np.int64)),
        torch.from_numpy(M.data), size=M.shape)


def _spgemm(X: sp.csr_matrix, Y: sp.csr_matrix,
            nt: int = 0) -> sp.csr_matrix:
    """Host SpGEMM: the native Gustavson kernel on ``nt`` OpenMP threads (0
    = OpenMP's default; shard tasks that already run in parallel pass 1),
    then torch's CPU sparse kernel, then scipy where torch has none for
    these operands (the stand-in for the reference's mkl_dcsrmultcsr base
    case, saena_object_setup_matmat.cpp:214)."""
    Z = _native.spgemm_csr(X.tocsr(), Y.tocsr(), nt=nt)
    if Z is not None:
        return Z
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            Z = torch.sparse.mm(_torch_csr(X), _torch_csr(Y))
        return sp.csr_matrix(
            (Z.values().numpy(), Z.col_indices().numpy(),
             Z.crow_indices().numpy()), shape=tuple(Z.shape))
    except (RuntimeError, NotImplementedError):
        return (X @ Y).tocsr()


def galerkin_product(R: sp.csr_matrix, A: sp.csr_matrix, P: sp.csr_matrix) -> sp.csr_matrix:
    Ac = _spgemm(R.tocsr(), _spgemm(A.tocsr(), P.tocsr()))
    Ac.sum_duplicates()
    Ac.sort_indices()
    return Ac


def filter_threshold(level: int, filter_thre: float, filter_max: float,
                     filter_start: int, filter_rate: int) -> float:
    if level < filter_start:
        return 0.0
    t = filter_thre * 10.0 ** (filter_rate * (level - filter_start))
    return min(t, filter_max)


def filter_lump(Ac: sp.csr_matrix, thre: float) -> sp.csr_matrix:
    """Drop |offdiag| < thre, lumping the dropped mass into the diagonal."""
    if thre <= 0.0:
        return Ac
    Ac = Ac.tocsr()
    n = Ac.shape[0]
    rows = np.repeat(np.arange(n), np.diff(Ac.indptr))
    is_diag = rows == Ac.indices
    small = ~is_diag & (np.abs(Ac.data) < thre)
    if not small.any():
        return Ac
    lump = np.zeros(n)
    np.add.at(lump, rows[small], Ac.data[small])
    data = Ac.data.copy()
    data[small] = 0.0
    # a row without a diagonal entry cannot absorb its lumped mass in place
    didx = np.flatnonzero(is_diag)
    data[didx] += lump[rows[didx]]
    missing = lump != 0
    missing[rows[didx]] = False
    # copy the structure arrays: eliminate_zeros() mutates them in place
    out = sp.csr_matrix((data, Ac.indices.copy(), Ac.indptr.copy()),
                        shape=Ac.shape)
    if missing.any():
        out = (out + sp.diags(np.where(missing, lump, 0.0))).tocsr()
    out.eliminate_zeros()
    out.sort_indices()
    return out


def sparsify_majid(Ac: sp.csr_matrix, sample_sz_percent: float, seed: int = 0) -> sp.csr_matrix:
    """Keep ~sample_sz_percent of the off-diagonal entries, sampled with
    probability proportional to val^2; kept entries keep their values and
    the diagonal is always kept."""
    if sample_sz_percent >= 1.0:
        return Ac
    coo = Ac.tocoo()
    offdiag = coo.row != coo.col
    n_off = int(offdiag.sum())
    target = int(sample_sz_percent * Ac.nnz)
    keep_off = max(0, target - (Ac.nnz - n_off))
    if keep_off >= n_off:
        return Ac
    w = coo.data[offdiag] ** 2
    p = w / w.sum()
    rng = np.random.default_rng(seed)
    sel = rng.choice(n_off, size=keep_off, replace=False, p=p)
    keep = ~offdiag
    off_idx = np.flatnonzero(offdiag)
    keep[off_idx[sel]] = True
    out = sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=Ac.shape)
    out.sort_indices()
    return out
