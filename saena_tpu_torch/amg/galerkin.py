"""Galerkin triple product, filtering, and sparsification (host, setup time).

The reference computes Ac = R*A*P with a ring-pipelined distributed SpGEMM
(triple_mat_mult / matmat_CSC, saena_object_setup_matmat.cpp). Setup runs
on the host here, so the product is a host sparse matmul: the native
Gustavson kernel (_native/spgemm.cpp), torch's CPU kernel without a
toolchain. A product takes the card instead (K5, ops/csr_spgemm.py, bit for
bit the native kernel) when the setup's device is a CUDA device, the
product has at least CARD_MIN_MACS multiply-adds and both operands are
canonical float64 CSR (``takes_card``); W = A*P then stays on the card for
R*W. Each product is recorded in the setup's PhaseTimer (``products``).

filter_lump(): diagonal lumping of small entries (ref
saena_object_setup2.cpp:852-918): dropped off-diagonal values are added to
the diagonal so row sums are preserved. Threshold schedule: filter_thre *
10^(filter_rate*(lvl - filter_start)), capped at filter_max (ref
saena_object.h:203-210).

sparsify_majid(): stochastic sparsifier keeping entries with probability
proportional to val^2, diagonal always kept (ref saena_object_sparsify.cpp).
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch import _native
from saena_tpu_torch.ops.csr_spgemm import DeviceCsr, csr_spgemm, is_canonical
from saena_tpu_torch.runtime import span

# A product of at least this many multiply-adds runs on the card.
# Measured by tools/spgemm_timing.py on NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit beside its 8-core host, the card's time with both operands'
# upload and the product's download (PERF.md, the K5 crossover): with one column
# window the card was ahead from 5.9 M multiply-adds and behind at 1.7 M;
# with 17 windows (an output 415,292 columns wide) it was behind the host's
# 8 cores at 92 M (0.36 against 0.21 s), but such wide products come from
# the shard-parallel levels, whose host products run on one core each.
CARD_MIN_MACS = 20_000_000


def _torch_csr(M: sp.csr_matrix) -> torch.Tensor:
    M = M.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)),
        torch.from_numpy(M.indices.astype(np.int64)),
        torch.from_numpy(M.data), size=M.shape)


def spgemm_macs(X: sp.csr_matrix, Y) -> int:
    """The multiply-adds of X @ Y: the sum over X's entries of the lengths
    of the Y rows they reach."""
    ylen = Y.row_lengths() if isinstance(Y, DeviceCsr) else np.diff(Y.indptr)
    return int(ylen.astype(np.int32)[X.indices].sum(dtype=np.int64))


def takes_card(device, macs: int, canonical: bool) -> bool:
    """The route of one product: the card (K5) when the setup's device is a
    CUDA device, the product has at least CARD_MIN_MACS multiply-adds and
    its operands are canonical float64 CSR; else the host."""
    return (device is not None and torch.device(device).type == "cuda"
            and macs >= CARD_MIN_MACS and canonical)


def _spgemm(X: sp.csr_matrix, Y, nt: int = 0, device=None, timer=None,
            level: int = -1, keep_on_card: bool = False):
    """X @ Y by the route ``takes_card`` picks, recorded in ``timer``'s
    ``products`` at ``level``. Y may be a DeviceCsr from an earlier product.
    On the card the result stays there with ``keep_on_card``; it comes back
    as a host CSR otherwise. On the host, ``nt`` OpenMP threads (0 =
    OpenMP's default; shard tasks that already run in parallel pass 1)."""
    t0 = time.perf_counter()
    X = X.tocsr()
    if not isinstance(Y, DeviceCsr):
        Y = Y.tocsr()
    macs = spgemm_macs(X, Y)
    canonical = is_canonical(X) and is_canonical(Y)
    if not canonical and is_canonical(X) and takes_card(device, macs, True):
        # The product's bits do not depend on the order of a Y row's
        # entries: an output entry takes at most one product from each Y
        # row, in the order of X's row, on either engine. So a Y with
        # unsorted rows (the P that coarsen_tail's reordering leaves for
        # the lazy updates) goes to the card sorted.
        Ys = Y.sorted_indices()
        if is_canonical(Ys):
            Y, canonical = Ys, True
    if takes_card(device, macs, canonical):
        engine = "card"
        with span("saena.setup.rap.card"):
            dev = torch.device(device)
            Z = csr_spgemm(DeviceCsr.from_host(X, dev),
                           Y if isinstance(Y, DeviceCsr) else DeviceCsr.from_host(Y, dev))
            if not keep_on_card:
                Z = Z.to_host()
    else:
        engine = "host"
        Z = _host_spgemm(X, Y.to_host() if isinstance(Y, DeviceCsr) else Y, nt)
    if timer is not None:
        timer.add_product(level, engine, macs, time.perf_counter() - t0)
    return Z


def _host_spgemm(X: sp.csr_matrix, Y: sp.csr_matrix, nt: int) -> sp.csr_matrix:
    """Host SpGEMM: the native Gustavson kernel, then torch's CPU sparse
    kernel, then scipy where torch has none for these operands (the
    stand-in for the reference's mkl_dcsrmultcsr base case,
    saena_object_setup_matmat.cpp:214)."""
    Z = _native.spgemm_csr(X, Y, nt=nt)
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


def galerkin_product(R: sp.csr_matrix, A: sp.csr_matrix, P: sp.csr_matrix,
                     device=None, timer=None, level: int = -1) -> sp.csr_matrix:
    """Ac = R @ (A @ P), each product by its route (``_spgemm``) for a setup
    on ``device``, recorded in ``timer`` at ``level``."""
    W = _spgemm(A, P, device=device, timer=timer, level=level, keep_on_card=True)
    Ac = _spgemm(R, W, device=device, timer=timer, level=level)
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
