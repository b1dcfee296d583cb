"""Strength-of-connection graph and MIS(1) aggregation (host, setup time).

The reference computes these with distributed halo exchanges
(create_strength_matrix saena_object_setup1.cpp:520-719, aggregation_1_dist
:724-995, an iterative min-index propagation). Here the keep mask and the
MIS(1) aggregation run in native code (_native/strength.cpp, mis1.cpp),
with vectorized numpy versions of the same computations (the fixpoint in
rounds, each one reference while-iteration) where no toolchain exists, so
the aggregates, and with them the hierarchy and the iteration counts,
follow the reference's semantics.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from saena_tpu_torch import _native


def _row_reduce(ufunc, vals, rows, n, identity):
    """Per-row ufunc reduction of (rows, vals) pairs, rows not assumed
    sorted: sorts once (skipped when already sorted), then reduceat."""
    if vals.size == 0:
        return np.full(n, identity)
    if rows.size > 1 and (rows[1:] >= rows[:-1]).all():
        rs, vs = rows, vals
    else:
        order = np.argsort(rows, kind="stable")
        rs, vs = rows[order], vals[order]
    starts = np.searchsorted(rs, np.arange(n))
    out = np.full(n, identity,
                  dtype=vals.dtype if vals.dtype.kind == "f" else np.float64)
    nonempty = starts < vs.size
    # reduceat returns vs[start] for an empty segment: mask those out
    seg = ufunc.reduceat(vs, np.minimum(starts, vs.size - 1))
    counts = np.diff(np.append(starts, vs.size))
    valid = nonempty & (counts > 0)
    out[valid] = seg[valid]
    return out


def _row_min_indices(cand, starts, counts, n, big):
    """Min of cand per row for presorted-by-row entries."""
    out = np.full(n, big, dtype=np.int64)
    if cand.size:
        seg = np.minimum.reduceat(cand, np.minimum(starts, cand.size - 1))
        valid = counts > 0
        out[valid] = seg[valid]
    return out


def strength_graph(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """S_ij = -a_ij / max_{k != i}(-a_ik); keep entries where S_ij > theta or
    S_ji > theta (union symmetrization, strength_matrix.cpp:233-271).
    Returns a boolean-pattern CSR without the diagonal, built directly on
    A's CSR arrays (the kept entries are a subset of A's, in CSR order).
    The keep mask is native (strength.cpp) where a toolchain exists,
    bit-identical to :func:`_strength_keep_numpy`."""
    A = A.tocsr()
    if not A.has_sorted_indices:
        A = A.copy()          # sort a copy: the caller's entry order stays
        A.sort_indices()
    n = A.shape[0]
    indptr, indices, data = A.indptr, A.indices, A.data

    nat = _native.strength_keep(indptr, indices, data, theta) \
        if data.size else None
    keep = nat[0] if nat is not None else \
        _strength_keep_numpy(indptr, indices, data, theta)

    cnt = np.zeros(n, dtype=np.int64)
    if keep.size:
        csum = np.concatenate([[0], np.cumsum(keep)])
        cnt = csum[indptr[1:]] - csum[indptr[:-1]]
    indptr_s = np.concatenate([[0], np.cumsum(cnt)])
    indices_s = indices[keep]
    return sp.csr_matrix(
        (np.ones(indices_s.size, dtype=np.int8), indices_s, indptr_s),
        shape=(n, n))


def _strength_keep_numpy(indptr, indices, data, theta: float) -> np.ndarray:
    """The strength keep mask in numpy: off-diagonal entries whose scaled
    value exceeds theta in their row or in their column."""
    n = indptr.size - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    isdiag = indices == rows
    negv = -data
    # per-row max of -a_ik over off-diagonal entries
    maxrow = np.full(n, -np.inf)
    if negv.size:
        starts = indptr[:-1].astype(np.int64)
        seg = np.maximum.reduceat(np.where(isdiag, -np.inf, negv),
                                  np.minimum(starts, negv.size - 1))
        valid = np.diff(indptr) > 0
        maxrow[valid] = seg[valid]
    # rows with no off-diagonal entries never produce strength edges
    safe = np.where(np.isfinite(maxrow) & (maxrow != 0), maxrow, 1.0)
    s_row = negv / safe[rows]     # scaled by the row's max
    s_col = negv / safe[indices]  # transpose scaling (symmetric-A shortcut)
    return ~isdiag & ((s_row > theta) | (s_col > theta))


def aggregate_mis1(S: sp.csr_matrix):
    """Distance-1 MIS aggregation, reproducing aggregation_1_dist
    (saena_object_setup1.cpp:724-995).

    The fixpoint (:func:`_aggregate_mis1_fixpoint`) resolves to the
    lexicographically first maximal independent set, since a node's
    decision depends only on smaller indices; the native single-pass sweep
    (mis1.cpp, O(nnz)) computes the same aggregation without the rounds.
    Without a toolchain the fixpoint runs.

    Returns (agg, roots): agg[i] = coarse index of node i's aggregate,
    roots = fine indices of the root nodes (sorted)."""
    S = S.tocsr()
    out = _native.mis1_aggregate(S.indptr, S.indices)
    if out is None:
        return _aggregate_mis1_fixpoint(S)
    agg, is_root = out
    roots = np.flatnonzero(is_root)
    coarse_id = np.searchsorted(roots, agg)
    return coarse_id.astype(np.int64), roots


def _aggregate_mis1_fixpoint(S: sp.csr_matrix):
    """The vectorized min-index fixpoint. Each round is one reference
    while-iteration: an undecided node i looks at its strength neighbours j
    that are undecided or roots and takes the minimum index jm; if none is
    below i, i becomes a root; if jm is a decided root, i joins it;
    otherwise i waits for jm to decide."""
    S = S.tocsr()
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices

    decided = np.zeros(n, dtype=bool)
    is_root = np.zeros(n, dtype=bool)
    agg = np.arange(n, dtype=np.int64)  # root fine-index per node

    BIG = n + 1
    counts = np.diff(indptr)
    starts = indptr[:-1]

    while True:
        und = ~decided
        if not und.any():
            break
        eligible = und | is_root
        cand = np.where(eligible[indices], indices, BIG).astype(np.int64)
        jm = _row_min_indices(cand, starts, counts, n, BIG)

        has_cand = jm < np.arange(n)
        new_root = und & ~has_cand
        join = und & has_cand & decided[jm.clip(0, n - 1)]
        if not (new_root.any() or join.any()):
            # the minimum of every waiting chain is always a new root, so
            # this cannot happen; guard against an endless loop regardless
            new_root = und.copy()

        is_root[new_root] = True
        decided[new_root] = True
        agg[join] = jm[join]
        decided[join] = True

    roots = np.flatnonzero(is_root)
    # aggregate_index_update (setup1.cpp:2103): renumber roots to 0..n_c-1
    coarse_id = np.searchsorted(roots, agg)
    return coarse_id.astype(np.int64), roots


def find_aggregation(A: sp.csr_matrix, theta: float, adaptive: bool = False):
    """Strength + aggregation + adaptive-theta loop
    (find_aggregation, saena_object_setup1.cpp:257-441).

    Returns (agg, n_coarse, theta_used)."""
    agg, n_c, theta, _ = _find_aggregation_s(A, theta, adaptive)
    return agg, n_c, theta


def _find_aggregation_s(A: sp.csr_matrix, theta: float, adaptive: bool):
    """find_aggregation that also returns the strength graph it used."""
    S = strength_graph(A, theta)
    agg, roots = aggregate_mis1(S)
    n_c = roots.size
    if adaptive:
        division = A.shape[0] / max(1, n_c)
        th = theta
        while (division < 1.5 or division > 8.0) and 0.2 <= th <= 0.95:
            th = th + 0.05 if division > 8.0 else th - 0.05
            if not (0.2 <= th <= 0.95):
                break
            S = strength_graph(A, th)
            agg, roots = aggregate_mis1(S)
            n_c = roots.size
            division = A.shape[0] / max(1, n_c)
        theta = th
    return agg, n_c, theta, S


def find_aggregation_double(A: sp.csr_matrix, theta: float,
                            adaptive: bool = False):
    """Composed (double) aggregation: aggregate once, build the aggregate
    adjacency graph, and aggregate that once more (the working version of
    the reference's disabled aggregation_2_dist,
    saena_object_setup1.cpp:1375; Options.aggregation="double").

    Returns (agg, n_coarse, theta_used) like find_aggregation."""
    agg1, nc1, theta_used, S1 = _find_aggregation_s(A, theta, adaptive)
    n = A.shape[0]
    T = sp.csr_matrix(
        (np.ones(n), (np.arange(n), agg1)), shape=(n, nc1))
    Sc = (T.T @ S1 @ T).tocsr()
    Sc.setdiag(0)
    Sc.eliminate_zeros()
    agg2, roots2 = aggregate_mis1(Sc)
    return agg2[agg1], roots2.size, theta_used
