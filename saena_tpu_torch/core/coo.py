"""Host-side COO ingest and assembly.

Replaces the reference's set()/set2() duplicate handling
(saena_matrix.cpp:403-513), setup_initial_data/remove_duplicates
(saena_matrix_setup.cpp:21-278) and remove_boundary_nodes
(saena_matrix_setup.cpp:281-505) with a vectorized numpy sort on the host.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

ALMOST_ZERO = 1e-14  # ref: data_struct.h:41


class CooBuilder:
    """Accumulates COO triples with Saena's duplicate semantics.

    - ``add_duplicates=False`` (ref set(), saena_matrix.cpp:403): a later
      entry with the same (row, col) *replaces* the earlier one.
    - ``add_duplicates=True`` (ref set2(), :460): duplicates are *summed*
      (the FEM assembly path).
    """

    def __init__(self, shape: tuple[int, int] | None = None, add_duplicates: bool = False):
        self.shape = shape
        self.add_duplicates = add_duplicates
        self._rows: list[np.ndarray] = []
        self._cols: list[np.ndarray] = []
        self._vals: list[np.ndarray] = []

    def set(self, rows, cols, vals) -> None:
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64)).ravel()
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64)).ravel()
        vals = np.atleast_1d(np.asarray(vals, dtype=np.float64)).ravel()
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError("rows/cols/vals must have identical shapes")
        self._rows.append(rows)
        self._cols.append(cols)
        self._vals.append(vals)

    def set_block(self, rows, cols, vals, row_offset: int = 0,
                  col_offset: int = 0) -> None:
        """Entries of a contiguous block at an offset (ref saena.cpp, the
        set overload with offsets)."""
        self.set(np.asarray(rows) + row_offset, np.asarray(cols) + col_offset,
                 vals)

    @property
    def nnz_buffered(self) -> int:
        return sum(r.size for r in self._rows)

    def assemble(self, drop_almost_zero: bool = True) -> sp.csr_matrix:
        """Sort + dedup + drop near-zeros; returns canonical CSR."""
        if not self._rows:
            raise ValueError("no entries were set")
        rows = np.concatenate(self._rows)
        cols = np.concatenate(self._cols)
        vals = np.concatenate(self._vals)
        n = self.shape[0] if self.shape else int(max(rows.max(), cols.max())) + 1
        m = self.shape[1] if self.shape else n

        if self.add_duplicates:
            a = sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()
            a.sum_duplicates()
        else:
            # replace semantics: keep the LAST occurrence of each (row, col)
            order = np.lexsort((np.arange(rows.size), cols, rows))  # stable by (row, col, seq)
            rows, cols, vals = rows[order], cols[order], vals[order]
            keep = np.ones(rows.size, dtype=bool)
            keep[:-1] = (rows[:-1] != rows[1:]) | (cols[:-1] != cols[1:])
            a = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, m))

        if drop_almost_zero:
            a.data[np.abs(a.data) < ALMOST_ZERO] = 0.0
            a.eliminate_zeros()
        a.sort_indices()
        return a


def coo_to_csr(rows, cols, vals, shape=None) -> sp.csr_matrix:
    """Canonical CSR of COO triples, duplicates summed."""
    b = CooBuilder(shape=shape, add_duplicates=True)
    b.set(rows, cols, vals)
    return b.assemble()


def remove_boundary_nodes(A: sp.csr_matrix, rhs: np.ndarray | None = None):
    """Extract Dirichlet rows (rows whose only entry is the diagonal) from A.

    Single-entry diagonal rows are split off and the interior system is
    renumbered densely. Returns (A_interior, interior_idx, bound_idx,
    bound_diag, rhs_interior). The boundary solution is u_b = rhs_b / diag_b
    (ref add_boundary_sol, saena_object.cpp:753-769).
    """
    A = A.tocsr()
    nnz_per_row = np.diff(A.indptr)
    one = nnz_per_row == 1
    diag_col = np.full(A.shape[0], -1, dtype=np.int64)
    diag_col[one] = A.indices[A.indptr[:-1][one]]
    is_bound = one & (diag_col == np.arange(A.shape[0]))
    if not is_bound.any():
        return A, np.arange(A.shape[0]), np.array([], dtype=np.int64), np.array([]), rhs

    interior = np.flatnonzero(~is_bound)
    bound = np.flatnonzero(is_bound)
    bound_diag = A.diagonal()[bound]
    Ai = A[interior][:, interior].tocsr()
    rhs_i = rhs[interior] if rhs is not None else None
    return Ai, interior, bound, bound_diag, rhs_i
