"""Matrix/RHS generators mirroring the reference's aux_functions2.cpp.

All generators return scipy CSR on the host (setup side); the manufactured
solution and rhs follow the reference's formulas so convergence histories
are comparable. References: laplacian2D (aux_functions2.cpp:3),
laplacian3D (:254), laplacian3D_set_rhs (:629), laplacian3D_check_solution
(:702), band_matrix (:1296), random_symm_matrix (:1384).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian2D(mx: int, my: int) -> sp.csr_matrix:
    """5-point 2-D Laplacian on [0,1]^2 with decoupled Dirichlet boundary
    rows (identity), matching aux_functions2.cpp:3-88."""
    hx = 1.0 / (mx - 1)
    hy = 1.0 / (my - 1)
    cx, cy = 1.0 / hx**2, 1.0 / hy**2

    i, j = np.meshgrid(np.arange(mx), np.arange(my), indexing="ij")
    i, j = i.T.ravel(), j.T.ravel()  # node = mx*j + i ordering
    node = mx * j + i
    boundary = (i == 0) | (j == 0) | (i == mx - 1) | (j == my - 1)

    rows, cols, vals = [], [], []

    def _add(r, c, v):
        rows.append(r)
        cols.append(c)
        vals.append(np.broadcast_to(v, r.shape).astype(np.float64))

    b = node[boundary]
    _add(b, b, 1.0)

    it = node[~boundary]
    ii, jj = i[~boundary], j[~boundary]
    _add(it, it, 2.0 * (cx + cy))
    for di, dj, c, edge in ((-1, 0, -cx, ii - 1 != 0), (1, 0, -cx, ii + 1 != mx - 1),
                            (0, -1, -cy, jj - 1 != 0), (0, 1, -cy, jj + 1 != my - 1)):
        m = edge
        _add(it[m], it[m] + di + mx * dj, c)

    n = mx * my
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    )


def laplacian3D(mx: int, my: int, mz: int) -> sp.csr_matrix:
    """7-point 3-D Laplacian, PETSc ex45 style (aux_functions2.cpp:254-373):
    boundary nodes are identity rows; interior rows omit couplings into the
    boundary. node = mx*my*k + mx*j + i."""
    hx, hy, hz = 1.0 / (mx - 1), 1.0 / (my - 1), 1.0 / (mz - 1)
    cx, cy, cz = 1.0 / hx**2, 1.0 / hy**2, 1.0 / hz**2

    k, j, i = np.meshgrid(np.arange(mz), np.arange(my), np.arange(mx), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    node = mx * my * k + mx * j + i
    boundary = (i == 0) | (j == 0) | (k == 0) | (i == mx - 1) | (j == my - 1) | (k == mz - 1)

    rows, cols, vals = [], [], []

    def _add(r, c, v):
        rows.append(r)
        cols.append(c)
        vals.append(np.broadcast_to(v, r.shape).astype(np.float64))

    b = node[boundary]
    _add(b, b, 1.0)

    it = node[~boundary]
    ii, jj, kk = i[~boundary], j[~boundary], k[~boundary]
    _add(it, it, 2.0 * (cx + cy + cz))
    for delta, c, keep in (
        (-mx * my, -cz, kk - 1 != 0),
        (-mx, -cy, jj - 1 != 0),
        (-1, -cx, ii - 1 != 0),
        (1, -cx, ii + 1 != mx - 1),
        (mx, -cy, jj + 1 != my - 1),
        (mx * my, -cz, kk + 1 != mz - 1),
    ):
        _add(it[keep], it[keep] + delta, c)

    n = mx * my * mz
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    )


def _grid_sines(mx: int, my: int, mz: int) -> np.ndarray:
    hx, hy, hz = 1.0 / (mx - 1), 1.0 / (my - 1), 1.0 / (mz - 1)
    x = np.sin(2 * np.pi * np.arange(mx) * hx)
    y = np.sin(2 * np.pi * np.arange(my) * hy)
    z = np.sin(2 * np.pi * np.arange(mz) * hz)
    return np.einsum("k,j,i->kji", z, y, x)


def laplacian3D_set_rhs(mx: int, my: int, mz: int) -> np.ndarray:
    """rhs = 12 pi^2 sin(2 pi x) sin(2 pi y) sin(2 pi z) (aux_functions2.cpp:629)."""
    return (12 * np.pi**2 * _grid_sines(mx, my, mz)).ravel()


def laplacian3D_solution(mx: int, my: int, mz: int) -> np.ndarray:
    """Manufactured solution u = sin(2 pi x) sin(2 pi y) sin(2 pi z)
    (aux_functions2.cpp:702 laplacian3D_check_solution)."""
    return _grid_sines(mx, my, mz).ravel()


def band_matrix(M: int, bandwidth: int) -> sp.csr_matrix:
    """Symmetric band matrix, A[i,j] = 1/(i+j+1) for |i-j| <= bandwidth
    (aux_functions2.cpp:1296-1345)."""
    if bandwidth >= M:
        raise ValueError("bandwidth must be smaller than the matrix size")
    rows, cols, vals = [], [], []
    i = np.arange(M)
    for d in range(bandwidth + 1):
        r = i[: M - d] if d else i
        c = r + d
        v = 1.0 / (r + c + 1)
        rows.append(r)
        cols.append(c)
        vals.append(v)
        if d:
            rows.append(c)
            cols.append(r)
            vals.append(v)
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(M, M)
    )


def random_symm_matrix(M: int, density: float, seed: int = 0) -> sp.csr_matrix:
    """Random SPD-ish symmetric matrix: uniform(0,1) diagonal plus symmetric
    random off-diagonal pairs to reach ~density*M^2 nnz
    (aux_functions2.cpp:1384-1460, deterministic seed instead of random_device)."""
    if not (0 < density <= 1):
        raise ValueError("density must be in (0, 1]")
    rng = np.random.default_rng(seed)
    nnz_target = int(density * M * M)
    diag_v = rng.uniform(0, 1, size=M)
    n_off = max(0, (nnz_target - M) // 2)
    # oversample then keep strictly-lower entries, like the reference's loop
    ii = rng.integers(0, M, size=3 * n_off + 16)
    jj = rng.integers(0, M, size=3 * n_off + 16)
    vv = rng.uniform(0, 1, size=3 * n_off + 16)
    m = ii > jj
    ii, jj, vv = ii[m][:n_off], jj[m][:n_off], vv[m][:n_off]
    rows = np.concatenate([np.arange(M), ii, jj])
    cols = np.concatenate([np.arange(M), jj, ii])
    vals = np.concatenate([diag_v, vv, vv])
    a = sp.csr_matrix((vals, (rows, cols)), shape=(M, M))
    a.sum_duplicates()
    # duplicates would break symmetry of summed values only if (i,j) pairs
    # collide asymmetrically; the construction above is symmetric by pairs.
    return a
