"""The plain reference of the configurations whose ``problem`` is
``laplacian3D``, in NumPy and SciPy.

A frozen copy of the 7-point 3-D Laplacian of Saena's
``experiments/Poisson.cpp`` (``laplacian3D``, PETSc ex45 style,
``aux_functions2.cpp:254-373``) and of its manufactured right-hand side
(``laplacian3D_set_rhs``, ``aux_functions2.cpp:629``), so that the
benchmark's inputs do not move when the program does. The judge's residual
(``residual.py``) is taken over the full system, boundary rows included, so
the reference needs no split of the Dirichlet rows. It imports nothing of
the program.

Each problem's module here gives ``matrix(config)`` and
``manufactured_rhs(config)``; this one reads the configuration's ``grid``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian3D(m: int) -> sp.csr_matrix:
    """The m x m x m grid's 7-point Laplacian on [0, 1]^3: boundary nodes
    are identity rows, interior rows omit their couplings into the
    boundary; node = m*m*k + m*j + i."""
    h = 1.0 / (m - 1)
    c = 1.0 / h**2
    k, j, i = np.meshgrid(np.arange(m), np.arange(m), np.arange(m), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    node = m * m * k + m * j + i
    boundary = (i == 0) | (j == 0) | (k == 0) | (i == m - 1) | (j == m - 1) | (k == m - 1)

    b = node[boundary]
    rows, cols, vals = [b], [b], [np.ones(b.size)]
    it = node[~boundary]
    ii, jj, kk = i[~boundary], j[~boundary], k[~boundary]
    rows.append(it)
    cols.append(it)
    vals.append(np.full(it.size, 2.0 * (c + c + c)))
    for delta, keep in ((-m * m, kk - 1 != 0), (-m, jj - 1 != 0), (-1, ii - 1 != 0),
                        (1, ii + 1 != m - 1), (m, jj + 1 != m - 1),
                        (m * m, kk + 1 != m - 1)):
        rows.append(it[keep])
        cols.append(it[keep] + delta)
        vals.append(np.full(int(keep.sum()), -c))
    n = m**3
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))


def laplacian3D_set_rhs(m: int) -> np.ndarray:
    """12 pi^2 sin(2 pi x) sin(2 pi y) sin(2 pi z) on the grid's nodes."""
    s = np.sin(2 * np.pi * np.arange(m) * (1.0 / (m - 1)))
    return (12 * np.pi**2 * np.einsum("k,j,i->kji", s, s, s)).ravel()


def matrix(config: dict) -> sp.csr_matrix:
    return laplacian3D(int(config["grid"]))


def manufactured_rhs(config: dict) -> np.ndarray:
    return laplacian3D_set_rhs(int(config["grid"]))
