"""Cross-library comparison baselines.

The reference compile-gates PETSc/CombBLAS comparison paths
(petsc_functions.cpp `petsc_solve`/`petsc_check_matmat`,
combblas_functions.cpp) to validate its solves and SpGEMM against
independent implementations. petsc4py is not available here; scipy plays
that role: direct sparse LU, scipy CG, and exact sparse products.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def solve_scipy_direct(A: sp.spmatrix, rhs: np.ndarray) -> np.ndarray:
    """Sparse-LU oracle (the reference's SuperLU-vs-GMRES check)."""
    return spla.spsolve(A.tocsc(), rhs)


def solve_scipy_cg(A: sp.spmatrix, rhs: np.ndarray, tol: float = 1e-8,
                   maxiter: int = 10000):
    """scipy CG oracle; returns (u, n_iters)."""
    it = {"n": 0}

    def cb(_):
        it["n"] += 1

    u, info = spla.cg(A, rhs, rtol=tol, maxiter=maxiter, callback=cb)
    return u, it["n"]


def check_matmat(A: sp.spmatrix, B: sp.spmatrix, C: sp.spmatrix,
                 tol: float = 1e-10) -> float:
    """Max abs deviation of C from A@B (ref petsc_check_matmat,
    petsc_functions.cpp:758)."""
    d = (A @ B) - C
    return float(np.abs(d.data).max()) if d.nnz else 0.0


def check_triple_product(R, A, P, Ac, tol: float = 1e-10) -> float:
    """RAP oracle (ref petsc_check_matmatmat, petsc_functions.cpp:554)."""
    d = (R @ A @ P) - Ac
    return float(np.abs(d.data).max()) if d.nnz else 0.0


def matrix_diff(A: sp.spmatrix, B: sp.spmatrix) -> float:
    """Max abs entry difference (ref petsc_mat_diff / amg::matrix_diff)."""
    d = A - B
    return float(np.abs(d.data).max()) if d.nnz else 0.0
