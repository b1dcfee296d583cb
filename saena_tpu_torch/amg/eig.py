"""Largest-eigenvalue estimation for the Chebyshev smoother.

lambda_max(D^{-1} A) with the reference's 1.0001 safety factor (ref
find_eig_lamlan, lamlan_saena.h:13-79), by Lanczos on the similar symmetric
form D^{-1/2} A D^{-1/2} on the host, its matvecs in native code
(_native/strength.cpp, scipy's per-row accumulation order) or scipy without
a toolchain; ``eig_max_invdiag_device`` is a power iteration over a matvec
closure on the device.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from saena_tpu_torch import _native
from saena_tpu_torch.runtime import resolve_device

SAFETY = 1.0001


def eig_max_invdiag_host(A: sp.csr_matrix) -> float:
    """lambda_max(D^{-1} A) via the symmetric similar matrix."""
    n = A.shape[0]
    d = A.diagonal()
    d_safe = np.where(d == 0, 1.0, d)
    dinv_sqrt = 1.0 / np.sqrt(np.abs(d_safe))
    # S = diag(ds) A diag(ds) by direct data scaling: the per-entry products
    # (ds_i * a_ij) * ds_j without two intermediate CSRs
    A = A.tocsr()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    S = sp.csr_matrix(
        ((dinv_sqrt[rows] * A.data) * dinv_sqrt[A.indices],
         A.indices, A.indptr), shape=A.shape)
    S.has_sorted_indices = A.has_sorted_indices
    if n <= 512:
        lam = float(np.linalg.eigvalsh(np.asarray(S.todense()))[-1])
    elif n <= 6144:
        # endpoint-sensitive matrices need the tight bound of the
        # reorthogonalized sweep; it is affordable up to mid-size levels
        lam = _lanczos_reorth_host(S)
    else:
        lam = _lanczos_host(S)
    return lam * SAFETY


def _top_ritz_tridiag(alphas, betas, beta_last: float):
    """(top Ritz value, residual bound) of the Lanczos tridiagonal through
    the LAPACK tridiagonal driver."""
    k = len(alphas)
    if k == 1:
        return float(alphas[0]), abs(beta_last)
    try:
        w, v = sla.eigh_tridiagonal(
            np.asarray(alphas), np.asarray(betas[: k - 1]),
            select="i", select_range=(k - 1, k - 1))
        return float(w[0]), float(abs(beta_last * v[-1, 0]))
    except (sla.LinAlgError, ValueError):
        T = (np.diag(alphas) + np.diag(betas[: k - 1], 1)
             + np.diag(betas[: k - 1], -1))
        evals, evecs = np.linalg.eigh(T)
        return float(evals[-1]), float(abs(beta_last * evecs[-1, -1]))


def _lanczos_reorth_host(S, m: int = 40, blocks: int = 6,
                         rtol: float = 1e-7) -> float:
    """Lanczos with full reorthogonalization for mid-size levels: returns
    ritz + bound within ~rtol of lambda_max. O(m^2 n)."""
    n = S.shape[0]
    mv = _host_matvec(S)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    V = np.empty((blocks * m + 1, n))
    V[0] = v
    alphas, betas = [], []
    j = 0
    ritz = bound = 0.0
    for _ in range(blocks):
        for _ in range(m):
            w = mv(V[j])
            a = float(V[j] @ w)
            alphas.append(a)
            w -= a * V[j]
            if j > 0:
                w -= betas[-1] * V[j - 1]
            w -= V[: j + 1].T @ (V[: j + 1] @ w)   # full reorth
            b = float(np.linalg.norm(w))
            if b <= 64 * np.finfo(np.float64).eps * max(
                    1.0, max(abs(x) for x in alphas)):
                T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
                return float(np.linalg.eigvalsh(T)[-1])
            betas.append(b)
            V[j + 1] = w / b
            j += 1
        # full eigh, not the tridiagonal driver: endpoint-sensitive matrices
        # flip pinned iteration counts on a one-ulp lambda change
        T = np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
        evals, evecs = np.linalg.eigh(T)
        ritz = float(evals[-1])
        bound = abs(betas[-1] * evecs[-1, -1])
        if bound <= rtol * abs(ritz):
            return ritz + bound
    return ritz + bound


def _host_matvec(S):
    """S @ x as a closure: the native OpenMP CSR SpMV when a toolchain
    exists (scipy's per-row sequential accumulation, so the Lanczos
    iterates are bit-identical), scipy otherwise. The arrays are converted
    once, outside the loop."""
    if not _native.have_native():
        return lambda x: S @ x
    S = S.tocsr()
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    data = np.ascontiguousarray(S.data, dtype=np.float64)
    return lambda x: _native.csr_matvec(indptr, indices, data, x)


def _lanczos_host(S, m: int = 96, rtol: float = 1e-6) -> float:
    """Plain 3-term Lanczos for the extreme Ritz value (the reference runs a
    plain recurrence too, lamlan_saena.h:13-79). Orthogonality loss only
    duplicates converged extreme Ritz values, so the maximum is unharmed.
    Returns ritz + residual bound so the Chebyshev interval sits at or above
    lambda_max. Cost: <= m SpMVs + O(m n)."""
    n = S.shape[0]
    mv = _host_matvec(S)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    v_prev = np.zeros(n)
    beta_prev = 0.0
    alphas: list[float] = []
    betas: list[float] = []
    ritz_prev = -np.inf
    ritz = bound = 0.0
    max_abs_alpha = 1.0

    for j in range(m):
        w = mv(v) - beta_prev * v_prev
        a = float(v @ w)
        alphas.append(a)
        max_abs_alpha = max(max_abs_alpha, abs(a))
        w -= a * v
        b = float(np.linalg.norm(w))
        # relative breakdown test: Krylov exhaustion leaves a roundoff-size b
        if b <= 64 * np.finfo(np.float64).eps * max_abs_alpha:
            ritz, bound = _top_ritz_tridiag(alphas, betas, 0.0)
            return ritz
        v_prev, v = v, w / b
        beta_prev = b
        if (j + 1) % 4 == 0 or j == m - 1:
            ritz, bound = _top_ritz_tridiag(alphas, betas, beta_prev)
            # converged when the residual bound is small or the top Ritz
            # value has stagnated
            if bound <= 1e-4 * abs(ritz) or \
                    abs(ritz - ritz_prev) <= rtol * abs(ritz):
                return ritz + min(bound, 1e-3 * abs(ritz))
            ritz_prev = ritz
        betas.append(b)
    return ritz + min(bound, 1e-3 * abs(ritz))


def _power_iteration_host(S, iters: int = 100, tol: float = 1e-5) -> float:
    """Power iteration for the largest eigenvalue of S (host, scipy
    matvecs): stops when the Rayleigh quotient moves by less than ``tol``
    relative."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(S.shape[0])
    v /= np.linalg.norm(v)
    lam = 0.0
    for _ in range(iters):
        w = S @ v
        lam_new = float(v @ w)
        nw = np.linalg.norm(w)
        if nw == 0:
            return 0.0
        v = w / nw
        if abs(lam_new - lam) < tol * abs(lam_new):
            lam = lam_new
            break
        lam = lam_new
    return lam


def eig_max_invdiag_device(matvec, inv_diag: torch.Tensor, n_pad: int, dtype,
                           iters: int = 60, seed: int = 0,
                           device=None) -> torch.Tensor:
    """Power iteration for lambda_max(D^{-1} A) with only a matvec closure
    (the JAX package's, for a matvec under jit or over a mesh): ``iters``
    steps from a normal start vector drawn by a ``torch.Generator`` seeded
    with ``seed`` (on the CPU, then moved to ``device``, the card unless
    named), the Rayleigh quotient times SAFETY. Returns a 0-d tensor."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(n_pad, generator=gen, dtype=dtype).to(device)
    for _ in range(iters):
        w = inv_diag * matvec(v)
        v = w / torch.linalg.vector_norm(w)
    w = inv_diag * matvec(v)
    return torch.dot(v, w) / torch.dot(v, v) * SAFETY
