"""Smoothers.

Jacobi (ref saena_matrix.cpp:1044-1071) and Chebyshev (ref :1074-1131,
classic 3-term recurrence on [0.13*eig, eig] of D^{-1}A, with homg's
coefficients so iteration counts line up).
"""
from __future__ import annotations


def _update(A, dinv, u, rhs, c: float, add_x: bool = True):
    """[u +] c * dinv * (rhs - A u). A format with a fused one-pass kernel
    (DiaMatrix) takes it when its dtype is the vector dtype; otherwise the
    matvec runs at the operator's dtype and the residual arithmetic at the
    vector's (ref saena_object.cpp:241-285: only the matvec is reduced)."""
    fu = getattr(A, "fused_update", None)
    if fu is not None and A.dtype == u.dtype:
        return fu(u, rhs, dinv=dinv, c=c, add_x=add_x)
    z = dinv * (rhs - A.matvec(u).to(u.dtype)) * c
    return u + z if add_x else z


def jacobi(A, inv_diag, u, rhs, iters: int, omega: float = 2.0 / 3.0,
           u_is_zero: bool = False):
    """u <- u - omega D^{-1} (A u - rhs), ``iters`` times. u_is_zero elides
    the first A@0 matvec."""
    for k in range(iters):
        if k == 0 and u_is_zero:
            u = omega * inv_diag * rhs
        else:
            u = _update(A, inv_diag, u, rhs, float(omega))
    return u


def chebyshev(A, inv_diag, eig_max: float, u, rhs, iters: int,
              u_is_zero: bool = False):
    """Chebyshev smoothing; eig_max is lambda_max(D^{-1}A) with the 1.0001
    safety factor already applied. u_is_zero elides the first A@0 matvec:
    the V-cycle always pre-smooths from a zero iterate."""
    if iters <= 0:
        return u
    alpha = 0.13 * eig_max
    beta = eig_max
    delta = (beta - alpha) / 2.0
    theta = (beta + alpha) / 2.0
    s1 = theta / delta
    rhok = 1.0 / s1

    if u_is_zero:
        d = inv_diag * rhs * (1.0 / theta)
        u = d
    else:
        d = _update(A, inv_diag, u, rhs, 1.0 / theta, add_x=False)
        u = u + d
    for _ in range(1, iters):
        rhokp1 = 1.0 / (2.0 * s1 - rhok)
        d1 = rhokp1 * rhok
        d2 = 2.0 * rhokp1 / delta
        rhok = rhokp1
        res = _update(A, inv_diag, u, rhs, float(d2), add_x=False)
        d = d1 * d + res
        u = u + d
    return u


def smooth_operator(level):
    """The operator of a level's smoothers and V-cycle residual: its
    reduced-precision twin when one was built (Options.smooth_dtype), else
    A. The outer Krylov method always uses A."""
    return level.A if level.A_smooth is None else level.A_smooth


def smooth(level, params, u, rhs, iters: int, u_is_zero: bool = False):
    """Dispatch like saena_object::smooth (saena_object.tpp:5-16), on the
    level's smoothing operator."""
    if iters <= 0:
        return u
    A = smooth_operator(level)
    if params.smoother == "jacobi":
        return jacobi(A, level.inv_diag, u, rhs, iters,
                      params.jacobi_omega, u_is_zero=u_is_zero)
    elif params.smoother == "chebyshev":
        return chebyshev(A, level.inv_diag, level.eig_max, u, rhs,
                         iters, u_is_zero=u_is_zero)
    raise ValueError(f"unknown smoother {params.smoother!r}")
