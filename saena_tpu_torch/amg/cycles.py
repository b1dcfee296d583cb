"""The V-cycle, mirroring saena_object::vcycle (solve.cpp:961-1431).

smooth -> residual -> restrict -> recurse -> prolong-correct -> smooth, with
the coarsest level taking the cached dense inverse/LU (the SuperLU
replacement) or matvec-only CG.

Sign convention follows the reference: res = A u - rhs is restricted, and
the coarse correction is subtracted (u -= P e), see solve.cpp:1240-1247.
"""
from __future__ import annotations

import torch

from saena_tpu_torch.amg.hierarchy import Hierarchy, SolveParams
from saena_tpu_torch.amg.smoothers import smooth, smooth_operator


def coarsest_cg(A, u, rhs, max_iter: int, tol: float):
    """Matvec-only CG for the coarsest level (ref solve_coarsest_CG,
    solve.cpp:14-114): until ||r|| <= tol * ||r0|| or max_iter. It runs a
    fixed ``max_iter`` iterations with no host sync, each frozen
    (``torch.where``) once the test has stopped it, so that it lives inside
    a captured V-cycle; the result is that of the JAX package's
    ``while_loop`` (saena_tpu/amg/cycles.py:24-46)."""
    r = rhs - A.matvec(u).to(rhs.dtype)
    rr = torch.dot(r, r)
    thr = rr * tol * tol
    p = r
    for _ in range(max_iter):
        go = rr > thr
        h = A.matvec(p).to(rhs.dtype)
        alpha = rr / torch.dot(p, h)
        u_n = u + alpha * p
        r_n = r - alpha * h
        rr_n = torch.dot(r_n, r_n)
        p_n = r_n + (rr_n / rr) * p
        u, r, p, rr = (torch.where(go, new, old) for new, old in
                       ((u_n, u), (r_n, r), (p_n, p), (rr_n, rr)))
    return u


def coarsest_solve(hierarchy: Hierarchy, params: SolveParams, rhs):
    level = hierarchy.levels[-1]
    if params.direct_solver == "LU" and hierarchy.coarse_lu is not None:
        return hierarchy.coarse_lu.solve(rhs).to(rhs.dtype)
    return coarsest_cg(level.A, torch.zeros_like(rhs), rhs,
                       params.CG_coarsest_max_iter, params.CG_coarsest_tol)


def vcycle(hierarchy: Hierarchy, params: SolveParams, u, rhs, lvl: int = 0,
           u_is_zero: bool = True):
    """One V-cycle at level ``lvl`` from iterate ``u``. The solver and every
    recursive call pass a zero iterate, so the pre-smoother's first A@0
    matvec is elided; pass u_is_zero=False with a nonzero u."""
    levels = hierarchy.levels
    level = levels[lvl]

    if lvl == len(levels) - 1:
        return coarsest_solve(hierarchy, params, rhs)

    # 1. pre-smooth
    u = smooth(level, params, u, rhs, params.preSmooth, u_is_zero=u_is_zero)
    # 2. residual (reference sign: res = A u - rhs), in one kernel pass
    # where the format has a fused update; on the smoothers' operator, which
    # is preconditioner-internal too
    A = smooth_operator(level)
    fu = getattr(A, "fused_update", None)
    if fu is not None and A.dtype == u.dtype:
        res = fu(u, rhs, c=-1.0, add_x=False)
    else:
        res = A.matvec(u).to(u.dtype) - rhs
    # 3. restrict
    res_c = level.R.matvec(res).to(u.dtype)
    # 4. recurse from a zero coarse iterate
    e_c = vcycle(hierarchy, params, torch.zeros_like(res_c), res_c, lvl + 1)
    # 5. prolong + correct (subtract: res had flipped sign)
    u = u - level.P.matvec(e_c).to(u.dtype)
    # 6. post-smooth
    return smooth(level, params, u, rhs, params.postSmooth)
