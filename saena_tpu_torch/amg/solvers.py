"""Outer solvers: pCG (the hot path), the stationary V-cycle iteration,
plain CG, smoother-only iteration and restarted FGMRES.

solve_pCG mirrors saena_object::solve_pCG (solve.cpp:2389-2803): residual
convention r = A u - rhs, update u -= alpha p, stop when ||r||^2 <
||r0||^2 * tol^2, with the JAX package's periodic residual replacement
(``SolveParams.residual_replace``).

pCG, the stationary iteration, the smoother iteration and CG are each an
``amg.graphs.Loop`` (the counterpart of the JAX package's jitted
``while_loop``s): one iteration body on static tensors with no host sync,
frozen once its stop flag drops. On the card the body runs as CUDA graph
replays, captured at the first solve and cached on the hierarchy by
(solver, SolveParams, dtype, max_iter); ``tol`` lives in a device buffer.
The host reads the stop flag once an iteration. On the CPU the same body is
called directly.

The reference declares GMRES/pGMRES but ships them disabled (solve.cpp:3805,
:4074 are `#if 0`); solve_GMRES is a working right-preconditioned restarted
FGMRES, with the JAX package's two engines: "device" (the Arnoldi
recurrence on tensors, breakdowns masked) and "host" (numpy Arnoldi, the
parity oracle). Both keep a Python loop with one host sync a step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from saena_tpu_torch.amg import graphs as _g
from saena_tpu_torch.amg.cycles import vcycle
from saena_tpu_torch.amg.hierarchy import Hierarchy, SolveParams
from saena_tpu_torch.amg.smoothers import smooth


@dataclasses.dataclass(frozen=True)
class SolveResult:
    u: torch.Tensor
    iters: int                  # iterations performed
    init_res: torch.Tensor      # ||r0||
    final_res: torch.Tensor     # ||r_final|| (solver-internal residual)
    history: torch.Tensor       # ||r_i||, padded with NaN past `iters`
    true_res: torch.Tensor      # ||A u - rhs|| recomputed at exit

    @property
    def rel_res(self):
        return self.final_res / self.init_res


_OUT = ("init_res", "final_res", "true_res")   # exit scalars of every loop


def _pcg(hierarchy: Hierarchy, params: SolveParams, rhs, max_iter: int):
    """pCG (saena_tpu/amg/solvers.py:59-113). The step starts with the
    V-cycle of the previous iteration's tail, so that no V-cycle runs once
    the stop test has ended the loop: z = M r, p = z + beta p (beta = 0 on
    the first iteration and after a residual replacement), then the update
    of u and r and the stop test."""
    A = hierarchy.levels[0].A
    k = params.residual_replace
    s = _g.new_state(rhs, max_iter, vectors=("u", "r", "rho", "p"),
                     scalars=("rr", "rz", "thr", "init_dot") + _OUT,
                     flags=("replaced",))

    def init():
        u = torch.zeros_like(s.rhs)
        r = A.matvec(u) - s.rhs                       # = -rhs
        init_dot = torch.dot(r, r)
        s.u.copy_(u)
        s.r.copy_(r)
        s.p.zero_()
        s.init_dot.copy_(init_dot)
        s.rr.copy_(init_dot)
        s.thr.copy_(init_dot * s.tol * s.tol)
        s.rz.fill_(1.0)
        s.replaced.fill_(True)                        # the first p is z
        _g.start(s, torch.sqrt(init_dot), init_dot >= s.thr)

    def step():
        go = s.go
        rho = vcycle(hierarchy, params, torch.zeros_like(s.r), s.r)
        rz = torch.dot(s.r, rho)
        beta = torch.where(s.replaced, 0.0, rz / s.rz)
        p = rho + beta * s.p
        h = A.matvec(p)
        alpha = rz / torch.dot(p, h)
        u = s.u - alpha * p
        r = s.r - alpha * h
        if k > 0:
            # periodic residual replacement bounds the drift of the
            # recursive residual from A u - rhs; the next direction
            # restarts (beta = 0), since carrying beta against a replaced
            # residual destroys conjugacy
            replaced = (s.i + 1) % k == 0
            r = torch.where(replaced, A.matvec(u) - s.rhs, r)
        else:
            replaced = torch.zeros_like(s.replaced)
        rr = torch.dot(r, r)
        _g.keep(go, (s.rho, rho), (s.p, p), (s.u, u), (s.r, r), (s.rz, rz),
                (s.rr, rr), (s.replaced, replaced))
        _g.advance(s, go, torch.sqrt(rr), rr >= s.thr)

    def fini():
        s.init_res.copy_(torch.sqrt(s.init_dot))
        s.final_res.copy_(torch.sqrt(s.rr))
        s.true_res.copy_(torch.linalg.norm(A.matvec(s.u) - s.rhs))

    return _g.Loop(s, init, step, fini, "pCG")


def _stationary(hierarchy: Hierarchy, rhs, max_iter: int, update, name: str):
    """u <- update(u, rhs) from u = 0 until ||A u - rhs|| < tol ||rhs|| or
    max_iter; the residual is recomputed after every step
    (saena_tpu/amg/solvers.py:123-150, :161-188)."""
    A = hierarchy.levels[0].A
    s = _g.new_state(rhs, max_iter, vectors=("u",),
                     scalars=("rr", "thr", "init_dot") + _OUT)

    def init():
        u = torch.zeros_like(s.rhs)
        r0 = A.matvec(u) - s.rhs
        rr = torch.dot(r0, r0)
        s.u.copy_(u)
        s.rr.copy_(rr)
        s.init_dot.copy_(rr)
        s.thr.copy_(rr * s.tol * s.tol)
        _g.start(s, torch.sqrt(rr), rr >= s.thr)

    def step():
        go = s.go
        u = update(s.u, s.rhs)
        r = A.matvec(u) - s.rhs
        rr = torch.dot(r, r)
        _g.keep(go, (s.u, u), (s.rr, rr))
        _g.advance(s, go, torch.sqrt(rr), rr >= s.thr)

    def fini():
        s.init_res.copy_(torch.sqrt(s.init_dot))
        s.final_res.copy_(torch.sqrt(s.rr))
        s.true_res.copy_(s.final_res)

    return _g.Loop(s, init, step, fini, name)


def _vcycle_iter(hierarchy: Hierarchy, params: SolveParams, rhs, max_iter: int):
    """Stationary iteration u <- vcycle(u) (ref saena_object::solve,
    solve.cpp:1883-2016)."""
    return _stationary(
        hierarchy, rhs, max_iter,
        lambda u, b: vcycle(hierarchy, params, u, b, u_is_zero=False),
        "V-cycle iteration")


def _smoother_iter(hierarchy: Hierarchy, params: SolveParams, rhs,
                   max_iter: int):
    """One sweep of the finest level's smoother a step (ref solve_smoother,
    solve.cpp:2017)."""
    lv = hierarchy.levels[0]
    return _stationary(hierarchy, rhs, max_iter,
                       lambda u, b: smooth(lv, params, u, b, 1),
                       "smoother iteration")


def _cg(hierarchy: Hierarchy, params: SolveParams, rhs, max_iter: int):
    """Unpreconditioned CG on the finest level (ref solve_CG,
    solve.cpp:2119; saena_tpu/amg/solvers.py:199-230)."""
    A = hierarchy.levels[0].A
    s = _g.new_state(rhs, max_iter, vectors=("u", "r", "p"),
                     scalars=("rr", "thr", "init_dot") + _OUT)

    def init():
        u = torch.zeros_like(s.rhs)
        r = s.rhs - A.matvec(u)
        init_dot = torch.dot(r, r)
        s.u.copy_(u)
        s.r.copy_(r)
        s.p.copy_(r)
        s.rr.copy_(init_dot)
        s.init_dot.copy_(init_dot)
        s.thr.copy_(init_dot * s.tol * s.tol)
        _g.start(s, torch.sqrt(init_dot), init_dot >= s.thr)

    def step():
        go = s.go
        h = A.matvec(s.p)
        alpha = s.rr / torch.dot(s.p, h)
        u = s.u + alpha * s.p
        r = s.r - alpha * h
        rr = torch.dot(r, r)
        p = r + (rr / s.rr) * s.p
        _g.keep(go, (s.u, u), (s.r, r), (s.p, p), (s.rr, rr))
        _g.advance(s, go, torch.sqrt(rr), rr >= s.thr)

    def fini():
        s.init_res.copy_(torch.sqrt(s.init_dot))
        s.final_res.copy_(torch.sqrt(s.rr))
        s.true_res.copy_(torch.linalg.norm(s.rhs - A.matvec(s.u)))

    return _g.Loop(s, init, step, fini, "CG")


def _prep_rhs(hierarchy: Hierarchy, rhs):
    """rhs (host array or tensor of length n_pad, zero padded) as a tensor
    of the hierarchy, symmetrically scaled when the hierarchy is."""
    rhs = torch.as_tensor(rhs, dtype=hierarchy.dtype, device=hierarchy.device)
    if hierarchy.inv_sq_diag is not None:
        rhs = rhs * hierarchy.inv_sq_diag
    return rhs


def _finalize(hierarchy: Hierarchy, res: SolveResult) -> SolveResult:
    """Undo the symmetric scaling (ref scale_vector after the solve)."""
    if hierarchy.inv_sq_diag is not None:
        res = dataclasses.replace(res, u=res.u * hierarchy.inv_sq_diag)
    return res


def _loop(build, hierarchy: Hierarchy, params: SolveParams, max_iter: int,
          rhs) -> _g.Loop:
    """The hierarchy's cached loop of ``build`` (one of _pcg, _vcycle_iter,
    _smoother_iter, _cg), made at its first use."""
    key = (build.__name__, params, hierarchy.dtype, max_iter)
    loop = hierarchy.graphs.get(key)
    if loop is None:
        loop = hierarchy.graphs[key] = build(hierarchy, params, rhs, max_iter)
    return loop


def _solve(build, hierarchy: Hierarchy, rhs, params=None, tol: float = 1e-8,
           max_iter: int = 100, graphs=None) -> SolveResult:
    """Run the loop of ``build`` on ``rhs``: as graph replays on the card
    (``graphs=None``), or its body called directly (``graphs=False``, the
    uncaptured loop the checks compare the graphs with). The result's
    tensors are copies, not the loop's buffers."""
    params = params or SolveParams()
    rhs = _prep_rhs(hierarchy, rhs)
    loop = _loop(build, hierarchy, params, max_iter, rhs)
    s = loop.s
    s.rhs.copy_(rhs)
    s.tol.fill_(tol)
    if graphs is None:
        graphs = hierarchy.device.type == "cuda"
    iters = loop.run(graphs)
    res = SolveResult(u=s.u.clone(), iters=iters, init_res=s.init_res.clone(),
                      final_res=s.final_res.clone(), history=s.hist.clone(),
                      true_res=s.true_res.clone())
    return _finalize(hierarchy, res)


def solve_pCG(hierarchy: Hierarchy, rhs, params=None, tol: float = 1e-8,
              max_iter: int = 100) -> SolveResult:
    """pCG on ``rhs`` (host array or tensor of length n_pad, zero padded)."""
    return _solve(_pcg, hierarchy, rhs, params, tol, max_iter)


def solve(hierarchy: Hierarchy, rhs, params=None, tol: float = 1e-8,
          max_iter: int = 100) -> SolveResult:
    """Stationary iteration u <- vcycle(u) (ref saena_object::solve,
    solve.cpp:1883-2016)."""
    return _solve(_vcycle_iter, hierarchy, rhs, params, tol, max_iter)


def solve_smoother(hierarchy: Hierarchy, rhs, params=None, tol: float = 1e-8,
                   max_iter: int = 100) -> SolveResult:
    """Smoother-only iteration, one sweep of the finest level's smoother a
    step (ref solve_smoother, solve.cpp:2017)."""
    return _solve(_smoother_iter, hierarchy, rhs, params, tol, max_iter)


def solve_CG(hierarchy: Hierarchy, rhs, params=None, tol: float = 1e-8,
             max_iter: int = 100) -> SolveResult:
    """Unpreconditioned CG on the finest level (ref solve_CG,
    solve.cpp:2119). ``params`` is accepted for a uniform signature."""
    return _solve(_cg, hierarchy, rhs, SolveParams(), tol, max_iter)


def _history(max_iter: int, first, dtype) -> torch.Tensor:
    hist = torch.full((max_iter + 1,), float("nan"), dtype=dtype,
                      device=first.device)
    hist[0] = first
    return hist


def _gmres_device(hierarchy: Hierarchy, params: SolveParams, rhs,
                  tol: float, max_iter: int, restart: int,
                  precondition: bool) -> SolveResult:
    """Restarted FGMRES, right-preconditioned by one V-cycle, on tensors:
    modified Gram-Schmidt over j <= k, Givens rotations, the triangular
    solve. The small H, g, cs, sn are carried at >= f32 (``hdt``); one host
    sync an Arnoldi step (the stopping test).

    Total breakdown (the rotated Hcol[k] and h_next both zero: A z lies in
    span(V) with no diagonal left) would make the rotation 0/0; it is
    masked to the identity rotation with a unit diagonal and a zero rhs
    entry, so y[k] = 0, and ends the cycle: the restart recomputes the
    true residual and carries on."""
    A = hierarchy.levels[0].A
    n = rhs.shape[0]
    dtype, dev = rhs.dtype, rhs.device
    hdt = torch.promote_types(dtype, torch.float32)   # H / Givens precision
    m = restart
    tiny = torch.finfo(hdt).tiny

    def M(v):
        if precondition:
            return vcycle(hierarchy, params, torch.zeros_like(v), v)
        return v

    u = torch.zeros_like(rhs)
    r = rhs - A.matvec(u)
    init_res = torch.linalg.norm(r).to(hdt)
    thr = init_res * tol
    hist = _history(max_iter, init_res, hdt)
    res_norm = init_res
    total_it = 0
    while total_it < max_iter and bool(res_norm >= thr):
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        Z = torch.zeros((m, n), dtype=dtype, device=dev)
        H = torch.zeros((m + 1, m), dtype=hdt, device=dev)
        g = torch.zeros(m + 1, dtype=hdt, device=dev)
        g[0] = res_norm
        cs = torch.zeros(m, dtype=hdt, device=dev)
        sn = torch.zeros(m, dtype=hdt, device=dev)
        V[0] = r / res_norm.to(dtype)
        k = 0
        go = True
        while k < m and total_it < max_iter and go:
            z = M(V[k])
            w = A.matvec(z).to(hdt)
            Z[k] = z
            Hcol = torch.zeros(m + 1, dtype=hdt, device=dev)
            for j in range(k + 1):                      # modified Gram-Schmidt
                Vj = V[j].to(hdt)
                hjk = torch.dot(Vj, w)
                w = w - hjk * Vj
                Hcol[j] = hjk
            h_next = torch.linalg.norm(w)
            Hcol[k + 1] = h_next
            ok = h_next > tiny
            V[k + 1] = torch.where(ok, w / torch.where(ok, h_next, 1.0),
                                   0.0).to(dtype)
            for j in range(k):                          # earlier rotations
                t = cs[j] * Hcol[j] + sn[j] * Hcol[j + 1]
                t2 = -sn[j] * Hcol[j] + cs[j] * Hcol[j + 1]
                Hcol[j] = t
                Hcol[j + 1] = t2
            d = torch.hypot(Hcol[k], Hcol[k + 1])
            dz = d <= tiny
            d_safe = torch.where(dz, 1.0, d)
            ck = torch.where(dz, 1.0, Hcol[k] / d_safe)
            sk = torch.where(dz, 0.0, Hcol[k + 1] / d_safe)
            cs[k] = ck
            sn[k] = sk
            Hcol[k] = d_safe
            Hcol[k + 1] = 0.0
            H[:, k] = Hcol
            gk = g[k].clone()
            g[k + 1] = -sk * gk
            g[k] = torch.where(dz, 0.0, ck * gk)
            rn = torch.abs(g[k + 1])
            hist[total_it + 1] = rn
            k += 1
            total_it += 1
            go = bool((rn >= thr) & ok & ~dz)          # the step's host sync
        # y = H[:k, :k]^{-1} g[:k]: H is upper triangular after the
        # rotations; zero breakdown columns have a unit diagonal and y = 0
        y = torch.linalg.solve_triangular(H[:k, :k], g[:k, None],
                                          upper=True)[:, 0]
        u = u + y.to(dtype) @ Z[:k]
        r = rhs - A.matvec(u)
        res_norm = torch.linalg.norm(r).to(hdt)
        # the last Givens estimate gives way to the true residual at the
        # restart boundary
        hist[total_it] = res_norm
    return SolveResult(u=u, iters=total_it, init_res=init_res.to(dtype),
                       final_res=res_norm.to(dtype), history=hist.to(dtype),
                       true_res=res_norm.to(dtype))


def _gmres_host(hierarchy: Hierarchy, params: SolveParams, rhs,
                tol: float, max_iter: int, restart: int,
                precondition: bool) -> SolveResult:
    """The host-driven FGMRES (the JAX package's reference loop): Arnoldi
    vectors, MGS, Givens and the small solve in numpy (f64 H), the
    preconditioner and matvecs on the hierarchy's device."""
    A = hierarchy.levels[0].A
    n = rhs.shape[0]
    dtype, dev = rhs.dtype, rhs.device
    np_dt = torch.empty(0, dtype=dtype).numpy().dtype

    def M(v):
        if precondition:
            return vcycle(hierarchy, params, torch.zeros_like(v), v)
        return v

    u = torch.zeros_like(rhs)
    r = rhs - A.matvec(u)
    init_res = float(torch.linalg.norm(r))
    res_norm = init_res
    hist = [init_res]
    total_it = 0
    while res_norm >= tol * init_res and total_it < max_iter:
        m = min(restart, max_iter - total_it)
        V = np.zeros((m + 1, n), dtype=np_dt)
        Z = np.zeros((m, n), dtype=np_dt)
        H = np.zeros((m + 1, m))
        V[0] = (r / res_norm).cpu().numpy()
        g = np.zeros(m + 1)
        g[0] = res_norm
        cs, sn = np.zeros(m), np.zeros(m)
        k_used = 0
        for k in range(m):
            z = M(torch.as_tensor(V[k], device=dev))
            w = A.matvec(z)
            Z[k] = z.cpu().numpy()
            wn = w.cpu().numpy().astype(np.float64)
            for j in range(k + 1):   # modified Gram-Schmidt
                H[j, k] = float(np.dot(V[j], wn))
                wn = wn - H[j, k] * V[j]
            h_next = float(np.linalg.norm(wn))
            H[k + 1, k] = h_next
            if h_next > 1e-300:
                V[k + 1] = (wn / h_next).astype(np_dt)
            # Givens rotations (ref GMRES_update helpers, solve.cpp:3745-3803)
            for j in range(k):
                t = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                H[j + 1, k] = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                H[j, k] = t
            d = np.hypot(H[k, k], H[k + 1, k])
            cs[k], sn[k] = H[k, k] / d, H[k + 1, k] / d
            H[k, k] = d
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k_used = k + 1
            total_it += 1
            res_norm = abs(g[k + 1])
            hist.append(res_norm)
            if res_norm < tol * init_res or h_next <= 1e-300:
                break
        y = np.linalg.solve(H[:k_used, :k_used], g[:k_used])
        du = (Z[:k_used].T @ y).astype(np_dt)
        u = u + torch.as_tensor(du, device=dev)
        r = rhs - A.matvec(u)
        res_norm = float(torch.linalg.norm(r))
        hist[-1] = res_norm

    hist_t = torch.full((max_iter + 1,), float("nan"), dtype=dtype, device=dev)
    hist_t[: len(hist)] = torch.tensor(hist[: max_iter + 1], dtype=dtype)
    scalar = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    return SolveResult(u=u, iters=total_it, init_res=scalar(init_res),
                       final_res=scalar(res_norm), history=hist_t,
                       true_res=scalar(res_norm))


def solve_GMRES(hierarchy: Hierarchy, rhs, params=None, tol: float = 1e-8,
                max_iter: int = 100, restart: int = 30,
                precondition: bool = True,
                engine: str = "device") -> SolveResult:
    """Restarted FGMRES, right-preconditioned by one V-cycle when
    ``precondition`` (pGMRES). ``engine="device"`` runs the Arnoldi
    recurrence on the hierarchy's tensors; ``engine="host"`` the
    reference-style numpy loop."""
    params = params or SolveParams()
    engines = {"device": _gmres_device, "host": _gmres_host}
    if engine not in engines:
        raise ValueError(f"unknown GMRES engine {engine!r}")
    res = engines[engine](hierarchy, params, _prep_rhs(hierarchy, rhs), tol,
                          max_iter, restart, precondition)
    return _finalize(hierarchy, res)
