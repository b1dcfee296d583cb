"""Outer solvers: pCG (the hot path), the stationary V-cycle iteration,
plain CG, smoother-only iteration and restarted FGMRES.

solve_pCG mirrors saena_object::solve_pCG (solve.cpp:2389-2803): residual
convention r = A u - rhs, update u -= alpha p, stop when ||r||^2 <
||r0||^2 * tol^2, with the JAX package's periodic residual replacement
(``SolveParams.residual_replace``).

pCG, the stationary iteration, the smoother iteration, CG and the FGMRES
device engine are each an ``amg.graphs.Loop`` (the counterpart of the JAX
package's jitted ``while_loop``s): one iteration body on static tensors
with no host sync, frozen once its stop flag drops. On the card the body
runs as CUDA graph replays, captured at the first solve and cached on the
hierarchy by (solver, SolveParams, dtype, max_iter and, for FGMRES,
restart and precondition); ``tol`` lives in a device buffer. The host reads
the stop flag once an iteration (FGMRES: once an Arnoldi step and once a
restart boundary). On the CPU the same body is called directly.

The reference declares GMRES/pGMRES but ships them disabled (solve.cpp:3805,
:4074 are `#if 0`); solve_GMRES is a working right-preconditioned restarted
FGMRES, with the JAX package's two engines: "device" (the Arnoldi
recurrence on tensors, fixed masked MGS and Givens sweeps, breakdowns
masked) and "host" (numpy Arnoldi with one host sync a step, the parity
oracle).
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from saena_tpu_torch.amg import graphs as _g
from saena_tpu_torch.amg.cycles import vcycle
from saena_tpu_torch.amg.hierarchy import Hierarchy, SolveParams
from saena_tpu_torch.amg.smoothers import smooth
from saena_tpu_torch.runtime import span


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
          rhs, **kw) -> _g.Loop:
    """The hierarchy's cached loop of ``build`` (one of _pcg, _vcycle_iter,
    _smoother_iter, _cg, _gmres, with its keyword arguments ``kw``), made at
    its first use. The loop's parts see the hierarchy through a weak proxy:
    the hierarchy holds the loop, and a strong reference back would make a
    cycle that keeps a dropped hierarchy, its device levels and its graphs
    until the cyclic collector runs."""
    key = (build.__name__, params, hierarchy.dtype, max_iter,
           *sorted(kw.items()))
    loop = hierarchy.graphs.get(key)
    if loop is None:
        loop = hierarchy.graphs[key] = build(
            weakref.proxy(hierarchy), params, rhs, max_iter, **kw)
    return loop


def _solve(build, hierarchy: Hierarchy, rhs, params=None, tol: float = 1e-8,
           max_iter: int = 100, graphs=None, **kw) -> SolveResult:
    """Run the loop of ``build`` (with its keyword arguments ``kw``) on
    ``rhs``: as graph replays on the card (``graphs=None``), or its body
    called directly (``graphs=False``, the uncaptured loop the checks
    compare the graphs with). The result's tensors are copies, not the
    loop's buffers."""
    params = params or SolveParams()
    with span("saena.api.upload"):
        rhs = _prep_rhs(hierarchy, rhs)
        loop = _loop(build, hierarchy, params, max_iter, rhs, **kw)
        s = loop.s
        s.rhs.copy_(rhs)
        s.tol.fill_(tol)
    if graphs is None:
        graphs = hierarchy.device.type == "cuda"
    iters = loop.run(graphs)
    with span("saena.api.download"):
        res = SolveResult(u=s.u.clone(), iters=iters,
                          init_res=s.init_res.clone(),
                          final_res=s.final_res.clone(),
                          history=s.hist.to(s.rhs.dtype, copy=True),
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


def _back_substitute(Hm: torch.Tensor, gm: torch.Tensor) -> torch.Tensor:
    """y of the upper triangular system Hm y = gm, one row at a time from
    the last: m steps of small tensor ops, none of which syncs."""
    m = gm.shape[0]
    y = torch.zeros_like(gm)
    y[m - 1] = gm[m - 1] / Hm[m - 1, m - 1]
    for i in range(m - 2, -1, -1):
        y[i] = (gm[i] - torch.dot(Hm[i, i + 1:], y[i + 1:])) / Hm[i, i]
    return y


def _gmres(hierarchy: Hierarchy, params: SolveParams, rhs, max_iter: int,
           restart: int = 30, precondition: bool = True):
    """Restarted FGMRES, right-preconditioned by one V-cycle when
    ``precondition``: the JAX package's device engine
    (saena_tpu/amg/solvers.py:242-370) as a loop of static tensors.

    State: V (m + 1, n), Z (m, n), and H (m + 1, m), g, cs, sn at ``hdt`` =
    promote(dtype, f32); the Arnoldi index k, the iteration counter, the
    residual and the stop flag ``go`` on the device. ``go`` is 0 (stop), 1
    (an Arnoldi step is next) or 2 (a restart boundary is next). ``step``
    is one Arnoldi step: modified Gram-Schmidt over a fixed j = 0..m with
    the updates masked by j <= k (subtracting 0 V[j] is an exact no-op) and
    the Givens sweep over a fixed j < m masked by j < k, so no host value
    decides a shape. The Arnoldi cycle ends, as in the JAX engine, at k = m,
    at ``max_iter`` iterations, at convergence or at a breakdown; then the
    ``restart`` part solves the padded triangular system (unit diagonals
    and zero rhs past k), adds y^T Z to u, writes the true residual into
    the history at the last iteration and starts the next cycle, or sets
    ``go`` to 0. Each part leaves the state as it is when ``go`` is not
    its own.

    Total breakdown (the rotated Hcol[k] and h_next both zero: A z lies in
    span(V) with no diagonal left) would make the rotation 0/0; it is
    masked to the identity rotation with a unit diagonal and a zero rhs
    entry, so y[k] = 0, and ends the cycle: the restart recomputes the
    true residual and carries on."""
    A = hierarchy.levels[0].A
    n, m = rhs.shape[0], restart
    dtype, dev = rhs.dtype, rhs.device
    hdt = torch.promote_types(dtype, torch.float32)   # H / Givens precision
    tiny = torch.finfo(hdt).tiny
    kw = dict(dtype=hdt, device=dev)
    s = _g.new_state(rhs, max_iter, vectors=("u",), scalars=_OUT)
    s.hist = torch.full((max_iter + 1,), float("nan"), **kw)
    s.go = torch.zeros((), dtype=torch.int64, device=dev)
    s.k = torch.zeros((), dtype=torch.int64, device=dev)
    s.V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    s.Z = torch.zeros((m, n), dtype=dtype, device=dev)
    s.H = torch.zeros((m + 1, m), **kw)
    s.g = torch.zeros(m + 1, **kw)
    s.cs = torch.zeros(m, **kw)
    s.sn = torch.zeros(m, **kw)
    for name in ("init", "res", "thr"):
        setattr(s, name, torch.zeros((), **kw))
    rows = torch.arange(m + 1, device=dev)
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    eye2 = torch.eye(2, **kw)

    def M(v):
        if precondition:
            return vcycle(hierarchy, params, torch.zeros_like(v), v)
        return v

    def set_row(X, j, row, act):
        """X[j] = row where ``act``; j a (1,) index tensor."""
        X.index_copy_(0, j, torch.where(act, row, X.index_select(0, j)[0])[None])

    def new_cycle(r, res, act):
        """Where ``act``: V[0] = r / res, g = res e0, the rest zero, k = 0
        (the JAX engine's restart_body prologue)."""
        for X in (s.V, s.Z, s.H, s.g, s.cs, s.sn, s.k):
            X.masked_fill_(act, 0)
        s.V[0] = torch.where(act, r / res.to(dtype), s.V[0])
        s.g[0] = torch.where(act, res, s.g[0])

    def init():
        u = torch.zeros_like(s.rhs)
        r = s.rhs - A.matvec(u)
        res = torch.linalg.norm(r).to(hdt)
        s.u.copy_(u)
        s.init.copy_(res)
        s.res.copy_(res)
        s.thr.copy_(res * s.tol.to(hdt))
        new_cycle(r, res, torch.ones((), dtype=torch.bool, device=dev))
        s.hist.fill_(float("nan"))
        s.hist[:1].copy_(res.reshape(1))
        s.i.zero_()
        s.go.copy_((res >= s.thr) & (max_iter > 0))

    def step():
        act = s.go == 1
        k = s.k
        k0, k1 = k.reshape(1), (k + 1).reshape(1)
        z = M(s.V.index_select(0, k0)[0])
        w = A.matvec(z).to(hdt)
        set_row(s.Z, k0, z, act)
        jle = rows <= k
        hs = []
        for j in range(m + 1):                       # modified Gram-Schmidt
            Vj = s.V[j].to(hdt)
            hjk = torch.where(jle[j], torch.dot(Vj, w), 0.0)
            w = w - hjk * Vj
            hs.append(hjk)
        h_next = torch.linalg.norm(w)
        Hcol = torch.stack(hs).index_copy(0, k1, h_next.reshape(1))
        ok = h_next > tiny
        set_row(s.V, k1, torch.where(ok, w / torch.where(ok, h_next, 1.0),
                                     0.0).to(dtype), act)
        # the earlier rotations j < k, each [[c, s], [-s, c]] (the identity
        # past k) on entries j, j + 1
        rot = torch.stack([torch.stack([s.cs, s.sn], -1),
                           torch.stack([-s.sn, s.cs], -1)], 1)
        rot = torch.where((rows[:m] < k)[:, None, None], rot, eye2)
        a, out = Hcol[0], []
        for j in range(m):
            t = torch.mv(rot[j], torch.stack([a, Hcol[j + 1]]))
            out.append(t[0])
            a = t[1]
        Hcol = torch.stack(out + [a])
        hk, hk1 = Hcol.index_select(0, k0)[0], Hcol.index_select(0, k1)[0]
        d = torch.hypot(hk, hk1)
        dz = d <= tiny
        d_safe = torch.where(dz, 1.0, d)
        ck = torch.where(dz, 1.0, hk / d_safe)
        sk = torch.where(dz, 0.0, hk1 / d_safe)
        Hcol = Hcol.index_copy(0, k0, d_safe.reshape(1)).index_copy(
            0, k1, torch.zeros_like(d).reshape(1))
        gk = s.g.index_select(0, k0)[0]
        g = s.g.index_copy(0, k1, (-sk * gk).reshape(1)).index_copy(
            0, k0, torch.where(dz, 0.0, ck * gk).reshape(1))
        rn = torch.abs(-sk * gk)
        _g.keep(act, (s.H, s.H.index_copy(1, k0, Hcol[:, None])),
                (s.cs, s.cs.index_copy(0, k0, ck.reshape(1))),
                (s.sn, s.sn.index_copy(0, k0, sk.reshape(1))), (s.g, g),
                (s.res, rn))
        idx = torch.clamp(s.i + 1, max=max_iter).reshape(1)
        s.hist.index_copy_(0, idx, torch.where(act, rn.reshape(1),
                                               s.hist.index_select(0, idx)))
        torch.where(act, k + 1, k, out=s.k)
        torch.where(act, s.i + 1, s.i, out=s.i)
        more = (s.k < m) & (s.i < max_iter) & (rn >= s.thr) & ok & ~dz
        torch.where(act, torch.where(more, 1, 2), s.go, out=s.go)

    def restart_():
        act = s.go == 2
        active = rows[:m] < s.k
        Hm = s.H[:m, :m] * active[None, :]
        Hm = torch.where(eye & ~active[None, :], 1.0, Hm)
        y = _back_substitute(Hm, torch.where(active, s.g[:m], 0.0))
        u = s.u + y.to(dtype) @ s.Z
        r = s.rhs - A.matvec(u)
        res = torch.linalg.norm(r).to(hdt)
        # the last Givens estimate gives way to the true residual at the
        # restart boundary
        idx = s.i.reshape(1)
        s.hist.index_copy_(0, idx, torch.where(act, res.reshape(1),
                                               s.hist.index_select(0, idx)))
        _g.keep(act, (s.u, u), (s.res, res))
        more = (res >= s.thr) & (s.i < max_iter)
        new_cycle(r, res, act & more)
        torch.where(act, more.to(s.go.dtype), s.go, out=s.go)

    def fini():
        s.init_res.copy_(s.init)
        s.final_res.copy_(s.res)
        s.true_res.copy_(s.res)

    return _g.Loop(s, init, step, fini, "FGMRES" if precondition else "GMRES",
                   restart=restart_)


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
    ``precondition`` (pGMRES). ``engine="device"`` runs the loop of
    ``_gmres`` (graph replays on the card, cached on the hierarchy under
    ``restart`` and ``precondition`` too); ``engine="host"`` the
    reference-style numpy loop."""
    if engine == "device":
        return _solve(_gmres, hierarchy, rhs, params, tol, max_iter,
                      restart=restart, precondition=precondition)
    if engine != "host":
        raise ValueError(f"unknown GMRES engine {engine!r}")
    params = params or SolveParams()
    res = _gmres_host(hierarchy, params, _prep_rhs(hierarchy, rhs), tol,
                      max_iter, restart, precondition)
    return _finalize(hierarchy, res)
