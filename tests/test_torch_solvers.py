"""The port's stationary, smoother-only, CG and FGMRES solvers against
saena_tpu's, in f64 on the CPU.

Both packages run on identical device state: saena_tpu's hierarchy is
carried across with ``convert.load_hierarchy`` (tests/test_torch_solve.py
flattens it). For each entry point the iteration counts are equal, the
residual histories agree at rtol 1e-6 and the solutions at rtol 1e-8
(the same recurrences, their dot products summed in another order).
Then the port alone: its device and host FGMRES engines agree, through
restarts and on an indefinite operator, and a total Arnoldi breakdown
leaves no NaN (tests/test_amg.py:152-196, 406).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from saena_tpu import AMG as JAMG, Matrix as JMatrix, Options as JOptions
from saena_tpu.amg import hierarchy as jh
from saena_tpu.amg import solvers as jsolvers
from saena_tpu.generators import band_matrix, laplacian2D, laplacian3D

import saena_tpu_torch
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.amg import solvers as tsolvers
from saena_tpu_torch.convert import load_hierarchy
from saena_tpu_torch.core.coo import remove_boundary_nodes
from test_torch_solve import flatten_hierarchy

F64 = dict(dtype=torch.float64, device="cpu")


def _interior(m):
    return remove_boundary_nodes(laplacian3D(m, m, m))[0].tocsr()


HIERARCHIES = {
    "poisson16": lambda: (_interior(16), JOptions()),
    "poisson12_scaled": lambda: (_interior(12), JOptions(scale=True)),
}


@pytest.fixture(scope="module", params=sorted(HIERARCHIES))
def carried(request):
    A, opts = HIERARCHIES[request.param]()
    H, _ = jh.setup(A, opts, dtype=jnp.float64)
    T = load_hierarchy(*flatten_hierarchy(H), **F64)
    rhs = np.random.default_rng(0).standard_normal(A.shape[0])
    return H, T, opts, np.pad(rhs, (0, H.n_pad - H.n))


ENTRY_POINTS = {
    # name: (function name, keyword arguments)
    "solve": ("solve", dict(max_iter=60)),
    "solve_smoother": ("solve_smoother", dict(max_iter=30)),
    "solve_CG": ("solve_CG", dict(max_iter=30)),
    "GMRES_device": ("solve_GMRES", dict(max_iter=40, restart=10,
                                         precondition=False)),
    "GMRES_host": ("solve_GMRES", dict(max_iter=40, restart=10,
                                       precondition=False, engine="host")),
    "pGMRES_device": ("solve_GMRES", dict(max_iter=40, restart=3)),
    "pGMRES_host": ("solve_GMRES", dict(max_iter=40, restart=3,
                                        engine="host")),
}


def _agree(res, ref, n, rtol_u=1e-8):
    it = int(ref.iters)
    assert res.iters == it
    np.testing.assert_allclose(res.history[: it + 1].numpy(),
                               np.asarray(ref.history)[: it + 1], rtol=1e-6)
    u, uj = res.u[:n].numpy(), np.asarray(ref.u)[:n]
    np.testing.assert_allclose(u, uj, rtol=rtol_u,
                               atol=rtol_u * np.abs(uj).max())


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_matches_saena_tpu(carried, entry):
    H, T, opts, rhs = carried
    fn, kw = ENTRY_POINTS[entry]
    params_j = jh.SolveParams.from_options(opts)
    params_t = th.SolveParams.from_options(
        saena_tpu_torch.Options(**{f: getattr(opts, f) for f in (
            "smoother", "preSmooth", "postSmooth", "jacobi_omega",
            "direct_solver", "CG_coarsest_max_iter", "CG_coarsest_tol")}))
    ref = getattr(jsolvers, fn)(H, jnp.asarray(rhs), params=params_j,
                                tol=1e-8, **kw)
    res = getattr(tsolvers, fn)(T, rhs, params=params_t, tol=1e-8, **kw)
    _agree(res, ref, H.n)


def test_solve_pGMRES_through_the_api():
    """AMG.solve_pGMRES of both packages, each from its own setup (the same
    host levels bit for bit), on the 16^3 Poisson with boundary rows."""
    m = 16
    A = laplacian3D(m, m, m).tocsr()
    rhs = np.random.default_rng(1).standard_normal(A.shape[0])
    JA = JMatrix()
    JA.set_csr(A)
    JA.assemble()
    js = JAMG().set_matrix(JA, JOptions(remove_boundary=True)).set_rhs(rhs)
    TA = saena_tpu_torch.Matrix()
    TA.set_csr(A)
    TA.assemble(**F64)
    ts = saena_tpu_torch.AMG(**F64).set_matrix(
        TA, saena_tpu_torch.Options(remove_boundary=True)).set_rhs(rhs)
    uj, rj = js.solve_pGMRES(tol=1e-8)
    ut, rt = ts.solve_pGMRES(tol=1e-8)
    assert rt.iters == int(rj.iters) and float(rt.rel_res) < 1e-8
    np.testing.assert_allclose(rt.history[: rt.iters + 1].numpy(),
                               np.asarray(rj.history)[: rt.iters + 1], rtol=1e-6)
    np.testing.assert_allclose(ut, uj, rtol=1e-8, atol=1e-8 * np.abs(uj).max())


def _port_hierarchy(A):
    return th.setup(A.tocsr(), saena_tpu_torch.Options(), **F64)[0]


def test_gmres_device_host_parity():
    A = laplacian2D(30, 30) + 0.05 * sp.random(
        900, 900, density=0.002, random_state=0, format="csr")
    A = (A + A.T).tocsr() + 2.0 * sp.identity(900, format="csr")
    rhs = np.cos(np.arange(900) * 0.13)
    H = _port_hierarchy(A)
    rhs_p = np.pad(rhs, (0, H.n_pad - 900))
    out = {}
    for eng in ("host", "device"):
        r = tsolvers.solve_GMRES(H, rhs_p, tol=1e-8, max_iter=120, restart=25,
                                 engine=eng)
        out[eng] = (r.iters, float(r.final_res / r.init_res))
        u = r.u[:900].numpy()
        assert np.linalg.norm(rhs - A @ u) / np.linalg.norm(rhs) < 1e-7, eng
    assert out["host"][0] == out["device"][0]
    assert abs(np.log10(out["host"][1]) - np.log10(out["device"][1])) < 0.5


def test_gmres_device_restarted_indefinite():
    """GMRES(40) stagnates on this indefinite band operator; both engines
    stagnate alike through many restart cycles."""
    A = band_matrix(300, 4).tocsr()
    rhs = np.ones(300)
    H = _port_hierarchy(A)
    rhs_p = np.pad(rhs, (0, H.n_pad - 300))
    out = {}
    for eng in ("host", "device"):
        r = tsolvers.solve_GMRES(H, rhs_p, tol=1e-8, max_iter=300, restart=40,
                                 precondition=False, engine=eng)
        u = r.u[:300].numpy()
        out[eng] = (r.iters, np.linalg.norm(rhs - A @ u) / np.linalg.norm(rhs))
    assert out["host"][0] == out["device"][0]
    np.testing.assert_allclose(out["device"][1], out["host"][1], rtol=1e-2)


def test_gmres_device_total_breakdown_no_nan():
    """A z in span(V) with nothing left (A r0 = 0): the 0/0 rotation is
    masked, the iterate stays at 0 and the residual at ||rhs||."""
    n = 128
    A = sp.csr_matrix(sp.kron(sp.identity(n // 2),
                              np.array([[1.0, 1.0], [1.0, 1.0]])))
    rhs = np.tile([1.0, -1.0], n // 2)
    assert np.abs(A @ rhs).max() == 0.0
    H = _port_hierarchy(A)
    r = tsolvers.solve_GMRES(H, np.pad(rhs, (0, H.n_pad - n)), tol=1e-8,
                             max_iter=5, restart=4, precondition=False,
                             engine="device")
    assert torch.isfinite(r.u).all() and torch.isfinite(r.final_res)
    assert torch.isfinite(r.history).all()
    np.testing.assert_allclose(r.u.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(float(r.final_res), np.linalg.norm(rhs),
                               rtol=1e-12)
