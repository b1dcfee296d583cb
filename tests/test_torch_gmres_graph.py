"""The port's FGMRES device engine as a loop of static tensors
(amg/solvers._gmres, amg/graphs.Loop with a restart part) against
saena_tpu's jitted FGMRES (saena_tpu/amg/solvers.py:_gmres_device), in f64
on the CPU, and its graph replays on the card.

CPU: both packages run on identical device state (saena_tpu's 12^3
hierarchy carried across with ``convert.load_hierarchy``), restart 5 and
30, with and without the V-cycle preconditioner, a ``max_iter`` that ends
inside a restart cycle, and a diagonal operator whose Krylov space closes
after four steps (a breakdown before m). Iterations are equal; histories
agree at rtol 1e-10 above a floor of 1e-14 ||r0|| (entries near 1e-8
||r0|| are Givens estimates and recomputed residuals whose rounding is
about eps ||r0||, as in tests/test_torch_graph_solve.py), ``final_res`` at
rtol 1e-8 above the same floor (the breakdown case ends at a residual of
roundoff size), u at rtol 1e-8 (the same recurrences, dots summed in another
order). A step or restart after the stop changes no state, and the loops
are cached on the hierarchy by restart and precondition.

Card (marker ``cuda``, skipped without one): the loop captured and
replayed gives the uncaptured loop's iterations, history and u bit for
bit, with the same kernel launches.
"""
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch import AMG, Matrix, Options, generators
from saena_tpu_torch.amg import solvers as tsolvers
from saena_tpu_torch.convert import load_hierarchy
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.runtime import launches_of

RTOL_HIST = 1e-10
ATOL_HIST = 1e-14      # times ||r0||


@pytest.fixture(scope="module")
def jx():
    """saena_tpu's pieces, imported here so that the card's tests of this
    file also run where JAX is not installed."""
    import jax.numpy as jnp

    from saena_tpu.amg import hierarchy as jh
    from saena_tpu.amg import solvers as jsolvers
    from saena_tpu.config import Options as JOptions
    from test_torch_solve import flatten_hierarchy

    return types.SimpleNamespace(jnp=jnp, jh=jh, jsolvers=jsolvers,
                                 JOptions=JOptions, flatten=flatten_hierarchy)


def _carry(jx, A, seed):
    H, _ = jx.jh.setup(A, jx.JOptions(), dtype=jx.jnp.float64)
    T = load_hierarchy(*jx.flatten(H), dtype=torch.float64, device="cpu")
    rhs = np.random.default_rng(seed).standard_normal(A.shape[0])
    return H, T, np.pad(rhs, (0, H.n_pad - H.n))


@pytest.fixture(scope="module")
def poisson(jx):
    A = remove_boundary_nodes(generators.laplacian3D(12, 12, 12))[0].tocsr()
    return _carry(jx, A, 1)


@pytest.fixture(scope="module")
def diagonal(jx):
    """Four distinct eigenvalues: the Krylov space closes at step 4."""
    d = np.repeat([1.0, 2.0, 3.0, 5.0], 50)
    return _carry(jx, sp.diags(d).tocsr(), 2)


CASES = {
    # name: (fixture, restart, precondition, max_iter)
    "restart5": ("poisson", 5, False, 100),
    "restart30": ("poisson", 30, False, 100),
    "prec_restart5": ("poisson", 5, True, 100),
    "prec_restart30": ("poisson", 30, True, 100),
    "capped_inside_a_cycle": ("poisson", 7, False, 17),
    "breakdown": ("diagonal", 30, False, 100),
}


def _solve_both(request, jx, case):
    fixture, restart, prec, max_iter = CASES[case]
    H, T, rhs = request.getfixturevalue(fixture)
    kw = dict(tol=1e-8, max_iter=max_iter, restart=restart, precondition=prec)
    ref = jx.jsolvers.solve_GMRES(H, jx.jnp.asarray(rhs), **kw)
    res = tsolvers.solve_GMRES(T, rhs, **kw)
    return H, T, rhs, ref, res, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_matches_saena_tpu(request, jx, case):
    H, T, rhs, ref, res, kw = _solve_both(request, jx, case)
    it = int(ref.iters)
    assert res.iters == it
    h, hj = res.history.numpy(), np.asarray(ref.history)
    np.testing.assert_allclose(h[: it + 1], hj[: it + 1], rtol=RTOL_HIST,
                               atol=ATOL_HIST * hj[0])
    assert np.isnan(h[it + 1:]).all()
    np.testing.assert_allclose(float(res.final_res), float(ref.final_res),
                               rtol=1e-8, atol=ATOL_HIST * hj[0])
    np.testing.assert_allclose(float(res.init_res), float(ref.init_res),
                               rtol=RTOL_HIST)
    n = H.n
    np.testing.assert_allclose(res.u[:n].numpy(), np.asarray(ref.u)[:n],
                               rtol=1e-8, atol=1e-8 * np.abs(ref.u).max())
    if case == "capped_inside_a_cycle":
        assert it == kw["max_iter"] and it % kw["restart"]
        assert float(res.rel_res) > 1e-8
    elif case == "breakdown":
        assert it == 4 and float(res.rel_res) < 1e-8
    else:
        assert float(res.rel_res) < 1e-8


@pytest.mark.parametrize("case", ["restart5", "prec_restart30",
                                  "capped_inside_a_cycle"])
def test_parts_after_the_stop_change_nothing(request, jx, case):
    """Once ``go`` is 0, neither a step nor a restart moves any state."""
    H, T, rhs, ref, res, kw = _solve_both(request, jx, case)
    key = ("_gmres", tsolvers.SolveParams(), T.dtype, kw["max_iter"],
           ("precondition", kw["precondition"]), ("restart", kw["restart"]))
    loop = T.graphs[key]
    s = loop.s
    assert int(s.go) == 0 and int(s.i) == res.iters
    before = {k: v.clone() for k, v in vars(s).items()
              if isinstance(v, torch.Tensor)}
    loop.parts[1]()                                   # a step
    loop.parts[3]()                                   # a restart
    for k, v in before.items():
        torch.testing.assert_close(getattr(s, k), v, rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def test_loops_cached_by_restart_and_precondition(poisson):
    _, T, rhs = poisson
    T.graphs.clear()
    for restart, prec in ((5, False), (5, True), (7, True), (5, False)):
        tsolvers.solve_GMRES(T, rhs, max_iter=10, restart=restart,
                             precondition=prec)
    keys = sorted((dict(k[4:])["restart"], dict(k[4:])["precondition"])
                  for k in T.graphs if k[0] == "_gmres")
    assert keys == [(5, False), (5, True), (7, True)]


def test_back_substitution_matches_solve_triangular():
    rng = np.random.default_rng(4)
    H = np.triu(rng.standard_normal((9, 9))) + 4 * np.eye(9)
    g = rng.standard_normal(9)
    y = tsolvers._back_substitute(torch.from_numpy(H), torch.from_numpy(g))
    np.testing.assert_allclose(y.numpy(), np.linalg.solve(H, g), rtol=1e-12)


# ------------------------------------------------------------- the card --


def _card_amg(m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = Matrix()
    A.set_csr(generators.laplacian3D(m, m, m))
    A.assemble(device="cuda", dtype=torch.float64)
    s = AMG(device="cuda", dtype=torch.float64)
    s.set_matrix(A, Options(remove_boundary=True))
    s.set_rhs(np.random.default_rng(2).standard_normal(m ** 3))
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("restart,prec,max_iter",
                         [(5, False, 60), (30, False, 60), (5, True, 40),
                          (30, True, 40), (7, False, 17)])
def test_cuda_graph_replay_matches_uncaptured_loop(restart, prec, max_iter):
    s = _card_amg(16)
    kw = dict(restart=restart, precondition=prec)

    def run(graphs_):
        return s._run(lambda H, r, **k: tsolvers._solve(
            tsolvers._gmres, H, r, graphs=graphs_, **k, **kw),
            max_iter=max_iter)

    run(None)                                          # capture
    (ug, rg), lg = launches_of(lambda: run(None))
    (ue, re_), le = launches_of(lambda: run(False))
    assert rg.iters == re_.iters
    it = rg.iters
    assert torch.equal(rg.history[: it + 1], re_.history[: it + 1])
    assert np.array_equal(ug, ue)
    assert lg == le
    loop = next(iter(s.hierarchy.graphs.values()))
    assert len(loop.graphs) == 4 and loop.capture_ms > 0
