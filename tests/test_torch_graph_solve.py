"""The port's solver loops (amg/graphs.py, amg/solvers.py: the counterpart
of saena_tpu's jitted while_loops) against saena_tpu's jitted solvers, in
f64 on the CPU, and their graph replays on the card.

CPU: both packages run on identical device state (saena_tpu's hierarchy
carried across with ``convert.load_hierarchy``). pCG (with and without
residual replacement, at k = 1 and k = 3), the stationary V-cycle
iteration, the smoother iteration and CG take the same iterations as
saena_tpu, with histories at rtol 1e-10 (above a floor of 1e-14 ||r0||
for recomputed residuals), solutions at rtol 1e-8 and the
recomputed true residual at rtol 1e-6, which cancels 8 digits (the same
recurrences, dot products summed in another order); so does a
``max_iter`` that stops before convergence. The coarsest level runs both
as the dense inverse and as the fixed-count frozen CG (direct_solver="CG")
against saena_tpu's while_loop CG. A step after the loop has stopped
changes no state, and the loops are cached on the hierarchy and dropped
with it by an update.

Card (marker ``cuda``, skipped without one): each loop captured and
replayed gives the uncaptured loop's iterations, history and u bit for
bit, with the same kernel launches; the LU coarse path (n_pad > 2048) and
the coarsest CG capture; a capture that syncs with the host raises; a
capture beside graphs left in reference cycles succeeds.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from saena_tpu_torch import AMG, Matrix, Options, generators
from saena_tpu_torch.amg import graphs
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.amg import solvers as tsolvers
from saena_tpu_torch.convert import load_hierarchy
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.runtime import launches_of

RTOL_HIST = 1e-10
# a history entry that is a recomputed A u - rhs (residual replacement,
# the stationary iterations) carries the rounding of the product, about
# eps * ||r0||, whatever its own size: the floor is 100 eps * ||r0||
ATOL_HIST = 1e-14


@pytest.fixture(scope="module")
def jx():
    """saena_tpu's pieces, imported here rather than at the top so that the
    card's tests of this file also run where JAX is not installed."""
    import jax.numpy as jnp

    from saena_tpu import AMG as JAMG, Matrix as JMatrix
    from saena_tpu.amg import hierarchy as jh
    from saena_tpu.amg import solvers as jsolvers
    from saena_tpu.config import Options as JOptions
    from test_torch_solve import flatten_hierarchy

    return types.SimpleNamespace(jnp=jnp, jh=jh, jsolvers=jsolvers,
                                 JOptions=JOptions, JAMG=JAMG, JMatrix=JMatrix,
                                 flatten=flatten_hierarchy)


def _interior(m):
    return remove_boundary_nodes(generators.laplacian3D(m, m, m))[0].tocsr()


CASES = {"poisson12": {}, "poisson12_coarse_cg": {"direct_solver": "CG"}}


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request, jx):
    A = _interior(12)
    opts = jx.JOptions(**CASES[request.param])
    H, _ = jx.jh.setup(A, opts, dtype=jx.jnp.float64)
    T = load_hierarchy(*jx.flatten(H), dtype=torch.float64, device="cpu")
    rhs = np.random.default_rng(1).standard_normal(A.shape[0])
    return H, T, opts, np.pad(rhs, (0, H.n_pad - H.n))


LOOPS = {
    # name: (solver, SolveParams changes, max_iter)
    "pcg": ("solve_pCG", {}, 100),
    "pcg_replace1": ("solve_pCG", {"residual_replace": 1}, 100),
    "pcg_replace3": ("solve_pCG", {"residual_replace": 3}, 100),
    "pcg_capped": ("solve_pCG", {}, 3),
    "vcycle": ("solve", {}, 60),
    "smoother": ("solve_smoother", {}, 25),
    "cg": ("solve_CG", {}, 40),
}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_loop_matches_saena_tpu(carried, jx, loop):
    H, T, opts, rhs = carried
    name, change, max_iter = LOOPS[loop]
    jp = dataclasses.replace(jx.jh.SolveParams.from_options(opts), **change)
    tp = th.SolveParams(**dataclasses.asdict(jp))
    ref = getattr(jx.jsolvers, name)(H, jx.jnp.asarray(rhs), params=jp,
                                     tol=1e-8, max_iter=max_iter)
    res = getattr(tsolvers, name)(T, rhs, params=tp, tol=1e-8,
                                  max_iter=max_iter)
    it = int(ref.iters)
    assert res.iters == it
    h, hj = res.history.numpy(), np.asarray(ref.history)
    np.testing.assert_allclose(h[: it + 1], hj[: it + 1], rtol=RTOL_HIST,
                               atol=ATOL_HIST * hj[0])
    assert np.isnan(h[it + 1:]).all()
    n = H.n
    np.testing.assert_allclose(res.u[:n].numpy(), np.asarray(ref.u)[:n],
                               rtol=1e-8, atol=1e-8 * np.abs(ref.u).max())
    for f in ("init_res", "final_res"):         # history entries 0 and it
        np.testing.assert_allclose(float(getattr(res, f)),
                                   float(getattr(ref, f)), rtol=RTOL_HIST,
                                   atol=ATOL_HIST * hj[0])
    # ||A u - rhs|| at 1e-8 of ||rhs|| cancels 8 digits
    np.testing.assert_allclose(float(res.true_res), float(ref.true_res),
                               rtol=1e-6)
    if loop == "pcg_capped":
        assert it == max_iter and float(res.rel_res) > 1e-8
    if loop == "pcg_replace1":
        # every iteration's residual is A u - rhs: nothing drifts
        assert float(res.rel_res) < 1e-8
        np.testing.assert_allclose(float(res.final_res), float(res.true_res),
                                   rtol=1e-6)


@pytest.mark.parametrize("loop", ["pcg", "pcg_replace3", "vcycle", "cg"])
def test_step_after_the_stop_changes_nothing(carried, loop):
    """The body's freeze: once the stop flag has dropped, a step leaves
    every state tensor as it is (a while_loop that has exited)."""
    _, T, opts, rhs = carried
    name, change, max_iter = LOOPS[loop]
    tp = dataclasses.replace(th.SolveParams(direct_solver=opts.direct_solver),
                             **change)
    res = getattr(tsolvers, name)(T, rhs, params=tp, max_iter=max_iter)
    build = {"solve_pCG": tsolvers._pcg, "solve": tsolvers._vcycle_iter,
             "solve_CG": tsolvers._cg}[name]
    params = tp if name != "solve_CG" else th.SolveParams()
    loop_ = T.graphs[(build.__name__, params, T.dtype, max_iter)]
    s = loop_.s
    assert not bool(s.go) and int(s.i) == res.iters
    before = {k: v.clone() for k, v in vars(s).items()
              if isinstance(v, torch.Tensor)}
    loop_.parts[1]()                                   # one more step
    for k, v in before.items():
        torch.testing.assert_close(getattr(s, k), v, rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def _amg_pair(jx, m=10):
    A0 = generators.laplacian3D(m, m, m)
    rhs = generators.laplacian3D_set_rhs(m, m, m)
    j = jx.JAMG()
    jA = jx.JMatrix()
    jA.set_csr(A0)
    jA.assemble()
    j.set_matrix(jA, jx.JOptions(remove_boundary=True, setup_shards=0))
    j.set_rhs(rhs)
    t = AMG(device="cpu", dtype=torch.float64)
    tA = Matrix()
    tA.set_csr(A0)
    tA.assemble(device="cpu", dtype=torch.float64)
    t.set_matrix(tA, Options(remove_boundary=True, setup_shards=0))
    t.set_rhs(rhs)
    return A0, j, t


def test_loops_cached_and_dropped_by_update1(jx):
    """The first solve caches its loop on the hierarchy under (solver,
    SolveParams, dtype, max_iter); update1 makes a new hierarchy, which
    starts without loops, and its solve agrees with saena_tpu's."""
    A0, j, t = _amg_pair(jx)
    t.solve_pCG()
    key = ("_pcg", t.params, torch.float64, t.opts.max_iter)
    assert set(t.hierarchy.graphs) == {key}
    t.solve_pCG(tol=1e-6)                    # tol is a buffer, not a key
    assert set(t.hierarchy.graphs) == {key}
    H0 = t.hierarchy
    for s, M in ((j, jx.JMatrix()), (t, Matrix())):
        M.set_csr((1.5 * A0).tocsr())
        if s is t:
            M.assemble(device="cpu", dtype=torch.float64)
        else:
            M.assemble()
        s.update1(M)
    assert t.hierarchy is not H0 and not t.hierarchy.graphs
    u, res = t.solve_pCG()
    uj, ref = j.solve_pCG()
    assert set(t.hierarchy.graphs) == {key}
    assert res.iters == int(ref.iters)
    it = res.iters
    np.testing.assert_allclose(res.history[: it + 1].numpy(),
                               np.asarray(ref.history)[: it + 1], rtol=1e-6)
    np.testing.assert_allclose(u, uj, rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------- the card --


def _card_amg(m, **opts):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = Matrix()
    A.set_csr(generators.laplacian3D(m, m, m))
    A.assemble(device="cuda", dtype=torch.float64)
    s = AMG(device="cuda", dtype=torch.float64)
    s.set_matrix(A, Options(remove_boundary=True, **opts))
    s.set_rhs(np.random.default_rng(2).standard_normal(m ** 3))
    return s


CARD_CASES = {"poisson16": (16, {}), "coarse_cg": (16, {"direct_solver": "CG"}),
              "coarse_lu": (20, {"max_level": 1})}


@pytest.mark.cuda
@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_graph_replay_matches_uncaptured_loop(case, loop):
    m, opts = CARD_CASES[case]
    s = _card_amg(m, **opts)
    if case == "coarse_lu":
        assert s.hierarchy.coarse_lu.lu is not None    # lu_solve, not inv
    name, change, max_iter = LOOPS[loop]
    build = {"solve_pCG": tsolvers._pcg, "solve": tsolvers._vcycle_iter,
             "solve_smoother": tsolvers._smoother_iter,
             "solve_CG": tsolvers._cg}[name]
    s.params = dataclasses.replace(s.params, **change)

    def run(graphs_):
        return s._run(lambda H, r, **kw: tsolvers._solve(build, H, r,
                                                         graphs=graphs_, **kw),
                      max_iter=max_iter)

    run(None)                                          # capture
    (ug, rg), lg = launches_of(lambda: run(None))
    (ue, re_), le = launches_of(lambda: run(False))
    assert rg.iters == re_.iters
    it = rg.iters
    assert torch.equal(rg.history[: it + 1], re_.history[: it + 1])
    assert np.array_equal(ug, ue)
    assert lg == le
    loop_ = next(iter(s.hierarchy.graphs.values()))
    assert loop_.graphs is not None and loop_.capture_ms > 0


@pytest.mark.cuda
def test_cuda_capture_survives_garbage_graphs():
    """A graph left in a reference cycle (as a dropped hierarchy's loops
    are) must not be freed by the collector inside another capture, where
    its reset would invalidate that capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.zeros(8, device="cuda")

    def drop_a_graph_in_a_cycle():
        cycle = [graphs.Graph(lambda: x.add_(1), "a graph to drop")]
        cycle.append(cycle)

    def body():
        junk = [[] for _ in range(200_000)]     # enough for the collector
        x.mul_(2)
        return junk

    for _ in range(3):
        drop_a_graph_in_a_cycle()
        g = graphs.Graph(body, "a capture beside garbage graphs")
    x.fill_(1.0)
    g()
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 2.0))


@pytest.mark.cuda
def test_cuda_failed_capture_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = Matrix()
    A.set_csr(generators.laplacian3D(6, 6, 6))
    A.assemble(device="cuda", dtype=torch.float64)
    v = np.ones(A.get_num_rows())
    with pytest.raises(graphs.GraphCaptureError, match="saena_tpu_torch/api.py"):
        graphs.Graph(lambda: A.matvec(v), "a host copy")
    np.testing.assert_allclose(A.matvec(v), A.csr @ v)   # the card works on
