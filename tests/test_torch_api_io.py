"""A solve's vectors between the caller and the device (api._SolveVectors):
the rhs crosses to the device in one copy and is split, padded and cast
there; the answer is merged there and crosses back in one copy.

Every answer is held bit for bit to the host path that it replaced, which
``host_path`` computes here: the numpy gather and boundary division,
``np.pad``, the solver on the padded host array,
``.cpu().numpy().astype(np.float64)`` and the zeros-and-scatter merge.

- remove_boundary on and off, f64 and f32, pCG and pGMRES, with one copy
  each way a solve in ``runtime.copies`` (the host route on the CPU, the
  pinned route on the card, n_full × 8 bytes each way);
- a solve after update1, update2 and update3 on new values: the boundary
  rows are rhs_b / the new diagonal, which the device holds too;
- answers kept over later solves stay as they were, and an rhs mutated in
  place between solves is read anew;
- an rhs of another length is refused.

The card's cases (marker ``cuda``) run the same tests at 32³.
"""
import numpy as np
import pytest
import torch

import saena_tpu_torch as T
from saena_tpu_torch.amg import solvers
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.generators import laplacian3D
from saena_tpu_torch.runtime import copies_of

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
GRID = {"cpu": 12, "cuda": 32}
SOLVERS = {"solve_pCG": (solvers.solve_pCG, {}),
           "solve_pGMRES": (solvers.solve_GMRES, {"precondition": True})}


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0) if name == "cuda" else torch.device("cpu")


def _matrix(A, device, dtype):
    M = T.Matrix()
    M.set_csr(A)
    return M.assemble(device=device, dtype=dtype)


def _amg(device, remove_boundary=True, dtype=torch.float64):
    g = GRID[device.type]
    A = laplacian3D(g, g, g).tocsr()
    amg = T.AMG(device=device, dtype=dtype).set_matrix(
        _matrix(A, device, dtype), T.Options(remove_boundary=remove_boundary))
    return amg, A


def _split(A, remove_boundary):
    """remove_boundary_nodes' (interior, bound, bound_diag), or None."""
    _, interior, bound, diag, _ = remove_boundary_nodes(A)
    return (interior, bound, diag) if remove_boundary and bound.size else None


def host_path(amg, rhs, split, solver="solve_pCG"):
    """The answer as AMG._run computed it on the host before its vectors
    moved to the device."""
    H = amg.hierarchy
    r = rhs
    if split is not None:
        interior, bound, diag = split
        bound_sol = rhs[bound] / diag
        r = rhs[interior]
    rhs_p = np.pad(r, (0, H.n_pad - H.n))
    fn, kw = SOLVERS[solver]
    res = fn(H, rhs_p, params=amg.params, tol=amg.opts.tol,
             max_iter=amg.opts.max_iter, **kw)
    u = res.u[:H.n].cpu().numpy().astype(np.float64)
    if split is None:
        return u
    full = np.zeros(rhs.size)
    full[interior] = u
    full[bound] = bound_sol
    return full


def _same_bits(a, b):
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))


def _one_each_way(made, device, n_full, solves=1):
    route = "pinned" if device.type == "cuda" else "host"
    assert made == {f"h2d.{route}": solves, f"d2h.{route}": solves,
                    "h2d.bytes": 8 * n_full * solves,
                    "d2h.bytes": 8 * n_full * solves}, made


@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("remove_boundary", [True, False])
@pytest.mark.parametrize("device", DEVICES)
def test_solve_matches_the_host_path(device, remove_boundary, dtype, solver):
    dev = _device(device)
    amg, A = _amg(dev, remove_boundary, dtype)
    n_full = A.shape[0]
    rhs = np.random.default_rng(7).uniform(-1.0, 1.0, n_full)
    amg.set_rhs(rhs)
    (u, res), made = copies_of(getattr(amg, solver))
    assert res.iters > 0
    _one_each_way(made, dev, n_full)
    _same_bits(u, host_path(amg, rhs, _split(A, remove_boundary), solver))


def _new_values(A):
    """A with its boundary diagonal times 2 + i / n and 0.5 more on the
    diagonal of its first eight interior rows: a diff small enough that
    update3 propagates it rather than running update2."""
    _, interior, bound, _, _ = remove_boundary_nodes(A)
    d = A.diagonal().copy()
    d[bound] *= 2.0 + np.arange(bound.size) / bound.size
    d[interior[:8]] += 0.5
    B = A.tolil()
    B.setdiag(d)
    return B.tocsr()


@pytest.mark.parametrize("update", ["update1", "update2", "update3"])
@pytest.mark.parametrize("device", DEVICES)
def test_solve_after_an_update_matches_the_host_path(device, update):
    dev = _device(device)
    amg, A = _amg(dev)
    B = _new_values(A)
    assert B.nnz == A.nnz
    getattr(amg, update)(_matrix(B, dev, torch.float64))
    interior, bound, _ = _split(A, True)
    diag = B.diagonal()[bound]
    np.testing.assert_array_equal(amg._io._diag.cpu().numpy(), diag)
    rhs = np.random.default_rng(8).uniform(-1.0, 1.0, A.shape[0])
    amg.set_rhs(rhs)
    u, _ = amg.solve_pCG()
    _same_bits(u[bound], rhs[bound] / diag)
    _same_bits(u, host_path(amg, rhs, (interior, bound, diag)))


@pytest.mark.parametrize("device", DEVICES)
def test_answers_and_rhs_across_solves(device):
    """Five answers kept over five more solves stay as they were and share
    no memory with the staging buffer; an rhs mutated in place after
    set_rhs is read anew by the next solve."""
    dev = _device(device)
    amg, A = _amg(dev)
    n_full = A.shape[0]
    rng = np.random.default_rng(9)
    rhs = [rng.uniform(-1.0, 1.0, n_full) for _ in range(10)]

    def solves():
        out = []
        for b in rhs:
            amg.set_rhs(b)
            out.append(amg.solve_pCG()[0])
        return out

    answers, made = copies_of(solves)
    _one_each_way(made, dev, n_full, solves=10)
    staged = amg._io._out.numpy()
    for u in answers[:5]:
        assert not np.shares_memory(u, staged)
    kept = [u.copy() for u in answers[:5]]
    for b in rhs[:5]:
        amg.set_rhs(b)
        amg.solve_pCG()
    for u, k in zip(answers[:5], kept):
        _same_bits(u, k)
    b = rhs[0].copy()
    amg.set_rhs(b)
    first, _ = amg.solve_pCG()
    b[:] = rhs[1]
    second, _ = amg.solve_pCG()
    _same_bits(first, answers[0])
    _same_bits(second, answers[1])


def test_rhs_of_another_length_is_refused():
    amg, A = _amg(torch.device("cpu"))
    for n in (A.shape[0] - 1, A.shape[0] + 1):
        amg.set_rhs(np.ones(n))
        with pytest.raises(ValueError, match="rows"):
            amg.solve_pCG()
