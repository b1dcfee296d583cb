"""p-coarsening in the port (amg/pcoarsen.py, setup(p_levels=),
dist_setup(p_levels=), AMG.set_matrix(p_levels=)) against saena_tpu, on the
CPU: the cases of tests/test_pcoarsen.py held against saena_tpu's own
functions.

- Element types, DOF selections, injection P matrices, coarse element maps
  and p-level chains are identical (numpy, the same code).
- detect_modal_blocks (a sparse count in the port, a dense one in
  saena_tpu) gives the same unit counts and raises on the same layouts.
- The p+h solve of tests/test_pcoarsen.py (two order-4 quads) gives the
  same coarsen_kinds, level sizes and iterations, histories at rtol 1e-6
  (the goldens' rtol); its host levels are bitwise saena_tpu's.
- dist_setup with p_levels is bitwise the serial setup.
- The reference-data cases (the Nektar++ Helmholtz matrices, the
  SuiteSparse goldens of tests/test_goldens.py:93-132) run under the same
  skipif as saena_tpu's: the data is not in the repository.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import saena_tpu_torch as T
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.amg import pcoarsen as tp
from saena_tpu_torch.amg import solvers as tsolvers
from saena_tpu_torch.parallel.dist_setup import dist_setup

from test_goldens import GOLDENS, REF    # saena_tpu's goldens and data

F64 = dict(dtype=torch.float64, device="cpu")
REF_HELM = f"{REF}/Helmholtz2D_CG_curved_tri"


@pytest.fixture(scope="module")
def jp():
    from saena_tpu.amg import pcoarsen

    return pcoarsen


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _two_quad_mesh(order):
    """Two order-p quads sharing an edge (tests/test_pcoarsen.py)."""
    op1 = order + 1
    grid = np.arange(1, op1 * (2 * op1 - 1) + 1).reshape(op1, 2 * op1 - 1)
    return [grid[:, :op1].ravel(), grid[:, op1 - 1:].ravel()], grid.size


def test_element_types_and_selections_match(jp):
    for n_dof, order in ((9, 2), (6, 2), (27, 2), (10, 2), (3, 2), (3, 1),
                         (5, 4), (25, 4), (15, 4), (18, 2), (35, 4)):
        try:
            ref = jp.element_type(n_dof, order)
        except ValueError:
            with pytest.raises(ValueError):
                tp.element_type(n_dof, order)
            continue
        assert tp.element_type(n_dof, order) == ref
    for etype in (tp.TRI, tp.QUAD, tp.TET, tp.HEX, tp.PRISM, tp.SEG):
        for order in (2, 3, 4, 5):
            for nxt in range(1, order):
                np.testing.assert_array_equal(
                    tp.coarse_dof_positions(order, nxt, etype),
                    jp.coarse_dof_positions(order, nxt, etype))


@pytest.mark.parametrize("order,bdydof", [(2, 0), (4, 0), (4, 3)])
def test_pcoarsen_step_matches(jp, order, bdydof):
    maps, _ = _two_quad_mesh(order)
    got = tp.pcoarsen_step(maps, order, order - 1, bdydof)
    ref = jp.pcoarsen_step(maps, order, order - 1, bdydof)
    _same_csr(got.P, ref.P)
    assert (got.order, got.next_order, got.bdydof) == \
        (ref.order, ref.next_order, ref.bdydof)
    for a, b in zip(got.elem_maps, ref.elem_maps):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("order_dif", [[2, 1], [1, 1, 1], [3]])
def test_pcoarsen_plevels_match(jp, order_dif):
    maps, n = _two_quad_mesh(4)
    got = tp.pcoarsen_plevels(maps, 4, order_dif, bdydof=0, n_fine=n)
    ref = jp.pcoarsen_plevels(maps, 4, order_dif, bdydof=0, n_fine=n)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _same_csr(a, b)


@pytest.mark.parametrize("n_units,nummodes,order_dif",
                         [(5, 4, None), (42, 6, None), (7, 5, [2, 1])])
def test_modal_block_plevels_match(jp, n_units, nummodes, order_dif):
    got = tp.modal_block_plevels(n_units, nummodes, order_dif)
    ref = jp.modal_block_plevels(n_units, nummodes, order_dif)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _same_csr(a, b)


def _modal(n_units_side, nummodes, seed):
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((nummodes, nummodes))
    L = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                 shape=(n_units_side, n_units_side))
    return sp.kron(L, E @ E.T / nummodes + 2 * np.eye(nummodes)).tocsr()


def test_detect_modal_blocks_matches(jp):
    A = _modal(12, 4, 0)
    assert tp.detect_modal_blocks(A, 4) == jp.detect_modal_blocks(A, 4) == 12
    for bad in (3, 5, 1):                     # not a multiple, or < 2
        for mod in (tp, jp):
            with pytest.raises(ValueError):
                mod.detect_modal_blocks(A, bad)
    B = A.tolil()
    B[0, 8] = 0.7                    # one entry in the uncoupled pair (0, 2)
    B = B.tocsr()
    for mod in (tp, jp):
        with pytest.raises(ValueError):
            mod.detect_modal_blocks(B, 4)
    C = A.copy()
    C.data[0] = 0.0                           # an explicit zero is no entry
    for mod in (tp, jp):
        with pytest.raises(ValueError):
            mod.detect_modal_blocks(C, 4)


def _p_then_h_system():
    """tests/test_pcoarsen.py:test_p_then_h_multigrid_solve's system."""
    maps, n = _two_quad_mesh(4)
    rng = np.random.default_rng(0)
    A = sp.lil_matrix((n, n))
    for nodes in maps:
        k = nodes.size
        E = rng.standard_normal((k, 2 * k))
        idx = np.asarray(nodes) - 1
        A[np.ix_(idx, idx)] += E @ E.T / k + 2 * np.eye(k)
    return A.tocsr(), maps, n


def test_p_then_h_solve_matches_saena_tpu(jp):
    import jax.numpy as jnp

    from saena_tpu.amg import hierarchy as jh
    from saena_tpu.amg import solvers as jsolvers
    from saena_tpu.config import Options as JOptions

    A, maps, n = _p_then_h_system()
    rhs = A @ np.ones(n)
    Ps = tp.pcoarsen_plevels(maps, 4, [1, 1, 1], bdydof=0, n_fine=n)
    TH, ti = th.setup(A, T.Options(least_row_threshold=4), p_levels=Ps, **F64)
    JH, ji = jh.setup(A, JOptions(least_row_threshold=4), dtype=jnp.float64,
                      p_levels=jp.pcoarsen_plevels(maps, 4, [1, 1, 1],
                                                   bdydof=0, n_fine=n))
    assert ti.coarsen_kinds == ji.coarsen_kinds
    assert ti.coarsen_kinds[: len(Ps)] == ["p"] * len(Ps)
    assert ti.sizes == ji.sizes
    for a, b in zip(ti.csr_levels, ji.csr_levels):
        _same_csr(a, b)
    rp = np.pad(rhs, (0, TH.n_pad - n))
    params = th.SolveParams.from_options(T.Options(least_row_threshold=4))
    res = tsolvers.solve_pCG(TH, rp, params=params, tol=1e-8, max_iter=200)
    ref = jsolvers.solve_pCG(JH, rp, tol=1e-8, max_iter=200)
    it = int(ref.iters)
    assert res.iters == it
    np.testing.assert_allclose(res.history[: it + 1].numpy(),
                               np.asarray(ref.history)[: it + 1], rtol=1e-6)
    u = res.u[:n].numpy()
    assert np.linalg.norm(rhs - A @ u) / np.linalg.norm(rhs) < 1e-7


@pytest.mark.parametrize("n_shards", [2, 3])
def test_dist_setup_with_p_levels_is_the_serial_setup(n_shards):
    """A modal operator big enough to shard after its p-levels: the
    shard-parallel setup gives the serial hierarchy bit for bit."""
    E = np.random.default_rng(2).standard_normal((3, 3))
    A = sp.kron(T.generators.laplacian2D(40, 40),
                E @ E.T / 3 + 2 * np.eye(3)).tocsr()
    Ps = tp.modal_block_plevels(1600, 3)
    opts = T.Options()
    _, si = th.setup(A, opts, p_levels=Ps, **F64)
    _, di = dist_setup(A, opts, n_shards=n_shards, tail_rows=64,
                       p_levels=Ps, **F64)
    assert si.coarsen_kinds == di.coarsen_kinds and si.coarsen_kinds[0] == "p"
    assert "h" in si.coarsen_kinds
    assert di.comm.dist_levels > 0
    for a, b in zip(si.csr_levels + si.Ps + si.Rs, di.csr_levels + di.Ps + di.Rs):
        _same_csr(a, b)


# ------------------------------------------- reference data (absent here) --


def _read_bin(path):
    from saena_tpu_torch.io.readers import read_bin

    return read_bin(path)


def _golden_solve(A_csr, opts, rhs, p_levels=None, max_iter=300):
    A = T.Matrix()
    A.set_csr(A_csr)
    A.assemble(**F64)
    s = T.AMG(**F64).set_matrix(A, opts, p_levels=p_levels).set_rhs(rhs)
    _, res = s.solve_pCG(max_iter=max_iter)
    it = res.iters
    return it, res.history[: it + 1].numpy(), list(s.info.sizes)


def _check(key, it, hist, levels):
    g = GOLDENS[key]
    assert levels == g["levels"] and it == g["iters"]
    np.testing.assert_allclose(hist, np.asarray(g["history"]), rtol=1e-6)


@pytest.mark.skipif(not os.path.isdir(REF_HELM), reason="reference data absent")
def test_helmholtz_p_coarsening_solve():
    """The p-path on the P5 Helmholtz matrix: P5 -> P4 -> P3 -> P2 then
    h; no more iterations than the h-only setup."""
    A = _read_bin(f"{REF_HELM}/Helmholtz2D_CG_P5_Modes_curved_tri.bin")
    n = A.shape[0]
    rhs = A @ np.ones(n)
    opts = T.Options(least_row_threshold=20)
    Ps = tp.modal_block_plevels(tp.detect_modal_blocks(A, 5), 5)
    assert [P.shape for P in Ps] == [(210, 168), (168, 126), (126, 84)]
    H, info = th.setup(A, opts, p_levels=Ps, **F64)
    assert info.coarsen_kinds[:3] == ["p", "p", "p"]
    assert "h" in info.coarsen_kinds[3:]
    params = th.SolveParams.from_options(opts)
    rp = np.pad(rhs, (0, H.n_pad - n))
    res = tsolvers.solve_pCG(H, rp, params=params, tol=1e-8, max_iter=200)
    u = res.u[:n].numpy()
    assert np.linalg.norm(rhs - A @ u) / np.linalg.norm(rhs) < 1e-7
    Hh, _ = th.setup(A, opts, **F64)
    assert res.iters <= tsolvers.solve_pCG(Hh, rp, params=params, tol=1e-8,
                                           max_iter=200).iters


@pytest.mark.skipif(not os.path.isdir(f"{REF}/FloridaCollection"),
                    reason="reference data absent")
def test_golden_bcsstk16():
    from saena_tpu_torch.io.readers import read_mtx

    A = read_mtx(f"{REF}/FloridaCollection/bcsstk16.mtx")
    _check("bcsstk16", *_golden_solve(A, T.Options(), A @ np.ones(A.shape[0])))


@pytest.mark.skipif(not os.path.isdir(f"{REF}/FloridaCollection"),
                    reason="reference data absent")
def test_golden_sih4_scaled():
    A = _read_bin(f"{REF}/FloridaCollection/SiH4.bin")
    _check("sih4_scaled", *_golden_solve(A, T.Options(scale=True),
                                         A @ np.ones(A.shape[0])))


@pytest.mark.parametrize("p", [2, 5])
@pytest.mark.skipif(not os.path.isdir(REF_HELM), reason="reference data absent")
def test_golden_helmholtz(p):
    A = _read_bin(f"{REF_HELM}/Helmholtz2D_CG_P{p}_Modes_curved_tri.bin")
    n_units = tp.detect_modal_blocks(A, p)
    _check(f"helmholtz_p{p}", *_golden_solve(
        A, T.Options(least_row_threshold=20), A @ np.ones(A.shape[0]),
        p_levels=tp.modal_block_plevels(n_units, p)))
