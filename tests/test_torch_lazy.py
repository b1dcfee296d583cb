"""The port's lazy updates (AMG.update1/2/3 and devicify's reuse path)
against saena_tpu's AMG, in f64 on the CPU.

- The same sequence through both packages (update1 with A scaled by 1.5,
  update2 with a shifted diagonal, update3 with a local diff of a few
  entries, a pCG solve after each), with and without remove_boundary:
  the host levels equal bit for bit, the iteration counts are equal and
  the histories agree at rtol 1e-6.
- Reuse: update1 keeps every level below 0 (``is``), the level-0 eig
  value and the coarse LU; a values-only update keeps structural P/R
  (their embedded A unchanged) and moves the strip, strip8 and BSR plan
  memos onto the new CSRs.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import saena_tpu as J
from saena_tpu.generators import laplacian3D

import saena_tpu_torch as T
from saena_tpu_torch.ops import strip8_spmv as ts8
from saena_tpu_torch.ops import strip_spmv as ts1
from saena_tpu_torch.ops.formats import bsr_bytes_estimate, pad_to
from saena_tpu_torch.ops.transfers import SmoothedP, SmoothedR

F64 = dict(dtype=torch.float64, device="cpu")
M = 12


def _matrix(pkg, A):
    mat = pkg.Matrix()
    mat.set_csr(A.copy())
    if pkg is T:
        mat.assemble(**F64)
    else:
        mat.assemble()
    return mat


def _sequence():
    """The full matrices of the sequence: setup, update1, update2, update3."""
    A0 = laplacian3D(M, M, M).tocsr()
    A1 = (1.5 * A0).tocsr()
    A2 = (A1 + sp.diags(np.full(A0.shape[0], 0.1))).tocsr()
    A3 = A2.tolil()
    for i in (5, 400, 1000):
        A3[i, i] += 0.5
    return [A0, A1, A2, A3.tocsr()]


def _drive(pkg, remove_boundary):
    mats = _sequence()
    s = (T.AMG(**F64) if pkg is T else J.AMG())
    s.set_matrix(_matrix(pkg, mats[0]),
                 pkg.Options(remove_boundary=remove_boundary))
    s.set_rhs(np.random.default_rng(0).standard_normal(mats[0].shape[0]))
    out = []
    for upd, A in zip((None, s.update1, s.update2, s.update3), mats):
        if upd is not None:
            upd(_matrix(pkg, A))
        u, res = s.solve_pCG()
        it = int(res.iters)
        out.append((it, np.asarray(res.history)[: it + 1], np.asarray(u),
                    list(s.info.csr_levels)))
    return out


@pytest.mark.parametrize("remove_boundary", [False, True])
def test_update_sequence_matches_saena_tpu(remove_boundary):
    port, ref = _drive(T, remove_boundary), _drive(J, remove_boundary)
    for step, ((it, hist, u, levels), (itj, histj, uj, levelsj)) in \
            enumerate(zip(port, ref)):
        assert len(levels) == len(levelsj), step
        for X, Y in zip(levels, levelsj):
            for attr in ("indptr", "indices", "data"):
                assert np.array_equal(getattr(X, attr), getattr(Y, attr)), step
        assert it == itj, step
        np.testing.assert_allclose(hist, histj, rtol=1e-6)
        np.testing.assert_allclose(u, uj, rtol=1e-8, atol=1e-8 * np.abs(uj).max())


def test_update1_reuses_levels_eig_and_coarse_lu():
    A0 = laplacian3D(M, M, M).tocsr()
    s = T.AMG(**F64).set_matrix(_matrix(T, A0), T.Options())
    h0 = s.hierarchy
    s.update1(_matrix(T, 1.5 * A0))
    h1 = s.hierarchy
    assert h1.levels[0] is not h0.levels[0]
    for l in range(1, h0.n_levels):
        assert h1.levels[l] is h0.levels[l], l
    assert h1.levels[0].eig_max == h0.levels[0].eig_max
    assert h1.coarse_lu is h0.coarse_lu
    assert s.info.native


def test_values_only_update_keeps_structural_transfers():
    """Structural SmoothedP/R embed the A they were smoothed with; a
    values-only update grafts them unchanged, so the device P still equals
    the host P the coarse operators were built through."""
    A0 = laplacian3D(14, 14, 14).tocsr()
    s = T.AMG(**F64).set_matrix(
        _matrix(T, A0), T.Options(structural_transfers="force"))
    h0 = s.hierarchy
    P0, R0 = h0.levels[0].P, h0.levels[0].R
    assert isinstance(P0, SmoothedP) and isinstance(R0, SmoothedR)
    xc = torch.zeros(pad_to(P0.shape[1]), dtype=torch.float64)
    xc[: P0.shape[1]] = torch.from_numpy(
        np.random.default_rng(3).standard_normal(P0.shape[1]))
    P_host = s.info.Ps[0]
    want = P_host @ xc[: P0.shape[1]].numpy()
    s.update1(_matrix(T, 1.7 * A0))
    h1 = s.hierarchy
    assert h1.levels[0].P is P0 and h1.levels[0].R is R0
    assert h1.levels[0].P.A is h0.levels[0].A
    np.testing.assert_allclose(h1.levels[0].P.matvec(xc)[: P0.shape[0]].numpy(),
                               want, rtol=1e-10, atol=1e-12)
    rhs = (1.7 * A0) @ np.ones(A0.shape[0])
    u, _ = s.set_rhs(rhs).solve_pCG()
    assert np.linalg.norm(rhs - 1.7 * A0 @ u) / np.linalg.norm(rhs) < 1e-7


def test_update2_moves_plan_memos_onto_new_csrs():
    """The pattern-only plans (strip pick, strip8 plan, BSR geometry) made
    on a level before an update are found on the same-pattern CSR after
    it; the strip8 memo's COO carries the new values."""
    A0 = laplacian3D(M, M, M).tocsr()
    s = T.AMG(**F64).set_matrix(_matrix(T, A0), T.Options())
    old = s.info.csr_levels[1]
    ts1.strip_time_estimate(old)
    ts8.strip8_time_estimate(old)
    bsr_bytes_estimate(old)
    memos = {a: getattr(old, a, None) for a in (
        "_saena_torch_strip_pick", "_saena_torch_strip8_plan",
        "_saena_torch_bsr_geom")}
    assert all(v is not None for v in memos.values())
    # times 2 is exact, so the filtered coarse patterns stay the same
    s.update2(_matrix(T, (2.0 * A0).tocsr()))
    new = s.info.csr_levels[1]
    assert new is not old and np.array_equal(new.indices, old.indices)
    assert not np.array_equal(new.data, old.data)
    assert new._saena_torch_strip_pick is memos["_saena_torch_strip_pick"]
    key, (coo, plan) = new._saena_torch_strip8_plan
    assert plan is memos["_saena_torch_strip8_plan"][1][1]
    np.testing.assert_array_equal(coo.data, new.tocoo().data)
    assert new._saena_torch_bsr_geom is memos["_saena_torch_bsr_geom"]
    assert not hasattr(new, "_saena_torch_symmetric")


def test_updates_refuse_a_scaled_hierarchy():
    A0 = laplacian3D(8, 8, 8).tocsr()
    s = T.AMG(**F64).set_matrix(_matrix(T, A0), T.Options(scale=True))
    with pytest.raises(NotImplementedError):
        s.update1(_matrix(T, 2.0 * A0))


def test_matrix_surface():
    A0 = laplacian3D(6, 6, 6).tocsr()
    mat = _matrix(T, A0)
    assert mat.get_num_rows() == A0.shape[0] and mat.get_nnz() == A0.nnz
    mat.update_values(2.0 * A0.data)
    x = np.random.default_rng(5).standard_normal(A0.shape[0])
    np.testing.assert_allclose(mat.matvec(x), 2.0 * A0 @ x, rtol=1e-12)
    s = T.AMG(**F64)
    assert s.matrix_diff(mat, _matrix(T, A0)) == np.abs(A0.data).max()
    mat.erase()
    with pytest.raises(ValueError):
        mat.csr
