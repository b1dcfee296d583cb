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
  memos onto the new CSRs; ``SetupInfo.reuse`` records how each level was
  built; a level whose pattern changed is planned and built anew and its
  eig run again, with its P/R device objects kept.
- The update's phases: one ``galerkin`` interval a level's product
  (update2, update3) and ``devicify`` around the rebuild, in the new
  ``SetupInfo``; a loop sees its hierarchy through a weak proxy, so the
  old hierarchy is freed without the cyclic collector.
- The benchmark's time steps (amgbench/traffic/lazy_update2.json) at 12³:
  every answer passes the plain reference's residual, and a uniform scale
  leaves the answer times its factor and the iterations as they were.

Card (marker ``cuda``): 20 update2 steps hold the device memory steady and
capture each step's graphs once.
"""
import gc
import json
import os
import weakref

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import saena_tpu_torch as T
from amgbench import traffic
from amgbench.reference import laplacian3D as ref_laplacian
from amgbench.reference.residual import relative_residuals
from saena_tpu_torch.amg import graphs
from saena_tpu_torch.generators import laplacian3D
from saena_tpu_torch.ops import strip8_spmv as ts8
from saena_tpu_torch.ops import strip_spmv as ts1
from saena_tpu_torch.ops.formats import bsr_bytes_estimate, pad_to
from saena_tpu_torch.ops.transfers import SmoothedP, SmoothedR

F64 = dict(dtype=torch.float64, device="cpu")
M = 12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def J():
    """saena_tpu, imported here rather than at the top so that the card's
    tests of this file also run where JAX is not installed."""
    import saena_tpu

    return saena_tpu


def _matrix(pkg, A, **kw):
    mat = pkg.Matrix()
    mat.set_csr(A.copy())
    if pkg is T:
        mat.assemble(**(kw or F64))
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
    s = T.AMG(**F64) if pkg is T else pkg.AMG()
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
def test_update_sequence_matches_saena_tpu(J, remove_boundary):
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


def _phase_spans(info, name):
    return [sp_ for sp_ in info.phase_spans if sp_[0] == name]


def test_reuse_and_phases_of_each_update():
    """set_matrix leaves ``reuse`` None; update1 rebuilds level 0's values
    and keeps the rest whole, with no Galerkin product; update2 and
    update3 take one ``galerkin`` interval a coarse level, all before the
    ``devicify`` interval, which covers the rebuild's own phases."""
    A0 = laplacian3D(M, M, M).tocsr()
    s = T.AMG(**F64).set_matrix(_matrix(T, A0), T.Options())
    n_lv = s.hierarchy.n_levels
    assert s.info.reuse is None and not _phase_spans(s.info, "devicify")

    s.update1(_matrix(T, (1.5 * A0).tocsr()))
    assert s.info.reuse == ["values"] + ["whole"] * (n_lv - 1)
    assert not _phase_spans(s.info, "galerkin")
    assert len(_phase_spans(s.info, "devicify")) == 1
    assert "devicify" in s.info.phases and "galerkin" not in s.info.phases

    # times 2 is exact: every filtered coarse pattern stays as it was
    A3 = (2.0 * A0).tolil()
    A3[5, 5] += 0.5
    for upd, A in ((s.update2, 2.0 * A0), (s.update3, A3)):
        upd(_matrix(T, A.tocsr()))
        gal = _phase_spans(s.info, "galerkin")
        (dev,) = _phase_spans(s.info, "devicify")
        assert len(gal) == n_lv - 1 and s.info.phases["galerkin"] > 0
        assert all(b <= dev[1] for _, _, b, _ in gal)
        inner = [x for x in s.info.phase_spans if x[0] not in ("galerkin", "devicify")]
        assert inner and all(dev[1] <= a and b <= dev[2] for _, a, b, _ in inner)
        assert len(s.info.reuse) == n_lv
        assert set(s.info.reuse) <= {"whole", "values", "rebuilt"}
    assert s.info.reuse[0] == "values"


def test_update2_rebuilds_a_level_whose_filtered_pattern_moved():
    """The Galerkin filter's threshold is absolute (1e-8 from level 3 on),
    so a scale of A moves entries across it and changes that level's
    pattern: the level's A is planned and built anew ("rebuilt") and its
    eig estimate computed again, as saena_tpu does; the levels whose
    pattern held keep their plans and eig estimates ("values"); every
    level keeps its P/R device objects (the host P and R are the same)."""
    g = 24
    A0 = laplacian3D(g, g, g).tocsr()
    s = T.AMG(**F64).set_matrix(_matrix(T, A0), T.Options())
    old = list(s.info.csr_levels)
    h0 = s.hierarchy
    s.update2(_matrix(T, (1.3 * A0).tocsr()))
    moved = [l for l, (a, b) in enumerate(zip(old, s.info.csr_levels))
             if a.nnz != b.nnz or not np.array_equal(a.indices, b.indices)]
    assert moved and min(moved) >= 3
    assert [l for l, how in enumerate(s.info.reuse) if how == "rebuilt"] == moved
    assert all(how == "values" for l, how in enumerate(s.info.reuse) if l not in moved)
    with_eig = [l for l in moved if h0.levels[l].eig_max is not None]
    assert len(_phase_spans(s.info, "eig")) == len(with_eig) > 0
    assert not _phase_spans(s.info, "devicify_PR")
    for l, (new, was) in enumerate(zip(s.hierarchy.levels, h0.levels)):
        assert new.P is was.P and new.R is was.R
        if l not in moved:
            assert new.eig_max == was.eig_max


def test_update2_with_a_new_pattern_runs_the_eig_again():
    """A changed finest pattern leaves no level's eig estimate standing: the
    levels whose pattern moved run their Lanczos again, and keep their P/R
    device objects, the host P and R being the same."""
    A0 = laplacian3D(M, M, M).tocsr()
    s = T.AMG(**F64).set_matrix(_matrix(T, A0), T.Options())
    h0 = s.hierarchy
    A1 = A0.tolil()
    A1[0, 2] = A1[2, 0] = -0.5
    s.update2(_matrix(T, A1.tocsr()))
    assert s.info.reuse[0] == "rebuilt"
    assert len(_phase_spans(s.info, "eig")) == s.info.reuse[:-1].count("rebuilt")
    assert s.hierarchy.levels[0].P is h0.levels[0].P


def test_update_frees_the_old_hierarchy_without_the_collector():
    """A solve leaves a loop on the hierarchy whose parts see it through a
    weak proxy, so the old hierarchy goes when the update drops it, not at
    the cyclic collector's next run."""
    A0 = laplacian3D(M, M, M).tocsr()
    s = T.AMG(**F64).set_matrix(_matrix(T, A0), T.Options())
    s.set_rhs(np.ones(A0.shape[0])).solve_pCG()
    old = weakref.ref(s.hierarchy)
    assert old().graphs
    gc.collect()
    gc.disable()
    try:
        s.update2(_matrix(T, (2.0 * A0).tocsr()))
        assert old() is None
    finally:
        gc.enable()


def _lazy_mix():
    with open(os.path.join(REPO, "amgbench", "traffic", "lazy_update2.json")) as f:
        return json.load(f)


def _scaled_steps(dtype, g=12, seed=2**31 + 7):
    """The mix's 16 time steps at grid ``g`` through update2 and solve_pCG,
    after a solve of the unscaled hierarchy: (u0, iters0, [(factor, u,
    iters, relative residual by the plain reference)])."""
    kw = dict(dtype=dtype, device="cpu")
    A = ref_laplacian.laplacian3D(g)
    b = np.random.default_rng(seed).uniform(-1.0, 1.0, A.shape[0])
    factors, _ = traffic.scales(_lazy_mix(), seed)
    assert len(factors) == 16
    s = T.AMG(**kw).set_matrix(_matrix(T, A, **kw), T.Options(remove_boundary=True))
    u0, r0 = s.set_rhs(b).solve_pCG()
    out = []
    for f in factors:
        Af = traffic.scaled(A, f)
        s.update2(_matrix(T, Af, **kw))
        u, r = s.solve_pCG()
        rel = relative_residuals(Af, u[:, None], b[:, None])[0]
        out.append((f, u, int(r.iters), rel))
    return u0, int(r0.iters), out


def test_update2_steps_against_the_reference():
    """Every step's answer passes the plain reference's residual at 1e-8. A
    uniform scale leaves D^-1 A, lambda_max, the Chebyshev coefficients and
    pCG's relative stopping test as they were, so each answer times its
    factor is the unscaled answer up to rounding (1e-9 relative), in as
    many iterations; a float32 run cannot meet that."""
    u0, it0, steps = _scaled_steps(torch.float64)
    for f, u, it, rel in steps:
        assert rel <= 1e-8, f
        assert it == it0, f
        assert np.linalg.norm(f * u - u0) <= 1e-9 * np.linalg.norm(u0), f
    u0, _, steps = _scaled_steps(torch.float32)
    worst = max(np.linalg.norm(f * u - u0) / np.linalg.norm(u0) for f, u, _, _ in steps)
    assert worst > 1e-9


@pytest.mark.cuda
def test_cuda_update2_steps_hold_memory_and_capture_once(monkeypatch):
    """20 update2 steps at 32³ on the card: the memory allocated after step
    20 is within 5% of that after step 2, and so is the memory the caching
    allocator reserves; each step captures the new hierarchy's graphs once
    and sets their ``capture_ms``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    kw = dict(dtype=torch.float64, device=dev)
    g = 32
    A = laplacian3D(g, g, g).tocsr()
    captures = [0]
    orig = graphs.Loop._capture

    def counted(self):
        captures[0] += 1
        return orig(self)

    monkeypatch.setattr(graphs.Loop, "_capture", counted)
    s = T.AMG(**kw).set_matrix(_matrix(T, A, **kw), T.Options(remove_boundary=True))
    s.set_rhs(np.ones(A.shape[0]))
    mem = []
    for k in range(20):
        Af = (A * (1.0 + 0.3 * (1 + k % 16))).tocsr()
        s.update2(_matrix(T, Af, **kw))
        n0 = captures[0]
        u, res = s.solve_pCG()
        s.solve_pCG()
        torch.cuda.synchronize(dev)
        loops = list(s.hierarchy.graphs.values())
        assert captures[0] - n0 == len(loops) == 1, k
        assert all(lp.capture_ms is not None and lp.graphs for lp in loops), k
        rel = np.linalg.norm(Af @ u - np.ones(A.shape[0])) / np.sqrt(A.shape[0])
        assert rel <= 1e-8, k
        mem.append((torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)))
    (a2, r2), (a20, r20) = mem[1], mem[-1]
    assert abs(a20 - a2) <= 0.05 * a2, mem
    assert abs(r20 - r2) <= 0.05 * r2, mem
