"""The port's native host kernels (saena_tpu_torch/_native) against
saena_tpu's, and against the port's own numpy versions, on the CPU.

- Every native function of the port gives saena_tpu._native's output on
  the same seeded input, bit for bit (both compile the same C++ with the
  same flags on this host).
- The port's numpy versions (taken without a toolchain) give the native
  output: bit for bit for the strength mask, MIS(1), the strip and strip8
  planners and the GR codec; the SpGEMM's torch fallback to rtol 1e-13
  with the same pattern.
- The loader builds into saena_tpu_torch/_build/ under a digest of the
  sources, the flags and the host CPU, reuses a current build, raises with
  the compiler's output when g++ fails, and gives None without g++.
"""
import fcntl
import os
import shutil
import tempfile
import time

import numpy as np
import pytest
import scipy.sparse as sp

from saena_tpu import _native as jn
from saena_tpu.generators import band_matrix, laplacian3D, random_symm_matrix

from saena_tpu_torch import _native as tn
from saena_tpu_torch.amg import eig as teig
from saena_tpu_torch.amg import galerkin as tgal
from saena_tpu_torch.amg import strength as tstr
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.ops import strip8_spmv as ts8
from saena_tpu_torch.ops import strip_spmv as ts1


def _load_reference_native(tries=10):
    """Load saena_tpu._native's library under a lock the test processes
    share. saena_tpu builds it on first use through one temporary file of a
    fixed name, so two processes that build it at once race, and the loser
    goes on without the library. Under the lock one process builds while
    the others wait; a process that lost a race with one that does not take
    the lock tries again once the winner's library is in place. Without g++
    there is nothing to build, and the tests that need it fail as before."""
    if shutil.which("g++") is None:
        return
    lock = os.path.join(tempfile.gettempdir(), "saena_tpu_native.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for _ in range(tries):
            if jn.have_native():
                return
            time.sleep(2.0)
            jn._TRIED = False


# at import, so every test process loads it before its tests run
_load_reference_native()


def _same(a, b):
    """Bitwise equality of two outputs (arrays, tuples, scalars, bytes)."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    else:
        assert a == b


def _poisson(m=14):
    return remove_boundary_nodes(laplacian3D(m, m, m))[0].tocsr()


MATRICES = {
    "poisson14": _poisson,
    "band": lambda: band_matrix(900, 12).tocsr(),
    "random": lambda: random_symm_matrix(600, 0.02, seed=5).tocsr(),
}


def _sorted_coo(A):
    A = A.tocsr().copy()
    A.sort_indices()
    return A.tocoo()


def test_native_builds_into_the_port_build_dir():
    assert tn.have_native()
    so = tn.library_path(shutil.which("g++"))
    assert os.path.dirname(so) == tn.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    assert os.path.exists(so)
    assert "-ffp-contract=off" in tn.CXX_FLAGS and "-march=native" in tn.CXX_FLAGS


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_strength_keep_and_csr_matvec_bitwise(name):
    A = MATRICES[name]()
    for theta in (0.0, 0.3, 0.7):
        _same(tn.strength_keep(A.indptr, A.indices, A.data, theta),
              jn.strength_keep(A.indptr, A.indices, A.data, theta))
    x = np.random.default_rng(1).standard_normal(A.shape[1])
    _same(tn.csr_matvec(A.indptr, A.indices, A.data, x),
          jn.csr_matvec(A.indptr, A.indices, A.data, x))
    # scipy-identical accumulation
    _same(tn.csr_matvec(A.indptr, A.indices, A.data, x), A @ x)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_mis1_aggregate_and_sweep_bitwise(name):
    S = tstr.strength_graph(MATRICES[name](), 0.3)
    _same(tn.mis1_aggregate(S.indptr, S.indices),
          jn.mis1_aggregate(S.indptr, S.indices))
    n = S.shape[0]
    split = [0, n // 3, 2 * n // 3, n]
    states = []
    for mod in (tn, jn):
        decided = np.zeros(n, np.uint8)
        is_root = np.zeros(n, np.uint8)
        agg = np.arange(n, dtype=np.int64)
        unds = []
        for _ in range(3):            # three rounds over three shards
            ds, rs = decided.copy(), is_root.copy()
            for p in range(3):
                Sh = S[split[p]:split[p + 1]]
                unds.append(mod.mis1_sweep(
                    split[p], np.ascontiguousarray(Sh.indptr, np.int64),
                    np.ascontiguousarray(Sh.indices, np.int32), ds, rs,
                    decided, is_root, agg))
        states.append((decided, is_root, agg, tuple(unds)))
    _same(states[0], states[1])


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spgemm_bitwise(name):
    A = MATRICES[name]()
    rng = np.random.default_rng(2)
    P = sp.random(A.shape[1], 97, density=0.05, random_state=rng, format="csr")
    for nt in (0, 1, 3):
        Z, Zj = tn.spgemm_csr(A, P, nt=nt), jn.spgemm_csr(A, P, nt=nt)
        for attr in ("indptr", "indices", "data"):
            _same(getattr(Z, attr), getattr(Zj, attr))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("perrow", [1, 2, 4, 8, 16])
def test_strip_plan_core_bitwise_and_numpy(name, perrow):
    coo = _sorted_coo(MATRICES[name]())
    rpt = ts1._rpt(perrow)
    n_strips = -(-coo.shape[1] // 128)
    nat = tn.strip_plan_core(coo.row, coo.col, rpt, n_strips, perrow)
    _same(nat, jn.strip_plan_core(coo.row, coo.col, rpt, n_strips, perrow))
    n_rows_pad = -(-coo.shape[0] // rpt) * rpt
    slot, inv, pair_rb, pair_strip = ts1._plan_pairs_numpy(
        coo.row, coo.col, rpt, n_strips, n_rows_pad, perrow)
    np.testing.assert_array_equal(nat[0], slot)
    np.testing.assert_array_equal(nat[1], inv)
    np.testing.assert_array_equal(nat[2], pair_rb)
    np.testing.assert_array_equal(nat[3], pair_strip)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("perrow", [1, 2, 4])
def test_strip8_plan_cores_bitwise_and_numpy(name, perrow):
    coo = _sorted_coo(MATRICES[name]())
    Q = 128 // perrow
    n_rb = -(-coo.shape[0] // Q)
    n_strips = -(-coo.shape[1] // 128)
    for fn in ("strip8_plan_core", "strip8i_plan_core"):
        _same(getattr(tn, fn)(coo.row, coo.col, n_rb, n_strips, perrow),
              getattr(jn, fn)(coo.row, coo.col, n_rb, n_strips, perrow))
    nat = tn.strip8_plan_core(coo.row, coo.col, n_rb, n_strips, perrow)
    ref = ts8._plan8_numpy(coo.row.astype(np.int64), coo.col.astype(np.int64),
                           n_rb, n_strips, perrow)
    for a, b in zip(nat, ref):
        np.testing.assert_array_equal(a, b)


def test_gr_codec_and_delta_bitwise_and_python():
    rng = np.random.default_rng(3)
    A = _poisson(12)
    cols = A.indices.astype(np.uint32)
    seg = A.indptr[:-1].astype(np.int64)
    streams = [rng.integers(0, 300, 4000).astype(np.uint32),
               np.zeros(500, np.uint32),
               np.array([0, 1, 127, 128, 2**20, 2**31, 5], np.uint32)]
    for v in streams:
        _same(tn.gr_pick_k(v), jn.gr_pick_k(v))
        for k in (0, 7, 15, None):
            p, kk = tn.gr_compress(v, k)
            _same((p, kk), jn.gr_compress(v, k))
            _same(tn.gr_decompress(p, v.size, kk), v)
            _same(tn._py_gr_compress(v, kk), p)
            _same(tn._py_gr_decompress(np.frombuffer(p, np.uint8), v.size, kk), v)
    d = tn.delta_encode(cols, seg)
    _same(d, jn.delta_encode(cols, seg))
    _same(tn.delta_decode(d, seg), cols)
    _same(tn.delta_decode(d, seg), jn.delta_decode(d, seg))


def test_numpy_versions_match_native(monkeypatch):
    """Without a toolchain every caller takes its numpy version: the
    strength graph, MIS(1), the strip pairs, strip8's general plan, the
    delta transforms and the eig matvec give the native results."""
    A = _poisson(14)
    S_nat = tstr.strength_graph(A, 0.3)
    agg_nat = tstr.aggregate_mis1(S_nat)
    coo = _sorted_coo(A)
    plan_nat = ts1._plan(coo.row, coo.col, *A.shape, 4)
    p8_nat = ts8._plan8_one(coo.row, coo.col, *A.shape, 2)
    lam_nat = teig.eig_max_invdiag_host(_poisson(20))
    seg = A.indptr[:-1].astype(np.int64)
    d_nat = tn.delta_encode(A.indices, seg)
    Z_nat = tgal._spgemm(A, A)

    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_TRIED", True)
    assert not tn.have_native()
    S_np = tstr.strength_graph(A, 0.3)
    for attr in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(S_np, attr), getattr(S_nat, attr))
    for a, b in zip(tstr.aggregate_mis1(S_np), agg_nat):
        np.testing.assert_array_equal(a, b)
    plan_np = ts1._plan(coo.row, coo.col, *A.shape, 4)
    for key in ("pair_rb", "pair_strip", "slot", "inv", "krb", "padded_pairs"):
        np.testing.assert_array_equal(plan_np[key], plan_nat[key])
    p8_np = ts8._plan8_one(coo.row, coo.col, *A.shape, 2)
    for a, b in zip(p8_np[:5], p8_nat[:5]):
        np.testing.assert_array_equal(a, b)
    assert ts8._plan8_one(coo.row, coo.col, *A.shape, 2, "interval") is None
    assert teig.eig_max_invdiag_host(_poisson(20)) == lam_nat
    np.testing.assert_array_equal(tn.delta_encode(A.indices, seg), d_nat)
    np.testing.assert_array_equal(tn.delta_decode(d_nat, seg), A.indices)
    Z_t = tgal._spgemm(A, A)
    Z_t.sort_indices()      # torch's product leaves a row's columns unsorted
    np.testing.assert_array_equal(Z_t.indptr, Z_nat.indptr)
    np.testing.assert_array_equal(Z_t.indices, Z_nat.indices)
    np.testing.assert_allclose(Z_t.data, Z_nat.data, rtol=1e-13)


def test_mis1_native_matches_fixpoint():
    """The single-pass sweep gives the min-index fixpoint's aggregation
    exactly (tests/test_amg.py::test_mis1_native_matches_fixpoint)."""
    A = remove_boundary_nodes(laplacian3D(20, 20, 20))[0].tocsr()
    cases = [tstr.strength_graph(A, 0.3), tstr.strength_graph(A, 0.7),
             tstr.strength_graph(band_matrix(800, 25).tocsr(), 0.3),
             tstr.strength_graph(random_symm_matrix(700, 0.02, seed=5), 0.3)]
    for S in cases:
        for a, b in zip(tstr.aggregate_mis1(S), tstr._aggregate_mis1_fixpoint(S)):
            np.testing.assert_array_equal(a, b)


def _random_operator(n, density):
    A = sp.random(n, n, density=density, random_state=1, format="csr")
    return (A + sp.identity(n, format="csr")).tocsr()


@pytest.mark.parametrize("n, density, mode", [(1024, 0.1, "interval"),
                                              (2048, 0.05, "general")])
def test_strip8_planner_weighs_modes_by_h100_costs(n, density, mode):
    """The (perrow, mode) sweep builds interval layouts from the native
    planner and weighs the modes by STRIP8_NS_PER_TILE (2.24 / 1.99 ns),
    not by the TPU's 2:1; on the second operator the TPU's weights would
    have picked interval mode."""
    import torch

    A = _random_operator(n, density)
    coo, plan = ts8._plan8(A)
    tiles = {(pr, m): ts8._plan8_one(coo.row, coo.col, n, n, pr, m)[3].shape[0]
             for pr in (1, 2, 4) for m in ("interval", "general")}
    h100 = {k: t * ts8.STRIP8_NS_PER_TILE[k[1]] for k, t in tiles.items()}
    tpu = {k: t * (1.0 if k[1] == "interval" else 2.0) for k, t in tiles.items()}
    assert (plan[7], plan[8]) == min(h100, key=h100.get)
    assert plan[8] == mode
    assert min(tpu, key=tpu.get)[1] == "interval"
    M = ts8.strip8_from_csr(A, torch.float64, "cpu")
    assert M.mode == mode
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(M.n_cols_pad))
    x[n:] = 0
    np.testing.assert_allclose(M.matvec(x)[:n].numpy(), A @ x[:n].numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["interval", "general"])
@pytest.mark.parametrize("perrow", [1, 2, 4])
def test_strip8_layouts_equal_saena_tpu(perrow, mode):
    """A layout of the port's native planner equals saena_tpu's layout of
    the same (perrow, mode) array for array."""
    import jax.numpy as jnp
    import torch
    from saena_tpu.ops import pallas_strip8_spmv as j8

    A = _random_operator(700, 0.03)
    coo = _sorted_coo(A)
    B = A.copy()
    B._saena_strip8_plan = ((B.shape, B.nnz), (
        coo, j8._plan8_one(coo, *A.shape, perrow, mode)))
    J = j8.strip8_from_csr(B, dtype=jnp.float64)
    T = ts8.strip8_from_csr(A, torch.float64, "cpu", perrow=perrow, mode=mode)
    assert (T.perrow, T.mode) == (J.perrow, J.mode) == (perrow, mode)
    for f in ("idx", "vals", "strips", "gather_idx"):
        np.testing.assert_array_equal(getattr(T, f).numpy(),
                                      np.asarray(getattr(J, f)), err_msg=f)


def test_mis1_sweep_rejects_mistyped_arrays():
    S = tstr.strength_graph(_poisson(8), 0.3)
    n = S.shape[0]
    flags = [np.zeros(n, np.uint8) for _ in range(4)]
    agg = np.arange(n, dtype=np.int64)
    with pytest.raises(TypeError):
        tn.mis1_sweep(0, S.indptr.astype(np.int64), S.indices.astype(np.int64),
                      *flags, agg)
    with pytest.raises(ValueError):
        tn.mis1_sweep(1, S.indptr.astype(np.int64), S.indices.astype(np.int32),
                      *flags, agg)


def test_host_helpers_match_saena_tpu():
    """The host helpers ported beside the native paths: the per-row
    reduction (sorted and unsorted rows, empty rows), the power iteration
    and the row splits give saena_tpu's results exactly."""
    from saena_tpu.amg import eig as jeig
    from saena_tpu.amg import strength as jstr
    from saena_tpu.parallel import partition as jpart
    from saena_tpu_torch.parallel import partition as tpart

    rng = np.random.default_rng(6)
    rows = np.sort(rng.integers(0, 50, 400))
    vals = rng.standard_normal(400)
    for r in (rows, rng.permutation(rows)):
        for uf, ident in ((np.maximum, -np.inf), (np.add, 0.0)):
            _same(tstr._row_reduce(uf, vals, r, 60, ident),
                  jstr._row_reduce(uf, vals, r, 60, ident))
    S = (lambda A: (A + A.T).tocsr())(random_symm_matrix(300, 0.05, seed=2))
    assert teig._power_iteration_host(S) == jeig._power_iteration_host(S)
    A = _poisson(10)
    for d in (1, 3, 8):
        _same(tpart.equal_row_split(A.shape[0], d), jpart.equal_row_split(A.shape[0], d))
        _same(tpart.nnz_balanced_split(A, d), jpart.nnz_balanced_split(A, d))
        _same(tpart.subset_split(A, 8, d), jpart.subset_split(A, 8, d))


def test_loader_digest_rebuild(tmp_path, monkeypatch):
    """The library path follows the sources, flags and host CPU; a current
    build is reused; a failed g++ raises with its output; without g++ the
    loader gives None."""
    cxx = shutil.which("g++")
    src = tmp_path / "src"
    shutil.copytree(tn._HERE, src, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(tn, "_HERE", str(src))
    monkeypatch.setattr(tn, "BUILD_DIR", str(tmp_path / "_build"))
    p0 = tn.library_path(cxx)
    with open(src / "mis1.cpp", "a") as f:
        f.write("\n// edited\n")
    p1 = tn.library_path(cxx)
    monkeypatch.setattr(tn, "CXX_FLAGS", tn.CXX_FLAGS + ("-DSAENA_X=1",))
    p2 = tn.library_path(cxx)
    monkeypatch.setattr(tn, "_host_target", lambda c: b"another cpu")
    p3 = tn.library_path(cxx)
    assert len({p0, p1, p2, p3}) == 4
    # a current build is reused without running g++
    os.makedirs(tn.BUILD_DIR)
    open(p3, "wb").close()
    monkeypatch.setattr(tn.subprocess, "run", lambda *a, **k: pytest.fail("rebuilt"))
    assert tn._build(cxx) == p3
    monkeypatch.undo()
    # a source that does not compile raises with g++'s output
    monkeypatch.setattr(tn, "_HERE", str(src))
    monkeypatch.setattr(tn, "BUILD_DIR", str(tmp_path / "_build2"))
    (src / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(tn, "SOURCES", ("broken.cpp",))
    with pytest.raises(RuntimeError, match="broken.cpp"):
        tn._build(cxx)
    # without g++ on PATH: no library, no error
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_TRIED", False)
    monkeypatch.setattr(tn.shutil, "which", lambda name: None)
    assert tn._build_and_load() is None and not tn.have_native()
