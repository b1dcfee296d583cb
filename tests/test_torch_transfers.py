"""Structural transfers, BSR and the accelerator branch of the format pick,
on the CPU in f64.

- SmoothedP / SmoothedR (P_t or P_t^T in a gather format, then the level's
  own A) equal the host P @ x and R @ r to rtol 1e-10 (the smoothed product
  is summed in another order, and the host P drops entries below 1e-14);
- coarsen_tail's structural data follows the coarse reordering: every level
  of a 16^3 setup under structural_transfers="force" applies its host P/R;
- bsr_from_csr builds saena_tpu's arrays exactly; its batched product
  matches scipy to rtol 1e-12;
- prefer_bsr=True takes the accelerator branch on the CPU: wide-stencil DIA
  up to 256 diagonals at fill >= 0.3, a gather format for a scattered
  operator, each matvec equal to scipy's.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from saena_tpu.ops import formats as jf

from saena_tpu_torch.amg.hierarchy import setup
from saena_tpu_torch.amg.prolongation import (
    restriction, smoothed_prolongator, smoothing_diag)
from saena_tpu_torch.amg.strength import find_aggregation
from saena_tpu_torch.config import Options
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.generators import band_matrix, laplacian3D
from saena_tpu_torch.ops import formats as tf
from saena_tpu_torch.ops.strip8_spmv import Strip8Matrix
from saena_tpu_torch.ops.strip_spmv import StripMatrix
from saena_tpu_torch.ops.transfers import (
    SmoothedP, SmoothedR, build_structural, device_bytes, is_symmetric,
    structural_estimate)


def _x(m, seed=0):
    return np.pad(np.random.default_rng(seed).standard_normal(m),
                  (0, tf.pad_to(m) - m))


def _poisson(m):
    return remove_boundary_nodes(laplacian3D(m, m, m))[0]


@pytest.mark.parametrize("psmoother", ["jacobi", "SPAI"])
def test_structural_matches_host_transfers(psmoother):
    A = _poisson(12)
    agg, n_c, _ = find_aggregation(A, 0.3)
    P = smoothed_prolongator(A, agg, n_c, psmoother=psmoother)
    R = restriction(P)
    wq = smoothing_diag(A, psmoother=psmoother)
    Adev = tf.device_matrix_from_csr(A, torch.float64, "cpu")
    Pd, Rd = build_structural(agg, n_c, wq, Adev, int(P.nnz), torch.float64,
                              torch.float64)
    assert Pd.A is Adev and Rd.A is Adev          # the level's A, not a copy
    n = A.shape[0]
    xc = _x(n_c, 1)
    y = Pd.matvec(torch.from_numpy(xc)).numpy()
    ref = P @ xc[:n_c]
    np.testing.assert_allclose(y[:n], ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    assert not y[n:].any()
    r = _x(n, 2)
    z = Rd.matvec(torch.from_numpy(r)).numpy()
    refz = R @ r[:n]
    np.testing.assert_allclose(z[:n_c], refz, rtol=1e-10,
                               atol=1e-10 * np.abs(refz).max())
    assert not z[n_c:].any()


def test_symmetry_gate_and_estimate():
    A = _poisson(10)
    assert is_symmetric(A)
    assert not is_symmetric(sp.random(50, 50, density=0.2, random_state=0,
                                      format="csr"))
    agg, n_c, _ = find_aggregation(A, 0.3)
    Adev = tf.device_matrix_from_csr(A, torch.float64, "cpu")
    assert device_bytes(Adev) == Adev.data.numel() * 8 + Adev.offsets_dev.numel() * 8
    est = structural_estimate(agg, n_c, Adev, torch.float32)
    assert np.isfinite(est) and est > 2 * device_bytes(Adev) / tf.BSR_STREAM_BPS


@pytest.fixture(scope="module")
def forced16():
    return setup(_poisson(16), Options(structural_transfers="force"),
                 dtype=torch.float64, device="cpu")


def test_forced_setup_applies_every_host_transfer(forced16):
    """Under "force" every level's P/R is structural on the CPU, and applies
    the host P/R of that level: the aggregation map and the smoothing
    diagonal follow the coarse reordering."""
    H, info = forced16
    assert len(info.structs) == len(H.levels) - 1
    for l, L in enumerate(H.levels[:-1]):
        assert isinstance(L.P, SmoothedP) and isinstance(L.R, SmoothedR)
        assert L.P.A is L.A and L.R.A is L.A
        assert isinstance(L.P.Pt, (StripMatrix, Strip8Matrix, tf.BsrMatrix))
        P, R = info.Ps[l], info.Rs[l]
        x = _x(P.shape[1], l)
        y = L.P.matvec(torch.from_numpy(x)).numpy()[:P.shape[0]]
        ref = P @ x[:P.shape[1]]
        np.testing.assert_allclose(y, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
        r = _x(R.shape[1], l + 10)
        z = L.R.matvec(torch.from_numpy(r)).numpy()[:R.shape[0]]
        refz = R @ r[:R.shape[1]]
        np.testing.assert_allclose(z, refz, rtol=1e-10,
                                   atol=1e-10 * np.abs(refz).max())


def test_default_cpu_setup_keeps_direct_ell_transfers():
    H, info = setup(_poisson(12), Options(), dtype=torch.float64, device="cpu")
    assert all(s is not None for s in info.structs)   # eligible, not taken
    assert all(type(L.P).__name__ == "EllMatrix" for L in H.levels[:-1])
    H2, info2 = setup(_poisson(12), Options(structural_transfers=False),
                      dtype=torch.float64, device="cpu")
    assert all(s is None for s in info2.structs)


def _scattered(n=2000):
    A = sp.random(n, n, density=0.01, random_state=5, format="csr")
    return (A + sp.eye(n) * 4.0).tocsr()


@pytest.mark.parametrize("name", ["scattered", "rect"])
def test_bsr_same_arrays_as_jax(name):
    A = _scattered(600) if name == "scattered" else sp.random(
        700, 300, density=0.03, random_state=2, format="csr")
    J = jf.bsr_from_csr(A, dtype=jnp.float64)
    T = tf.bsr_from_csr(A, torch.float64, "cpu")
    np.testing.assert_array_equal(T.blocks.numpy(), np.asarray(J.blocks))
    np.testing.assert_array_equal(T.bcols.numpy(), np.asarray(J.bcols))
    x = _x(A.shape[1], 3)
    y = T.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(J.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12 * np.abs(y).max())
    np.testing.assert_allclose(y[:A.shape[0]], A @ x[:A.shape[1]], rtol=1e-12,
                               atol=1e-12 * np.abs(y).max())
    assert tf.bsr_bytes_estimate(A) == jf.bsr_bytes_estimate(A.copy())


def test_accelerator_branch_takes_wide_dia():
    A = band_matrix(2000, 50)                       # 101 diagonals, fill ~0.98
    assert type(tf.device_matrix_from_csr(A, torch.float64, "cpu")).__name__ \
        == "EllMatrix"                              # CPU branch: <= 40 only
    M = tf.device_matrix_from_csr(A, torch.float64, "cpu", prefer_bsr=True)
    assert isinstance(M, tf.DiaMatrix) and len(M.offsets) == 101
    x = _x(2000, 4)
    np.testing.assert_allclose(M.matvec(torch.from_numpy(x)).numpy()[:2000],
                               A @ x[:2000], rtol=1e-12, atol=1e-12)
    wide = band_matrix(1000, 200)                   # 401 diagonals: too many
    assert not isinstance(tf.device_matrix_from_csr(
        wide, torch.float64, "cpu", prefer_bsr=True), tf.DiaMatrix)


def test_accelerator_branch_picks_a_gather_format():
    A = _scattered()
    M = tf.device_matrix_from_csr(A, torch.float64, "cpu", prefer_bsr=True)
    assert isinstance(M, (StripMatrix, Strip8Matrix, tf.BsrMatrix))
    est = {StripMatrix: "strip", Strip8Matrix: "strip8", tf.BsrMatrix: "bsr"}
    from saena_tpu_torch.ops.strip8_spmv import strip8_time_estimate
    from saena_tpu_torch.ops.strip_spmv import strip_time_estimate
    times = {"strip": strip_time_estimate(A, torch.float64),
             "strip8": strip8_time_estimate(A, torch.float64),
             "bsr": tf.bsr_time_estimate(A, torch.float64)}
    assert times[est[type(M)]] == min(times.values())
    assert tf.gather_time_estimate(A, torch.float64) == min(times.values())
    x = _x(2000, 5)
    np.testing.assert_allclose(M.matvec(torch.from_numpy(x)).numpy()[:2000],
                               A @ x[:2000], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("build", ["strip", "strip8", "bsr"])
def test_every_gather_format_matches_scipy(build):
    from saena_tpu_torch.ops.strip8_spmv import strip8_from_csr
    from saena_tpu_torch.ops.strip_spmv import strip_from_csr

    fn = {"strip": strip_from_csr, "strip8": strip8_from_csr,
          "bsr": tf.bsr_from_csr}[build]
    A = _scattered(900)
    M = fn(A, torch.float64, "cpu")
    x = _x(900, 6)
    y = M.matvec(torch.from_numpy(x)).numpy()
    assert y.shape == (tf.pad_to(900),)
    np.testing.assert_allclose(y[:900], A @ x[:900], rtol=1e-12, atol=1e-12)
    assert not y[900:].any()


def test_byte_caps_exclude_every_format(monkeypatch):
    A = _scattered(900)
    monkeypatch.setattr(tf, "GATHER_MAX_BYTES", 1)
    assert tf.pick_gather_format(A, torch.float64) is None
    assert tf.gather_time_estimate(A, torch.float64) == float("inf")
    M = tf.device_matrix_from_csr(A, torch.float64, "cpu", prefer_bsr=True)
    assert type(M).__name__ == "EllMatrix"
