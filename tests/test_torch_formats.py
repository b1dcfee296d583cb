"""The port's device formats and converters against saena_tpu's, in f64 on
the CPU.

Converters must produce the same arrays (exactly: both packages place the
same host values). Matvecs agree to rtol 1e-12: the same products, summed
in another order. The format pick and the matvec of every level of a 16^3
hierarchy must agree when both devicify() calls get saena_tpu's own
csr_levels / Ps / Rs.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from saena_tpu.amg import hierarchy as jh
from saena_tpu.config import Options as JOptions
from saena_tpu.core.coo import remove_boundary_nodes
from saena_tpu.generators import band_matrix, laplacian3D
from saena_tpu.ops import formats as jf

from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.config import Options
from saena_tpu_torch.ops import formats as tf


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-12,
                               atol=1e-12 * max(1.0, np.abs(b).max()))


def _x(m, seed=0):
    rng = np.random.default_rng(seed)
    return np.pad(rng.standard_normal(m), (0, tf.pad_to(m) - m))


def _poisson(m):
    A0 = laplacian3D(m, m, m)
    return remove_boundary_nodes(A0, np.ones(A0.shape[0]))[0]


def _skewed():
    """Rows of very different length, so ELL at the 0.98 quantile spills."""
    rng = np.random.default_rng(9)
    n = 600
    A = sp.random(n, n, density=0.01, random_state=1, format="lil")
    for r in (0, 1):                                # two long rows
        A[r, rng.choice(n, 80, replace=False)] = rng.standard_normal(80)
    A.setdiag(10.0)
    return A.tocsr()


MATRICES = {
    "poisson8": lambda: _poisson(8),
    "band500": lambda: band_matrix(500, 4),
    "skewed": _skewed,
    "rect_P": lambda: sp.random(700, 90, density=0.03, random_state=2,
                                format="csr"),
}


@pytest.mark.parametrize("n", [1, 127, 128, 129, 97336])
def test_pad_to(n):
    assert tf.pad_to(n) == jf.pad_to(n)
    assert tf.pad_to(n) % tf.PAD == 0


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ell_from_csr_same_arrays(name):
    A = MATRICES[name]()
    J = jf.ell_from_csr(A, dtype=jnp.float64, width_quantile=0.98)
    T = tf.ell_from_csr(A, torch.float64, "cpu", width_quantile=0.98)
    for f in ("cols", "vals", "spill_rows", "spill_cols", "spill_vals"):
        np.testing.assert_array_equal(getattr(T, f).numpy(),
                                      np.asarray(getattr(J, f)), err_msg=f)
    assert (T.shape, T.nnz) == (J.shape, J.nnz)
    x = _x(A.shape[1])
    _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))


def test_ell_spill_is_exercised():
    T = tf.ell_from_csr(_skewed(), torch.float64, "cpu", width_quantile=0.98)
    assert T.spill_rows.numel() > 0


def test_ell_spill_sums_in_a_fixed_order():
    """The spill's row groups list every triple once, in its order, under
    its row; the matvec gives saena_tpu's to 1e-12 and two give equal bits."""
    A = _skewed()
    T = tf.ell_from_csr(A, torch.float64, "cpu", width_quantile=0.98)
    J = jf.ell_from_csr(A, dtype=jnp.float64, width_quantile=0.98)
    rows = T.spill_rows.numpy()
    seg_rows, seg_idx = (t.numpy() for t in T.seg)
    S = rows.size
    assert np.unique(seg_rows).size == seg_rows.size
    listed = seg_idx[seg_idx < S]
    assert np.array_equal(np.sort(listed), np.arange(S))
    for u, lst in zip(seg_rows, seg_idx):
        lst = lst[lst < S]
        assert (rows[lst] == u).all() and (np.diff(lst) > 0).all()
    assert T.seg[1].shape[1] >= 2                # some row spills several
    x = _x(A.shape[1], seed=4)
    y = T.matvec(torch.from_numpy(x))
    _close(y, J.matvec(jnp.asarray(x)))
    assert torch.equal(y, T.matvec(torch.from_numpy(x)))


@pytest.mark.cuda
def test_cuda_ell_spill_matvecs_are_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = _skewed()
    T = tf.ell_from_csr(A, torch.float64, "cuda", width_quantile=0.98)
    x = torch.from_numpy(_x(A.shape[1], seed=4)).cuda()
    y = T.matvec(x)
    assert torch.equal(y, T.matvec(x))
    _close(y.cpu(), tf.ell_from_csr(A, torch.float64, "cpu", width_quantile=0.98)
           .matvec(x.cpu()))


@pytest.mark.parametrize("name", ["poisson8", "band500"])
def test_dia_from_csr_same_arrays(name):
    A = MATRICES[name]()
    J = jf.dia_from_csr(A, dtype=jnp.float64)
    T = tf.dia_from_csr(A, torch.float64, "cpu")
    assert T.offsets == J.offsets
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    np.testing.assert_array_equal(tf.dia_offsets_of(A), jf.dia_offsets_of(A))
    x = _x(A.shape[0])
    _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))


@pytest.mark.parametrize("unit_diag_pad", [False, True])
def test_dense_from_csr_same_arrays(unit_diag_pad):
    A = _poisson(4)
    J = jf.dense_from_csr(A, dtype=jnp.float64, unit_diag_pad=unit_diag_pad)
    T = tf.dense_from_csr(A, torch.float64, "cpu", unit_diag_pad=unit_diag_pad)
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    x = _x(A.shape[1])
    _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_device_matrix_from_csr_same_pick(name):
    A = MATRICES[name]()
    J = jf.device_matrix_from_csr(A, dtype=jnp.float64)
    T = tf.device_matrix_from_csr(A, torch.float64, "cpu")
    assert type(T).__name__ == type(J).__name__
    x = _x(A.shape[1])
    _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))


def test_coarse_ordering_helpers():
    """The RCM-vs-original footprint comparison that decides the coarse
    ordering (and with it the next level's aggregation)."""
    A = _poisson(8)
    np.testing.assert_array_equal(tf.rcm_permutation(A), jf.rcm_permutation(A))
    coo = A.tocoo()
    assert tf.bsr_block_width(coo.row, coo.col, A.shape) == \
        jf.bsr_block_width(coo.row, coo.col, A.shape)
    assert tf.bsr_bytes_estimate(A) == jf.bsr_bytes_estimate(A.copy())


@pytest.fixture(scope="module")
def hier16():
    """saena_tpu's serial setup of the 16^3 Poisson interior in f64."""
    A = _poisson(16)
    _, info = jh.setup(A, JOptions(remove_boundary=True), dtype=jnp.float64)
    return info


def test_devicify_same_formats_and_matvecs(hier16):
    info = hier16
    Jh, Ji = jh.devicify(info.csr_levels, info.Ps, info.Rs, JOptions(),
                         dtype=jnp.float64)
    Th, Ti = th.devicify(info.csr_levels, info.Ps, info.Rs, Options(),
                         dtype=torch.float64, device="cpu")
    assert Ti.formats == Ji.formats
    assert Ti.formats[0] == "DiaMatrix" and Ti.sizes == Ji.sizes
    for l, (JL, TL) in enumerate(zip(Jh.levels, Th.levels)):
        assert TL.eig_max == JL.eig_max, l
        np.testing.assert_array_equal(TL.inv_diag.numpy(), np.asarray(JL.inv_diag))
        ops = [("A", JL.A, TL.A)]
        if JL.P is not None:
            assert type(TL.P).__name__ == type(JL.P).__name__ == "EllMatrix"
            ops += [("P", JL.P, TL.P), ("R", JL.R, TL.R)]
        for name, J, T in ops:
            x = _x(J.shape[1], seed=l)
            _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))
    np.testing.assert_array_equal(Th.coarse_lu.inv.numpy(),
                                  np.asarray(Jh.coarse_lu.inv))
