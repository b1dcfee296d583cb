"""The hybrid ELL kernel "K4" (ops/ell_spmv.py, csrc/ell_spmv.cu).

On the CPU:
- each matrix's per-tile bound is the longest row of each 32-row tile
  (capped at the width), whether built by ``ell_from_csr``, as a smoothers'
  twin or through ``convert.load_hierarchy``;
- ``EllMatrix.matvec`` on the CPU is the plain function, bit for bit;
- the schedule puts every tile in exactly one block and balances the
  blocks by cost.

On a card (skips without one), the kernel against ``ell_spmv_plain``:
relative max error 1e-12 in f64, 1e-5 in f32, 1e-5 row-sum-scaled with bf16
values (f32 x and sums, against the f32 sum of the same bf16 values: a
kernel that rounded x or its products to bf16 would read some 2e-3);
square with spill, rectangular, one whose x outgrows shared memory and
the L1, and a level-3-shaped operator (about 20 K rows of 500-4,900
entries, ``level3_like``); two launches bit-equal, a launch inside a
captured CUDA graph, the launches in runtime.launches, and a refused
dtype.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch.ops import ell_spmv as K
from saena_tpu_torch.ops.formats import EllMatrix, ell_from_csr, pad_to
from saena_tpu_torch.runtime import launches_of

F64 = torch.float64


def _rand(n, m, d, seed):
    A = sp.random(n, m, density=d, random_state=np.random.default_rng(seed),
                  format="csr")
    A.sort_indices()
    return A


def _skewed(n=600, seed=9):
    """Rows of very different length, so ELL at the 0.98 quantile spills."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.01, random_state=1, format="lil")
    for r in (0, 1, 70):
        A[r, rng.choice(n, 80, replace=False)] = rng.standard_normal(80)
    A.setdiag(10.0)
    return A.tocsr()


def level3_like(n=20835, radius=9.67, sigma=0.09, seed=3, dims=(27, 28, 28)):
    """A square operator shaped like the 96^3 Poisson level 3 (20,835 rows,
    50.7 M nonzeros, 499 to 4,699 a row; ELL width 4,037 at the 0.98
    quantile, whose 32-row tiles' longest rows read 68.0 M of 84.2 M
    slots). Its rows are the first n points of a ``dims`` lattice in
    lexicographic order, and row r holds the lattice points within a radius
    ``radius * exp(sigma * z_r / 3)`` of its own (z_r standard normal): the
    rows near the lattice's faces are short, as a Galerkin level's rows
    near the boundary are, and the factor stands for the aggregates'
    uneven sizes. With the defaults: 51.6 M nonzeros, 510 to 4,917 a row,
    width 4,044, 66.6 M of 84.4 M slots read, 82,310 spill triples in 416
    rows (chip_smoke.py times the ELL kernel on it)."""
    rng = np.random.default_rng(seed)
    _, g1, g2 = dims
    r = np.arange(n)
    pz, py, px = r // (g1 * g2), r // g2 % g1, r % g2
    rho2 = (radius * np.exp(sigma * rng.standard_normal(n) / 3)) ** 2
    m = int(np.sqrt(rho2.max())) + 1
    dz, dy, dx = (a.ravel() for a in np.meshgrid(*[np.arange(-m, m + 1)] * 3, indexing="ij"))
    d2 = dz * dz + dy * dy + dx * dx
    near = d2 <= rho2.max()
    dz, dy, dx, d2 = dz[near], dy[near], dx[near], d2[near]

    def held(k):
        """(rows holding offset k, its column)."""
        z, y, x = pz + dz[k], py + dy[k], px + dx[k]
        c = (z * g1 + y) * g2 + x
        return ((z >= 0) & (y >= 0) & (y < g1) & (x >= 0) & (x < g2) & (c < n)
                & (d2[k] <= rho2)), c

    length = sum(held(k)[0].astype(np.int64) for k in range(d2.size))
    indptr = np.concatenate([[0], np.cumsum(length)])
    cols = np.empty(indptr[-1], dtype=np.int32)
    fill = indptr[:-1].copy()
    for k in range(d2.size):            # lexicographic offsets: columns ascend
        ok, c = held(k)
        cols[fill[ok]] = c[ok]
        fill[ok] += 1
    return sp.csr_matrix((rng.standard_normal(cols.size), cols, indptr), shape=(n, n))


MATRICES = {
    "skewed": _skewed,
    "rect_P": lambda: _rand(700, 90, 0.03, 2),
    "rect_R": lambda: _rand(90, 700, 0.05, 4),
    "wide": lambda: _rand(300, 300, 0.3, 5),
}


def _x(m, seed=0, dtype=F64):
    x = np.random.default_rng(seed).standard_normal(m)
    return torch.from_numpy(np.pad(x, (0, pad_to(m) - m))).to(dtype)


def _longest_rows(A, width, n_pad):
    length = np.minimum(np.diff(A.tocsr().indptr), width)
    return np.pad(length, (0, n_pad - length.size)).reshape(-1, K.TILE).max(1)


# ------------------------------------------------------------------ CPU --

@pytest.mark.parametrize("name", sorted(MATRICES))
def test_tile_bound_is_the_longest_row_of_each_tile(name):
    A = MATRICES[name]()
    M = ell_from_csr(A, F64, "cpu", width_quantile=0.98)
    width, n_pad = M.vals.shape
    assert M.tile_bound.dtype == torch.int32
    np.testing.assert_array_equal(M.tile_bound.numpy(), _longest_rows(A, width, n_pad))
    assert M.plan is None                       # the card's plan only


def test_tile_bound_of_a_twin():
    A = _skewed()
    M, T = ell_from_csr(A, F64, "cpu", width_quantile=0.98,
                        smooth_dtype=torch.float32)
    assert T.vals.dtype == torch.float32
    np.testing.assert_array_equal(T.tile_bound.numpy(), M.tile_bound.numpy())
    np.testing.assert_array_equal(
        T.tile_bound.numpy(), _longest_rows(A, *M.vals.shape))


def test_tile_bound_through_load_hierarchy():
    from saena_tpu_torch.convert import load_hierarchy

    A = _rand(500, 500, 0.02, 6) + sp.identity(500, format="csr")
    A = A.tocsr()
    A.sort_indices()
    M = ell_from_csr(A, F64, "cpu", width_quantile=0.98)
    arrays = {f"L0.A.{f}": getattr(M, f).numpy() for f in
              ("cols", "vals", "spill_rows", "spill_cols", "spill_vals")}
    arrays["L0.inv_diag"] = np.ones(M.n_pad)
    meta = {"levels": [{"n": 500, "lvl": 0, "A": {"format": "EllMatrix",
                                                   "shape": [500, 500],
                                                   "nnz": int(A.nnz)}}]}
    H = load_hierarchy(arrays, meta, dtype=F64, device="cpu")
    L = H.levels[0].A
    assert isinstance(L, EllMatrix)
    np.testing.assert_array_equal(L.tile_bound.numpy(),
                                  _longest_rows(A, *M.vals.shape))


def test_tile_bound_leaves_out_trailing_stored_zeros():
    A = _rand(64, 64, 0.2, 7).tolil()
    A[3, :] = 0
    A[3, 0:10] = 1.0
    A = A.tocsr()
    A.sort_indices()
    M = ell_from_csr(A, F64, "cpu")
    M.vals[5:, 3] = 0.0                          # row 3 keeps 5 nonzero slots
    others = [r for r in range(32) if r != 3]
    expect = max(5, int(np.diff(A.indptr)[others].max()))
    assert int(K.tile_bounds(M.vals)[0]) == expect


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_cpu_matvec_is_the_plain_function(name):
    A = MATRICES[name]()
    M = ell_from_csr(A, F64, "cpu", width_quantile=0.98)
    x = _x(A.shape[1], 1)
    y = M.matvec(x)
    assert torch.equal(y, K.ell_spmv_plain(M, x))
    np.testing.assert_allclose(y[: A.shape[0]].numpy(), A @ x[: A.shape[1]].numpy(),
                               rtol=1e-12, atol=1e-12 * float(abs(A).max()))


@pytest.mark.parametrize("n_tiles,n_blocks", [(652, 132), (5, 132), (300, 7), (1, 1)])
def test_schedule_covers_every_tile_once_and_balances(n_tiles, n_blocks):
    cost = np.random.default_rng(n_tiles).integers(565, 4038, n_tiles) + K.TILE_COST
    order, ptr = K.ell_schedule(cost, n_blocks)
    assert order.dtype == ptr.dtype == np.int32
    assert ptr[0] == 0 and ptr[-1] == n_tiles and (np.diff(ptr) >= 1).all()
    assert np.array_equal(np.sort(order), np.arange(n_tiles))
    loads = [int(cost[order[a:b]].sum()) for a, b in zip(ptr[:-1], ptr[1:])]
    for a, b in zip(ptr[:-1], ptr[1:]):
        assert (np.diff(order[a:b]) > 0).all()   # ascending within a block
    # longest-first greedy: no block exceeds the mean by more than one tile
    assert max(loads) <= sum(loads) / len(loads) + cost.max()


def test_schedule_is_a_pure_function_of_the_costs():
    cost = np.random.default_rng(1).integers(0, 5000, 900)
    a, b = K.ell_schedule(cost, 132), K.ell_schedule(cost.copy(), 132)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# ---------------------------------------------------------------- card --

TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _against_plain(A, dname, seed=0):
    """(kernel y, plain y on the card, error): relative max error for f32
    and f64 values, row-sum-scaled for bf16 values."""
    dev = _card()
    dt = getattr(torch, dname)
    M = ell_from_csr(A, dt, dev, width_quantile=0.98)
    cdt = K.compute_dtype(dt)
    x = _x(A.shape[1], seed, cdt).to(dev)
    y = M.matvec(x)
    torch.cuda.synchronize()
    assert y.dtype == cdt and y.shape == (M.n_pad,)
    if dname == "bfloat16":
        M32 = EllMatrix(M.cols, M.vals.float(), M.spill_rows, M.spill_cols,
                        M.spill_vals.float(), M.shape, M.nnz)
        Ma = EllMatrix(M.cols, M.vals.float().abs(), M.spill_rows, M.spill_cols,
                       M.spill_vals.float().abs(), M.shape, M.nnz)
        ref = K.ell_spmv_plain(M32, x)
        scale = K.ell_spmv_plain(Ma, x.abs()).clamp_min(1e-30)
        return M, x, y, ref, float(((y - ref).abs() / scale).max())
    ref = K.ell_spmv_plain(M, x)
    err = float((y - ref).abs().max() / ref.abs().max())
    return M, x, y, ref, err


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_cuda_kernel_matches_plain(name, dname):
    A = MATRICES[name]()
    M, x, y, ref, err = _against_plain(A, dname)
    assert err <= TOL[dname], err
    assert torch.equal(y[A.shape[0]:], torch.zeros_like(y[A.shape[0]:]))
    if name == "skewed":
        assert M.plan.spill_ptr is not None


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float64", "float32", "bfloat16"])
def test_cuda_kernel_x_past_shared_memory(dname):
    """x longer than a block's shared memory and an SM's L1 hold."""
    m = 70_000                                   # 560 KB of f64, 280 KB of f32
    A = _rand(3000, m, 0.002, 8)
    M, x, y, ref, err = _against_plain(A, dname)
    assert M.plan.n_x == pad_to(m)
    assert err <= TOL[dname], err


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float64", "float32", "bfloat16"])
def test_cuda_kernel_level3_shape(dname):
    A = level3_like()
    M, x, y, ref, err = _against_plain(A, dname)
    assert M.plan.n_blocks > 1
    assert err <= TOL[dname], err
    assert M.plan.spill_ptr is not None          # rows past the 0.98 quantile
    assert torch.equal(y, M.matvec(x))


@pytest.mark.cuda
def test_cuda_two_launches_bit_equal_and_counted():
    dev = _card()
    for A, dt in ((_skewed(), F64), (_rand(3000, 70_000, 0.002, 8), F64),
                  (_skewed(), torch.bfloat16)):
        M = ell_from_csr(A, dt, dev, width_quantile=0.98)
        x = _x(A.shape[1], 2, K.compute_dtype(dt)).to(dev)
        (y1, y2), made = launches_of(lambda: (M.matvec(x), M.matvec(x)))
        assert torch.equal(y1, y2)
        assert made["ell"] == 2
        assert made["ell.bf16"] == (2 if dt == torch.bfloat16 else 0)
        assert made[("ell", M.n_pad, pad_to(A.shape[1]), M.vals.shape[0])] == 2


@pytest.mark.cuda
def test_cuda_launch_inside_a_graph():
    from saena_tpu_torch.amg import graphs

    dev = _card()
    A = _skewed()
    M = ell_from_csr(A, F64, dev, width_quantile=0.98)
    x = _x(A.shape[1], 3).to(dev)
    ref = M.matvec(x)
    out = torch.empty_like(ref)
    g, made = launches_of(lambda: graphs.Graph(lambda: out.copy_(M.matvec(x)),
                                               "an ELL matvec"))
    assert not made                              # the capture is taken off
    _, made = launches_of(lambda: (g(), g()))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert made["ell"] == 2                      # replays count as launches


@pytest.mark.cuda
def test_cuda_wrapper_raises():
    dev = _card()
    A = _skewed()
    M = ell_from_csr(A, F64, dev, width_quantile=0.98)
    H = EllMatrix(M.cols, M.vals.half(), M.spill_rows, M.spill_cols,
                  M.spill_vals.half(), M.shape, M.nnz)
    with pytest.raises(TypeError):
        H.matvec(_x(A.shape[1]).to(dev))
    with pytest.raises(ValueError):
        M.matvec(_x(A.shape[1]).to(dev)[:-1])
    with pytest.raises(ValueError):
        M.matvec(torch.cat([_x(A.shape[1]), _x(128)]).to(dev))
