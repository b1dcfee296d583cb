"""The port's multi-strip format (ops/strip8_spmv.py) against saena_tpu's.

- the numpy planner equals saena_tpu's ``_plan8_numpy`` exactly, and a
  general-mode layout built from the same plan has the same arrays;
- the plain version, saena_tpu's Pallas kernel in interpret mode and scipy
  agree in f64 to rtol 1e-12 (same products, summed in another order), with
  the zero padding exact: general layouts of either package, interval
  layouts (synthetic, and saena_tpu's native planner where it is built),
  and the rectangular Pt / Pt^T of a 16^3 hierarchy;
- the split of each row block's tile list that the CUDA kernel walks covers
  every tile once, checked by walking it in numpy;
- on a card (skips without one) the CUDA kernel matches the plain version:
  row-sum-scaled error 1e-5 in f32, 1e-12 in f64 (FMA contraction).
"""
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch.ops import strip8_spmv as t8
from saena_tpu_torch.ops.formats import pad_to

FIELDS = ("idx", "vals", "strips", "gather_idx")


@pytest.fixture(scope="module")
def jx():
    """saena_tpu's strip8 pieces, imported here so the CUDA-only tests of
    this file also run where JAX is not installed."""
    import jax.numpy as jnp

    from saena_tpu import _native
    from saena_tpu.ops import pallas_strip8_spmv as pallas

    return types.SimpleNamespace(jnp=jnp, native=_native, pallas=pallas)


def _rand(n, m, d, seed):
    A = sp.random(n, m, density=d, random_state=np.random.default_rng(seed),
                  format="csr")
    A.sort_indices()
    return A


MATRICES = {
    "500x700": lambda: _rand(500, 700, 0.02, 1),
    "300x300": lambda: _rand(300, 300, 0.1, 2),
    "129x1300": lambda: _rand(129, 1300, 0.05, 3),
}


def _x(m, seed=0):
    return np.pad(np.random.default_rng(seed).standard_normal(m),
                  (0, pad_to(m) - m))


def _close(y, ref):
    np.testing.assert_allclose(y, ref, rtol=1e-12,
                               atol=1e-12 * max(1.0, np.abs(ref).max()))


def _to_port(J):
    """A saena_tpu Strip8Matrix as the port's, array for array."""
    from saena_tpu_torch.convert import _STRIP8_META, _matrix

    arrays = {f"S.{f}": np.array(getattr(J, f)) for f in FIELDS}
    spec = {"format": "Strip8Matrix", "shape": list(J.shape), "nnz": J.nnz,
            **{k: getattr(J, k) for k in _STRIP8_META}}
    return _matrix(arrays, "S", spec, torch.float64, "cpu")


@pytest.mark.parametrize("perrow", (1, 2, 4))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plan8_numpy_matches_jax(name, perrow, jx):
    A = MATRICES[name]()
    coo = A.tocoo()
    Q = 128 // perrow
    args = (coo.row.astype(np.int64), coo.col.astype(np.int64),
            pad_to(A.shape[0], Q) // Q, pad_to(A.shape[1]) // 128, perrow)
    for got, ref, what in zip(t8._plan8_numpy(*args),
                              jx.pallas._plan8_numpy(*args),
                              ("e_tile", "e_sub", "e_krem", "tile_strips",
                               "rb_tiles")):
        np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("perrow", (1, 2, 4))
def test_general_layout_matches_jax_and_scipy_f64(perrow, jx, monkeypatch):
    """The same general-mode plan in both packages gives the same arrays;
    the plain version agrees with the Pallas kernel and with scipy."""
    monkeypatch.setattr(jx.native, "strip8_plan_core", lambda *a, **k: None)
    A = MATRICES["500x700"]()
    coo = A.tocoo()
    B = A.copy()
    B._saena_strip8_plan = ((B.shape, B.nnz), (
        coo, jx.pallas._plan8_one(coo, *A.shape, perrow, "general")))
    J = jx.pallas.strip8_from_csr(B, dtype=jx.jnp.float64)
    T = t8.strip8_from_csr(A, torch.float64, "cpu", perrow=perrow)
    assert (T.perrow, T.mode, T.n_cols_pad, T.n_out) == \
        (J.perrow, J.mode, J.n_cols_pad, J.n_out)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(T, f).numpy(),
                                      np.asarray(getattr(J, f)), err_msg=f)
    x = _x(A.shape[1])
    y = T.matvec(torch.from_numpy(x)).numpy()
    _close(y, np.asarray(J.matvec(jx.jnp.asarray(x))))
    _close(y[:A.shape[0]], A @ x[:A.shape[1]])
    assert not y[A.shape[0]:].any()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_port_picks_match_scipy_f64(name):
    A = MATRICES[name]()
    T = t8.strip8_from_csr(A, torch.float64, "cpu")
    x = _x(A.shape[1], 1)
    y = T.matvec(torch.from_numpy(x)).numpy()
    assert y.shape == (pad_to(A.shape[0]),)
    _close(y[:A.shape[0]], A @ x[:A.shape[1]])
    assert not y[A.shape[0]:].any()


def _interval_arrays(n_rb=6, tiles_per_rb=3, n_strips=10, perrow=2, seed=3,
                     past_end=True):
    """Dense random interval-mode tiles with bases in [0, n_strips - 8]; the
    last row block holds one tile fewer (a padding entry in gather_idx).
    With past_end the last tile's base is n_strips - 3, so its sublanes
    3..7 read past the last strip: zeros, as saena_tpu's strip8_spmv_xla
    defines it (its Pallas kernel reads an 8-strip window that must lie
    inside x)."""
    rng = np.random.default_rng(seed)
    counts = np.full(n_rb, tiles_per_rb)
    counts[-1] -= 1
    n_tiles = int(counts.sum())
    n_pad = t8._padded_tiles(n_tiles)
    idx = np.zeros((n_pad, 8, 128), dtype=np.int8)
    vals = np.zeros((n_pad, 8, 128))
    idx[:n_tiles] = rng.integers(0, 128, (n_tiles, 8, 128))
    vals[:n_tiles] = rng.standard_normal((n_tiles, 8, 128))
    bases = np.zeros(n_pad, dtype=np.int32)
    bases[:n_tiles] = rng.integers(0, n_strips - 7, n_tiles)
    if past_end:
        bases[n_tiles - 1] = n_strips - 3
    gather = np.full((n_rb, tiles_per_rb), n_pad, dtype=np.int32)
    off = np.cumsum(counts) - counts
    for t in range(tiles_per_rb):
        gather[counts > t, t] = off[counts > t] + t
    n_rows = n_rb * (128 // perrow)
    meta = dict(shape=(n_rows, n_strips * 128), nnz=n_tiles * 1024,
                perrow=perrow, mode="interval", n_cols_pad=n_strips * 128,
                n_out=pad_to(n_rows))
    return dict(idx=idx, vals=vals, strips=bases, gather_idx=gather), meta


@pytest.mark.parametrize("past_end", [False, True])
@pytest.mark.parametrize("perrow", (1, 2, 4))
def test_interval_layout_matches_jax_f64(perrow, past_end, jx):
    """Against the Pallas kernel in interpret mode where every 8-strip
    window lies inside x, and against strip8_spmv_xla where one does not."""
    arrays, meta = _interval_arrays(perrow=perrow, seed=perrow, past_end=past_end)
    J = jx.pallas.Strip8Matrix(**{k: jx.jnp.asarray(v) for k, v in arrays.items()},
                               **meta)
    T = t8.Strip8Matrix(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                        **meta)
    x = _x(meta["n_cols_pad"], 4)
    y = T.matvec(torch.from_numpy(x)).numpy()
    if past_end:
        ref_j = np.asarray(jx.pallas.strip8_spmv_xla(J, jx.jnp.asarray(x)))
        _close(y[:ref_j.size], ref_j)
    else:
        _close(y, np.asarray(J.matvec(jx.jnp.asarray(x))))
    # the same sums entry by entry, sublanes past the last strip reading zeros
    n_rb, tpr = arrays["gather_idx"].shape
    Q = 128 // perrow
    ref = np.zeros(meta["n_out"])
    xz = np.concatenate([x, np.zeros(8 * 128)])
    for rb in range(n_rb):
        for t in arrays["gather_idx"][rb]:
            if t == arrays["vals"].shape[0]:
                continue
            cols = (arrays["strips"][t] + np.arange(8))[:, None] * 128 \
                + arrays["idx"][t].astype(np.int64)
            c = (arrays["vals"][t] * xz[cols]).sum(0)
            ref[rb * Q:(rb + 1) * Q] += c.reshape(perrow, Q).sum(0)
    _close(y, ref)


def test_jax_native_interval_layout_carried_across(jx):
    """saena_tpu's native planner makes interval layouts; they load one for
    one and give the same product."""
    if not jx.native.have_native():
        pytest.skip("saena_tpu's native planner is not built here")
    rng = np.random.default_rng(11)
    A = sp.random(700, 900, density=0.03, random_state=rng, format="csr")
    A.sort_indices()
    coo = A.tocoo()
    x = _x(900, 5)
    for perrow in (1, 2, 4):
        B = A.copy()
        B._saena_strip8_plan = ((B.shape, B.nnz), (
            coo, jx.pallas._plan8_one(coo, 700, 900, perrow, "interval")))
        J = jx.pallas.strip8_from_csr(B, dtype=jx.jnp.float64)
        assert J.mode == "interval"
        T = _to_port(J)
        assert T.mode == "interval" and T.idx.dtype == torch.int8
        y = T.matvec(torch.from_numpy(x)).numpy()
        _close(y[:700], A @ x[:900])
        assert not y[700:].any()


def test_rectangular_transfers_of_a_16cubed_hierarchy():
    """Pt (fine x coarse) and Pt^T of every coarsening step of the 16^3
    Poisson setup, in both gather formats, against scipy."""
    from saena_tpu_torch.amg.hierarchy import setup
    from saena_tpu_torch.amg.prolongation import tentative_prolongator
    from saena_tpu_torch.core.coo import remove_boundary_nodes
    from saena_tpu_torch.generators import laplacian3D
    from saena_tpu_torch.ops.strip_spmv import strip_from_csr

    A = remove_boundary_nodes(laplacian3D(16, 16, 16))[0]
    _, info = setup(A, dtype=torch.float64, device="cpu")
    for l, (agg, _) in enumerate(info.structs):
        Pt = tentative_prolongator(agg, info.sizes[l + 1])
        for M in (Pt, Pt.T.tocsr()):
            x = _x(M.shape[1], l)
            for build in (strip_from_csr, t8.strip8_from_csr):
                y = build(M, torch.float64, "cpu").matvec(
                    torch.from_numpy(x)).numpy()
                _close(y[:M.shape[0]], M @ x[:M.shape[1]])
                assert not y[M.shape[0]:].any()


def _walk_kernel_splits(M, x):
    """The CUDA kernel's indexing in numpy: each row block's gather_idx
    entries cut into n_split chunks, tiles summed per lane, lanes folded
    over the perrow groups, chunks summed in order."""
    Q = 128 // M.perrow
    idx, vals = M.idx.numpy().astype(np.int64), M.vals.numpy()
    strips, gather = M.strips.numpy(), M.gather_idx.numpy()
    n_tiles = idx.shape[0]
    n_rb, t_max = gather.shape
    chunk = -(-t_max // M.n_split)
    y = np.zeros(n_rb * Q)
    seen = np.zeros(n_tiles, dtype=int)
    for rb in range(n_rb):
        for s in range(M.n_split):
            acc = np.zeros(128)
            for k in range(min(t_max, s * chunk), min(t_max, s * chunk + chunk)):
                t = gather[rb, k]
                if t >= n_tiles:
                    continue
                seen[t] += 1
                acc += (vals[t] * x[strips[t * 8:t * 8 + 8, None] * 128
                                    + idx[t]]).sum(0)
            y[rb * Q:(rb + 1) * Q] += acc.reshape(M.perrow, Q).sum(0)
    return y, seen


@pytest.mark.parametrize("perrow", (1, 4))
def test_kernel_splits_cover_every_tile_once(perrow):
    A = _rand(300, 900, 0.3, 6)
    M = t8.strip8_from_csr(A, torch.float64, "cpu", perrow=perrow)
    M.n_split = 3
    x = _x(900, 6)
    y, seen = _walk_kernel_splits(M, x)
    n_real = int(M.gather_idx.numpy().max(initial=-1,
                                          where=M.gather_idx.numpy() < M.idx.shape[0]) + 1)
    assert (seen[:n_real] == 1).all() and not seen[n_real:].any()
    _close(y[:300], A @ x[:900])


def test_n_split_follows_the_longest_tile_list():
    M = t8.strip8_from_csr(_rand(300, 900, 0.3, 6), torch.float64, "cpu",
                           perrow=1)
    t_max = M.gather_idx.shape[1]
    assert M.n_split == min(t8.MAX_SPLIT, max(1, -(-t_max // t8.SPLIT_TILES)))
    assert M.counter.shape == (M.gather_idx.shape[0],) and not M.counter.any()


def test_wrapper_uses_plain_on_cpu_without_counting():
    M = t8.strip8_from_csr(MATRICES["300x300"](), torch.float64, "cpu")
    x = torch.from_numpy(_x(300))
    before = t8.launches
    assert torch.equal(t8.strip8_spmv(M, x), t8.strip8_spmv_plain(M, x))
    assert t8.launches == before


def test_wrapper_raises_on_other_devices():
    M = t8.strip8_from_csr(MATRICES["300x300"](), torch.float64, "cpu")
    M.vals = M.vals.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        t8.strip8_spmv(M, torch.zeros(M.n_cols_pad, device="meta"))


def _cuda_check(M, x, n):
    before = t8.launches
    yk = t8.strip8_spmv(M, x)
    torch.cuda.synchronize()
    assert t8.launches == before + 1
    yp = t8.strip8_spmv_plain(M, x)
    absM = t8.Strip8Matrix(M.idx, M.vals.abs().double(), M.strips, M.gather_idx,
                           M.shape, M.nnz, M.perrow, M.mode, M.n_cols_pad,
                           M.n_out)
    scale = t8.strip8_spmv_plain(absM, x.abs().double())
    err = ((yk.double() - yp.double()).abs() / scale.clamp_min(1e-300)).max()
    assert float(err) <= (1e-12 if M.dtype == torch.float64 else 1e-5)
    assert (yk[n:] == 0).all() and not M.counter.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("perrow", (1, 2, 4))
def test_cuda_kernel_matches_plain(perrow, dname):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = _rand(300, 900, 0.3, 6)
    dt = getattr(torch, dname)
    M = t8.strip8_from_csr(A, dt, "cuda", perrow=perrow)
    _cuda_check(M, torch.from_numpy(_x(900, 7)).to("cuda", dt), 300)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_cuda_kernel_matches_plain_interval(dname):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays, meta = _interval_arrays()
    dt = getattr(torch, dname)
    conv = {"vals": dt}
    M = t8.Strip8Matrix(**{k: torch.from_numpy(v).to("cuda", conv.get(k))
                           for k, v in arrays.items()}, **meta)
    x = torch.from_numpy(_x(meta["n_cols_pad"], 8)).to("cuda", dt)
    _cuda_check(M, x, meta["shape"][0])
