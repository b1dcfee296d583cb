"""The port's multi-strip format (ops/strip8_spmv.py) against saena_tpu's.

- the numpy planner equals saena_tpu's ``_plan8_numpy`` exactly, and a
  general-mode layout built from the same plan has the same arrays;
- the plain version, saena_tpu's Pallas kernel in interpret mode and scipy
  agree in f64 to rtol 1e-12 (same products, summed in another order), with
  the zero padding exact: general layouts of either package, interval
  layouts (synthetic, and saena_tpu's native planner where it is built),
  and the rectangular Pt / Pt^T of a 16^3 hierarchy;
- the work tables the CUDA kernel walks (the real tiles in row-block
  order, cut into equal chunks, cut row blocks summed through pieces) cover
  every tile once and write every row block once, checked by walking them
  in numpy, for layouts of either package and one whose row blocks' tiles
  are not contiguous;
- on a card (skips without one) the CUDA kernel matches the plain version:
  row-sum-scaled error 1e-5 in f32, 1e-12 in f64 (FMA contraction).
"""
import copy
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch.ops import chunks
from saena_tpu_torch.ops import strip8_spmv as t8
from saena_tpu_torch.ops.formats import pad_to
from saena_tpu_torch.runtime import launches_of

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


@pytest.mark.parametrize("perrow", (1, 2, 4))
def test_interval_walk_reads_zeros_past_the_end(perrow):
    arrays, meta = _interval_arrays(perrow=perrow, seed=perrow)
    M = _rechunk(t8.Strip8Matrix(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                                 **meta), 2)
    # the last tile's base is n_strips - 3: its sublanes 3..7 lie outside x
    np.testing.assert_array_equal(M.unit_strips.numpy()[-8:], [7, 8, 9, -1, -1, -1, -1, -1])
    x = _x(meta["n_cols_pad"], 4)
    y, seen = _walk_chunks(M, x)
    assert M.chunks.n_cuts > 0 and seen.max() == 1
    _close(y, M.matvec(torch.from_numpy(x)).numpy()[:y.size])


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


def _walk_chunks(M, x):
    """The stream path's walk in numpy: warp c takes the list positions
    [chunk_ptr[c], chunk_ptr[c + 1]) of tile_list segment by segment, sums
    each tile's sublanes per lane (strips outside x read zeros), folds the
    perrow lane groups and writes the row block's Q rows to y, or, for a
    cut row block, to a piece summed with the row block's other pieces in
    segment order. Checks that every row block is written once and that
    unit_strips holds each listed tile's strips (-1 outside x)."""
    h = M.chunks.host
    Q = 128 // M.perrow
    idx, vals = M.idx.numpy().astype(np.int64), M.vals.numpy()
    strips, tiles = M.strips.numpy(), M.tile_list.numpy()
    us = M.unit_strips.numpy().reshape(-1, 8)
    n_strips = M.n_cols_pad // 128
    xz = np.concatenate([x, np.zeros(8 * 128)])
    n_rb = M.gather_idx.shape[0]
    y = np.full(n_rb * Q, np.nan)
    part = {}
    seen = np.zeros(idx.shape[0], dtype=int)
    for c in range(M.chunks.n_chunks):
        k = h["chunk_ptr"][c]
        for g in range(h["seg_ptr"][c], h["seg_ptr"][c + 1]):
            rb, lo, hi, cut = h["segs"][g]
            assert lo == k <= hi and M.rbt_ptr[rb] <= lo and hi <= M.rbt_ptr[rb + 1]
            acc = np.zeros(128)
            for pos in range(lo, hi):
                t = tiles[pos]
                seen[t] += 1
                s = us[pos]
                ref = (strips[t] + np.arange(8) if M.mode == "interval"
                       else strips[t * 8:t * 8 + 8])
                np.testing.assert_array_equal(s, np.where(ref < n_strips, ref, -1))
                s = np.where(s >= 0, s, n_strips)           # zeros outside x
                acc += (vals[t] * xz[s[:, None] * 128 + idx[t]]).sum(0)
            k = hi
            rows = acc.reshape(M.perrow, Q).sum(0)
            if cut < 0:
                assert np.isnan(y[rb * Q:(rb + 1) * Q]).all()
                y[rb * Q:(rb + 1) * Q] = rows
            else:
                part[g] = rows
        assert k == h["chunk_ptr"][c + 1]
    for cut, (g0, n) in enumerate(h["cuts"]):
        rb = h["segs"][g0, 0]
        assert (h["segs"][g0:g0 + n, 0] == rb).all() and (h["segs"][g0:g0 + n, 3] == cut).all()
        y[rb * Q:(rb + 1) * Q] = sum(part.pop(g) for g in range(g0, g0 + n))
    assert not part and not np.isnan(y).any()
    return y, seen


def _rechunk(M, chunk_min):
    """M with its work cut into chunks of about ``chunk_min`` tiles."""
    return M.rechunk(chunk_min, whole_max=0)


@pytest.mark.parametrize("chunk_min", [3, 8, 1000])
@pytest.mark.parametrize("perrow", (1, 4))
def test_kernel_splits_cover_every_tile_once(perrow, chunk_min):
    A = _rand(300, 900, 0.3, 6)
    M = _rechunk(t8.strip8_from_csr(A, torch.float64, "cpu", perrow=perrow), chunk_min)
    x = _x(900, 6)
    y, seen = _walk_chunks(M, x)
    gi = M.gather_idx.numpy()
    n_real = int((gi < M.idx.shape[0]).sum())
    assert (seen[:n_real] == 1).all() and not seen[n_real:].any()
    _close(y[:300], A @ x[:900])
    assert not y[300:].any()


@pytest.mark.parametrize("perrow", (1, 4))
def test_n_split_follows_the_longest_tile_list(perrow):
    """The rows path splits a row block's gather_idx row (t_max entries,
    padding included) among n_split blocks of about SPLIT_TILES entries; the
    stream path's grid follows the real tiles, not t_max nor the padding.
    A layout takes the stream path when its row blocks are longer than
    SPLIT_TILES and its real tiles fit the resident warps."""
    M = t8.strip8_from_csr(_rand(300, 900, 0.3, 6), torch.float64, "cpu",
                           perrow=perrow)
    n_real = M.tile_list.numel()
    assert n_real < M.gather_idx.numel()       # gather_idx holds padding
    n_rb, t_max = M.gather_idx.shape
    cap = chunks.WARPS_PER_SM * chunks.H100_SMS
    assert (M.chunks is not None) == (t_max > t8.SPLIT_TILES and n_real <= cap)
    assert M.n_split == min(t8.MAX_SPLIT, max(1, -(-t_max // t8.SPLIT_TILES)))
    assert M.counter.shape == (n_rb,) and not M.counter.any()
    C = M.rechunk().chunks
    share = np.diff(C.host["chunk_ptr"])
    assert share.sum() == n_real and 1 <= C.n_chunks <= cap
    assert C.counter.shape == (C.n_cuts,) and not C.counter.any()


def _shuffled(perrow=2, seed=4):
    """A general-mode layout whose tiles are stored in shuffled order, so a
    row block's tiles are not contiguous, with gather_idx padded by two
    extra columns of padding entries."""
    A = _rand(500, 700, 0.05, seed)
    M = t8.strip8_from_csr(A, torch.float64, "cpu", perrow=perrow)
    n_pad = M.idx.shape[0]
    gi = M.gather_idx.numpy()
    n_real = int((gi < n_pad).sum())
    perm = np.random.default_rng(seed).permutation(n_real)     # old -> new
    inv = np.argsort(perm)
    idx, vals = M.idx.numpy().copy(), M.vals.numpy().copy()
    strips = M.strips.numpy().reshape(n_pad, 8).copy()
    idx[:n_real], vals[:n_real] = idx[inv], vals[inv]
    strips[:n_real] = strips[inv]
    gi = np.where(gi < n_real, perm[np.minimum(gi, n_real - 1)], gi)
    gi = np.pad(gi, ((0, 0), (0, 2)), constant_values=n_pad)
    T = t8.Strip8Matrix(torch.from_numpy(idx), torch.from_numpy(vals),
                        torch.from_numpy(strips.reshape(-1)),
                        torch.from_numpy(gi.astype(np.int32)), M.shape, M.nnz,
                        perrow, "general", M.n_cols_pad, M.n_out)
    return A, T


def test_tile_list_drops_padding_and_keeps_gather_order():
    A, M = _shuffled()
    gi = M.gather_idx.numpy()
    real = gi < M.idx.shape[0]
    np.testing.assert_array_equal(M.tile_list.numpy(), gi[real])
    np.testing.assert_array_equal(np.diff(M.rbt_ptr), real.sum(axis=1))
    tl = M.tile_list.numpy()
    assert (np.diff(tl[M.rbt_ptr[0]:M.rbt_ptr[1]]) != 1).any()   # not contiguous
    x = _x(700, 2)
    y, _ = _walk_chunks(_rechunk(M, 3), x)
    _close(y[:500], A @ x[:700])


@pytest.mark.parametrize("mode", ["general", "interval"])
def test_jax_native_layout_walks_its_tile_list(mode, jx):
    """saena_tpu's native planner builds the layout; carried across, its
    tile list is gather_idx without padding, and the kernel's walk over
    the chunk tables (cut row blocks included) gives its product."""
    if not jx.native.have_native():
        pytest.skip("saena_tpu's native planner is not built here")
    A = _rand(700, 900, 0.03, 11)
    coo = A.tocoo()
    x = _x(900, 5)
    for perrow in (1, 2, 4):
        B = A.copy()
        B._saena_strip8_plan = ((B.shape, B.nnz), (
            coo, jx.pallas._plan8_one(coo, 700, 900, perrow, mode)))
        J = jx.pallas.strip8_from_csr(B, dtype=jx.jnp.float64)
        T = _to_port(J)
        gi = np.asarray(J.gather_idx)
        np.testing.assert_array_equal(T.tile_list.numpy(), gi[gi < T.idx.shape[0]])
        y, seen = _walk_chunks(_rechunk(T, 2), x)
        assert T.chunks.n_cuts > 0 and seen.max() == 1
        _close(y, np.asarray(J.matvec(jx.jnp.asarray(x)))[:y.size])


def test_wrapper_uses_plain_on_cpu_without_counting():
    M = t8.strip8_from_csr(MATRICES["300x300"](), torch.float64, "cpu")
    x = torch.from_numpy(_x(300))
    y, made = launches_of(lambda: t8.strip8_spmv(M, x))
    assert torch.equal(y, t8.strip8_spmv_plain(M, x))
    assert not made


def test_wrapper_raises_on_other_devices():
    M = t8.strip8_from_csr(MATRICES["300x300"](), torch.float64, "cpu")
    M.vals = M.vals.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        t8.strip8_spmv(M, torch.zeros(M.n_cols_pad, device="meta"))


def _cuda_check(M, x, n):
    """Kernel against the plain version (row-sum-scaled error 1e-5 in f32,
    1e-12 in f64), two launches bitwise equal, padding rows zero, tickets
    left zero."""
    (yk, yk2), made = launches_of(lambda: (t8.strip8_spmv(M, x), t8.strip8_spmv(M, x)))
    torch.cuda.synchronize()
    assert made["strip8"] == 2
    assert torch.equal(yk, yk2)
    yp = t8.strip8_spmv_plain(M, x)
    absM = copy.copy(M)
    absM.vals = M.vals.abs().double()
    scale = t8.strip8_spmv_plain(absM, x.abs().double())
    err = ((yk.double() - yp.double()).abs() / scale.clamp_min(1e-300)).max()
    assert float(err) <= (1e-12 if M.dtype == torch.float64 else 1e-5)
    assert (yk[n:] == 0).all() and not M.counter.any()
    assert M.chunks is None or not M.chunks.counter.any()
    return yk



def _on_path(M, path):
    """M sent down the kernel's rows or stream path."""
    if path == "stream":
        return M.rechunk()
    M.chunks = None
    return M


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rows", "stream"])
@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("perrow", (1, 2, 4))
def test_cuda_kernel_matches_plain(perrow, dname, path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = _rand(300, 900, 0.3, 6)
    dt = getattr(torch, dname)
    M = _on_path(t8.strip8_from_csr(A, dt, "cuda", perrow=perrow), path)
    _cuda_check(M, torch.from_numpy(_x(900, 7)).to("cuda", dt), 300)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_cuda_kernel_matches_plain_interval(dname):
    """Interval strips past the end of x read zeros; a row block is cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays, meta = _interval_arrays()
    dt = getattr(torch, dname)
    conv = {"vals": dt}
    M = t8.Strip8Matrix(**{k: torch.from_numpy(v).to("cuda", conv.get(k))
                           for k, v in arrays.items()}, **meta)
    x = torch.from_numpy(_x(meta["n_cols_pad"], 8)).to("cuda", dt)
    _cuda_check(_on_path(M, "rows"), x, meta["shape"][0])
    M = _rechunk(M, 2)
    assert M.chunks.n_cuts > 0
    _cuda_check(M, x, meta["shape"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("case", ["cut_row_block", "one_tile", "zero_padding",
                                  "uneven_chunks", "misaligned_x", "shuffled"])
def test_cuda_kernel_edge_cases(case, dname):
    """A row block cut by chunk boundaries; an operator of one real tile (and
    63 zero padding tiles); gather_idx padding entries and zero padding
    tiles; a tile count that is no multiple of the chunk; x a view that is
    not 16-byte aligned (the kernels gather x by single values, so the
    result equals the aligned x's); a layout whose row blocks' tiles are not contiguous."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dname)
    if case == "shuffled":
        A, Mc = _shuffled()
        M = t8.Strip8Matrix(Mc.idx.cuda(), Mc.vals.to("cuda", dt), Mc.strips.cuda(),
                            Mc.gather_idx.cuda(), Mc.shape, Mc.nnz, Mc.perrow,
                            Mc.mode, Mc.n_cols_pad, Mc.n_out)
    else:
        A = (sp.csr_matrix((np.ones(1), ([5], [3])), shape=(128, 128))
             if case == "one_tile" else _rand(300, 900, 0.3, 6))
        M = t8.strip8_from_csr(A, dt, "cuda", perrow=2)
    if case == "cut_row_block":
        M = _rechunk(M, 3)
        assert M.chunks.n_cuts > 0
    if case == "one_tile":
        assert M.tile_list.numel() == 1
    if case == "zero_padding":
        assert M.tile_list.numel() < M.gather_idx.numel()
        assert M.tile_list.numel() < M.idx.shape[0]
    if case == "uneven_chunks":
        M = _rechunk(M, 7)
        assert M.tile_list.numel() % M.chunks.n_chunks != 0
    x = torch.from_numpy(_x(A.shape[1], 9)).to("cuda", dt)
    n = A.shape[0]
    paths = [None] if case in ("cut_row_block", "uneven_chunks") else ["rows", "stream"]
    for path in paths:
        M = M if path is None else _on_path(M, path)
        if case == "misaligned_x":
            store = torch.zeros(x.numel() + 1, dtype=dt, device="cuda")
            store[1:] = x
            view = store[1:]
            assert view.data_ptr() % 16
            assert torch.equal(_cuda_check(M, view, n), _cuda_check(M, x, n))
        else:
            _cuda_check(M, x, n)
