"""The port's strip-gather format (ops/strip_spmv.py) against saena_tpu's.

- the numpy planner gives the same pair layout (pair_rb, pair_strip, slot,
  inv) as saena_tpu's numpy branch, for every perrow (exactly);
- the plain version, saena_tpu's Pallas kernel in interpret mode and scipy
  agree in f64 to rtol 1e-12 (same products, summed in another order), and
  the zero padding stays exact, for layouts built by either package;
- the work tables the CUDA kernel walks (the pair list cut into equal
  chunks, cut row blocks summed through pieces) cover every pair once and
  write every row block once, checked by walking them in numpy;
- the pick memo holds the pick that strip_from_csr resolved;
- on a card (skips without one) the CUDA kernel matches the plain version:
  row-sum-scaled error 1e-5 in f32, 1e-12 in f64 (FMA contraction).
"""
import copy
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.generators import laplacian3D
from saena_tpu_torch.ops import chunks
from saena_tpu_torch.ops import strip_spmv as ts
from saena_tpu_torch.ops.formats import pad_to
from saena_tpu_torch.runtime import launches_of

PERROWS = (1, 2, 4, 8, 16)


@pytest.fixture(scope="module")
def jx():
    """saena_tpu's strip pieces, imported here so the CUDA-only tests of
    this file also run where JAX is not installed."""
    import jax.numpy as jnp

    from saena_tpu import _native
    from saena_tpu.ops import pallas_strip_spmv as pallas

    return types.SimpleNamespace(jnp=jnp, native=_native, pallas=pallas)


def _rect():
    return sp.random(500, 300, density=0.05, random_state=7, format="csr")


def _overflow():
    """Row 7 has 200 entries, spilling into replica pairs at every perrow."""
    A = sp.random(400, 400, density=0.005, random_state=9, format="csr")
    A = A + sp.csr_matrix((np.ones(200), (np.full(200, 7), np.arange(200))),
                          shape=(400, 400))
    return A.tocsr()


def _poisson(m):
    return remove_boundary_nodes(laplacian3D(m, m, m))[0]


def _wide_short():
    """320 rows, 8192 columns: perrow 16 leaves n_rows_pad short of 384."""
    return sp.random(320, 8192, density=0.002, random_state=11, format="csr")


MATRICES = {"rect": _rect, "overflow": _overflow, "poisson9": lambda: _poisson(9),
            "wide_short": _wide_short}


def _x(m, seed=0):
    return np.pad(np.random.default_rng(seed).standard_normal(m),
                  (0, pad_to(m) - m))


def _close(y, ref):
    np.testing.assert_allclose(y, ref, rtol=1e-12,
                               atol=1e-12 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("perrow", PERROWS)
@pytest.mark.parametrize("name", ["rect", "overflow", "poisson9"])
def test_plan_matches_jax_numpy_plan(name, perrow, jx, monkeypatch):
    monkeypatch.setattr(jx.native, "strip_plan_core", lambda *a, **k: None)
    A = MATRICES[name]()
    coo = A.tocoo()
    ref = jx.pallas._plan(coo.row, coo.col, *A.shape, perrow)
    got = ts._plan(coo.row, coo.col, *A.shape, perrow)
    for key in ("pair_rb", "pair_strip", "slot", "inv", "n_rb", "n_rows_pad",
                "n_strips", "rpt"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name,perrow", [("overflow", pr) for pr in PERROWS]
                         + [("rect", 2), ("wide_short", 16)])
def test_plain_matches_pallas_interpret_and_scipy_f64(name, perrow, jx):
    A = MATRICES[name]()
    n, m = A.shape
    x = _x(m)
    T = ts.strip_from_csr(A, torch.float64, "cpu", perrow=perrow)
    J = jx.pallas.strip_from_csr(A, dtype=jx.jnp.float64, perrow=perrow)
    y = T.matvec(torch.from_numpy(x)).numpy()
    ref = np.asarray(J.matvec(jx.jnp.asarray(x)))
    assert y.shape == ref.shape == (pad_to(n),)
    _close(y, ref)
    _close(y[:n], A @ x[:m])
    assert not y[n:].any()


def _carry(J):
    """A saena_tpu StripMatrix as the port's, array for array."""
    from saena_tpu_torch.convert import _STRIP_META, _matrix

    arrays = {f"S.{f}": np.array(getattr(J, f))
              for f in ("idx", "vals", "strip_of", "rb_local", "sb_of")}
    spec = {"format": "StripMatrix", "shape": list(J.shape), "nnz": J.nnz,
            **{k: getattr(J, k) for k in _STRIP_META}}
    return _matrix(arrays, "S", spec, torch.float64, "cpu")


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_jax_built_layout_carried_across(name, jx):
    """saena_tpu's own picks (native planner, its krb) load one for one,
    int8 indices kept, and give the same product."""
    A = MATRICES[name]()
    J = jx.pallas.strip_from_csr(A, dtype=jx.jnp.float64)
    T = _carry(J)
    assert T.idx.dtype == torch.int8 and T.idx.shape == J.idx.shape
    np.testing.assert_array_equal(T.vals.numpy(), np.asarray(J.vals))
    x = _x(A.shape[1], 1)
    y = T.matvec(torch.from_numpy(x)).numpy()
    _close(y, np.asarray(J.matvec(jx.jnp.asarray(x))))
    assert not y[A.shape[0]:].any()


def _walk_chunks(M, x):
    """The stream path in numpy: warp c takes the pairs
    [chunk_ptr[c], chunk_ptr[c + 1]) segment by segment, folds each
    segment's slot sums over the perrow slot groups and writes the row
    block's rows to y, or, for a cut row block, to a piece that is summed
    with the row block's other pieces in segment order. Checks on the way
    that the segments follow each other and that every row block is
    written once."""
    h = M.chunks.host
    Q = 128 // M.perrow
    rpt = 8 * Q
    idx, vals = M.idx.numpy().astype(np.int64), M.vals.numpy()
    strip_of = M.strip_of.numpy()
    y = np.full(M.n_rows_pad, np.nan)
    part = {}
    seen = np.zeros(idx.shape[0], dtype=int)
    t = np.arange(rpt)
    q, i = t >> 3, t & 7
    for c in range(M.chunks.n_chunks):
        k = h["chunk_ptr"][c]
        for g in range(h["seg_ptr"][c], h["seg_ptr"][c + 1]):
            rb, lo, hi, cut = h["segs"][g]
            assert lo == k <= hi
            acc = np.zeros((8, 128))
            for p in range(lo, hi):
                seen[p] += 1
                acc += vals[p] * x[strip_of[p] * 128 + idx[p]]
            k = hi
            rows = sum(acc[i, s * Q + q] for s in range(M.perrow))
            if cut < 0:
                assert np.isnan(y[rb * rpt:(rb + 1) * rpt]).all()
                y[rb * rpt:(rb + 1) * rpt] = rows
            else:
                part[g] = rows
        assert k == h["chunk_ptr"][c + 1]
    for cut, (g0, n) in enumerate(h["cuts"]):
        rb = h["segs"][g0, 0]
        assert (h["segs"][g0:g0 + n, 0] == rb).all() and (h["segs"][g0:g0 + n, 3] == cut).all()
        assert np.isnan(y[rb * rpt:(rb + 1) * rpt]).all()
        y[rb * rpt:(rb + 1) * rpt] = sum(part.pop(g) for g in range(g0, g0 + n))
    assert not part and not np.isnan(y).any()
    return y, seen


def _rechunk(M, chunk_min):
    """M with its work cut into chunks of about ``chunk_min`` pairs."""
    return M.rechunk(chunk_min, whole_max=0)


@pytest.mark.parametrize("chunk_min", [3, 8, 1000])
@pytest.mark.parametrize("perrow", [1, 4, 16])
def test_kernel_ranges_cover_every_pair_once(perrow, chunk_min):
    A = _overflow()
    M = _rechunk(ts.strip_from_csr(A, torch.float64, "cpu", perrow=perrow), chunk_min)
    x = _x(A.shape[1], 2)
    y, seen = _walk_chunks(M, x)
    assert (seen == 1).all()
    _close(y[:A.shape[0]], A @ x[:A.shape[1]])
    assert not y[A.shape[0]:].any()


def test_row_block_ptr_hands_padding_to_the_last_row_block():
    # two superblocks of krb 4: sb 0 holds rb 0 (2 pairs) and rb 2 (1 pair)
    # then 61 padding pairs; sb 1 holds only padding
    rb_local = np.zeros(128, dtype=np.int32)
    rb_local[2] = 2
    ptr = ts.row_block_ptr(np.array([0, 1]), rb_local, krb=4, n_rb=8)
    np.testing.assert_array_equal(ptr, [0, 2, 2, 64, 64, 128, 128, 128, 128])


@pytest.mark.parametrize("perrow", [1, 8])
def test_n_split_spreads_long_row_blocks(perrow):
    """The rows path shares the longest row block's pairs among n_split
    blocks of about SPLIT_PAIRS pairs; the stream path cuts the pair list
    into chunks of at least STRIP_CHUNK_MIN pairs (at most the resident
    warps), and cuts a row block into at most max_pieces(rpt) pieces, with
    one ticket each. A layout takes the stream path only at perrow > 1 with
    more pairs than the card keeps warps resident."""
    A = _poisson(9)
    M = ts.strip_from_csr(A, torch.float64, "cpu", perrow=perrow)
    n_pairs, n_rb = M.idx.shape[0], M.rb_ptr.size - 1
    cap = chunks.WARPS_PER_SM * chunks.H100_SMS
    assert (M.chunks is not None) == (perrow > 1 and n_pairs > cap)
    longest = int(np.diff(M.rb_ptr).max())
    assert M.n_split == min(ts.MAX_SPLIT, max(1, -(-longest // ts.SPLIT_PAIRS)))
    assert M.counter.shape == (n_rb,) and not M.counter.any()
    C = M.rechunk().chunks
    share = np.diff(C.host["chunk_ptr"])
    assert 1 <= C.n_chunks <= cap and share.sum() == n_pairs
    # equal shares, or row blocks kept whole up to STRIP_WHOLE_MAX pairs
    cut_rbs = C.host["segs"][C.host["cuts"][:, 0], 0]
    assert np.ptp(share) <= 1 or (np.diff(M.rb_ptr)[cut_rbs] > ts.STRIP_WHOLE_MAX).all()
    assert (C.host["cuts"][:, 1] <= chunks.max_pieces(8 * (128 // perrow))).all()
    assert C.counter.shape == (C.n_cuts,) and not C.counter.any()


def _walk_rows(M, x):
    """The rows path in numpy: each row block's pair range [rb_ptr[rb],
    rb_ptr[rb + 1]) cut into n_split splits, each split's slot sums folded
    over the perrow slot groups, the splits summed in order."""
    Q = 128 // M.perrow
    rpt = 8 * Q
    ptr = M.rb_ptr
    idx, vals = M.idx.numpy().astype(np.int64), M.vals.numpy()
    strip_of = M.strip_of.numpy()
    y = np.zeros(M.n_rows_pad)
    seen = np.zeros(idx.shape[0], dtype=int)
    t = np.arange(rpt)
    q, i = t >> 3, t & 7
    for rb in range(ptr.size - 1):
        r0, r1 = ptr[rb], ptr[rb + 1]
        chunk = -(-(r1 - r0) // M.n_split)
        for s in range(M.n_split):
            p0 = min(r1, r0 + s * chunk)
            p1 = min(r1, p0 + chunk)
            acc = np.zeros((8, 128))
            for p in range(p0, p1):
                seen[p] += 1
                acc += vals[p] * x[strip_of[p] * 128 + idx[p]]
            y[rb * rpt + t] += sum(acc[i, g * Q + q] for g in range(M.perrow))
    return y, seen


@pytest.mark.parametrize("perrow", [1, 4, 16])
def test_rows_path_ranges_cover_every_pair_once(perrow):
    A = _overflow()
    M = ts.strip_from_csr(A, torch.float64, "cpu", perrow=perrow)
    M.n_split = 3                         # exercise uneven splits
    x = _x(A.shape[1], 2)
    y, seen = _walk_rows(M, x)
    assert (seen == 1).all()
    _close(y[:A.shape[0]], A @ x[:A.shape[1]])


def test_chunk_tables_mark_every_cut_row_block():
    """A row block is cut exactly when its pairs lie in more than one
    chunk; a layout smaller than one chunk is one block, uncut."""
    A = _overflow()
    M = _rechunk(ts.strip_from_csr(A, torch.float64, "cpu", perrow=1), 5)
    h = M.chunks.host
    owner = np.searchsorted(h["chunk_ptr"], np.arange(M.idx.shape[0]), side="right") - 1
    spans = [np.unique(owner[a:b]).size for a, b in zip(M.rb_ptr[:-1], M.rb_ptr[1:])]
    assert M.chunks.n_cuts > 0
    cut_rbs = h["segs"][h["cuts"][:, 0], 0]
    np.testing.assert_array_equal(cut_rbs, np.flatnonzero(np.array(spans) > 1))
    np.testing.assert_array_equal(h["cuts"][:, 1], np.array(spans)[cut_rbs])
    small = _rechunk(ts.strip_from_csr(A, torch.float64, "cpu", perrow=1), 10 ** 6)
    assert small.chunks.n_chunks == 1 and small.chunks.n_cuts == 0
    assert small.chunks.n_seg == small.rb_ptr.size - 1


def test_pick_memo_holds_the_resolved_pick(monkeypatch):
    """A close sampled call names a runner-up; strip_from_csr plans both in
    full, builds the better, and the memo then holds what was built with its
    exact pair count, so later estimates describe the built layout (the
    JAX package's memo keeps the sampled winner)."""
    A = _overflow()
    coo = A.tocoo()
    full = {pr: ts._plan(coo.row, coo.col, *A.shape, pr) for pr in PERROWS}
    best = min(PERROWS, key=lambda pr: full[pr]["score"])
    worse = max(PERROWS, key=lambda pr: full[pr]["score"])
    monkeypatch.setattr(ts, "_pick_candidate",
                        lambda *a, **k: (worse, 1, best))
    M = ts.strip_from_csr(A, torch.float64, "cpu")
    assert M.perrow == best
    assert ts._pick_cached(A) == (best, full[best]["padded_pairs"], None)
    assert ts.strip_time_estimate(A) == pytest.approx(
        ts.STRIP_LAUNCH_S + full[best]["padded_pairs"]
        * ts.STRIP_NS_BY_PERROW[best] * 1e-9)


def test_pick_memo_keeps_a_winner_that_holds(monkeypatch):
    A = _overflow()
    coo = A.tocoo()
    full = {pr: ts._plan(coo.row, coo.col, *A.shape, pr) for pr in PERROWS}
    best = min(PERROWS, key=lambda pr: full[pr]["score"])
    worse = max(PERROWS, key=lambda pr: full[pr]["score"])
    monkeypatch.setattr(ts, "_pick_candidate",
                        lambda *a, **k: (best, 1, worse))
    assert ts.strip_from_csr(A, torch.float64, "cpu").perrow == best
    assert ts._pick_cached(A) == (best, full[best]["padded_pairs"], None)


def test_sampled_pick_on_a_large_operator():
    """Above _SAMPLE_NNZ the pick runs on a row sample; the layout built is
    exact whatever was picked."""
    A = sp.random(3000, 3000, density=0.02, random_state=4, format="csr")
    assert A.nnz > ts._SAMPLE_NNZ
    M = ts.strip_from_csr(A, torch.float64, "cpu")
    pr, padded, runner = ts._pick_cached(A)
    assert (pr, padded, runner) == (M.perrow, M.pick_pairs, None)
    x = _x(3000, 3)
    _close(M.matvec(torch.from_numpy(x)).numpy()[:3000], A @ x[:3000])


def test_wrapper_uses_plain_on_cpu_without_counting():
    A = _rect()
    M = ts.strip_from_csr(A, torch.float64, "cpu")
    x = torch.from_numpy(_x(A.shape[1]))
    y, made = launches_of(lambda: ts.strip_spmv(M, x))
    assert torch.equal(y, ts.strip_spmv_plain(M, x))
    assert not made


def test_wrapper_raises_on_other_devices():
    M = ts.strip_from_csr(_rect(), torch.float64, "cpu")
    M.vals = M.vals.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        ts.strip_spmv(M, torch.zeros(M.n_cols_pad, device="meta"))


def _cuda_check(M, x, n):
    """Kernel against the plain version (row-sum-scaled error 1e-5 in f32,
    1e-12 in f64), two launches bitwise equal, padding rows zero, tickets
    left zero."""
    (yk, yk2), made = launches_of(lambda: (ts.strip_spmv(M, x), ts.strip_spmv(M, x)))
    torch.cuda.synchronize()
    assert made["strip"] == 2
    assert torch.equal(yk, yk2)
    yp = ts.strip_spmv_plain(M, x)
    absM = copy.copy(M)
    absM.vals = M.vals.abs().double()
    scale = ts.strip_spmv_plain(absM, x.abs().double())
    err = ((yk.double() - yp.double()).abs() / scale.clamp_min(1e-300)).max()
    assert float(err) <= (1e-12 if M.dtype == torch.float64 else 1e-5)
    assert (yk[n:] == 0).all()
    assert not (M.counter.any() or M.chunks is not None and M.chunks.counter.any())
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
@pytest.mark.parametrize("perrow", PERROWS)
def test_cuda_kernel_matches_plain(perrow, dname, path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = _overflow()
    dt = getattr(torch, dname)
    M = _on_path(ts.strip_from_csr(A, dt, "cuda", perrow=perrow), path)
    _cuda_check(M, torch.from_numpy(_x(A.shape[1], 4)).to("cuda", dt), A.shape[0])


def _one_entry():
    return sp.csr_matrix((np.ones(1), ([5], [3])), shape=(128, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("case", ["cut_row_block", "one_pair", "zero_padding",
                                  "uneven_chunks", "misaligned_x"])
def test_cuda_kernel_edge_cases(case, dname):
    """A row block cut by chunk boundaries; an operator of one real pair (and
    63 zero padding pairs); a layout with its zero padding pairs handed to
    a row block in the middle of a chunk; a pair count that is no multiple
    of the chunk; x a view that is not 16-byte aligned (the kernels gather x
    by single values, so the result equals the aligned x's). The cases that
    need no cut run on both paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dname)
    A = _one_entry() if case == "one_pair" else _overflow()
    perrow = {"cut_row_block": 1, "zero_padding": 4}.get(case, 2)
    M = ts.strip_from_csr(A, dt, "cuda", perrow=perrow)
    if case == "cut_row_block":
        M = _rechunk(M, 3)
        assert M.chunks.n_cuts > 0
    if case == "zero_padding":
        assert (M.vals.reshape(M.idx.shape[0], -1) == 0).all(dim=1).any()
    if case == "uneven_chunks":
        M = _rechunk(M, 7)
        assert M.idx.shape[0] % M.chunks.n_chunks != 0
    x = torch.from_numpy(_x(A.shape[1], 5)).to("cuda", dt)
    paths = [None] if case in ("cut_row_block", "uneven_chunks") else ["rows", "stream"]
    for path in paths:
        M = M if path is None else _on_path(M, path)
        if case == "misaligned_x":
            store = torch.zeros(x.numel() + 1, dtype=dt, device="cuda")
            store[1:] = x
            view = store[1:]
            assert view.data_ptr() % 16
            assert torch.equal(_cuda_check(M, view, A.shape[0]),
                               _cuda_check(M, x, A.shape[0]))
        else:
            _cuda_check(M, x, A.shape[0])
