"""Strip-gather SpMV: the format, its host planner, the kernel wrapper and
its plain PyTorch version.

The port of saena_tpu/ops/pallas_strip_spmv.py (the Pallas kernel
``_kernel`` there, launched by ``strip_spmv``). A is stored as PAIRS: all
nonzeros whose row lies in one row block of ``rpt = 8 * 128 / perrow``
rows and whose column lies in one 128-column strip of x. Each pair owns one
(8, 128) tile of lane indices (int8, the column within the strip) and
values; slot (i, j) of a tile belongs to row ``i + 8 * (j % Q)`` of the
row block, ``Q = 128 / perrow``, so every row has ``perrow`` slots per
pair. Rows with more entries in one strip spill into replica pairs.

Pairs are stored superblock-major (``krb`` row blocks per superblock), each
superblock padded with zero pairs (strip 0, ``rb_local`` 0) to a multiple
of ``GROUP``: the layout of the JAX package, so its arrays load one for
one. Its pairs come in row-block order; ``rb_ptr`` (where each row block's
pairs start) is derived from ``sb_of`` and ``rb_local`` when the matrix is
built, and from it the tables of the kernel's two paths: ``n_split`` and
``counter`` for the rows path, and, when the layout takes the stream path,
``chunks`` (ops/chunks.py): the pair list cut into chunks, one per kernel
warp, with the row blocks that the cuts split and their tickets. Tickets are
zeros between launches, so a matrix takes one launch at a time: its
launches go to one stream.

    y[row] = sum over the row's slots of vals * x[strip * 128 + idx]

`strip_spmv` launches the CUDA kernel (csrc/strip_spmv.cu) for tensors on
the card, on the layout's path, and runs `strip_spmv_plain` for tensors on
the CPU; it never falls back from one to the other. bf16 values take an
f32 x and y (the smoothers' twin of an operator, Options.smooth_dtype).
Launches are recorded in `runtime.launches` ("strip" and its routes).

Cost constants (``STRIP_NS_BY_PERROW``, ``STRIP_LAUNCH_S``) are H100
measurements from ``chip_smoke.py`` phase 4; see PERF.md.
"""
from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch import _native
from saena_tpu_torch.ops import cuda_build
from saena_tpu_torch.ops import chunks
from saena_tpu_torch.ops.chunks import ChunkTables
from saena_tpu_torch.ops.dia_spmv import compute_dtype
from saena_tpu_torch.ops.formats import (
    index_to_device,
    int8_to_device,
    pad_to,
    scatter_value_dtype,
    to_device,
)
from saena_tpu_torch.runtime import launched

GROUP = 64                 # pairs per superblock padding unit (JAX layout)
_PERROW_CANDIDATES = (1, 2, 4, 8, 16)
_KRB_CANDIDATES = (1, 2, 4, 8, 16, 32)

# values dtype -> the kernel's code: f32 values with an f32 x and
# accumulator, bf16 values with an f32 x and accumulator, f64 throughout
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
# The two paths of the kernel (csrc/strip_spmv.cu). The rows path gives a
# block of 1024 threads to each row block, or to each SPLIT_PAIRS pairs of
# one (at most MAX_SPLIT blocks a row block). The stream path gives warps
# equal chunks of the pair list (ops/chunks.py: at least STRIP_CHUNK_MIN
# pairs a warp, row blocks of up to STRIP_WHOLE_MAX pairs kept whole when
# the operator is too small to fill the card). A layout takes the stream
# path when it has more pairs than the card keeps warps resident and more
# than one row-block row group per pair (perrow > 1); on smaller layouts and
# on the 1024-row row blocks of perrow 1 the rows path is faster (PERF.md,
# PR 3).
STRIP_CHUNK_MIN = 4
STRIP_WHOLE_MAX = 16
SPLIT_PAIRS = 16
MAX_SPLIT = 64


def _rpt(perrow: int) -> int:
    return 8 * (128 // perrow)


def row_block_ptr(sb_of: np.ndarray, rb_local: np.ndarray, krb: int,
                  n_rb: int) -> np.ndarray:
    """(n_rb + 1,) int32: row block rb's pairs are [ptr[rb], ptr[rb + 1]).

    Within a superblock the real pairs come in row-block order and the
    zero padding pairs (rb_local 0) follow them; the running maximum of
    ``sb * krb + rb_local`` hands the padding to the superblock's last
    nonempty row block, where its zero values add nothing, and makes the
    row-block ids non-decreasing."""
    sb = np.repeat(np.asarray(sb_of, dtype=np.int64), GROUP)
    g = np.maximum.accumulate(sb * krb + np.asarray(rb_local, dtype=np.int64)) \
        if sb.size else sb
    return np.searchsorted(g, np.arange(n_rb + 1), side="left").astype(np.int32)


class StripMatrix:
    """Strip-gather sparse matrix (fields as in the JAX StripMatrix).

    idx (n_pairs, 8, 128) int8; vals (n_pairs, 8, 128) at the level dtype;
    strip_of, rb_local (n_pairs,) int32; sb_of (n_pairs / GROUP,) int32;
    derived: rb_ptr (n_rows_pad / rpt + 1,) int32 numpy (rb_ptr_dev on the
    device), n_split and counter (the rows path) and, on the stream path,
    chunks (its work tables)."""

    def __init__(self, idx, vals, strip_of, rb_local, sb_of, shape, nnz,
                 perrow=4, krb=1, n_rows_pad=0, n_cols_pad=0, n_out=0,
                 pick_pairs=0):
        self.idx, self.vals = idx, vals
        self.strip_of, self.rb_local, self.sb_of = strip_of, rb_local, sb_of
        self.shape, self.nnz = tuple(shape), int(nnz)
        self.perrow, self.krb = int(perrow), int(krb)
        self.n_rows_pad, self.n_cols_pad = int(n_rows_pad), int(n_cols_pad)
        self.n_out, self.pick_pairs = int(n_out), int(pick_pairs)
        n_rb = self.n_rows_pad // _rpt(self.perrow)
        strips = strip_of.cpu().numpy()
        if self.n_cols_pad and strips.size and not (
                0 <= strips.min() and strips.max() < self.n_cols_pad // 128):
            raise ValueError("strip_of names a strip outside x")
        self.rb_ptr = row_block_ptr(sb_of.cpu().numpy(), rb_local.cpu().numpy(),
                                    self.krb, n_rb)
        # the rows path's tables
        longest = int(np.diff(self.rb_ptr).max()) if n_rb else 0
        self.n_split = int(np.clip(-(-longest // SPLIT_PAIRS), 1, MAX_SPLIT))
        self.rb_ptr_dev = index_to_device(self.rb_ptr, vals.device)
        self.counter = torch.zeros(n_rb, dtype=torch.int32, device=vals.device)
        self.chunks = None
        if self.perrow > 1 and idx.shape[0] > chunks.resident_warps(
                "strip_spmv", vals.dtype, vals.device):
            self.rechunk()

    def with_vals(self, vals) -> "StripMatrix":
        """The same layout (index arrays shared) with other values, such as
        a twin at another dtype; its kernel path is chosen for its dtype."""
        return StripMatrix(self.idx, vals, self.strip_of, self.rb_local,
                           self.sb_of, self.shape, self.nnz, self.perrow,
                           self.krb, self.n_rows_pad, self.n_cols_pad,
                           self.n_out, self.pick_pairs)

    def rechunk(self, chunk_min: int = STRIP_CHUNK_MIN,
                whole_max: int = STRIP_WHOLE_MAX):
        """Cut the pair list into the stream path's work chunks
        (ops/chunks.py), which sends every launch down that path; returns
        self."""
        self.chunks = ChunkTables(
            self.rb_ptr, self.device, _rpt(self.perrow), chunk_min, whole_max,
            chunks.warps_per_sm("strip_spmv", self.dtype, self.device))
        return self

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_pad(self) -> int:
        return self.n_out or self.n_rows_pad

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x at promote(dtype, f32); x: (n_cols_pad,) -> (n_pad,)."""
        y = strip_spmv(self, x)
        n_out = self.n_pad
        if n_out > self.n_rows_pad:
            # perrow 16 (rpt 64) can leave n_rows_pad a non-multiple of 128
            return torch.nn.functional.pad(y, (0, n_out - self.n_rows_pad))
        return y[:n_out]


def strip_spmv_plain(A: StripMatrix, x: torch.Tensor) -> torch.Tensor:
    """The same function as the kernel: gather, multiply, the per-row fold
    of the perrow slot groups (the JAX kernel's halving lane fold), then
    the sum of each row block's pairs. Returns (n_rows_pad,)."""
    cdt = compute_dtype(A.dtype)
    Q = 128 // A.perrow
    xs = x.to(cdt).reshape(-1, 128)
    src = xs.index_select(0, A.strip_of.long())              # (P, 128)
    g = torch.gather(src[:, None, :].expand(-1, 8, -1), 2, A.idx.long())
    c = A.vals.to(cdt) * g                                   # (P, 8, 128)
    w = 64
    while w >= Q:
        c = c[:, :, :w] + c[:, :, w:2 * w]
        w //= 2
    n_rb = A.n_rows_pad // _rpt(A.perrow)
    sb = A.sb_of.long()[:, None].expand(-1, GROUP).reshape(-1)
    rb = sb * A.krb + A.rb_local.long()
    out = torch.zeros((n_rb, 8, Q), dtype=cdt, device=x.device)
    out.index_add_(0, rb, c)
    # out[rb, i, q] is row rb * rpt + i + 8 q: linear order (rb, q, i)
    return out.transpose(1, 2).reshape(-1)


@functools.cache
def _kernel_fns():
    lib = cuda_build.load("strip_spmv")
    p, i = ctypes.c_void_p, ctypes.c_int
    stream, rows = lib.saena_strip_stream, lib.saena_strip_rows
    stream.argtypes = [i, p, p, p, p, p, p, p, i, i, p, p, p, p]
    rows.argtypes = [i, p, p, p, p, p, i, i, i, p, p, p, p]
    stream.restype = rows.restype = ctypes.c_int
    return stream, rows


def strip_spmv(A: StripMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, (n_rows_pad,) at promote(dtype, f32)."""
    if A.vals.device.type == "cpu":
        return strip_spmv_plain(A, x)
    if A.vals.device.type != "cuda":
        raise ValueError(f"strip_spmv: no kernel for device {A.vals.device}")
    return _strip_cuda(A, x)


def _strip_cuda(A: StripMatrix, x):
    dev = A.vals.device
    if A.dtype not in _DTYPE_CODE:
        raise TypeError(f"strip_spmv: values dtype {A.dtype} not supported "
                        "(float32, bfloat16, float64)")
    n_pairs = A.idx.shape[0]
    shapes_ok = (A.idx.shape == (n_pairs, 8, 128) and A.idx.dtype == torch.int8
                 and A.vals.shape == A.idx.shape
                 and A.strip_of.shape == (n_pairs,))
    if not shapes_ok:
        raise ValueError("strip_spmv: idx/vals must be (n_pairs, 8, 128) "
                         "int8/float and strip_of (n_pairs,)")
    C = A.chunks
    arrays = dict(idx=A.idx, vals=A.vals, strip_of=A.strip_of, rb_ptr=A.rb_ptr_dev,
                  counter=A.counter)
    if C is not None:
        arrays.update(zip(("heads", "segs", "cuts", "chunk_counter"), C.tensors()))
    for name, t in arrays.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"strip_spmv: {name} must be contiguous on {dev}")
        if t.dtype != torch.int32 and name not in ("idx", "vals"):
            raise ValueError(f"strip_spmv: {name} must be int32")
    if A.perrow not in _PERROW_CANDIDATES:
        raise ValueError(f"strip_spmv: perrow {A.perrow} not supported")
    rpt = _rpt(A.perrow)
    n_rb = A.rb_ptr.size - 1
    if (n_rb * rpt != A.n_rows_pad or A.rb_ptr[-1] != n_pairs
            or A.counter.shape != (n_rb,) or not 1 <= A.n_split <= MAX_SPLIT):
        raise ValueError("strip_spmv: rb_ptr/counter/n_split do not match the layout")
    if x.device != dev or x.dim() != 1 or x.shape[0] != A.n_cols_pad:
        raise ValueError(f"strip_spmv: x must be 1-D ({A.n_cols_pad},) on {dev}")
    if C is not None:
        # the stream path copies idx, vals and strip_of (16 bytes at a time)
        for name in ("idx", "vals", "strip_of", "heads"):
            if arrays[name].data_ptr() % 16:
                raise ValueError(f"strip_spmv: {name} must be 16-byte aligned")
        if n_pairs % 4:
            raise ValueError("strip_spmv: the pair count must be a multiple of 4")
    # x is read by gathers of single values: any offset in its storage does
    x = x.to(compute_dtype(A.dtype)).contiguous()
    y = torch.empty(A.n_rows_pad, dtype=x.dtype, device=dev)
    stream_fn, rows_fn = _kernel_fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if C is not None:
            part = torch.empty(C.n_seg * rpt if C.n_cuts else 0, dtype=x.dtype, device=dev)
            rc = stream_fn(
                _DTYPE_CODE[A.dtype], A.idx.data_ptr(), A.vals.data_ptr(),
                A.strip_of.data_ptr(), C.heads.data_ptr(), C.segs.data_ptr(),
                C.cuts.data_ptr(), x.data_ptr(), C.n_chunks, A.perrow,
                part.data_ptr(), C.counter.data_ptr(), y.data_ptr(), stream)
        else:
            part = torch.empty(A.n_rows_pad * A.n_split if A.n_split > 1 else 0,
                               dtype=x.dtype, device=dev)
            rc = rows_fn(
                _DTYPE_CODE[A.dtype], A.idx.data_ptr(), A.vals.data_ptr(),
                A.strip_of.data_ptr(), A.rb_ptr_dev.data_ptr(), x.data_ptr(), n_rb,
                A.n_split, A.perrow, part.data_ptr(), A.counter.data_ptr(),
                y.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"strip_spmv: kernel launch failed with CUDA error {rc}")
    launched("strip", stream=C is not None, bf16=A.dtype == torch.bfloat16)
    return y


# ---------------------------------------------------------------------------
# host planner (native pair assignment, numpy where no toolchain exists)
# ---------------------------------------------------------------------------

# H100 cost model, measured by chip_smoke.py phase 4 on NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit (PERF.md, "Cost constants"): matvec seconds
# = STRIP_LAUNCH_S + padded pairs x ns per pair at the layout's perrow, in
# f32. STRIP_LAUNCH_S is the time of the smallest layout (one superblock of
# GROUP pairs, the rows path); the ns per pair are fitted on the 48^3
# level-2 A built at each perrow (the rows path at perrow 1, the stream path
# at 2-16, as the wrapper picks them). The ns per pair do not depend on krb:
# the planner's krb choice only trades GROUP padding, which the pair count
# holds.
STRIP_NS_BY_PERROW = {1: 3.63, 2: 3.65, 4: 2.43, 8: 2.27, 16: 2.59}
STRIP_LAUNCH_S = 7.07e-6


def _plan_pairs_numpy(row, col, rpt, n_strips, n_rows_pad, perrow):
    """(slot, inv, pair_rb, pair_strip) of the strip planner in numpy."""
    rb = row // rpt
    strip = col // 128
    # per (rb, strip, row) running slot index k; entries with k >= perrow
    # overflow into a repeated pair (same rb/strip, next replica)
    key_rsr = (rb.astype(np.int64) * n_strips + strip) * n_rows_pad + row
    order = np.argsort(key_rsr, kind="stable")
    k = np.zeros(row.size, dtype=np.int64)
    if row.size:
        kr = key_rsr[order]
        same = np.concatenate([[False], kr[1:] == kr[:-1]])
        breaks = np.flatnonzero(~same)
        seg_id = np.cumsum(~same) - 1
        k[order] = np.arange(row.size) - breaks[seg_id]
    replica = k // perrow
    slot = k % perrow

    cap = 128 // perrow      # replica < cap (<= 128 entries/row/strip)
    pkey = ((rb.astype(np.int64) * n_strips + strip) * cap
            + np.minimum(replica, cap - 1))
    if row.size:
        uniq, inv = np.unique(pkey, return_inverse=True)
    else:
        uniq = np.array([], dtype=np.int64)
        inv = np.array([], dtype=np.int64)
    pair_rb = (uniq // (cap * n_strips)).astype(np.int64)
    pair_strip = ((uniq // cap) % n_strips).astype(np.int32)
    return slot, inv, pair_rb, pair_strip


def _plan(row, col, n, m, perrow):
    """Pair layout for one perrow candidate: (pair_rb, pair_strip, slot,
    inv) from the native planner core or its numpy version, krb by
    modelled time, the padded pair count and the score."""
    rpt = _rpt(perrow)
    n_strips = pad_to(m) // 128
    n_rows_pad = pad_to(n, rpt)
    n_rb = n_rows_pad // rpt

    # entry -> (slot within row, pair id) and the sorted unique pairs: the
    # native core (stripplan.cpp, O(nnz) on (row, col)-sorted entries), or
    # the numpy version for unsorted input and without a toolchain
    nat = _native.strip_plan_core(row, col, rpt, n_strips, perrow) \
        if row.size else None
    if nat is not None:
        slot, inv, pair_rb, pair_strip = nat
        pair_rb = pair_rb.astype(np.int64)
    else:
        slot, inv, pair_rb, pair_strip = _plan_pairs_numpy(
            row, col, rpt, n_strips, n_rows_pad, perrow)

    best = None
    for krb in _KRB_CANDIDATES:
        n_sb = -(-n_rb // krb)
        counts = np.bincount(pair_rb // krb, minlength=n_sb)
        padded = int(np.maximum(
            GROUP, ((counts + GROUP - 1) // GROUP) * GROUP).sum())
        score = padded * STRIP_NS_BY_PERROW[perrow]
        if best is None or score < best[2]:
            best = (krb, padded, score)
    krb, padded_pairs, score = best
    return dict(pair_rb=pair_rb, pair_strip=pair_strip, inv=inv, slot=slot,
                krb=krb, padded_pairs=padded_pairs, score=score, n_rb=n_rb,
                n_rows_pad=n_rows_pad, n_strips=n_strips, perrow=perrow,
                rpt=rpt)


_SAMPLE_NNZ = 150_000     # above this nnz the candidate sweep runs on a
                          # stratified row sample (planning cost)
_SEG = 1024               # sampling segment: whole tiles for every rpt


def _pick_candidate(row, col, n, m, perrow=None):
    """Choose perrow, on a stratified sample of 1024-row segments (every
    stride-th across the whole matrix, rows rebased so tiles stay aligned)
    when the operator is large. Returns (perrow, padded_pairs scaled to
    full size, runner_up_perrow or None); the runner-up is set when a
    sampled call was close (within 25%) and is resolved by strip_from_csr
    with full plans."""
    cands = (perrow,) if perrow else _PERROW_CANDIDATES
    nnz = row.size
    if nnz > _SAMPLE_NNZ and perrow is None:
        stride = max(2, int(np.ceil(nnz / _SAMPLE_NNZ)))
        seg = row // _SEG
        keep = (seg % stride) == 0
        rs = (seg[keep] // stride) * _SEG + (row[keep] % _SEG)
        cs = col[keep]
        kept = int(keep.sum())
        if kept:
            ns = int(rs.max()) + 1
            plans = sorted((_plan(rs, cs, ns, m, pr) for pr in cands),
                           key=lambda p: p["score"])
            best = plans[0]
            runner = (plans[1]["perrow"]
                      if len(plans) > 1
                      and plans[1]["score"] <= 1.25 * best["score"]
                      else None)
            return (best["perrow"],
                    int(best["padded_pairs"] * nnz / max(1, kept)), runner)
    plans = [_plan(row, col, n, m, pr) for pr in cands]
    best = min(plans, key=lambda p: p["score"])
    return best["perrow"], int(best["padded_pairs"]), None


_MEMO = "_saena_torch_strip_pick"


def _pick_cached(A: sp.spmatrix, perrow=None):
    """(perrow, padded_pairs, runner_up or None) for a CSR, memoized on the
    matrix object keyed by (shape, nnz). strip_from_csr overwrites the memo
    with the pick it resolved, so later estimates use what was built."""
    A = A.tocsr()
    if perrow is not None:
        coo = A.tocoo()
        return _pick_candidate(coo.row, coo.col, A.shape[0], A.shape[1],
                               perrow)
    key = (A.shape, A.nnz)
    tok = getattr(A, _MEMO, None)
    if tok is not None and tok[0] == key:
        return tok[1]
    coo = A.tocoo()
    res = _pick_candidate(coo.row, coo.col, A.shape[0], A.shape[1])
    _set_memo(A, key, res)
    return res


def _set_memo(A, key, res) -> None:
    try:
        setattr(A, _MEMO, (key, res))
    except AttributeError:
        pass


def strip_from_csr(A: sp.spmatrix, dtype, device, perrow=None,
                   timer=None, smooth_dtype=None):
    """Host conversion CSR -> strip pairs (the planner picks perrow and krb
    unless ``perrow`` is forced). With ``smooth_dtype``: (M, twin), the
    twin's values at that dtype beside M's index arrays."""
    t0 = time.perf_counter()
    A = A.tocsr()
    n, m = A.shape
    coo = A.tocoo()
    pr, _, runner = _pick_cached(A, perrow)
    pln = _plan(coo.row, coo.col, n, m, pr)
    if runner is not None:
        # a close sampled call: resolve it on the full pattern now that the
        # layout is built
        pln2 = _plan(coo.row, coo.col, n, m, runner)
        if pln2["score"] < pln["score"]:
            pln = pln2
    if perrow is None:
        # the memo holds the resolved pick and its exact pair count
        _set_memo(A, (A.shape, A.nnz), (pln["perrow"], pln["padded_pairs"], None))
    pr, krb, rpt = pln["perrow"], pln["krb"], pln["rpt"]
    Q = 128 // pr
    n_rb = pln["n_rb"]
    n_sb = -(-n_rb // krb)
    n_rows_pad = n_sb * krb * rpt
    n_strips = pln["n_strips"]

    pair_rb, pair_strip = pln["pair_rb"], pln["pair_strip"]
    pair_sb = pair_rb // krb
    counts = np.bincount(pair_sb, minlength=n_sb)
    padded = np.maximum(GROUP, ((counts + GROUP - 1) // GROUP) * GROUP)
    offsets = np.cumsum(padded) - padded
    n_pairs = int(padded.sum())
    # position of each real pair inside the padded superblock-major layout
    within = np.arange(pair_rb.size) - (np.cumsum(counts) - counts)[pair_sb]
    pos = offsets[pair_sb] + within

    idx = np.zeros((n_pairs, 8, 128), dtype=np.int8)
    vals = np.zeros((n_pairs, 8, 128), dtype=scatter_value_dtype(dtype, smooth_dtype))
    strip_of = np.zeros(n_pairs, dtype=np.int32)
    rb_local = np.zeros(n_pairs, dtype=np.int32)
    if pair_rb.size:
        strip_of[pos] = pair_strip
        rb_local[pos] = (pair_rb % krb).astype(np.int32)
        sub = coo.row % 8
        q = (coo.row % rpt) // 8
        j = pln["slot"].astype(np.int64) * Q + q
        flat = (pos[pln["inv"]].astype(np.int64) * 8 + sub) * 128 + j
        idx.reshape(-1)[flat] = (coo.col % 128).astype(np.int8)
        vals.reshape(-1)[flat] = coo.data
    sb_of = np.repeat(np.arange(n_sb), padded // GROUP).astype(np.int32)
    if timer is not None:
        timer.add("plan_strip", time.perf_counter() - t0)
    M = StripMatrix(
        idx=int8_to_device(idx, device),
        vals=to_device(vals, dtype, device, timer),
        strip_of=index_to_device(strip_of, device),
        rb_local=index_to_device(rb_local, device),
        sb_of=index_to_device(sb_of, device),
        shape=(n, m), nnz=int(A.nnz), perrow=pr, krb=krb,
        n_rows_pad=n_rows_pad, n_cols_pad=n_strips * 128, n_out=pad_to(n),
        pick_pairs=pln["padded_pairs"])
    if smooth_dtype is None:
        return M
    return M, M.with_vals(to_device(vals, smooth_dtype, device, timer))


def strip_bytes_estimate(A: sp.spmatrix, dtype=torch.float32) -> int:
    """Device bytes of the strip layout (idx + vals), from the pick."""
    _, padded, _ = _pick_cached(A.tocsr())
    return int(padded * 8 * 128 * (1 + dtype.itemsize))


def strip_time_estimate(A: sp.spmatrix, dtype=torch.float32) -> float:
    """Estimated matvec seconds: launch floor + padded pairs at the picked
    perrow's ns per pair."""
    pr, padded, _ = _pick_cached(A.tocsr())
    return STRIP_LAUNCH_S + padded * STRIP_NS_BY_PERROW[pr] * 1e-9
