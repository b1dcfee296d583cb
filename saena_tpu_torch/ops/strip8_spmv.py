"""Multi-strip ("strip8") gather SpMV: the format, its host planner, the
kernel wrapper and its plain PyTorch version.

The port of saena_tpu/ops/pallas_strip8_spmv.py (the Pallas kernel
``_kernel`` there, launched by ``strip8_spmv``, and its epilogue
``_reduce_scratch``). A tile covers the Q = 128 / perrow rows of one row
block; lane j belongs to row ``rb * Q + j % Q`` and each of the tile's 8
sublanes gathers from its own 128-column strip of x:

- general mode: ``strips[t * 8 + i]`` is sublane i's strip;
- interval mode: ``strips[t]`` is a base and sublane i reads ``base + i``
  (strips past the end of x read zeros).

The planner sweeps (perrow, mode) and keeps the layout of the least
modelled time, its real tiles weighted by the mode's H100 cost per tile
(``STRIP8_NS_PER_TILE``). Both modes come from the native planner
(_native/strip8plan.cpp); without a toolchain the numpy version plans the
general mode only.

``gather_idx[rb]`` lists the row block's tiles, padded with ``n_tiles_pad``.
When the matrix is built, ``tile_list`` lists the real tiles in row-block
order (padding dropped; a row block's tiles need not be contiguous) and
``rbt_ptr`` where each row block's start, ``unit_strips`` the strip each
sublane of each listed tile reads (-1 outside x): the stream path's inputs.
Its work tables, ``chunks`` (ops/chunks.py), cut that list into chunks, one
per kernel warp, with tickets for the row blocks the cuts split; the rows
path has ``n_split`` and ``counter``. Tickets are zeros between launches,
so a matrix takes one launch at a time: its launches go to one stream.
``tile_identity`` says that list position k is tile k, as in every layout
the port's planner builds; the kernel then skips the tile_list lookup.

    y[rb * Q + q] = sum over the row block's tiles, sublanes and the
                    perrow lane groups s of vals * x[strip * 128 + idx]
                    at lane s * Q + q

`strip8_spmv` launches the CUDA kernel (csrc/strip8_spmv.cu) for tensors
on the card, on the layout's path, and runs `strip8_spmv_plain` for
tensors on the CPU; it never falls back from one to the other. bf16 values
take an f32 x and y (the smoothers' twin of an operator,
Options.smooth_dtype). Launches are recorded in `runtime.launches`
("strip8" and its routes; "strip8.shard" on a shard's view, a layout with
``shard`` set, parallel/sharded.py).

The cost constants (``STRIP8_NS_PER_TILE``) are H100 measurements from
``chip_smoke.py`` phase 4; see PERF.md.
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

GROUP8 = 64           # tile-count padding unit (JAX layout)
_PERROW8 = (1, 2, 4)
MODES = ("general", "interval")

# values dtype -> the kernel's code: f32 values with an f32 x and
# accumulator, bf16 values with an f32 x and accumulator, f64 throughout
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
# The two paths of the kernel (csrc/strip8_spmv.cu). The rows path gives a
# block to each row block, or to each SPLIT_TILES entries of its gather_idx
# row (at most MAX_SPLIT blocks a row block). The stream path gives warps
# equal chunks of the real tiles (ops/chunks.py: at least STRIP8_CHUNK_MIN
# tiles a warp, row blocks of up to STRIP8_WHOLE_MAX tiles kept whole when
# the operator is too small to fill the card). A layout takes the stream
# path when its row blocks are longer than SPLIT_TILES (the rows path would
# split them and chain their tiles) and its real tiles fit the warps the
# card keeps resident; every other layout, the 48^3 level-2 A included,
# runs faster on the rows path (PERF.md, PR 3).
STRIP8_CHUNK_MIN = 2
STRIP8_WHOLE_MAX = 8
SPLIT_TILES = 8
MAX_SPLIT = 64


def real_tiles(gather_idx: np.ndarray, n_tiles: int):
    """(tile_list, rbt_ptr): the entries of gather_idx below n_tiles (the
    real tiles, padding dropped) in row-block order, and where each row
    block's entries start in that list."""
    real = gather_idx < n_tiles
    ptr = np.concatenate([[0], np.cumsum(real.sum(axis=1))]).astype(np.int32)
    return gather_idx[real].astype(np.int32), ptr


def unit_strips(strips: np.ndarray, tiles: np.ndarray, mode: str,
                n_strips: int) -> np.ndarray:
    """(len(tiles) * 8,) int32: the strip each sublane of each listed tile
    reads, general and interval mode alike; -1 where that strip lies
    outside x (it reads zeros)."""
    if mode == "interval":
        s = strips[tiles].astype(np.int64)[:, None] + np.arange(8)
    else:
        s = strips.reshape(-1, 8)[tiles].astype(np.int64)
    return np.where((s >= 0) & (s < n_strips), s, -1).astype(np.int32).reshape(-1)


class Strip8Matrix:
    """Multi-strip gather matrix (fields as in the JAX Strip8Matrix).

    idx (n_tiles_pad, 8, 128) int8; vals (n_tiles_pad, 8, 128); strips
    int32, (n_tiles_pad * 8,) in general mode, (n_tiles_pad,) in interval
    mode; gather_idx (n_rb, t_max) int32; derived: n_split and counter
    (the rows path), tile_list (n_real,) int32, tile_identity, unit_strips
    (n_real * 8,) int32, rbt_ptr (n_rb + 1,) int32 numpy and, on the stream
    path, chunks (its work tables). ``shard``: the shard whose view this
    is (None: not a shard's)."""

    def __init__(self, idx, vals, strips, gather_idx, shape, nnz, perrow=1,
                 mode="general", n_cols_pad=0, n_out=0, shard=None):
        if mode not in MODES:
            raise ValueError(f"strip8 mode {mode!r}")
        self.shard = shard
        self.idx, self.vals = idx, vals
        self.strips, self.gather_idx = strips, gather_idx
        self.shape, self.nnz = tuple(shape), int(nnz)
        self.perrow, self.mode = int(perrow), mode
        self.n_cols_pad, self.n_out = int(n_cols_pad), int(n_out)
        tiles, self.rbt_ptr = real_tiles(gather_idx.cpu().numpy(), idx.shape[0])
        self.tile_list = index_to_device(tiles, vals.device)
        self.tile_identity = bool((tiles == np.arange(tiles.size)).all())
        self.unit_strips = index_to_device(
            unit_strips(strips.cpu().numpy(), tiles, mode, self.n_cols_pad // 128),
            vals.device)
        # the rows path's tables
        n_rb, t_max = gather_idx.shape
        self.n_split = int(np.clip(-(-t_max // SPLIT_TILES), 1, MAX_SPLIT))
        self.counter = torch.zeros(n_rb, dtype=torch.int32, device=vals.device)
        self.chunks = None
        if t_max > SPLIT_TILES and tiles.size <= chunks.resident_warps(
                "strip8_spmv", vals.dtype, vals.device):
            self.rechunk()

    def with_vals(self, vals) -> "Strip8Matrix":
        """The same layout (index arrays shared) with other values, such as
        a twin at another dtype; its kernel path is chosen for its dtype."""
        return Strip8Matrix(self.idx, vals, self.strips, self.gather_idx,
                            self.shape, self.nnz, self.perrow, self.mode,
                            self.n_cols_pad, self.n_out, self.shard)

    def rechunk(self, chunk_min: int = STRIP8_CHUNK_MIN,
                whole_max: int = STRIP8_WHOLE_MAX):
        """Cut the tile list into the stream path's work chunks
        (ops/chunks.py), which sends every launch down that path; returns
        self."""
        self.chunks = ChunkTables(
            self.rbt_ptr, self.device, 128 // self.perrow, chunk_min, whole_max,
            chunks.warps_per_sm("strip8_spmv", self.dtype, self.device))
        return self

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_pad(self) -> int:
        return self.n_out

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x at promote(dtype, f32); x: (n_cols_pad,) -> (n_out,)."""
        y = strip8_spmv(self, x)
        if y.shape[0] < self.n_out:
            return torch.nn.functional.pad(y, (0, self.n_out - y.shape[0]))
        return y[: self.n_out]


def strip8_spmv_plain(A: Strip8Matrix, x: torch.Tensor) -> torch.Tensor:
    """The same function as the kernel (strip8_spmv_xla and _reduce_scratch
    in the JAX package): per-tile products folded over the sublanes
    pairwise, a row-block sum of the tile rows, the perrow lane-group fold.
    Returns (n_rb * Q,)."""
    cdt = compute_dtype(A.dtype)
    n_tiles = A.idx.shape[0]
    xs = x.to(cdt).reshape(-1, 128)
    if A.mode == "interval":
        # strip base + sublane; 8 zero strips so base + 7 stays in range
        xs = torch.nn.functional.pad(xs, (0, 0, 0, 8))
        rows = A.strips[:n_tiles, None].long() + torch.arange(8, device=x.device)
    else:
        rows = A.strips[: n_tiles * 8].long().reshape(n_tiles, 8)
    src = xs[rows]                                           # (T, 8, 128)
    c = A.vals.to(cdt) * torch.gather(src, 2, A.idx.long())
    c = c[:, 0:4] + c[:, 4:8]
    c = c[:, 0:2] + c[:, 2:4]
    scratch = c[:, 0] + c[:, 1]                              # (T, 128)
    scratch0 = torch.cat([scratch, scratch.new_zeros(1, 128)])
    y = scratch0[A.gather_idx.long()].sum(dim=1)             # (n_rb, 128)
    if A.perrow > 1:
        y = y.reshape(y.shape[0], A.perrow, 128 // A.perrow).sum(dim=1)
    return y.reshape(-1)


@functools.cache
def _kernel_fns():
    lib = cuda_build.load("strip8_spmv")
    p, i = ctypes.c_void_p, ctypes.c_int
    stream, rows = lib.saena_strip8_stream, lib.saena_strip8_rows
    stream.argtypes = [i, p, p, p, p, p, p, p, p, i, i, p, p, p, p]
    rows.argtypes = [i, i, p, p, p, p, i, i, i, i, p, i, i, p, p, p, p]
    stream.restype = rows.restype = ctypes.c_int
    return stream, rows


def strip8_spmv(A: Strip8Matrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, (n_rb * Q,) at promote(dtype, f32)."""
    if A.vals.device.type == "cpu":
        return strip8_spmv_plain(A, x)
    if A.vals.device.type != "cuda":
        raise ValueError(f"strip8_spmv: no kernel for device {A.vals.device}")
    return _strip8_cuda(A, x)


def _strip8_cuda(A: Strip8Matrix, x):
    dev = A.vals.device
    if A.dtype not in _DTYPE_CODE:
        raise TypeError(f"strip8_spmv: values dtype {A.dtype} not supported "
                        "(float32, bfloat16, float64)")
    n_tiles = A.idx.shape[0]
    n_strips_rec = n_tiles * 8 if A.mode == "general" else n_tiles
    if (A.idx.shape != (n_tiles, 8, 128) or A.idx.dtype != torch.int8
            or A.vals.shape != A.idx.shape or A.strips.shape != (n_strips_rec,)
            or A.gather_idx.dim() != 2):
        raise ValueError("strip8_spmv: idx/vals must be (n_tiles, 8, 128) "
                         f"int8/float, strips ({n_strips_rec},) for mode "
                         f"{A.mode!r}, gather_idx 2-D")
    C = A.chunks
    arrays = dict(idx=A.idx, vals=A.vals, strips=A.strips, gather_idx=A.gather_idx,
                  counter=A.counter)
    if C is not None:
        arrays.update(tile_list=A.tile_list, unit_strips=A.unit_strips,
                      **dict(zip(("heads", "segs", "cuts", "chunk_counter"), C.tensors())))
    for name, t in arrays.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"strip8_spmv: {name} must be contiguous on {dev}")
        if t.dtype != torch.int32 and name not in ("idx", "vals"):
            raise ValueError(f"strip8_spmv: {name} must be int32")
    if A.perrow not in _PERROW8:
        raise ValueError(f"strip8_spmv: perrow {A.perrow} not supported")
    n_rb, t_max = A.gather_idx.shape
    if A.counter.shape != (n_rb,) or not 1 <= A.n_split <= MAX_SPLIT:
        raise ValueError("strip8_spmv: counter/n_split do not match gather_idx")
    if x.device != dev or x.dim() != 1 or x.shape[0] != A.n_cols_pad:
        raise ValueError(f"strip8_spmv: x must be 1-D ({A.n_cols_pad},) on {dev}")
    if C is not None:
        n_real = int(A.rbt_ptr[-1])
        if (A.rbt_ptr.size != n_rb + 1 or A.tile_list.shape != (n_real,)
                or A.unit_strips.shape != (8 * n_real,)):
            raise ValueError("strip8_spmv: tile_list/unit_strips/rbt_ptr do not "
                             "match gather_idx")
        # the stream path copies idx, vals and unit_strips (16 bytes at a time)
        for name in ("idx", "vals", "unit_strips", "heads"):
            if arrays[name].data_ptr() % 16:
                raise ValueError(f"strip8_spmv: {name} must be 16-byte aligned")
    # x is read by gathers of single values: any offset in its storage does
    x = x.to(compute_dtype(A.dtype)).contiguous()
    Q = 128 // A.perrow
    y = torch.empty(n_rb * Q, dtype=x.dtype, device=dev)
    stream_fn, rows_fn = _kernel_fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if C is not None:
            part = torch.empty(C.n_seg * Q if C.n_cuts else 0, dtype=x.dtype, device=dev)
            rc = stream_fn(
                _DTYPE_CODE[A.dtype], A.idx.data_ptr(), A.vals.data_ptr(),
                None if A.tile_identity else A.tile_list.data_ptr(),
                A.unit_strips.data_ptr(), C.heads.data_ptr(), C.segs.data_ptr(),
                C.cuts.data_ptr(), x.data_ptr(), C.n_chunks, A.perrow,
                part.data_ptr(), C.counter.data_ptr(), y.data_ptr(), stream)
        else:
            part = torch.empty(n_rb * Q * A.n_split if A.n_split > 1 else 0,
                               dtype=x.dtype, device=dev)
            rc = rows_fn(
                _DTYPE_CODE[A.dtype], int(A.mode == "interval"), A.idx.data_ptr(),
                A.vals.data_ptr(), A.strips.data_ptr(), A.gather_idx.data_ptr(),
                n_rb, t_max, n_tiles, A.n_cols_pad // 128, x.data_ptr(), A.perrow,
                A.n_split, part.data_ptr(), A.counter.data_ptr(), y.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"strip8_spmv: kernel launch failed with CUDA error {rc}")
    launched("strip8", stream=C is not None, interval=A.mode == "interval",
             bf16=A.dtype == torch.bfloat16, shard=A.shard is not None)
    return y


# ---------------------------------------------------------------------------
# host planner (native, both modes; numpy for the general mode)
# ---------------------------------------------------------------------------

# H100 cost model, measured by chip_smoke.py phase 4 on NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit (PERF.md, "Cost constants"): ns per real
# tile in f32 beyond formats.KERNEL_LAUNCH_S, general mode on the 48^3
# level-2 A at the planner's perrow, interval mode on a synthetic layout of
# about the same tile count (both on the rows path, which the wrapper picks
# for them). The planner weighs tile counts by the same per-tile costs.
STRIP8_NS_PER_TILE = {"general": 2.24, "interval": 1.99}

# above this nnz the candidate sweep ranks on a stratified row sample and
# only the winner gets the full-pattern plan
SAMPLE_SWEEP_NNZ = 500_000

_MEMO = "_saena_torch_strip8_plan"


def _plan8_one(row, col, n, m, perrow, mode="general"):
    """Plan of one (perrow, mode) candidate from (row, col)-sorted entries:
    the native core, or the numpy version for the general mode. None when
    no plan of that mode can be made here (interval mode without a
    toolchain)."""
    Q = 128 // perrow
    n_rb = pad_to(n, Q) // Q
    n_strips = pad_to(m) // 128
    core = _native.strip8i_plan_core if mode == "interval" \
        else _native.strip8_plan_core
    nat = core(row, col, n_rb, n_strips, perrow)
    if nat is None:
        if mode == "interval":
            return None
        nat = _plan8_numpy(row.astype(np.int64), col.astype(np.int64),
                           n_rb, n_strips, perrow)
    e_tile, e_sub, e_krem, tile_strips, rb_tiles = nat
    return (e_tile, e_sub, e_krem, tile_strips, rb_tiles, n_rb, n_strips,
            perrow, mode)


def _plan_cost(plan) -> float:
    """Modelled ns of a plan: real tiles at its mode's cost per tile."""
    return plan[3].shape[0] * STRIP8_NS_PER_TILE[plan[8]]


def _plan8(A: sp.spmatrix, timer=None):
    """(coo, plan) of the layout of least modelled time over the (perrow,
    mode) candidates. Large operators rank the candidates on a stratified
    sample (every 8th 1024-row segment, rows rebased, whole segments so
    the row-block structure survives) and plan only the winner in full,
    the next-ranked one if the full pattern rejects it. Memoized on the
    matrix object keyed by (shape, nnz)."""
    t0 = time.perf_counter()
    A = A.tocsr()
    key = (A.shape, A.nnz)
    tok = getattr(A, _MEMO, None)
    if tok is not None and tok[0] == key:
        return tok[1]
    orig = A
    if not A.has_sorted_indices:
        A = A.copy()
        A.sort_indices()
    n, m = A.shape
    coo = A.tocoo()
    cands = [(pr, mode) for pr in _PERROW8 for mode in ("interval", "general")]
    best = None
    if coo.nnz > SAMPLE_SWEEP_NNZ:
        seg_len, stride = 1024, 8
        seg = coo.row // seg_len
        keep = (seg % stride) == 0
        if keep.any() and not keep.all():
            srow = (seg[keep] // stride) * seg_len + coo.row[keep] % seg_len
            scol = coo.col[keep]
            n_s = min(n, int(((n - 1) // seg_len // stride) * seg_len + seg_len))
            ranked = []
            for pr, mode in cands:
                p = _plan8_one(srow, scol, n_s, m, pr, mode)
                if p is not None:
                    ranked.append((_plan_cost(p), pr, mode))
            ranked.sort()
            for _, pr, mode in ranked:
                p = _plan8_one(coo.row, coo.col, n, m, pr, mode)
                if p is not None:
                    best = (_plan_cost(p), p)
                    break
    if best is None:
        for pr, mode in cands:
            p = _plan8_one(coo.row, coo.col, n, m, pr, mode)
            if p is not None and (best is None or _plan_cost(p) < best[0]):
                best = (_plan_cost(p), p)
    res = (coo, best[1])
    try:
        setattr(orig, _MEMO, (key, res))
    except AttributeError:
        pass
    if timer is not None:
        timer.add("plan_strip8", time.perf_counter() - t0)
    return res


def _plan8_numpy(row, col, n_rb, n_strips, perrow=1):
    """Entry -> (tile, sublane, lane group), per-tile strips and per-row-
    block tile counts; the JAX package's numpy planner."""
    Q = 128 // perrow
    nnz = row.size
    e_tile = np.empty(nnz, dtype=np.int32)
    e_sub = np.empty(nnz, dtype=np.int8)
    e_krem = np.empty(nnz, dtype=np.int8)
    rb_tiles = np.zeros(n_rb, dtype=np.int32)
    strips_out = []
    n_tiles = 0
    rb_of = row // Q
    strip = col // 128
    starts = np.searchsorted(rb_of, np.arange(n_rb + 1))
    # per-(row, strip) running index k via run detection (entries sorted)
    same = np.zeros(nnz, dtype=bool)
    if nnz > 1:
        same[1:] = (row[1:] == row[:-1]) & (strip[1:] == strip[:-1])
    runb = np.flatnonzero(~same)
    k_all = np.arange(nnz) - runb[np.cumsum(~same) - 1]
    for rb in range(n_rb):
        lo, hi = starts[rb], starts[rb + 1]
        if lo == hi:
            continue
        s_blk = strip[lo:hi]
        k_blk = k_all[lo:hi]
        uniq = np.unique(s_blk)
        maxrep = np.zeros(uniq.size, dtype=np.int64)
        inv = np.searchsorted(uniq, s_blk)
        np.maximum.at(maxrep, inv, k_blk // perrow)
        widths = maxrep + 1
        bases = np.cumsum(widths) - widths
        ncols = int(widths.sum())
        t_rb = -(-ncols // 8)
        ts = np.zeros(t_rb * 8, dtype=np.int32)
        ts[:ncols] = np.repeat(uniq, widths).astype(np.int32)
        strips_out.append(ts.reshape(t_rb, 8))
        c = bases[inv] + k_blk // perrow
        e_tile[lo:hi] = n_tiles + c // 8
        e_sub[lo:hi] = (c % 8).astype(np.int8)
        e_krem[lo:hi] = (k_blk % perrow).astype(np.int8)
        rb_tiles[rb] = t_rb
        n_tiles += t_rb
    tile_strips = (np.concatenate(strips_out, axis=0)
                   if strips_out else np.zeros((0, 8), dtype=np.int32))
    return e_tile, e_sub, e_krem, tile_strips, rb_tiles


def _padded_tiles(n_tiles: int) -> int:
    return max(GROUP8, -(-n_tiles // GROUP8) * GROUP8)


def strip8_from_csr(A: sp.spmatrix, dtype, device, perrow=None,
                    mode="general", timer=None, smooth_dtype=None):
    """Host conversion CSR -> multi-strip tiles: the planner picks perrow
    and mode, unless ``perrow`` is forced, which plans ``mode`` at it. With
    ``smooth_dtype``: (M, twin), the twin's values at that dtype beside
    M's index arrays."""
    A = A.tocsr()
    n, m = A.shape
    if perrow is None:
        coo, plan = _plan8(A, timer)
    else:
        if not A.has_sorted_indices:
            A = A.copy()
            A.sort_indices()
        coo = A.tocoo()
        plan = _plan8_one(coo.row, coo.col, n, m, perrow, mode)
        if plan is None:
            raise RuntimeError(f"no {mode}-mode strip8 plan without the "
                               "native planner")
    (e_tile, e_sub, e_krem, tile_strips, rb_tiles, n_rb, n_strips,
     perrow, mode) = plan
    Q = 128 // perrow
    n_tiles = tile_strips.shape[0]
    n_tiles_pad = _padded_tiles(n_tiles)

    idx = np.zeros((n_tiles_pad, 8, 128), dtype=np.int8)
    vals = np.zeros((n_tiles_pad, 8, 128), dtype=scatter_value_dtype(dtype, smooth_dtype))
    strips = np.zeros(n_tiles_pad if mode == "interval" else n_tiles_pad * 8,
                      dtype=np.int32)
    if n_tiles:
        strips[: tile_strips.size] = tile_strips.reshape(-1)
        lane = e_krem.astype(np.int64) * Q + coo.row % Q
        flat = (e_tile.astype(np.int64) * 8 + e_sub) * 128 + lane
        idx.reshape(-1)[flat] = (coo.col % 128).astype(np.int8)
        vals.reshape(-1)[flat] = coo.data

    t_max = max(1, int(rb_tiles.max())) if rb_tiles.size else 1
    gather_idx = np.full((n_rb, t_max), n_tiles_pad, dtype=np.int32)
    off = np.cumsum(rb_tiles) - rb_tiles
    for t in range(t_max):
        mask = rb_tiles > t
        gather_idx[mask, t] = off[mask] + t

    M = Strip8Matrix(
        idx=int8_to_device(idx, device),
        vals=to_device(vals, dtype, device, timer),
        strips=index_to_device(strips, device),
        gather_idx=index_to_device(gather_idx, device),
        shape=(n, m), nnz=int(A.nnz), perrow=perrow, mode=mode,
        n_cols_pad=n_strips * 128, n_out=pad_to(n))
    if smooth_dtype is None:
        return M
    return M, M.with_vals(to_device(vals, smooth_dtype, device, timer))


def strip8_bytes_estimate(A: sp.spmatrix, dtype=torch.float32) -> int:
    """Device bytes of the strip8 layout (idx + vals), from the plan."""
    _, plan = _plan8(A)
    return int(_padded_tiles(plan[3].shape[0]) * 8 * 128 * (1 + dtype.itemsize))


def strip8_time_estimate(A: sp.spmatrix, dtype=torch.float32) -> float:
    """Estimated matvec seconds: launch floor + real tiles at the mode's ns
    per tile (the kernel walks the real tiles only)."""
    from saena_tpu_torch.ops.formats import KERNEL_LAUNCH_S

    _, plan = _plan8(A)
    return (KERNEL_LAUNCH_S + plan[3].shape[0]
            * STRIP8_NS_PER_TILE[plan[8]] * 1e-9)
