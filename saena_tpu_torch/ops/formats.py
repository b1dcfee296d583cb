"""Device sparse-matrix formats and their host-side converters.

The formats keep the layouts of saena_tpu/ops/formats.py, so the two
packages can be compared array for array:

- ``EllMatrix``: slot-major ELLPACK, cols/vals ``(width, n_pad)``; rows
  longer than ``width`` spill to a COO tail, summed row by row in a fixed
  order (``ell_spmv.spill_segments``) and added once to each row.
- ``DiaMatrix``: diagonal storage ``(ndiag, n_pad)`` for stencil matrices;
  its matvec and fused smoother update are the DIA kernel (ops/dia_spmv.py).
- ``DenseMatrix``: coarse levels switch to dense (ref
  saena_object_setup2.cpp:327-339), applied with ``torch.matmul``.
- ``BsrMatrix``: (8, 128)-block rows in block-ELL layout, applied as a
  batched matrix product (plain PyTorch, as the JAX package left it to XLA).
- ``StripMatrix`` and ``Strip8Matrix`` (ops/strip_spmv.py,
  ops/strip8_spmv.py): the gather formats of the strip and strip8 kernels.

Vector convention: every device vector of a space of logical size n is
padded to ``pad_to(n)`` (a multiple of 128) with zeros, and every operator
preserves the zero padding, so the solve path never slices.

Each format holds tensors on one explicit device. ELL's matvec is the ELL
kernel on the card (ops/ell_spmv.py) and plain PyTorch on the CPU (an
``index_select`` gather and a sum); both sum a row's spill in the order of
its triples and add it once, so two matvecs on the card give equal bits (a
scatter of the triples would add a row's entries with atomics in no fixed
order).

``device_matrix_from_csr`` takes the JAX package's CPU branch for a CPU
target and its accelerator branch for a CUDA target (or when the caller
passes ``prefer_bsr=True``): wide-stencil DIA, then the gather picker,
which ranks strip, strip8 and BSR by estimated matvec time. Cost constants
are H100 measurements from ``chip_smoke.py`` phase 4; see PERF.md.

Every converter takes ``smooth_dtype``: it then returns (M, M_smooth), the
twin holding the same host values at that dtype (Options.smooth_dtype)
beside M's own index arrays and layout, so the format pick is M's. DIA,
strip and strip8 twins with bf16 values stream them through their kernels
with an f32 x and accumulator; ELL, dense and BSR twins compute at the
twin's dtype, as the JAX package's do.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch.ops import ell_spmv as _ell
from saena_tpu_torch.ops.dia_spmv import dia_plan, dia_spmv, sm_count

PAD = 128  # alignment of every device vector and row dimension

_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


def accelerator_branch(device) -> bool:
    """Whether setup takes the JAX package's accelerator branch (wide DIA,
    the gather picker, structural transfers) for ``device``: on the card."""
    return torch.device(device).type == "cuda"


def pad_to(n: int, m: int = PAD) -> int:
    return max(((n + m - 1) // m) * m, m)


def to_device(arr, dtype: torch.dtype, device, timer=None) -> torch.Tensor:
    """Upload a host array at its final dtype; the seconds and bytes go to
    ``timer`` (a runtime.PhaseTimer) when one is given."""
    t0 = time.perf_counter()
    np_dt = _NP_FLOAT.get(dtype)
    if np_dt is not None:
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=np_dt))
    else:                              # bf16 and other torch-only dtypes
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float64)).to(dtype)
    out = host.to(device)
    if timer is not None:
        timer.add_upload(time.perf_counter() - t0, out.numel() * out.element_size())
    return out


def scatter_value_dtype(dtype, smooth_dtype=None):
    """numpy dtype of a converter's value-scatter buffer: the target dtype
    itself when it is a numpy float and no twin is asked for (scattering
    f64 values into it rounds each as a cast would, without an f64 copy),
    else f64, from which M and its twin are both cast."""
    if smooth_dtype is None:
        return _NP_FLOAT.get(dtype, np.float64)
    return np.float64


def index_to_device(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)


def int8_to_device(arr, device) -> torch.Tensor:
    """Lane indices within a 128-column strip (0..127) as int8."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int8)).to(device)


class EllMatrix:
    """Hybrid slot-major ELLPACK. cols/vals: (width, n_pad); padding slots
    have col=0, val=0. The spill triples hold the entries of rows whose nnz
    exceeds width; ``seg`` their row groups (``spill_segments``) on the
    device, or None without spill. ``tile_bound`` (n_pad / 32,) int32: the
    slots of each 32-row tile that hold its longest row
    (``ell_spmv.tile_bounds``); on the card ``plan``, how the kernel walks
    the matrix (``ell_spmv.ell_plan``), else None."""

    def __init__(self, cols, vals, spill_rows, spill_cols, spill_vals, shape, nnz):
        self.cols, self.vals = cols, vals
        self.spill_rows, self.spill_cols, self.spill_vals = spill_rows, spill_cols, spill_vals
        self.shape, self.nnz = tuple(shape), int(nnz)
        self.seg = None
        if spill_rows.numel():
            seg_rows, seg_idx = _ell.spill_segments(spill_rows.cpu().numpy()[None])
            self.seg = (torch.from_numpy(seg_rows[0]).to(spill_rows.device),
                        torch.from_numpy(seg_idx[0]).to(spill_rows.device))
        self.tile_bound = _ell.tile_bounds(vals)
        self.plan = (_ell.ell_plan(self.tile_bound, spill_rows, spill_cols, spill_vals,
                                   self.n_pad, pad_to(self.shape[1]))
                     if vals.device.type == "cuda" else None)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def n_pad(self) -> int:
        return self.cols.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x. x: (pad_to(n_cols),) -> y: (pad_to(n_rows),); the
        kernel on the card (at promote(dtype, f32)), the plain version on
        the CPU (ops/ell_spmv.py)."""
        return _ell.ell_spmv(self, x)


class DiaMatrix:
    """Diagonal (DIA) storage: data[k, i] = A[i, i + offsets[k]]."""

    def __init__(self, data, offsets, shape, nnz):
        self.data = data
        self.offsets = tuple(int(o) for o in offsets)
        # the offsets once more on the device, so a launch copies nothing
        self.offsets_dev = torch.tensor(self.offsets, dtype=torch.int64,
                                        device=data.device)
        # and the kernel's launch plan for this card (ops/dia_spmv.py)
        self.plan = (dia_plan(self.offsets, data.shape[1], data.dtype,
                              sm_count(data.device))
                     if data.device.type == "cuda" else None)
        self.shape, self.nnz = tuple(shape), int(nnz)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def n_pad(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x at the compute dtype promote(dtype, f32)."""
        return dia_spmv(self.data, x, self.offsets, offsets_dev=self.offsets_dev,
                        plan=self.plan)

    def fused_update(self, x, rhs, dinv=None, c: float = 1.0,
                     add_x: bool = True) -> torch.Tensor:
        """y = [x +] c * [dinv *] (rhs - A@x) in one kernel pass."""
        return dia_spmv(self.data, x, self.offsets, rhs=rhs, dinv=dinv, c=c,
                        add_x=add_x, offsets_dev=self.offsets_dev, plan=self.plan)


class DenseMatrix:
    """Row-major dense block (n_pad, m_pad), zero-padded."""

    def __init__(self, data, shape, nnz):
        self.data = data
        self.shape, self.nnz = tuple(shape), int(nnz)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def n_pad(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.data, x.to(self.dtype))


class BsrMatrix:
    """Block-sparse rows: (8, 128) dense blocks, block-ELL across block rows.
    blocks (n_br, W, 8, 128), bcols (n_br, W) int32, the 128-column chunk
    of x each block reads; padding blocks are zero and read chunk 0."""

    def __init__(self, blocks, bcols, shape, nnz):
        self.blocks, self.bcols = blocks, bcols
        self.shape, self.nnz = tuple(shape), int(nnz)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def n_pad(self) -> int:
        return self.blocks.shape[0] * 8

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """One batched (8, 128) @ (128,) product per block, summed over the
        block row's W blocks."""
        g = x.to(self.dtype).view(-1, 128)[self.bcols.long()]  # (n_br, W, 128)
        y = torch.matmul(self.blocks, g.unsqueeze(-1))           # (n_br, W, 8, 1)
        return y.sum(dim=1).reshape(-1)


DeviceMatrix = EllMatrix | DiaMatrix | DenseMatrix | BsrMatrix


# ---------------------------------------------------------------------------
# host-side converters (setup path, numpy)
# ---------------------------------------------------------------------------


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total) - starts


def ell_from_csr(A: sp.spmatrix, dtype, device, width: Optional[int] = None,
                 width_quantile: float = 1.0, timer=None, smooth_dtype=None):
    """Convert CSR to hybrid slot-major ELL. width defaults to the max row
    nnz; with width_quantile < 1 it is cut at that quantile and the tail
    spills to COO, unless that would spill more than 10% of nnz. With
    ``smooth_dtype``: (M, twin)."""
    A = A.tocsr()
    if not A.has_sorted_indices:
        A = A.copy()          # don't reorder the caller's entry order
        A.sort_indices()
    n, m = A.shape
    nnz_per_row = np.diff(A.indptr)
    if width is None:
        if nnz_per_row.size == 0 or A.nnz == 0:
            width = 1
        elif width_quantile >= 1.0:
            width = int(nnz_per_row.max())
        else:
            width = max(1, int(np.quantile(nnz_per_row, width_quantile)))
            spill = int(np.maximum(nnz_per_row - width, 0).sum())
            if spill > 0.1 * A.nnz:
                width = int(nnz_per_row.max())
    width = max(1, width)

    n_pad = pad_to(n)
    cols = np.zeros((width, n_pad), dtype=np.int32)
    vals = np.zeros((width, n_pad), dtype=np.float64)
    take = np.minimum(nnz_per_row, width)

    # slot-major fill: slot k holds each row's k-th entry
    rows_idx = np.repeat(np.arange(n), take)
    slot_idx = _ranges(take)
    src = A.indptr[:-1].repeat(take) + slot_idx
    cols[slot_idx, rows_idx] = A.indices[src]
    vals[slot_idx, rows_idx] = A.data[src]

    # spill: entries beyond width
    over = nnz_per_row - take
    s_rows = np.repeat(np.arange(n), over)
    s_src = (A.indptr[:-1] + take).repeat(over) + _ranges(over)

    s_vals = A.data[s_src]
    M = EllMatrix(
        cols=index_to_device(cols, device),
        vals=to_device(vals, dtype, device, timer),
        spill_rows=index_to_device(s_rows, device),
        spill_cols=index_to_device(A.indices[s_src], device),
        spill_vals=to_device(s_vals, dtype, device, timer),
        shape=(n, m),
        nnz=int(A.nnz),
    )
    if smooth_dtype is None:
        return M
    return M, EllMatrix(M.cols, to_device(vals, smooth_dtype, device, timer),
                        M.spill_rows, M.spill_cols,
                        to_device(s_vals, smooth_dtype, device, timer),
                        M.shape, M.nnz)


def dia_offsets_of(A: sp.spmatrix) -> np.ndarray:
    """Distinct diagonals, O(nnz + n) via bincount."""
    coo = A.tocoo()
    if coo.row.size == 0:
        return np.zeros(0, dtype=np.int64)
    n, m = A.shape
    offs = coo.col.astype(np.int64) - coo.row + (n - 1)
    present = np.bincount(offs, minlength=n + m - 1) > 0
    return np.flatnonzero(present) - (n - 1)


def dia_from_csr(A: sp.spmatrix, dtype, device, timer=None, smooth_dtype=None):
    """Convert to DIA; with ``smooth_dtype``: (M, twin), the twin's data at
    that dtype on the same offsets (bf16 data streams through the DIA
    kernel with an f32 x and accumulator)."""
    coo = A.tocoo()
    n, m = A.shape
    if n != m:
        raise ValueError("DIA format requires a square matrix")
    offs = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq = np.unique(offs)
    data = np.zeros((uniq.size, pad_to(n)), dtype=np.float64)
    data[np.searchsorted(uniq, offs), coo.row] = coo.data  # canonical CSR: no duplicates
    M = DiaMatrix(data=to_device(data, dtype, device, timer),
                  offsets=uniq, shape=(n, m), nnz=int(A.nnz))
    if smooth_dtype is None:
        return M
    return M, DiaMatrix(data=to_device(data, smooth_dtype, device, timer),
                        offsets=uniq, shape=(n, m), nnz=int(A.nnz))


def dense_from_csr(A: sp.spmatrix, dtype, device, unit_diag_pad: bool = False,
                   timer=None, smooth_dtype=None):
    n, m = A.shape
    n_pad, m_pad = pad_to(n), pad_to(m)
    d = np.zeros((n_pad, m_pad), dtype=np.float64)
    d[:n, :m] = A.toarray()
    if unit_diag_pad and n_pad == m_pad:
        idx = np.arange(n, n_pad)
        d[idx, idx] = 1.0  # keep the padded system nonsingular for LU
    M = DenseMatrix(data=to_device(d, dtype, device, timer), shape=(n, m),
                    nnz=int(A.nnz))
    if smooth_dtype is None:
        return M
    return M, DenseMatrix(data=to_device(d, smooth_dtype, device, timer),
                          shape=(n, m), nnz=int(A.nnz))


def bsr_from_csr(A: sp.spmatrix, dtype, device, timer=None, smooth_dtype=None):
    """Convert CSR to (8, 128)-block BSR (block-ELL across block rows); with
    ``smooth_dtype``: (M, twin)."""
    A = A.tocsr()
    n, m = A.shape
    n_br = pad_to(n) // 8
    n_bc = pad_to(m) // 128
    coo = A.tocoo()
    key = (coo.row // 8).astype(np.int64) * n_bc + coo.col // 128
    uniq, inv = np.unique(key, return_inverse=True)
    u_br = (uniq // n_bc).astype(np.int64)
    u_bc = (uniq % n_bc).astype(np.int64)
    counts = np.bincount(u_br, minlength=n_br)
    W = max(1, int(counts.max())) if counts.size else 1
    # slot of each unique block within its block row (uniq is sorted)
    slot = np.arange(uniq.size) - (np.cumsum(counts) - counts)[u_br]
    blocks = np.zeros((n_br, W, 8, 128),
                      dtype=scatter_value_dtype(dtype, smooth_dtype))
    bcols = np.zeros((n_br, W), dtype=np.int32)
    bcols[u_br, slot] = u_bc
    blocks[u_br[inv], slot[inv], coo.row % 8, coo.col % 128] = coo.data
    M = BsrMatrix(blocks=to_device(blocks, dtype, device, timer),
                  bcols=index_to_device(bcols, device), shape=(n, m),
                  nnz=int(A.nnz))
    if smooth_dtype is None:
        return M
    return M, BsrMatrix(blocks=to_device(blocks, smooth_dtype, device, timer),
                        bcols=M.bcols, shape=(n, m), nnz=int(A.nnz))


# H100 cost constants, measured by chip_smoke.py phase 4 on NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit (PERF.md, "Cost constants").
# BSR_STREAM_BPS: the read rate of one sum over the 48^3 level-2 A's f32 BSR
# blocks (234 MB); BSR_TIME_FACTOR: that operator's BSR matvec time over its
# block bytes at that rate; KERNEL_LAUNCH_S: the time of the smallest strip8
# layout (one tile), the launch floor of a gather kernel.
BSR_STREAM_BPS = 2.846e12
BSR_TIME_FACTOR = 2.22
KERNEL_LAUNCH_S = 2.02e-6


def bsr_time_estimate(A: sp.spmatrix, dtype=torch.float32) -> float:
    """Estimated matvec seconds: the BSR product streams its blocks."""
    return KERNEL_LAUNCH_S + \
        bsr_bytes_estimate(A, dtype) / BSR_STREAM_BPS * BSR_TIME_FACTOR


def device_matrix_from_csr(
    A: sp.spmatrix,
    dtype,
    device,
    dense_thre: float = 0.1,
    dense_sz_thre: int = 5000,
    switch_to_dense: bool = True,
    max_dia_diags: int = 40,
    dia_fill_thre: float = 0.3,
    prefer_bsr: Optional[bool] = None,
    timer=None,
    smooth_dtype=None,
):
    """Pick the device format of a matrix: the reference's dense switch
    (density > dense_thre and size <= dense_sz_thre,
    saena_object_setup2.cpp:327-339), then DIA at <= max_dia_diags
    diagonals with fill >= dia_fill_thre. ``prefer_bsr`` (None: follow the
    device, True on the card) selects the accelerator branch next:
    wide-stencil DIA up to 256 diagonals at the same fill, then the fastest
    gather format by estimated time (strip, strip8, BSR, within the byte
    caps GATHER_MAX_BYTES and GATHER_MAX_BYTES_PER_NNZ). Everything else is
    ELL cut at the 0.98 row-nnz quantile. With ``smooth_dtype`` it returns
    (M, M_smooth): the twin of the format picked for M, at that dtype."""
    A = A.tocsr()
    device = torch.device(device)
    n, m = A.shape
    density = A.nnz / max(1, n * m)
    if prefer_bsr is None:
        prefer_bsr = accelerator_branch(device)
    kw = dict(timer=timer, smooth_dtype=smooth_dtype)
    if switch_to_dense and density > dense_thre and max(n, m) <= dense_sz_thre:
        return dense_from_csr(A, dtype, device, **kw)
    if n == m and A.nnz > 0:
        offs = dia_offsets_of(A)
        fill = A.nnz / (offs.size * n)
        if fill >= dia_fill_thre and (
                offs.size <= max_dia_diags or (prefer_bsr and offs.size <= 256)):
            return dia_from_csr(A, dtype, device, **kw)
    if prefer_bsr and A.nnz > 0:
        builder = pick_gather_format(A, dtype)
        if builder is not None:
            return builder(A, dtype, device, **kw)
    return ell_from_csr(A, dtype, device, width_quantile=0.98, **kw)


# ---------------------------------------------------------------------------
# gather-format picker (accelerator branch)
# ---------------------------------------------------------------------------


# device-footprint caps of a gather format: in all, and per nonzero
GATHER_MAX_BYTES = 768 * 1024 * 1024
GATHER_MAX_BYTES_PER_NNZ = 1024


def gather_time_estimate(A: sp.spmatrix, dtype=torch.float32) -> float:
    """Least estimated matvec seconds over the gather formats that fit the
    byte caps (strip, strip8, BSR); inf if none does."""
    return _pick_gather(A, dtype)[0]


def gather_time_estimate_quick(A: sp.spmatrix, dtype=torch.float32) -> float:
    """A cheap estimate from the sampled strip pick and the BSR geometry,
    without strip8's full-pattern plan; callers use it to decide whether
    the exact estimate is worth computing."""
    from saena_tpu_torch.ops.strip_spmv import strip_time_estimate

    t = bsr_time_estimate(A, dtype)
    if A.nnz >= 4096:
        t = min(t, strip_time_estimate(A, dtype))
    return t


def pick_gather_format(A: sp.spmatrix, dtype=torch.float32):
    """The builder (fn(A, dtype, device, timer=None, smooth_dtype=None)) of
    the gather format with the least estimated matvec time, or None when
    none fits the caps."""
    return _pick_gather(A, dtype)[1]


def _pick_gather(A, dtype):
    from saena_tpu_torch.ops.strip8_spmv import (
        strip8_bytes_estimate, strip8_from_csr, strip8_time_estimate)
    from saena_tpu_torch.ops.strip_spmv import (
        strip_bytes_estimate, strip_from_csr, strip_time_estimate)

    A = A.tocsr()
    cap = min(GATHER_MAX_BYTES, GATHER_MAX_BYTES_PER_NNZ * max(1, A.nnz))
    best = (float("inf"), None)
    if A.nnz >= 4096:
        if strip_bytes_estimate(A, dtype) <= cap:
            best = min(best, (strip_time_estimate(A, dtype), strip_from_csr),
                       key=lambda b: b[0])
        if strip8_bytes_estimate(A, dtype) <= cap:
            best = min(best, (strip8_time_estimate(A, dtype), strip8_from_csr),
                       key=lambda b: b[0])
    if bsr_bytes_estimate(A, dtype) <= cap:
        best = min(best, (bsr_time_estimate(A, dtype), bsr_from_csr),
                   key=lambda b: b[0])
    return best


# ---------------------------------------------------------------------------
# host helpers for the coarse-ordering decision (amg/hierarchy.coarsen_tail)
# ---------------------------------------------------------------------------


def rcm_permutation(A: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering for bandwidth reduction."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True))


def bsr_block_width(rows: np.ndarray, cols: np.ndarray,
                    shape: tuple) -> tuple[int, int]:
    """(n_br, W): block rows and the most blocks in one block row of the
    (8, 128) blocking of a coordinate pattern. The coarse-ordering decision
    compares this footprint of the RCM-permuted pattern with the original's,
    which decides the ordering the next aggregation sees."""
    n_br = pad_to(shape[0]) // 8
    n_bc = pad_to(shape[1]) // 128
    if rows.size == 0:
        return n_br, 1
    if n_br * n_bc <= 3 * 10**7:
        key = (rows.astype(np.int64) // 8) * n_bc + cols // 128
        occ = np.bincount(key, minlength=n_br * n_bc) > 0
        return n_br, max(1, int(occ.reshape(n_br, n_bc).sum(axis=1).max()))
    pat = sp.csr_matrix(
        (np.ones(rows.size, dtype=np.int8),
         (rows // 8, cols // 128)), shape=(n_br, n_bc))
    return n_br, max(1, int(np.diff(pat.indptr).max()))


_BSR_MEMO = "_saena_torch_bsr_geom"


def bsr_bytes_estimate(A: sp.spmatrix, dtype=torch.float32) -> int:
    """Bytes of A's (8, 128)-block storage at ``dtype``; the (n_br, W)
    geometry is memoized on the matrix object keyed by (shape, nnz)."""
    key = (A.shape, A.nnz)
    tok = getattr(A, _BSR_MEMO, None)
    if tok is not None and tok[0] == key:
        n_br, W = tok[1]
    else:
        coo = A.tocoo()
        n_br, W = bsr_block_width(coo.row, coo.col, A.shape)
        set_bsr_geometry(A, n_br, W)
    return n_br * W * 8 * 128 * dtype.itemsize


def set_bsr_geometry(A: sp.spmatrix, n_br: int, W: int) -> None:
    try:
        setattr(A, _BSR_MEMO, ((A.shape, A.nnz), (n_br, W)))
    except AttributeError:
        pass
