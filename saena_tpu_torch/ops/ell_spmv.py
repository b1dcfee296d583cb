"""Hybrid ELL SpMV ("K4"): the kernel wrapper, its host tables and its plain
PyTorch version.

    y[r] = sum over slots k of vals[k, r] * x[cols[k, r]]
           + the sum of row r's spill triples, added once

over slot-major cols / vals (width, n_pad) (ops/formats.EllMatrix). It
replaces no Pallas kernel: the JAX package leaves its EllMatrix to XLA, and
``ell_spmv_plain`` is that function in torch ops (an ``index_select``
gather, a product and a sum, the spill summed per row in the order of
``spill_segments``).

`ell_spmv` launches the CUDA kernel (csrc/ell_spmv.cu) for tensors on the
card and runs `ell_spmv_plain` for tensors on the CPU; it never falls back
from one to the other. The kernel reads, of each 32-row tile, only the
slots below the tile's ``tile_bounds`` entry; the tiles are shared out to
one block per SM by ``ell_schedule``, balanced by their slot counts (the
matrix's ``EllPlan``, built with it). x is gathered through the read-only
path. bf16 values compute with an f32 x and return an f32 y, as the other
kernels' do. Launches are recorded in `runtime.launches` ("ell", "ell.bf16"
and ("ell", n_pad, n_x, width)).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq

import numpy as np
import torch

from saena_tpu_torch.ops import cuda_build
from saena_tpu_torch.ops.chunks import sm_count
from saena_tpu_torch.ops.dia_spmv import compute_dtype
from saena_tpu_torch.runtime import launched

TILE = 32            # rows of a tile (shared with csrc/ell_spmv.cu)
TILE_COST = 64       # a tile's fixed cost in the schedule, in slots
BOUND_SLOTS = 256    # slots ``tile_bounds`` reads at a time

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def spill_segments(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row groups of COO spill triples, so that each row's entries can be
    summed in a fixed order and the sum added once to the row. rows (k, S)
    -> (seg_rows (k, U), seg_idx (k, U, W)), int64: seg_idx[d, u] lists, in
    their order, the triples of row seg_rows[d, u], padded with S (a zero
    appended to the products); a group with fewer rows pads seg_rows with
    row 0 and an all-padding list."""
    k, S = rows.shape
    groups = [np.unique(r, return_inverse=True, return_counts=True) for r in rows]
    U = max(g[0].size for g in groups)
    W = max(int(g[2].max()) for g in groups)
    seg_rows = np.zeros((k, U), dtype=np.int64)
    seg_idx = np.full((k, U, W), S, dtype=np.int64)
    for d, (u, inv, cnt) in enumerate(groups):
        order = np.argsort(inv, kind="stable")
        seg_rows[d, : u.size] = u
        slot = np.arange(S) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        seg_idx[d, inv[order], slot] = order
    return seg_rows, seg_idx


def spill_sums(prod: torch.Tensor, seg_idx: torch.Tensor) -> torch.Tensor:
    """Per-row sums of spill products (..., S) in the order of
    ``spill_segments``' lists: (..., U)."""
    pad = torch.nn.functional.pad(prod, (0, 1))
    if pad.dim() == 1:
        return pad[seg_idx].sum(-1)
    k = seg_idx.shape[0]
    return torch.gather(pad, 1, seg_idx.reshape(k, -1)).reshape(seg_idx.shape).sum(-1)


def tile_bounds(vals: torch.Tensor) -> torch.Tensor:
    """(n_pad / TILE,) int32 on vals' device: for each tile of TILE rows the
    slots the kernel reads, the last slot of any of its rows that holds a
    nonzero value, plus one (a row's longest run of stored entries; a
    trailing stored zero adds nothing and is left out)."""
    width, n_pad = vals.shape
    length = torch.zeros(n_pad, dtype=torch.int32, device=vals.device)
    for s0 in range(0, width, BOUND_SLOTS):
        held = vals[s0:s0 + BOUND_SLOTS] != 0
        slot = torch.arange(s0 + 1, s0 + held.shape[0] + 1, dtype=torch.int32,
                            device=vals.device)
        length = torch.maximum(length, (held * slot[:, None]).amax(0))
    return length.view(-1, TILE).amax(1)


def ell_schedule(cost: np.ndarray, n_blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """Whole tiles shared out to at most ``n_blocks`` blocks by their costs,
    longest first, each to the least loaded block (ties to the lower tile
    and the lower block): (order, block_ptr), int32, the tiles grouped by
    block in ascending order and where each block's start."""
    n_tiles = cost.size
    n_blocks = max(1, min(n_blocks, n_tiles))
    heap = [(0, b) for b in range(n_blocks)]
    owner = np.empty(n_tiles, dtype=np.int64)
    for t in np.argsort(-cost, kind="stable"):
        load, b = heapq.heappop(heap)
        owner[t] = b
        heapq.heappush(heap, (load + int(cost[t]), b))
    order = np.argsort(owner, kind="stable")
    block_ptr = np.searchsorted(owner[order], np.arange(n_blocks + 1))
    return order.astype(np.int32), block_ptr.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """How the kernel walks one EllMatrix on the card: the length of x
    (``n_x``), the schedule of the tiles, and the spill by row
    (``spill_ptr`` (n_pad + 1,) and the triples in row order, each row's in
    their own order; None without spill)."""
    n_x: int
    order: torch.Tensor
    block_ptr: torch.Tensor
    n_blocks: int
    spill_ptr: torch.Tensor | None
    spill_cols: torch.Tensor | None
    spill_vals: torch.Tensor | None


def ell_plan(tile_bound, spill_rows, spill_cols, spill_vals, n_pad: int,
             n_x: int) -> EllPlan | None:
    """The kernel's plan of a matrix on the card (built once, with it);
    None for values of a dtype the kernel does not take."""
    dev = spill_vals.device
    if spill_vals.dtype not in _DTYPE_CODE:
        return None
    rows = spill_rows.cpu().numpy().astype(np.int64)
    cost = tile_bound.cpu().numpy().astype(np.int64) + TILE_COST
    cost += np.bincount(rows // TILE, minlength=cost.size) // TILE
    order, block_ptr = ell_schedule(cost, sm_count(dev))
    on_dev = lambda a: torch.from_numpy(a).to(dev)
    sp_ptr = sp_cols = sp_vals = None
    if rows.size:
        perm = np.argsort(rows, kind="stable")
        sp_ptr = on_dev(np.searchsorted(rows[perm], np.arange(n_pad + 1)).astype(np.int32))
        if (perm == np.arange(perm.size)).all():
            sp_cols, sp_vals = spill_cols, spill_vals
        else:
            idx = on_dev(perm)
            sp_cols, sp_vals = spill_cols[idx].contiguous(), spill_vals[idx].contiguous()
    return EllPlan(n_x, on_dev(order), on_dev(block_ptr), int(block_ptr.size - 1),
                   sp_ptr, sp_cols, sp_vals)


def ell_spmv_plain(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in torch ops, at A's dtype. x: (pad_to(n_cols),) ->
    y: (n_pad,)."""
    x = x.to(A.dtype)
    gathered = x.index_select(0, A.cols.reshape(-1)).view(A.cols.shape)
    y = (A.vals * gathered).sum(0)
    if A.seg is not None:
        seg_rows, seg_idx = A.seg
        prod = A.spill_vals * x.index_select(0, A.spill_cols)
        # distinct rows: each gets one add
        y.index_add_(0, seg_rows, spill_sums(prod, seg_idx))
    return y


@functools.cache
def _library():
    lib = cuda_build.load("ell_spmv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.saena_ell_spmv.argtypes = [i, p, p, i, p, p, p, i, p, p, p, p, p, p]
    lib.saena_ell_spmv.restype = ctypes.c_int
    return lib


def ell_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for an EllMatrix A: (n_pad,), at promote(dtype, f32) on the
    card, at A's dtype on the CPU."""
    if A.vals.device.type == "cpu":
        return ell_spmv_plain(A, x)
    if A.vals.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for device {A.vals.device}")
    return _ell_cuda(A, x)


def _ell_cuda(A, x):
    dev, plan = A.vals.device, A.plan
    if A.dtype not in _DTYPE_CODE:
        raise TypeError(f"ell_spmv: values dtype {A.dtype} not supported "
                        "(float32, bfloat16, float64)")
    width, n_pad = A.vals.shape
    if plan is None or A.cols.shape != (width, n_pad) or n_pad % TILE:
        raise ValueError("ell_spmv: cols/vals must be (width, n_pad) with n_pad a "
                         f"multiple of {TILE}, and the matrix needs its plan")
    arrays = dict(cols=A.cols, vals=A.vals, tile_bound=A.tile_bound, order=plan.order,
                  block_ptr=plan.block_ptr)
    if plan.spill_ptr is not None:
        arrays.update(spill_ptr=plan.spill_ptr, spill_cols=plan.spill_cols,
                      spill_vals=plan.spill_vals)
    for name, t in arrays.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"ell_spmv: {name} must be contiguous on {dev}")
        if t.dtype != (A.dtype if name.endswith("vals") else torch.int32):
            raise ValueError(f"ell_spmv: {name} has dtype {t.dtype}")
    if A.tile_bound.shape != (n_pad // TILE,) or plan.block_ptr.shape != (plan.n_blocks + 1,):
        raise ValueError("ell_spmv: tile_bound/block_ptr do not match the matrix")
    n_x = plan.n_x
    if x.device != dev or x.dim() != 1 or x.shape[0] != n_x:
        raise ValueError(f"ell_spmv: x must be 1-D ({n_x},) on {dev}")
    x = x.to(compute_dtype(A.dtype)).contiguous()
    y = torch.empty(n_pad, dtype=x.dtype, device=dev)
    fn = _library().saena_ell_spmv
    spill = (None, None, None) if plan.spill_ptr is None else (
        plan.spill_ptr.data_ptr(), plan.spill_cols.data_ptr(), plan.spill_vals.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_DTYPE_CODE[A.dtype], A.cols.data_ptr(), A.vals.data_ptr(), n_pad,
                A.tile_bound.data_ptr(), plan.order.data_ptr(), plan.block_ptr.data_ptr(),
                plan.n_blocks, *spill, x.data_ptr(), y.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed with CUDA error {rc}")
    launched("ell", (n_pad, n_x, width), bf16=A.dtype == torch.bfloat16)
    return y
