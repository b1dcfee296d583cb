"""Work tables of the gather kernels (strip and strip8): a row-block-ordered
list of units (pairs or tiles) cut into contiguous chunks, one per kernel
warp.

``row_ptr`` (n_rb + 1) gives each row block's units as one range of the
list. `balance` returns, as numpy int32 arrays:

- ``chunk_ptr`` (n_chunks + 1): warp c owns units [chunk_ptr[c],
  chunk_ptr[c + 1]);
- ``seg_ptr`` (n_chunks + 1) and ``segs`` (n_seg, 4): warp c walks the
  segments segs[seg_ptr[c]:seg_ptr[c + 1]], each (rb, lo, hi, cut), the
  units [lo, hi) of row block rb. A row block inside one chunk has one
  segment with cut -1 (an empty row block too, with lo == hi, in the chunk
  that holds its position); a row block that chunk boundaries cut has one
  segment in each chunk it touches, consecutive in ``segs``, and cut >= 0;
- ``cuts`` (n_cuts, 2): (first segment, number of segments) of each cut row
  block, in row-block order.

The kernel writes a cut row block's pieces to scratch rows indexed by
segment and the last warp to arrive sums them in segment order, so the
result does not depend on which warp finishes first.

`ChunkTables` sizes the chunks and gives each warp a head record (two int4:
{k0, k1, g0, g1} and its first segment), so one load starts a warp. An
operator too small to fill the card (the kernel's resident warps) keeps each
row block of up to ``whole_max`` units whole, packing short row blocks into
chunks of up to ``chunk_min`` units: on such an operator a cut row block's
fence, ticket and second pass would be the kernel's longest chain. A larger
operator is cut into equal shares, as many as the card keeps resident and
no smaller than ``chunk_min`` units, so that its time follows its unit
count. Either way a row block is cut into at most ``max_pieces(rows)``
pieces, so that the warp that sums them reads at most FIXUP_VALUES values.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from saena_tpu_torch.ops import cuda_build

WARPS_PER_SM = 16      # resident warps per SM assumed off the card
FIXUP_VALUES = 32768   # values a cut row block's last warp sums, at most
H100_SMS = 132         # SMs assumed when the tables are built off the card


def sm_count(device) -> int:
    """SMs of the card that holds ``device``; H100_SMS off the card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def warps_per_sm(kernel: str, dtype, device) -> int:
    """Warps of the stream path of csrc/<kernel>.cu that the card holding
    ``device`` keeps resident per SM at values ``dtype`` (f32, bf16 or
    f64), as the CUDA occupancy calculator gives them; WARPS_PER_SM off the
    card."""
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
    if torch.device(device).type != "cuda" or dtype not in codes:
        return WARPS_PER_SM
    fn = getattr(cuda_build.load(kernel), f"saena_{kernel[:-len('_spmv')]}_stream_warps_per_sm")
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    with torch.cuda.device(device):
        n = fn(codes[dtype])
    if n <= 0:
        raise RuntimeError(f"{kernel}: the stream kernel fits no SM")
    return n


def resident_warps(kernel: str, dtype, device) -> int:
    """Warps of that stream path the whole card keeps resident."""
    return warps_per_sm(kernel, dtype, device) * sm_count(device)


def max_pieces(rows: int) -> int:
    """Pieces a row block of ``rows`` rows may be cut into."""
    return max(2, FIXUP_VALUES // max(1, rows))


def n_chunks_for(n_units: int, cap: int, chunk_min: int) -> int:
    """Warps for ``n_units``: at least one, at most ``cap``, and no more
    than leave each warp ``chunk_min`` units."""
    return int(max(1, min(-(-n_units // chunk_min), cap)))


def equal_bounds(n_units: int, n_chunks: int) -> np.ndarray:
    """(n_chunks + 1,) boundaries of equal, contiguous shares."""
    return np.arange(n_chunks + 1, dtype=np.int64) * n_units // n_chunks


def packed_bounds(row_ptr: np.ndarray, chunk_min: int, whole_max: int,
                  pieces: int) -> np.ndarray:
    """Chunk boundaries that keep every row block of at most ``whole_max``
    units whole, packing consecutive row blocks into chunks of at most
    ``chunk_min`` units (a row block larger than that alone), and cut a
    longer row block into pieces of about ``chunk_min`` units, at most
    ``pieces`` of them."""
    ptr = np.asarray(row_ptr, dtype=np.int64)
    bounds = [0]
    for a, b in zip(ptr[:-1].tolist(), ptr[1:].tolist()):
        if b - a > whole_max:
            if a > bounds[-1]:
                bounds.append(a)
            m = min(-(-(b - a) // chunk_min), pieces)
            bounds.extend(a + (i * (b - a)) // m for i in range(1, m + 1))
        elif b - bounds[-1] > chunk_min and a > bounds[-1]:
            bounds.append(a)
    if bounds[-1] < ptr[-1] or len(bounds) == 1:
        bounds.append(int(ptr[-1]))
    return np.asarray(bounds, dtype=np.int64)


def balance(row_ptr: np.ndarray, chunk_ptr: np.ndarray):
    """(chunk_ptr, seg_ptr, segs, cuts) for the units that ``row_ptr``
    spreads over its row blocks, cut at the boundaries ``chunk_ptr``."""
    ptr = np.asarray(row_ptr, dtype=np.int64)
    n_rb = ptr.size - 1
    chunk_ptr = np.asarray(chunk_ptr, dtype=np.int64)
    n_chunks = chunk_ptr.size - 1

    def owner(pos):
        return np.clip(np.searchsorted(chunk_ptr, pos, side="right") - 1,
                       0, n_chunks - 1)

    a, b = ptr[:-1], ptr[1:]
    first = owner(a)
    lastc = np.where(b > a, owner(b - 1), first)
    pieces = lastc - first + 1
    rb = np.repeat(np.arange(n_rb), pieces)
    start = np.cumsum(pieces) - pieces
    chunk = first[rb] + np.arange(rb.size) - start[rb]
    lo = np.maximum(a[rb], chunk_ptr[chunk])
    hi = np.minimum(b[rb], chunk_ptr[chunk + 1])
    is_cut = pieces > 1
    cut_of = np.where(is_cut, np.cumsum(is_cut) - 1, -1)
    order = np.argsort(chunk, kind="stable")  # (chunk, rb) order
    segs = np.stack([rb, lo, hi, cut_of[rb]], axis=1)[order]
    seg_ptr = np.concatenate([[0], np.cumsum(np.bincount(chunk, minlength=n_chunks))])
    n_cuts = int(is_cut.sum())
    cuts = np.zeros((n_cuts, 2), dtype=np.int64)
    if n_cuts:
        pos = np.flatnonzero(segs[:, 3] >= 0)
        cid = segs[pos, 3]
        cuts[:, 0] = pos[np.searchsorted(cid, np.arange(n_cuts))]
        cuts[:, 1] = pieces[is_cut]
    as32 = lambda v: np.ascontiguousarray(v, dtype=np.int32)
    return as32(chunk_ptr), as32(seg_ptr), as32(segs).reshape(-1, 4), as32(cuts).reshape(-1, 2)


def chunk_bounds(row_ptr: np.ndarray, rows: int, cap: int, chunk_min: int,
                 whole_max: int) -> np.ndarray:
    """The chunk boundaries `ChunkTables` uses (module docstring) for a
    card that keeps ``cap`` warps of the kernel resident."""
    ptr = np.asarray(row_ptr, dtype=np.int64)
    n_units = int(ptr[-1])
    pieces = max_pieces(rows)
    if -(-n_units // chunk_min) <= cap:
        bounds = packed_bounds(ptr, chunk_min, whole_max, pieces)
        if bounds.size - 1 <= cap:
            return bounds
    longest = int(np.diff(ptr).max()) if ptr.size > 1 else 0
    # a row block of `longest` units spans at most longest / share + 1 chunks
    n = min(n_chunks_for(n_units, cap, chunk_min),
            max(1, n_units * (pieces - 1) // max(1, longest)))
    return equal_bounds(n_units, n)


def head_records(chunk_ptr, seg_ptr, segs) -> np.ndarray:
    """(n_chunks, 8) int32: {k0, k1, g0, g1} and the first segment of each
    chunk (zeros for a chunk without segments)."""
    g0, g1 = seg_ptr[:-1], seg_ptr[1:]
    first = np.zeros((g0.size, 4), dtype=np.int64)
    has = g1 > g0
    first[has] = segs[g0[has]]
    return np.ascontiguousarray(np.concatenate(
        [np.stack([chunk_ptr[:-1], chunk_ptr[1:], g0, g1], axis=1), first], axis=1),
        dtype=np.int32)


class ChunkTables:
    """The head records and `balance`'s segments and cuts on ``device``
    for row blocks of ``rows`` rows and a kernel of which each SM keeps
    ``warps_per_sm`` warps resident,
    with the kernel's tickets (``counter``, one zero per cut row block;
    zeros between launches, so a matrix takes one launch at a time: its
    launches go to one stream)."""

    def __init__(self, row_ptr: np.ndarray, device, rows: int, chunk_min: int,
                 whole_max: int, warps_per_sm: int = WARPS_PER_SM):
        cap = max(1, warps_per_sm) * sm_count(device)
        bounds = chunk_bounds(row_ptr, rows, cap, chunk_min, whole_max)
        host = balance(row_ptr, bounds)
        self.host = dict(zip(("chunk_ptr", "seg_ptr", "segs", "cuts"), host))
        self.host["heads"] = head_records(*host[:3])
        self.n_chunks = int(bounds.size - 1)
        self.n_seg = int(host[2].shape[0])
        self.n_cuts = int(host[3].shape[0])
        dev = lambda a: torch.from_numpy(a).to(device)
        self.heads, self.segs, self.cuts = (dev(self.host[k]) for k in ("heads", "segs", "cuts"))
        self.counter = torch.zeros(self.n_cuts, dtype=torch.int32, device=device)

    def tensors(self):
        return (self.heads, self.segs, self.cuts, self.counter)
