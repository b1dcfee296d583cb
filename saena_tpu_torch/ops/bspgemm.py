"""Block-sparse SpGEMM: host symbolic phase + device numeric phase.

The port of the serial half of saena_tpu/ops/bspgemm.py (:49-206), the
Galerkin engine of ``Options(rap="device")`` (amg/hierarchy.coarsen_csr):
the replacement of the reference's sparse SpGEMM engine (fast_mm +
matmat_CSC, saena_object_setup_matmat.cpp:27-1163), which bounds a dense
accumulator with matmat_thre1 and recurses.

- **Host symbolic** (numpy, integer-only, the JAX package's code): tile A
  into (8, bk) blocks and B into (bk, 128) blocks, keep only nonzero tiles,
  and enumerate the contributing block pairs (a, b) -> c with
  c = (A.block_row, B.block_col). The product's data-dependent shapes are
  decided here, on the host.
- **Device numeric** (``_bsp_numeric``, PyTorch): gather the paired tiles,
  one batched (8, bk) @ (bk, 128) product per chunk of ``CHUNK`` pairs
  (``torch.bmm``), and ``index_add_`` by output block into the output block
  stack. Memory is proportional to the number of nonzero blocks, never
  O(n^2). The JAX package leaves this product to XLA, outside any Pallas
  kernel. On the card ``index_add_`` adds with atomics, so blocks that meet
  in one chunk sum in no fixed order (equal to rounding).

bk (the contraction width) trades block fill for the product's shape: 32
keeps memory tight on ~5-30 nnz/row operators (AMG fine levels), 128 suits
denser mid-level operators; ``pick_bk`` is matmat_thre1's density switch
(saena_object.h:75-85). ``pairs_total`` counts the block pairs multiplied.

The distributed ring half (saena_tpu/ops/bspgemm.py:208-388) is not ported
yet.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch.runtime import resolve_device

CHUNK = 512          # pairs per numeric step: bounds the gathered operand
                     # slab to CHUNK * (8 + bk) * 128 values a step
pairs_total = 0      # block pairs multiplied by spgemm_blocks, padding aside


# ---------------------------------------------------------------------------
# host symbolic helpers
# ---------------------------------------------------------------------------


def _block_left(A: sp.spmatrix, bk: int):
    """Tile A into (8, bk) nonzero blocks.

    Returns (blocks, abr, abc): blocks (nA, 8, bk) float64, abr/abc int64
    block coordinates."""
    A = A.tocoo()
    n, m = A.shape
    n_bc = -(-m // bk)
    key = (A.row // 8).astype(np.int64) * n_bc + A.col // bk
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((len(uniq), 8, bk))
    blocks[inv, A.row % 8, A.col % bk] = A.data
    return blocks, (uniq // n_bc).astype(np.int64), (uniq % n_bc).astype(np.int64)


def _block_right(B: sp.spmatrix, bk: int):
    """Tile B into (bk, 128) nonzero blocks. Returns (blocks, bbr, bbc)."""
    B = B.tocoo()
    n, m = B.shape
    br = B.row // bk
    bc = B.col // 128
    n_bc = -(-m // 128)
    key = br.astype(np.int64) * n_bc + bc
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((len(uniq), bk, 128))
    blocks[inv, B.row % bk, B.col % 128] = B.data
    return blocks, (uniq // n_bc).astype(np.int64), (uniq % n_bc).astype(np.int64)


def _pairs(abr, abc, bbr, bbc, n_bc_C):
    """Contributing pairs (a, b) with abc[a] == bbr[b], plus the compacted
    output block id per pair (sorted by c so the scatter-add is sorted).

    Returns (a_idx, b_idx, c_idx, c_keys) with c_keys the sorted unique
    (C.block_row * n_bc_C + C.block_col) keys."""
    if abr.size == 0 or bbr.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z
    order_b = np.argsort(bbr, kind="stable")
    bbr_s = bbr[order_b]
    n_k = int(max(abc.max(), bbr.max())) + 1
    starts = np.searchsorted(bbr_s, np.arange(n_k + 1))
    cnt = np.diff(starts)                     # B blocks per block-row k
    rep = cnt[abc]                            # pairs contributed per A block
    total = int(rep.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z
    a_idx = np.repeat(np.arange(abr.size, dtype=np.int64), rep)
    cum = np.cumsum(rep) - rep
    pos = np.arange(total, dtype=np.int64) - np.repeat(cum, rep)
    b_idx = order_b[np.repeat(starts[abc], rep) + pos]
    c_key = abr[a_idx] * n_bc_C + bbc[b_idx]
    c_keys, c_idx = np.unique(c_key, return_inverse=True)
    order = np.argsort(c_idx, kind="stable")
    return a_idx[order], b_idx[order], c_idx[order], c_keys


def _pad_pairs(a_idx, b_idx, c_idx, n_cblocks, chunk=CHUNK):
    """Pad pair lists to a chunk multiple; padding scatters into the dummy
    block n_cblocks."""
    p = a_idx.size
    target = -(-max(p, 1) // chunk) * chunk
    pad = target - p
    a = np.concatenate([a_idx, np.zeros(pad, np.int64)]).astype(np.int32)
    b = np.concatenate([b_idx, np.zeros(pad, np.int64)]).astype(np.int32)
    c = np.concatenate([c_idx, np.full(pad, n_cblocks, np.int64)]).astype(np.int32)
    return a, b, c


# ---------------------------------------------------------------------------
# device numeric phase
# ---------------------------------------------------------------------------


def _bsp_numeric(Ab, Bb, a_idx, b_idx, c_idx, n_cblocks: int,
                 chunk: int = CHUNK) -> torch.Tensor:
    """C[c] += A[a] @ B[b] over the padded pair lists, ``chunk`` pairs a
    step. One extra dummy output block absorbs the padding."""
    C = torch.zeros((n_cblocks + 1, 8, 128), dtype=Ab.dtype, device=Ab.device)
    a_idx, b_idx, c_idx = (t.long() for t in (a_idx, b_idx, c_idx))
    for s in range(0, a_idx.shape[0], chunk):
        prod = torch.bmm(Ab.index_select(0, a_idx[s:s + chunk]),
                         Bb.index_select(0, b_idx[s:s + chunk]))
        C.index_add_(0, c_idx[s:s + chunk], prod)
    return C


def _assemble_csr(C_blocks: np.ndarray, c_keys: np.ndarray, n_bc: int,
                  shape) -> sp.csr_matrix:
    """Nonzero entries of the block stack -> scipy CSR."""
    nb = c_keys.size
    if nb == 0:
        return sp.csr_matrix(shape)
    blk = C_blocks[:nb]
    cb_r = (c_keys // n_bc) * 8
    cb_c = (c_keys % n_bc) * 128
    bi, ri, ci = np.nonzero(blk)
    rows = cb_r[bi] + ri
    cols = cb_c[bi] + ci
    keep = (rows < shape[0]) & (cols < shape[1])
    M = sp.csr_matrix(
        (blk[bi[keep], ri[keep], ci[keep]], (rows[keep], cols[keep])),
        shape=shape)
    M.sum_duplicates()
    M.sort_indices()
    return M


def pick_bk(A: sp.spmatrix, B: sp.spmatrix) -> int:
    """Contraction width: 32 for sparse operands (tight blocks), 128 once
    the inner dimension's rows are dense enough that wide blocks fill."""
    nnz_per_row = B.nnz / max(1, B.shape[0])
    return 128 if nnz_per_row >= 24 else 32


def spgemm_blocks(A: sp.spmatrix, B: sp.spmatrix, device=None) -> sp.csr_matrix:
    """Block-sparse C = A @ B: host symbolic, the numeric phase on
    ``device`` (the card unless named) in f64 (the JAX package's x64
    branch; TF32 stays off); memory ∝ nonzero blocks."""
    global pairs_total
    if A.shape[1] != B.shape[0]:
        raise ValueError("inner dimensions must match")
    device = resolve_device(device)
    bk = pick_bk(A, B)
    Ab, abr, abc = _block_left(A, bk)
    Bb, bbr, bbc = _block_right(B, bk)
    n_bc_C = -(-B.shape[1] // 128)
    a_idx, b_idx, c_idx, c_keys = _pairs(abr, abc, bbr, bbc, n_bc_C)
    if c_keys.size == 0:
        return sp.csr_matrix((A.shape[0], B.shape[1]))
    pairs_total += int(a_idx.size)
    a, b, c = _pad_pairs(a_idx, b_idx, c_idx, c_keys.size)
    up = lambda arr: torch.from_numpy(arr).to(device)
    C = _bsp_numeric(up(Ab), up(Bb), up(a), up(b), up(c), c_keys.size)
    return _assemble_csr(C.cpu().numpy(), c_keys, n_bc_C,
                         (A.shape[0], B.shape[1]))
