"""Block-sparse SpGEMM: host symbolic phase + device numeric phase.

The port of saena_tpu/ops/bspgemm.py: the serial engine of
``Options(rap="device")`` (amg/hierarchy.coarsen_csr) and the distributed
ring of ``ops/spgemm.matmat``; the replacement of the reference's sparse
SpGEMM engine (fast_mm + matmat_CSC, saena_object_setup_matmat.cpp:27-1163,
1710-2470), which bounds a dense accumulator with matmat_thre1 and
recurses.

- **Host symbolic** (numpy, integer-only, the JAX package's code): tile A
  into (8, bk) blocks and B into (bk, 128) blocks, keep only nonzero tiles,
  and enumerate the contributing block pairs (a, b) -> c with
  c = (A.block_row, B.block_col). The product's data-dependent shapes are
  decided here, on the host.
- **Device numeric** (``_bsp_numeric``, PyTorch): gather the paired tiles,
  one batched (8, bk) @ (bk, 128) product per chunk of ``CHUNK`` pairs
  (``torch.bmm``; the JAX package leaves this product to XLA, outside any
  Pallas kernel), and add them by output block into the output block stack
  in a fixed order (``_WindowSums``: the pairs are sorted by output block,
  so one block's products in a window of ``WINDOW`` chunks are a run,
  summed by a pairwise tree whose steps are built on the host; each run's
  sum is then added once), so two calls on the card give equal bits. Memory is proportional to the
  number of nonzero blocks, never O(n^2).

bk (the contraction width) trades block fill for the product's shape: 32
keeps memory tight on ~5-30 nnz/row operators (AMG fine levels), 128 suits
denser mid-level operators; ``pick_bk`` is matmat_thre1's density switch
(saena_object.h:75-85). ``pairs_total`` counts the block pairs that
spgemm_blocks multiplies.

The distributed form (``matmat_sparse``) rotates B's row-owner block stacks
around the mesh's ring (``Mesh.ppermute``; the reference's Isend/Irecv
ring, :1986-2103), the per-(shard, step) pair lists precomputed and padded
on the host (``_ring_plan``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch.parallel.partition import equal_row_split
from saena_tpu_torch.runtime import resolve_device

CHUNK = 512          # pairs per numeric step: bounds the gathered operand
                     # slab to CHUNK * (8 + bk) * 128 values a step
WINDOW = 8           # chunks whose products are summed together: the sums'
                     # few small ops a window, not a chunk, so that the host
                     # issues fewer of them (a buffer of WINDOW * CHUNK
                     # (8, 128) products)
pairs_total = 0      # block pairs multiplied by spgemm_blocks, padding aside


# ---------------------------------------------------------------------------
# host symbolic helpers
# ---------------------------------------------------------------------------


def _block_left(A: sp.spmatrix, bk: int, col_block_of=None, n_bc=None):
    """Tile A into (8, bk) nonzero blocks.

    Returns (blocks, abr, abc): blocks (nA, 8, bk) float64, abr/abc int64
    block coordinates. ``col_block_of``/``n_bc`` optionally remap columns
    into an owner-padded block-column space (distributed case)."""
    A = A.tocoo()
    n, m = A.shape
    br = A.row // 8
    if col_block_of is None:
        bc = A.col // bk
        sub_c = A.col % bk
        n_bc = -(-m // bk)
    else:
        bc, sub_c = col_block_of(A.col)
    key = br.astype(np.int64) * n_bc + bc
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((len(uniq), 8, bk))
    blocks[inv, A.row % 8, sub_c] = A.data
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


def _pad_pairs(a_idx, b_idx, c_idx, n_cblocks, chunk=CHUNK, min_len=None):
    """Pad pair lists to a chunk multiple (at least ``min_len``); padding
    pairs name the dummy block n_cblocks."""
    p = a_idx.size
    target = max(min_len or 0, -(-max(p, 1) // chunk) * chunk)
    pad = target - p
    a = np.concatenate([a_idx, np.zeros(pad, np.int64)]).astype(np.int32)
    b = np.concatenate([b_idx, np.zeros(pad, np.int64)]).astype(np.int32)
    c = np.concatenate([c_idx, np.full(pad, n_cblocks, np.int64)]).astype(np.int32)
    return a, b, c


# ---------------------------------------------------------------------------
# device numeric phase
# ---------------------------------------------------------------------------


class _WindowSums:
    """The fixed-order sums of a pair list cut into windows of ``span``
    pairs, whose output block ids ``c`` are sorted within each window: one
    block's products in a window are a run. Step k of a pairwise tree adds
    product r + k of a run to product r for r a multiple of 2k (dst and src
    disjoint, so each target gets one add), then each run's head is added
    once to its block. Pairs naming ``dummy`` (padding) take no part. The
    tables are built on the host and held on ``device``, with per-window
    offsets on the host."""

    def __init__(self, c: np.ndarray, dummy: int, span: int, device):
        c = np.asarray(c, dtype=np.int64)
        n_win = c.size // span
        pos = np.arange(c.size, dtype=np.int64)
        t = pos // span
        loc = pos - t * span
        live = c != dummy
        # same[i]: pair i + 1 continues pair i's run
        same = live[:-1] & live[1:] & (c[1:] == c[:-1]) & (t[1:] == t[:-1])
        start = live & ~np.concatenate([[False], same])
        end = live & ~np.concatenate([same, [False]])
        heads = np.flatnonzero(start)
        run = np.maximum(np.cumsum(start) - 1, 0)
        r = pos - heads[run] if heads.size else pos
        L = np.where(live, (np.flatnonzero(end) - heads + 1)[run], 0) \
            if heads.size else np.zeros(c.size, np.int64)
        up = lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        bounds = np.arange(n_win + 1)
        self.steps = []
        k = 1
        while live.any() and k < int(L.max()):
            sel = live & (r % (2 * k) == 0) & (r + k < L)
            self.steps.append((up(loc[sel]), up(loc[sel] + k),
                               np.searchsorted(t[sel], bounds)))
            k *= 2
        self.heads, self.head_c = up(loc[heads]), up(c[heads])
        self.head_off = np.searchsorted(t[heads], bounds)

    def add(self, w: int, prod: torch.Tensor, C: torch.Tensor) -> None:
        """Add window ``w``'s products ``prod`` (span, 8, 128) into C."""
        for dst, src, off in self.steps:
            lo, hi = off[w], off[w + 1]
            if hi > lo:
                prod.index_add_(0, dst[lo:hi], prod.index_select(0, src[lo:hi]))
        lo, hi = self.head_off[w], self.head_off[w + 1]
        if hi > lo:
            C.index_add_(0, self.head_c[lo:hi], prod.index_select(0, self.heads[lo:hi]))


def _pad_to_windows(c: np.ndarray, dummy: int, span: int) -> np.ndarray:
    """c (..., P) padded with ``dummy`` to a multiple of ``span`` pairs."""
    P = c.shape[-1]
    width = [(0, 0)] * (c.ndim - 1) + [(0, -(-P // span) * span - P)]
    return np.pad(c, width, constant_values=dummy)


def _run_list(Ab, Bb, a, b, n_chunks: int, chunk: int, sums: "_WindowSums",
              w0: int, buf: torch.Tensor, C: torch.Tensor) -> None:
    """C += the products of a pair list's first ``n_chunks`` chunks: one
    batched product a chunk into ``buf``, a window of WINDOW chunks at a
    time, each window's sums (``sums`` windows w0, w0 + 1, ...) added into
    C."""
    for w in range(-(-n_chunks // WINDOW)):
        for i in range(min(WINDOW, n_chunks - w * WINDOW)):
            sl = slice((w * WINDOW + i) * chunk, (w * WINDOW + i + 1) * chunk)
            torch.bmm(Ab.index_select(0, a[sl]), Bb.index_select(0, b[sl]),
                      out=buf[i * chunk: (i + 1) * chunk])
        sums.add(w0 + w, buf, C)


def _bsp_numeric(Ab, Bb, a_idx, b_idx, c_idx, n_cblocks: int,
                 chunk: int = CHUNK) -> torch.Tensor:
    """C[c] += A[a] @ B[b] over the padded host pair lists, ``chunk`` pairs
    a step, summed in a fixed order. The extra dummy output block, which
    the padding names, stays zero."""
    dev = Ab.device
    C = torch.zeros((n_cblocks + 1, 8, 128), dtype=Ab.dtype, device=dev)
    span = WINDOW * chunk
    sums = _WindowSums(_pad_to_windows(np.asarray(c_idx), n_cblocks, span),
                       n_cblocks, span, dev)
    a, b = (torch.from_numpy(np.asarray(i, dtype=np.int64)).to(dev)
            for i in (a_idx, b_idx))
    buf = torch.empty((span, 8, 128), dtype=Ab.dtype, device=dev)
    _run_list(Ab, Bb, a, b, a.shape[0] // chunk, chunk, sums, 0, buf, C)
    return C


def _assemble_csr(C_blocks: np.ndarray, c_keys: np.ndarray, n_bc: int,
                  shape, tol: float = 0.0) -> sp.csr_matrix:
    """Nonzero entries of the block stack -> scipy CSR; with ``tol`` > 0
    the entries of magnitude above it."""
    nb = c_keys.size
    if nb == 0:
        return sp.csr_matrix(shape)
    blk = C_blocks[:nb]
    cb_r = (c_keys // n_bc) * 8
    cb_c = (c_keys % n_bc) * 128
    bi, ri, ci = np.nonzero(blk if tol <= 0 else (np.abs(blk) > tol))
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


def spgemm_blocks(A: sp.spmatrix, B: sp.spmatrix, dtype=torch.float64,
                  bk: int | None = None, tol: float = 0.0,
                  device=None) -> sp.csr_matrix:
    """Single-device block-sparse C = A @ B: host symbolic, the numeric
    phase on ``device`` (the card unless named; TF32 stays off) at
    ``dtype``; memory ∝ nonzero blocks."""
    global pairs_total
    if A.shape[1] != B.shape[0]:
        raise ValueError("inner dimensions must match")
    device = resolve_device(device)
    bk = bk or pick_bk(A, B)
    Ab, abr, abc = _block_left(A, bk)
    Bb, bbr, bbc = _block_right(B, bk)
    n_bc_C = -(-B.shape[1] // 128)
    a_idx, b_idx, c_idx, c_keys = _pairs(abr, abc, bbr, bbc, n_bc_C)
    if c_keys.size == 0:
        return sp.csr_matrix((A.shape[0], B.shape[1]))
    pairs_total += int(a_idx.size)
    a, b, c = _pad_pairs(a_idx, b_idx, c_idx, c_keys.size)
    up = lambda arr: torch.from_numpy(arr).to(device, dtype)
    C = _bsp_numeric(up(Ab), up(Bb), a, b, c, c_keys.size)
    return _assemble_csr(C.cpu().numpy(), c_keys, n_bc_C,
                         (A.shape[0], B.shape[1]), tol)


# ---------------------------------------------------------------------------
# distributed ring form
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _RingPlan:
    """Host-precomputed symbolic structure for one ring product, its
    tensors holding the mesh's local shards (all D without a mesh)."""

    Ab: torch.Tensor       # (k, nA_max, 8, bk)
    Bb: torch.Tensor       # (k, nB_max, bk, 128)
    AI: torch.Tensor       # (k, D, P_max) int64: pair a-ids per (shard, step)
    BI: torch.Tensor       # (k, D, P_max)
    CI: np.ndarray         # (D, D, P_max) int32, host: pair c-ids, which the
                           # device reads only through ``sums``
    NCK: np.ndarray        # (D, D) int32, host: live chunk count per
                           # (shard, step); ring steps whose owner gives no
                           # pairs cost no numeric work (band operators have
                           # most of their pairs at owners e ~ d)
    sums: _WindowSums      # the fixed-order sums of the local CI lists, each
                           # padded to whole windows
    c_keys: list           # per-shard sorted C block keys (host)
    n_cb: list             # per-shard C block count
    nC_max: int
    n_bc_C: int
    shape: tuple
    a_split: np.ndarray
    pairs: int             # live block pairs over every shard and step
    seconds: dict          # host "plan" and "upload" seconds


def _ring_plan(A: sp.spmatrix, B: sp.spmatrix, D: int, bk: int,
               a_split: np.ndarray, b_split: np.ndarray, dtype,
               mesh=None) -> _RingPlan:
    t0 = time.perf_counter()
    # owner-padded block-column space for A's columns (= B's row space)
    brows_per = np.array([-(-(b_split[e + 1] - b_split[e]) // bk)
                          for e in range(D)])
    cb_off = np.concatenate([[0], np.cumsum(brows_per)])
    n_bc_A = int(cb_off[-1])

    def col_block_of(cols):
        e = np.searchsorted(b_split, cols, side="right") - 1
        loc = cols - b_split[e]
        return cb_off[e] + loc // bk, loc % bk

    n_bc_C = -(-B.shape[1] // 128)

    # per-owner B block stacks (local block rows)
    B_csr = B.tocsr()
    Bblocks, Bbr, Bbc = [], [], []
    for e in range(D):
        Be = B_csr[b_split[e]: b_split[e + 1]]
        blk, br, bc = _block_right(Be, bk)
        Bblocks.append(blk)
        Bbr.append(br)
        Bbc.append(bc)
    nB_max = max(1, max(b.shape[0] for b in Bblocks))

    # per-shard A block stacks + per-step pair lists
    A_csr = A.tocsr()
    pairs = [[None] * D for _ in range(D)]
    Ablocks, c_keys_per_d, n_cb = [], [], []
    P_max = 1
    for d in range(D):
        Ad = A_csr[a_split[d]: a_split[d + 1]]
        blk, abr, abc = _block_left(Ad, bk, col_block_of=col_block_of,
                                    n_bc=n_bc_A)
        Ablocks.append(blk)
        all_ck = []
        for e in range(D):
            sel = (abc >= cb_off[e]) & (abc < cb_off[e + 1])
            ai, bi, _, _ = _pairs(abr[sel], abc[sel] - cb_off[e],
                                  Bbr[e], Bbc[e], n_bc_C)
            # remap ai back into the full per-shard A block ids
            a_glob = np.flatnonzero(sel)[ai]
            ckey = abr[a_glob] * n_bc_C + Bbc[e][bi]
            pairs[d][e] = (a_glob, bi, ckey)
            all_ck.append(ckey)
        ck_all = np.unique(np.concatenate(all_ck))
        c_keys_per_d.append(ck_all)
        n_cb.append(ck_all.size)
        for e in range(D):
            P_max = max(P_max, pairs[d][e][0].size)
    nC_max = max(1, max(n_cb))
    nA_max = max(1, max(b.shape[0] for b in Ablocks))
    P_max = -(-P_max // CHUNK) * CHUNK

    Ab = np.zeros((D, nA_max, 8, bk))
    Bb = np.zeros((D, nB_max, bk, 128))
    AI = np.zeros((D, D, P_max), np.int32)
    BI = np.zeros((D, D, P_max), np.int32)
    CI = np.full((D, D, P_max), nC_max, np.int32)
    NCK = np.zeros((D, D), np.int32)
    n_pairs = 0
    for d in range(D):
        Ab[d, : Ablocks[d].shape[0]] = Ablocks[d]
        Bb[d, : Bblocks[d].shape[0]] = Bblocks[d]
        for e in range(D):
            s = (e - d) % D          # ring step at which d holds B_e
            a_g, bi, ckey = pairs[d][e]
            if a_g.size == 0:
                continue
            n_pairs += a_g.size
            ci = np.searchsorted(c_keys_per_d[d], ckey)
            a, b, c = _pad_pairs(a_g, bi, ci, n_cb[d], min_len=P_max)
            # remap padding's dummy (n_cb[d]) to the shared dummy nC_max
            c[c == n_cb[d]] = nC_max
            AI[d, s], BI[d, s], CI[d, s] = a, b, c
            NCK[d, s] = -(-a_g.size // CHUNK)

    local = slice(None) if mesh is None else mesh.local
    device = torch.device("cpu") if mesh is None else mesh.device
    span = WINDOW * CHUNK
    sums = _WindowSums(_pad_to_windows(CI[local], nC_max, span).reshape(-1),
                       nC_max, span, device)
    t1 = time.perf_counter()
    vals = lambda arr: torch.from_numpy(arr[local]).to(device, dtype)
    idx = lambda arr: torch.from_numpy(arr[local].astype(np.int64)).to(device)
    tensors = dict(Ab=vals(Ab), Bb=vals(Bb), AI=idx(AI), BI=idx(BI))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return _RingPlan(
        **tensors, CI=CI, NCK=NCK, sums=sums,
        c_keys=c_keys_per_d, n_cb=n_cb, nC_max=nC_max, n_bc_C=n_bc_C,
        shape=(A.shape[0], B.shape[1]), a_split=a_split, pairs=n_pairs,
        seconds={"plan": t1 - t0, "upload": time.perf_counter() - t1})


def _ring_bsp_numeric(plan: _RingPlan, mesh) -> torch.Tensor:
    """Ring-rotate B block stacks; at each step every local shard runs its
    live chunks (``plan.NCK``, on the host) against the resident stack,
    then B moves one shard down the ring (``mesh.ppermute``, across ranks
    with a group). Returns this process's C block stacks (k, nC_max + 1, 8,
    128). Each shard's chunks run on their own, so shards may have
    different counts; the last step's rotation, which would bring B home,
    is left out."""
    D = mesh.size
    span = WINDOW * CHUNK
    n_win = -(-plan.AI.shape[-1] // span)          # windows a padded list
    C = torch.zeros((mesh.k, plan.nC_max + 1, 8, 128), dtype=plan.Ab.dtype,
                    device=plan.Ab.device)
    buf = torch.empty((span, 8, 128), dtype=plan.Ab.dtype, device=plan.Ab.device)
    perm = [(j, (j - 1) % D) for j in range(D)]
    Bcur = plan.Bb
    for s in range(D):
        for j, d in enumerate(mesh.shard_ids()):
            _run_list(plan.Ab[j], Bcur[j], plan.AI[j, s], plan.BI[j, s],
                      int(plan.NCK[d, s]), CHUNK, plan.sums, (j * D + s) * n_win,
                      buf, C[j])
        if s < D - 1:
            Bcur = mesh.ppermute(Bcur, perm)
    return C


def matmat_sparse(A: sp.spmatrix, B: sp.spmatrix, mesh, dtype=torch.float64,
                  bk: int | None = None, tol: float = 0.0, a_split=None,
                  b_split=None) -> sp.csr_matrix:
    """Distributed block-sparse C = A @ B over the mesh's ring, gathered to
    every rank. Peak device memory ∝ nonzero blocks of A, B, C per shard,
    never O(n^2/D)."""
    if A.shape[1] != B.shape[0]:
        raise ValueError("inner dimensions must match")
    D = mesh.size
    bk = bk or pick_bk(A, B)
    a_split = np.asarray(a_split) if a_split is not None \
        else equal_row_split(A.shape[0], D)
    b_split = np.asarray(b_split) if b_split is not None \
        else equal_row_split(B.shape[0], D)
    plan = _ring_plan(A, B, D, bk, a_split, b_split, dtype, mesh)
    C_np = mesh.all_gather(_ring_bsp_numeric(plan, mesh)).cpu().numpy()
    return _assemble_ring(C_np, plan, tol)


def _assemble_ring(C_np: np.ndarray, plan: _RingPlan, tol: float) -> sp.csr_matrix:
    """Every shard's block stack (D, nC_max + 1, 8, 128) -> scipy CSR."""
    out = []
    for d in range(C_np.shape[0]):
        rows_d = int(plan.a_split[d + 1] - plan.a_split[d])
        out.append(_assemble_csr(C_np[d], plan.c_keys[d], plan.n_bc_C,
                                 (rows_d, plan.shape[1]), tol))
    C = sp.vstack(out).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C
