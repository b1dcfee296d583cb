"""Distributed (shard-parallel) AMG hierarchy setup.

The reference distributes its ENTIRE setup over MPI ranks: the strength
graph exchanges per-row maxima like a matvec halo (create_strength_matrix,
saena_object_setup1.cpp:520-719), MIS(1) aggregation is an iterative
boolean-halo fixpoint with a global convergence Allreduce
(aggregation_1_dist, :724-995), prolongation smoothing exchanges aggregate
ids for remote columns (:58-241), R = P^T ships transposed COO entries to
their coarse owners (restrict_matrix.cpp:10-130), and the Galerkin triple
product runs as a ring SpGEMM (saena_object_setup_matmat.cpp:1710-2470).

Setup runs on the host here (irregular, data-dependent work), but a
host-serial setup wastes a many-core machine and caps the weak-scaled
problem size. This module re-runs the serial setup's per-level algorithms
as shard-parallel row-block computations with explicit neighbour
exchanges:

- every matrix lives as contiguous row blocks over a ``split`` (the
  reference's ``split[nprocs+1]``, saena_matrix.h:95);
- each phase is a per-shard task consuming (local rows + fetched remote
  rows/values) and producing local rows only — message-passing discipline;
- remote data moves through fetch helpers that meter the wire volume an
  MPI transport would carry (the in-process transport is shared memory;
  the per-shard tasks themselves are transport-agnostic);
- shard tasks run on a thread pool: the native kernels (ctypes) and
  scipy/numpy kernels release the GIL, so shard work genuinely overlaps
  on a multi-core host.

Every per-shard computation reproduces the serial setup's row-local
arithmetic exactly — same expressions, same per-row accumulation order —
so :func:`dist_setup` returns a hierarchy that is bitwise identical to
:func:`saena_tpu_torch.amg.hierarchy.setup` (tests/test_torch_dist_setup.py;
the convergence goldens therefore hold unchanged). Levels below
``n_shards * tail_rows`` take the serial ``coarsen_csr``, the analog of
the reference gathering shrunken coarse levels onto few ranks (shrink_cpu,
saena_matrix_shrink.cpp:167). The phases go into the setup's PhaseTimer,
passed down explicitly. No collective runs here: this is host thread-pool
code.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import scipy.sparse as sp

from saena_tpu_torch import _native
from saena_tpu_torch.config import Options
from saena_tpu_torch.amg.hierarchy import (
    Hierarchy,
    SetupInfo,
    coarsen_csr,
    coarsen_tail,
    setup as serial_setup,
)
from saena_tpu_torch.amg.galerkin import _spgemm
from saena_tpu_torch.amg.prolongation import ALMOST_ZERO, tentative_prolongator
from saena_tpu_torch.amg.strength import _row_min_indices
from saena_tpu_torch.parallel.partition import nnz_balanced_split
from saena_tpu_torch.runtime import PhaseTimer


@dataclasses.dataclass
class CommMeter:
    """Wire-volume accounting for the exchanges a distributed-memory
    transport would carry (the reference prints the same classes of traffic
    under its verbose_* flags). Entry costs: matrix rows 12 B/nnz + 8 B/row
    (value + int32 col, int64 row id), COO triples 20 B (cooEntry,
    data_struct.h:116), scalars/ids by dtype size, MIS halo flags 2 B
    (decided + root booleans, aggregation_1_dist's bool exchange)."""

    bytes_by_phase: dict = dataclasses.field(default_factory=dict)
    raw_by_phase: dict = dataclasses.field(default_factory=dict)
    mis_rounds: int = 0
    dist_levels: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def add(self, phase: str, nbytes: int, raw: Optional[int] = None):
        """``nbytes`` = what actually crosses the wire; ``raw`` = the
        uncompressed payload size (defaults to nbytes) so ``table`` can show
        the codec's ratio like the reference's verbose_matmat prints."""
        with self._lock:
            self.bytes_by_phase[phase] = self.bytes_by_phase.get(phase, 0) + int(nbytes)
            self.raw_by_phase[phase] = self.raw_by_phase.get(phase, 0) + int(
                nbytes if raw is None else raw)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_phase.values())

    def table(self) -> str:
        lines = []
        for k, v in sorted(self.bytes_by_phase.items()):
            raw = self.raw_by_phase.get(k, v)
            tail = f"  ({v / raw:5.2f}x of raw)" if raw > v else ""
            lines.append(f"{k:<12} {v / 1e6:10.3f} MB{tail}")
        lines.append(f"{'total':<12} {self.total_bytes / 1e6:10.3f} MB "
                     f"(MIS rounds: {self.mis_rounds}, "
                     f"dist levels: {self.dist_levels})")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# transport helpers (shared-memory implementation of the MPI-shaped fetches)
# ---------------------------------------------------------------------------


def _gr_pack(part: sp.csr_matrix):
    """Encode a CSR window the way the reference's compressed SpGEMM ring
    ships a CSCMat window (CSCMat::compress_prep + GR_encoder, data_struct.h
    :512, setup_matmat.cpp:1986-2103): GR-coded per-row nnz counts, GR-coded
    per-row delta column ids (per-stream k, like compress_prep's per-rank k),
    values raw — GR_encoder compresses the index streams only."""
    cnts = np.diff(part.indptr).astype(np.uint32)
    cnt_payload, k_cnt = _native.gr_compress(cnts)
    seg = part.indptr[:-1].astype(np.int64)
    col_payload, k_col = _native.gr_compress(
        _native.delta_encode(part.indices.astype(np.uint32), seg))
    vals = part.data.tobytes()
    wire = len(cnt_payload) + len(col_payload) + len(vals) + 2  # + two k bytes
    return (part.shape, int(part.nnz), cnt_payload, k_cnt, col_payload, k_col,
            vals, part.data.dtype, bool(part.has_sorted_indices), wire)


def _gr_unpack(packed) -> sp.csr_matrix:
    shape, nnz, cnt_payload, k_cnt, col_payload, k_col, vals, vdt, srt, _ = packed
    cnts = _native.gr_decompress(cnt_payload, shape[0], k_cnt)
    indptr = np.concatenate([[0], np.cumsum(cnts, dtype=np.int64)])
    cols = _native.delta_decode(
        _native.gr_decompress(col_payload, nnz, k_col), indptr[:-1])
    out = sp.csr_matrix(
        (np.frombuffer(vals, dtype=vdt), cols.astype(np.int64), indptr),
        shape=shape)
    out.has_sorted_indices = srt
    return out


def _fetch_rows(slices, split, ids, requester: int, meter: CommMeter,
                phase: str, codec: str = "none") -> sp.csr_matrix:
    """Gather rows ``ids`` (sorted global) from their owner shards, stacked
    in id order with GLOBAL columns. Remote rows are metered at 12 B/nnz +
    8 B/row — what the reference's Isend of a CSR window costs — unless
    ``codec="gr"``, in which case each remote window genuinely round-trips
    through the Golomb-Rice index-stream codec (encoded at the owner,
    decoded at the requester; values pass through bit-exact) and the meter
    records the compressed wire size."""
    bounds = np.searchsorted(ids, split)
    parts = []
    for p in range(len(slices)):
        lo, hi = bounds[p], bounds[p + 1]
        if lo == hi:
            continue
        part = slices[p][ids[lo:hi] - split[p]]
        if p != requester:
            raw = part.nnz * 12 + (hi - lo) * 8
            if codec == "gr":
                packed = _gr_pack(part)
                part = _gr_unpack(packed)
                meter.add(phase, packed[-1], raw=raw)
            else:
                meter.add(phase, raw)
        parts.append(part)
    if not parts:
        n_cols = slices[0].shape[1]
        return sp.csr_matrix((0, n_cols))
    if len(parts) == 1:
        return parts[0]
    return _vstack(parts)


def _vstack(parts) -> sp.csr_matrix:
    """Exact row-block concatenation: raw array concat, no scipy
    re-normalization (keeps the assembled matrix bitwise equal to the
    serial one when every row matches)."""
    parts = [p.tocsr() for p in parts]
    n_cols = parts[0].shape[1]
    data = np.concatenate([p.data for p in parts])
    indices = np.concatenate([p.indices.astype(np.int64) for p in parts])
    nnzs = np.concatenate([np.diff(p.indptr) for p in parts])
    indptr = np.concatenate([[0], np.cumsum(nnzs)])
    out = sp.csr_matrix((data, indices, indptr),
                        shape=(int(indptr.size - 1), n_cols))
    out.has_sorted_indices = all(p.has_sorted_indices for p in parts)
    return out


def _slices(A: sp.csr_matrix, split: np.ndarray):
    return [A[split[p]:split[p + 1]] for p in range(len(split) - 1)]


# ---------------------------------------------------------------------------
# distributed strength graph (create_strength_matrix's maxPerRow halo)
# ---------------------------------------------------------------------------


def _strength_safe_shard(Ash: sp.csr_matrix, r0: int) -> np.ndarray:
    """Per-row scaling denominator (max of -offdiag), local rows only —
    the same expression as amg/strength.py:strength_graph."""
    n_loc = Ash.shape[0]
    indptr, indices, data = Ash.indptr, Ash.indices, Ash.data
    rows_g = np.repeat(np.arange(r0, r0 + n_loc, dtype=np.int64),
                       np.diff(indptr))
    negv = -data
    maxrow = np.full(n_loc, -np.inf)
    if negv.size:
        starts = indptr[:-1].astype(np.int64)
        seg = np.maximum.reduceat(
            np.where(indices == rows_g, -np.inf, negv),
            np.minimum(starts, negv.size - 1))
        valid = np.diff(indptr) > 0
        maxrow[valid] = seg[valid]
    return np.where(np.isfinite(maxrow) & (maxrow != 0), maxrow, 1.0)


def _strength_keep_shard(Ash: sp.csr_matrix, r0: int, theta: float,
                         safe_all: np.ndarray, split, p, meter) -> sp.csr_matrix:
    """Keep mask + local S rows given the assembled safe[] (remote entries
    metered as the maxPerRow halo). Bit-identical to strength_graph's
    test: ~diag & (negv/safe[i] > theta | negv/safe[j] > theta)."""
    n_loc, n = Ash.shape
    indptr, indices, data = Ash.indptr, Ash.indices, Ash.data
    rows_g = np.repeat(np.arange(r0, r0 + n_loc, dtype=np.int64),
                       np.diff(indptr))
    negv = -data
    isdiag = indices == rows_g
    halo = np.unique(indices[(indices < split[p]) | (indices >= split[p + 1])])
    meter.add("strength", halo.size * 8)
    s_row = negv / safe_all[rows_g]
    s_col = negv / safe_all[indices]
    keep = ~isdiag & ((s_row > theta) | (s_col > theta))
    cnt = np.zeros(n_loc, dtype=np.int64)
    if keep.size:
        csum = np.concatenate([[0], np.cumsum(keep)])
        cnt = csum[indptr[1:]] - csum[indptr[:-1]]
    indptr_s = np.concatenate([[0], np.cumsum(cnt)])
    indices_s = indices[keep]
    return sp.csr_matrix(
        (np.ones(indices_s.size, dtype=np.int8), indices_s, indptr_s),
        shape=(n_loc, n))


def _dist_strength(A_slices, split, theta: float, pool, meter) -> list:
    safes = list(pool.map(
        lambda p: _strength_safe_shard(A_slices[p], split[p]),
        range(len(A_slices))))
    safe_all = np.concatenate(safes) if safes else np.empty(0)
    return list(pool.map(
        lambda p: _strength_keep_shard(A_slices[p], split[p], theta,
                                       safe_all, split, p, meter),
        range(len(A_slices))))


# ---------------------------------------------------------------------------
# distributed MIS(1) aggregation (aggregation_1_dist's bool-halo fixpoint)
# ---------------------------------------------------------------------------


def _mis_round_shard(Ssh, r0, decided, is_root, elig, meter):
    """One fixpoint round on local rows, reading neighbor state (the
    reference's boolean halo). Returns (new_root_loc, join_loc, jm)."""
    n = decided.size
    n_loc = Ssh.shape[0]
    indptr, indices = Ssh.indptr, Ssh.indices
    rows_g = np.arange(r0, r0 + n_loc, dtype=np.int64)
    und_loc = ~decided[r0:r0 + n_loc]
    BIG = n + 1
    cand = np.where(elig[indices], indices.astype(np.int64), BIG)
    starts = indptr[:-1].astype(np.int64)
    counts = np.diff(indptr)
    jm = _row_min_indices(cand, starts, counts, n_loc, BIG)
    has_cand = jm < rows_g
    new_root = und_loc & ~has_cand
    join = und_loc & has_cand & decided[jm.clip(0, n - 1)]
    # wire volume: decided+root flags for this shard's remote neighbors
    remote = (indices < r0) | (indices >= r0 + n_loc)
    meter.add("mis", int(np.unique(indices[remote]).size) * 2)
    return new_root, join, jm


def _dist_mis(S_slices, split, pool, meter):
    """Min-index MIS(1) fixpoint over row shards. Two engines, identical
    results (the fixpoint is schedule-independent — a node's outcome depends
    only on which smaller neighbors are MIS members):

    - native sweep rounds (mis1.cpp:mis1_sweep): each round is a full
      ascending-index local pass between boundary-state exchanges — the
      reference's aggregation_1_dist structure — converging in one round
      per cross-shard hop of the longest dependency chain;
    - numpy synchronous rounds (`_mis_round_shard`), exactly one serial
      `_aggregate_mis1_fixpoint` round each, as the no-toolchain fallback.
    """
    n = int(split[-1])
    P = len(S_slices)
    if _native.have_native() and n < 2**31:
        decided = np.zeros(n, dtype=np.uint8)
        is_root = np.zeros(n, dtype=np.uint8)
        agg = np.arange(n, dtype=np.int64)
        prep = []
        for p in range(P):
            Ssh = S_slices[p]
            indptr = np.ascontiguousarray(Ssh.indptr, dtype=np.int64)
            indices = np.ascontiguousarray(Ssh.indices, dtype=np.int32)
            r0, r1 = int(split[p]), int(split[p + 1])
            n_halo = int(np.unique(indices[(indices < r0) |
                                           (indices >= r1)]).size)
            prep.append((indptr, indices, n_halo))
        while True:
            dec_snap = decided.copy()
            root_snap = is_root.copy()
            unds = list(pool.map(
                lambda p: _native.mis1_sweep(
                    int(split[p]), prep[p][0], prep[p][1],
                    dec_snap, root_snap, decided, is_root, agg),
                range(P)))
            meter.mis_rounds += 1
            meter.add("mis", sum(pr[2] for pr in prep) * 2)
            if sum(unds) == 0:
                break
        roots = np.flatnonzero(is_root)
        coarse_id = np.searchsorted(roots, agg)
        return coarse_id.astype(np.int64), roots
    decided = np.zeros(n, dtype=bool)
    is_root = np.zeros(n, dtype=bool)
    agg = np.arange(n, dtype=np.int64)
    P = len(S_slices)
    while True:
        und = ~decided
        if not und.any():        # the convergence Allreduce
            break
        elig = und | is_root
        outs = list(pool.map(
            lambda p: _mis_round_shard(S_slices[p], split[p], decided,
                                       is_root, elig, meter),
            range(P)))
        meter.mis_rounds += 1
        any_update = False
        for p, (new_root, join, jm) in enumerate(outs):
            r0 = split[p]
            sl = slice(r0, r0 + new_root.size)
            if not (new_root.any() or join.any()):
                continue
            any_update = True
            is_root[sl] |= new_root
            decided[sl] |= new_root | join
            agg_sl = agg[sl]
            agg_sl[join] = jm[join]
            agg[sl] = agg_sl
        if not any_update:
            # unreachable (the chain-minimum argument in the serial code);
            # keep the same guard: decide everything root
            for p in range(P):
                r0, r1 = split[p], split[p + 1]
                is_root[r0:r1] |= ~decided[r0:r1]
                decided[r0:r1] = True
    roots = np.flatnonzero(is_root)
    # aggregate_index_update (setup1.cpp:2103): roots renumbered by a scan
    # of per-shard root counts, so coarse row c is OWNED by the shard that
    # owns fine row roots[c] — the reference's splitNew
    coarse_id = np.searchsorted(roots, agg)
    return coarse_id.astype(np.int64), roots


def _dist_find_aggregation(A_slices, split, theta, adaptive, pool, meter):
    """find_aggregation (saena_object_setup1.cpp:257-441) with distributed
    strength + MIS; the adaptive-theta loop reproduces _find_aggregation_s
    round for round (division thresholds are global scalars)."""
    n = int(split[-1])
    S_sl = _dist_strength(A_slices, split, theta, pool, meter)
    agg, roots = _dist_mis(S_sl, split, pool, meter)
    n_c = roots.size
    if adaptive:
        division = n / max(1, n_c)
        th = theta
        while (division < 1.5 or division > 8.0) and 0.2 <= th <= 0.95:
            th = th + 0.05 if division > 8.0 else th - 0.05
            if not (0.2 <= th <= 0.95):
                break
            S_sl = _dist_strength(A_slices, split, th, pool, meter)
            agg, roots = _dist_mis(S_sl, split, pool, meter)
            n_c = roots.size
            division = n / max(1, n_c)
        theta = th
    return agg, n_c, theta, S_sl, roots


def _dist_aggregation_double(A_slices, split, theta, adaptive, pool, meter):
    """find_aggregation_double distributed: pass-1 MIS, contract the
    strength graph to aggregate adjacency (each fine shard emits coarse
    (ci, cj) pairs for its S entries and ships them to ci's owner — the
    entry-shipping pattern of restrict_matrix::transposeP), pass-2 MIS on
    the contracted shards."""
    agg1, nc1, theta_used, S_sl, roots1 = _dist_find_aggregation(
        A_slices, split, theta, adaptive, pool, meter)
    P = len(A_slices)

    def pairs_shard(p):
        Ssh = S_sl[p]
        r0 = split[p]
        rows_g = np.repeat(
            np.arange(r0, r0 + Ssh.shape[0], dtype=np.int64),
            np.diff(Ssh.indptr))
        halo = np.unique(Ssh.indices[(Ssh.indices < split[p]) |
                                     (Ssh.indices >= split[p + 1])])
        meter.add("contract", halo.size * 8)   # agg1 halo (int64 ids)
        ci = agg1[rows_g]
        cj = agg1[Ssh.indices]
        m = ci != cj                            # setdiag(0) analog
        key = ci[m] * nc1 + cj[m]
        return np.unique(key)

    keys = list(pool.map(pairs_shard, range(P)))
    # coarse-1 ownership follows the pass-1 roots (the reference's splitNew,
    # aggregate_index_update setup1.cpp:2103): contracted shard p holds the
    # aggregates whose root fine row lives on fine shard p
    split2 = np.searchsorted(roots1, split)

    def sc_shard(q):
        lo, hi = split2[q], split2[q + 1]
        mine = []
        for p, k in enumerate(keys):
            b0, b1 = np.searchsorted(k, [lo * nc1, hi * nc1])
            sel = k[b0:b1]
            mine.append(sel)
            if p != q:
                meter.add("contract", sel.size * 20)  # cooEntry triples
        kk = np.unique(np.concatenate(mine)) if mine else np.empty(0, np.int64)
        ci = (kk // nc1 - lo).astype(np.int64)
        cj = (kk % nc1).astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(ci, minlength=hi - lo))])
        return sp.csr_matrix(
            (np.ones(cj.size, dtype=np.int8), cj, indptr),
            shape=(int(hi - lo), nc1))

    Sc_sl = list(pool.map(sc_shard, range(P)))
    agg2, roots2 = _dist_mis(Sc_sl, split2, pool, meter)
    # home of final coarse row c = fine root of its pass-1 representative
    return agg2[agg1], roots2.size, theta_used, roots1[roots2]


# ---------------------------------------------------------------------------
# distributed prolongation / restriction / Galerkin
# ---------------------------------------------------------------------------


def _dist_smoothing_diag(A_slices, split, omega, psmoother, pool):
    """Per-shard smoothing_diag; SPAI's global row-sum max is the one
    Allreduce (ref SA() :110-136)."""
    if psmoother == "jacobi":
        return list(pool.map(
            lambda p: _jacobi_wq(A_slices[p], split[p], omega),
            range(len(A_slices))))
    # SPAI: q row-local, omega = 4 / (3 * max_global(sum_j |a_ij|))
    def row_stats(p):
        Ash = A_slices[p]
        diag = _local_diag(Ash, split[p])
        sq = np.asarray(Ash.multiply(Ash).sum(axis=1)).ravel()
        absmax = float(np.abs(Ash).sum(axis=1).max()) if Ash.shape[0] else 0.0
        q = np.where(sq != 0, diag / np.where(sq == 0, 1.0, sq), 0.0)
        return q, absmax
    outs = list(pool.map(row_stats, range(len(A_slices))))
    w = 4.0 / (3.0 * max(a for _, a in outs))
    return [w * q for q, _ in outs]


def _local_diag(Ash: sp.csr_matrix, r0: int) -> np.ndarray:
    n_loc = Ash.shape[0]
    rows_g = np.repeat(np.arange(r0, r0 + n_loc, dtype=np.int64),
                       np.diff(Ash.indptr))
    d = np.zeros(n_loc)
    m = Ash.indices == rows_g
    d[rows_g[m] - r0] = Ash.data[m]
    return d


def _jacobi_wq(Ash, r0, omega):
    diag = _local_diag(Ash, r0)
    q = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 0.0)
    return omega * q


def _dist_prolongator(A_slices, split, agg, n_c, omega, psmoother,
                      pool, meter):
    """P = (I - w Q A) P_t per row shard — identical scipy row arithmetic to
    smoothed_prolongator; the aggregate-id halo (remote columns of A) is the
    exchange the reference does at setup1.cpp:58-241."""
    wqs = _dist_smoothing_diag(A_slices, split, omega, psmoother, pool)
    Pt = tentative_prolongator(agg, n_c)

    def task(p):
        Ash = A_slices[p]
        r0 = split[p]
        halo = np.unique(Ash.indices[(Ash.indices < split[p]) |
                                     (Ash.indices >= split[p + 1])])
        meter.add("prolong", halo.size * 8)     # agg halo (int64)
        QA = sp.diags(wqs[p], shape=(Ash.shape[0], Ash.shape[0])) @ Ash
        Pt_loc = Pt[r0:r0 + Ash.shape[0]]
        Psh = (Pt_loc - 1.0 * (QA @ Pt)).tocsr()
        Psh.data[np.abs(Psh.data) < ALMOST_ZERO] = 0.0
        Psh.eliminate_zeros()
        Psh.sort_indices()
        return Psh

    return list(pool.map(task, range(len(A_slices))))


def _dist_transpose(P_slices, split, split_c, meter):
    """R = P^T by shipping (coarse_row, fine_col, val) triples to the
    coarse owner (restrict_matrix.cpp:46-130), then a local CSR build."""
    P = len(P_slices)
    coos = [Psh.tocoo() for Psh in P_slices]
    n = int(split[-1])

    def r_shard(q):
        lo, hi = split_c[q], split_c[q + 1]
        rows, cols, vals = [], [], []
        for p, c in enumerate(coos):
            m = (c.col >= lo) & (c.col < hi)
            rows.append(c.col[m] - lo)
            cols.append(c.row[m].astype(np.int64) + split[p])
            vals.append(c.data[m])
            if p != q:
                meter.add("transpose", int(m.sum()) * 20)  # cooEntry
        R = sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(int(hi - lo), n))
        R.sort_indices()
        return R

    return [r_shard(q) for q in range(P)]


def _relabel(X: sp.csr_matrix, need: np.ndarray) -> sp.csr_matrix:
    """Compact X's (global) columns onto the fetched-row index space —
    order-preserving, so per-row Gustavson accumulation order (and thus
    every output bit) matches the serial full-operand product."""
    return sp.csr_matrix(
        (X.data, np.searchsorted(need, X.indices).astype(np.int32),
         X.indptr), shape=(X.shape[0], int(need.size)))


def _dist_galerkin(R_slices, A_slices, P_slices, split, pool, meter,
                   codec: str = "none", device=None, timer=None, level: int = -1):
    """Ac = R @ (A @ P) — the same product order as galerkin_product — with
    each factor row-sharded and remote operand rows fetched on demand (the
    reference's ring rotation delivers the same rows, matmat_CSC). With
    ``codec="gr"`` every remote window crosses the wire Golomb-Rice
    compressed, the reference's compressed-matmat mode. Each shard's
    product takes galerkin's route for a setup on ``device`` and is
    recorded in ``timer`` at ``level``."""
    n_c = P_slices[0].shape[1]

    def w_task(p):
        Ash = A_slices[p]
        if Ash.nnz == 0:
            return sp.csr_matrix((Ash.shape[0], n_c))
        need = np.unique(Ash.indices)
        Pn = _fetch_rows(P_slices, split, need, p, meter, "spgemm", codec)
        # nt=1: the shard tasks themselves run in parallel on the pool
        return _spgemm(_relabel(Ash, need), Pn, nt=1, device=device, timer=timer,
                       level=level)

    W_slices = list(pool.map(w_task, range(len(A_slices))))

    def ac_task(q):
        Rsh = R_slices[q]
        if Rsh.nnz == 0:
            return sp.csr_matrix((Rsh.shape[0], n_c))
        need = np.unique(Rsh.indices)
        Wn = _fetch_rows(W_slices, split, need, q, meter, "spgemm", codec)
        Ac = _spgemm(_relabel(Rsh, need), Wn, nt=1, device=device, timer=timer,
                     level=level)
        Ac.sum_duplicates()
        Ac.sort_indices()
        return Ac

    return list(pool.map(ac_task, range(len(R_slices))))


# ---------------------------------------------------------------------------
# per-level driver + public entry
# ---------------------------------------------------------------------------


def coarsen_dist(A: sp.csr_matrix, lvl: int, opts: Options, n_shards: int,
                 pool, meter: CommMeter, tm: PhaseTimer, codec: str = "none",
                 device=None):
    """Shard-parallel coarsen_csr: same contract, bitwise-identical output.
    The row split is nnz-balanced per level (repartition_nnz,
    saena_matrix_repart.cpp) — shard boundaries never affect results."""
    n = A.shape[0]
    split = nnz_balanced_split(A, n_shards, opts.repart_thre,
                               opts.switch_repart)
    A_slices = _slices(A, split)
    with tm.phase("aggregation"):
        if opts.aggregation == "double":
            agg, n_c, theta, home = _dist_aggregation_double(
                A_slices, split, opts.connStrength, opts.adaptive_coarsening,
                pool, meter)
        else:
            agg, n_c, theta, _, home = _dist_find_aggregation(
                A_slices, split, opts.connStrength, opts.adaptive_coarsening,
                pool, meter)
    if n_c == 0 or n_c >= n:
        return None
    last = False
    if opts.dynamic_levels:
        if n_c <= opts.least_row_threshold:
            last = True
        elif n_c / n > opts.row_reduction_up_thrshld:
            last = True
    with tm.phase("prolongation"):
        P_slices = _dist_prolongator(A_slices, split, agg, n_c,
                                     opts.Pomega, opts.PSmoother, pool, meter)
        # splitNew: coarse row c lives with its root's fine shard (ref
        # aggregate_index_update + P.splitNew) — keeps R/Ac shards aligned
        # with the fine shards that feed them, so SpGEMM fetches stay
        # halo-sized
        split_c = np.searchsorted(home, split)
        R_slices = _dist_transpose(P_slices, split, split_c, meter)
    with tm.phase("rap"):
        Ac_slices = _dist_galerkin(R_slices, A_slices, P_slices, split,
                                   pool, meter, codec, device, tm, lvl)
        P_h = _vstack(P_slices)
        R_h = _vstack(R_slices)
        Ac = _vstack(Ac_slices)
    meter.dist_levels += 1
    with tm.phase("coarsen_tail"):
        P_h, R_h, Ac, agg, struct = coarsen_tail(A, P_h, R_h, Ac, agg, lvl,
                                                 opts)
    return P_h, R_h, Ac, last, theta, struct


def default_shards() -> int:
    """One shard for every 4 cores, at least 2 and at most 8. The native
    kernels the shards call (SpGEMM, the eig SpMV) are already OpenMP
    threaded, so the shard threads keep to a quarter of the cores: on the
    8-core host of an H100 machine the 48^3 setup took 8.3-9.0 s at 2
    shards, 7.9-9.6 at 4 and 8.8-10.1 at 8, against 6.5-7.2 s serial
    (tools/setup_timing.py, PERF.md)."""
    return max(2, min(8, (os.cpu_count() or 2) // 4))


def dist_setup(
    A: sp.csr_matrix,
    opts: Optional[Options] = None,
    dtype=None,
    device=None,
    n_shards: int = 0,
    max_workers: Optional[int] = None,
    tail_rows: int = 512,
    use_dense: bool = False,
    p_levels: Optional[list] = None,
    wire_codec: str = "gr",
    dense_serial_thre: float = 0.01,
) -> tuple[Hierarchy, SetupInfo]:
    """Shard-parallel hierarchy setup: a drop-in for hierarchy.setup with a
    bitwise-identical result, its device levels on ``device`` (the card
    unless named) at ``dtype``. ``info.comm`` carries the CommMeter. Levels
    smaller than n_shards * tail_rows run the serial coarsen (the shrink
    analog: the reference gathers small coarse levels the same way), with
    ``Options.rap``'s Galerkin engine; the sharded levels take the
    distributed host product. ``p_levels`` pass through to the serial
    setup, which applies them before the h-coarsening.

    ``wire_codec``: "gr" (default) Golomb-Rice-compresses every remote
    SpGEMM window as the reference's compressed matmat ring does
    (GR_encoder on the index streams, setup_matmat.cpp:1986-2103); "none"
    ships raw CSR windows. Lossless either way: the hierarchy is identical.

    ``dense_serial_thre``: coarse levels denser than this fraction run the
    serial coarsen even above the row threshold, the setup-side analog of
    the reference's processor shrinking (shrink_cpu gathers small or dense
    coarse levels onto few ranks, saena_matrix_shrink.cpp:167). On a dense
    operator the Galerkin intermediate W = A@P has near-dense rows, so the
    distributed product would ship windows about the size of the whole
    product while the gain of sharding is bounded; the fine sparse levels,
    whose wire is halo-sized, stay distributed.
    """
    opts = opts or Options()
    if n_shards <= 0:
        n_shards = default_shards()
    meter = CommMeter()
    with ThreadPoolExecutor(max_workers=max_workers or n_shards) as pool:
        def fn(Acur, lvl, o, timer, dev):
            n = Acur.shape[0]
            if n < n_shards * tail_rows or \
                    Acur.nnz >= dense_serial_thre * n * n:
                return coarsen_csr(Acur, lvl, o, timer, dev)
            return coarsen_dist(Acur, lvl, o, n_shards, pool, meter, timer,
                                wire_codec, dev)
        hier, info = serial_setup(A, opts, dtype=dtype, device=device,
                                  use_dense=use_dense, p_levels=p_levels,
                                  coarsen_fn=fn)
    info.comm = meter
    info.n_shards = n_shards   # per-shard stats in info.table()
    return hier, info
