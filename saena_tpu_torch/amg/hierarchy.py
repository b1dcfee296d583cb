"""AMG hierarchy: host-side setup producing device-resident levels.

All irregular, data-dependent work (strength, aggregation, Galerkin
products, format selection) runs once on the host with numpy/scipy; the
output is a tuple of ``Level`` objects holding tensors on one device (DIA,
ELL and dense operators, inverse diagonals, the cached coarse solve) that
the V-cycle and pCG consume (ref saena_object::setup, saena_object.cpp:
175-406).

``setup(p_levels=)`` applies p-coarsening injections first (amg/pcoarsen.py,
the Galerkin product on the host), then h-coarsening takes over. The
coarsening loop takes a ``coarsen_fn`` hook: the shard-parallel setup
(parallel/dist_setup.py), which ``AMG.set_matrix`` takes by default, plugs
in there with a bitwise-identical result. ``Options(rap="device")`` computes
each serial coarsening's Galerkin product with the block-sparse engine of
ops/bspgemm.py on the hierarchy's device (f64), "host" with the native
SpGEMM, whose large products take the card's row-wise SpGEMM (K5) on a CUDA
device, bit for bit the same (amg/galerkin.py; ``SetupInfo.products``
records each product and where it ran). Each level's Lanczos eig estimate
runs on a worker thread behind the coarsening of deeper levels, and
``devicify`` builds the levels on the same executor, assembled in level
order. ``devicify(reuse=...)`` is the lazy-update path: it reuses unchanged
levels, and the eig estimate, format plans and P/R of levels whose pattern
is unchanged.

Formats follow the JAX package's two branches. On the CPU: DIA, ELL or
dense A, direct P/R in ELL. On the card: wide-stencil DIA and the gather
picker (strip, strip8, BSR) for A, and structural transfers
(ops/transfers.py: P = (I - wq A) P_t, R = P_t^T (I - A wq) through the
level's own A) wherever their estimate beats the direct P/R, which
otherwise take the gather picker too. ``Options(structural_transfers=
"force")`` builds the structural transfers on any device whenever the
level's A is symmetric; ``structural_transfers=False`` never does.

``Options.smooth_dtype`` gives every level but the coarsest a twin of A at
that dtype (``Level.A_smooth``, built from the same host arrays, sharing A's
index arrays and layout), which the smoothers and the V-cycle's residual
use; the outer Krylov method uses A.
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch import _native
from saena_tpu_torch.config import Options
from saena_tpu_torch.runtime import PhaseTimer, resolve_device, resolve_dtype
from saena_tpu_torch.ops.formats import (
    DeviceMatrix,
    accelerator_branch,
    bsr_block_width,
    bsr_bytes_estimate,
    dense_from_csr,
    device_matrix_from_csr,
    ell_from_csr,
    gather_time_estimate,
    gather_time_estimate_quick,
    pad_to,
    pick_gather_format,
    rcm_permutation,
    set_bsr_geometry,
    to_device,
)
from saena_tpu_torch.ops.transfers import (
    build_structural,
    is_symmetric,
    mark_symmetric,
    structural_estimate,
)
from saena_tpu_torch.amg.strength import find_aggregation, find_aggregation_double
from saena_tpu_torch.amg.prolongation import (
    restriction,
    smoothed_prolongator,
    smoothing_diag,
)
from saena_tpu_torch.amg.galerkin import (
    galerkin_product,
    filter_lump,
    filter_threshold,
    sparsify_majid,
)
from saena_tpu_torch.amg.eig import eig_max_invdiag_host


@dataclasses.dataclass(frozen=True)
class Level:
    """One grid level. P/R transfer to the next (coarser) level and are None
    on the coarsest. (ref Grid, grid.h:11-78)"""

    A: DeviceMatrix
    inv_diag: torch.Tensor                   # (n_pad,)
    P: Optional[DeviceMatrix]                # (n, n_coarse)
    R: Optional[DeviceMatrix]                # (n_coarse, n)
    # A at Options.smooth_dtype for the smoothers and the V-cycle's
    # residual (preconditioner-internal); the outer Krylov method uses A
    A_smooth: Optional[DeviceMatrix] = None
    n: int = 0                               # logical size
    lvl: int = 0
    eig_max: Optional[float] = None          # lambda_max(D^{-1}A)*1.0001

    @property
    def n_pad(self) -> int:
        return self.inv_diag.shape[0]

    @property
    def dtype(self):
        # the level's VECTOR dtype; the operator may be stored reduced
        # (Options.float_storage)
        return self.inv_diag.dtype


@dataclasses.dataclass(frozen=True)
class CoarseLU:
    """Cached dense direct solver for the coarsest operator (replaces
    SuperLU_DIST's cached factorization, solve.cpp:117-420, 793-958).

    - ``inv`` (n_pad <= 2048): the inverse is computed once on the host in
      f64 and applied as a matrix product plus one refinement step. Padding
      rows and columns of ``inv`` and ``adense`` are zero, so the solve
      preserves zero padding.
    - ``lu`` (larger n): LU factors on the device and ``lu_solve``, the
      padded tail carrying a unit diagonal to keep the factors nonsingular.
    """

    lu: Optional[torch.Tensor]
    piv: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]
    adense: Optional[torch.Tensor]
    n: int

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        if self.inv is not None:
            b = rhs.to(self.inv.dtype)
            x = self.inv @ b
            # one refinement step removes the kappa*eps error of the
            # explicit-inverse apply
            return x + self.inv @ (b - self.adense @ x)
        return torch.linalg.lu_solve(self.lu, self.piv,
                                     rhs.to(self.lu.dtype)[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    levels: tuple                            # tuple[Level, ...]
    coarse_lu: Optional[CoarseLU]
    inv_sq_diag: Optional[torch.Tensor]      # D^{-1/2} of the finest level when scaled
    # the solvers' loops (amg/graphs.Loop), with their static buffers and,
    # on the card, their captured graphs, by (solver, SolveParams, dtype,
    # max_iter); not an init field, so a hierarchy made from another one
    # (dataclasses.replace, devicify after an update) starts empty
    graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def n(self) -> int:
        return self.levels[0].n

    @property
    def n_pad(self) -> int:
        return self.levels[0].n_pad

    @property
    def dtype(self):
        return self.levels[0].dtype

    @property
    def device(self) -> torch.device:
        return self.levels[0].inv_diag.device

    def tensors(self):
        """Every tensor the hierarchy holds."""
        def walk(obj):
            if isinstance(obj, torch.Tensor):
                yield obj
            elif isinstance(obj, (tuple, list)):
                for o in obj:
                    yield from walk(o)
            elif hasattr(obj, "__dict__"):
                for v in vars(obj).values():
                    yield from walk(v)
        yield from walk(self)


@dataclasses.dataclass(frozen=True)
class SolveParams:
    """Static solve configuration."""

    smoother: str = "chebyshev"
    preSmooth: int = 3
    postSmooth: int = 3
    jacobi_omega: float = 2.0 / 3.0
    direct_solver: str = "LU"
    CG_coarsest_max_iter: int = 150
    CG_coarsest_tol: float = 1e-12
    # pCG: every k-th iteration replace the recursive residual by A u - rhs
    # and restart the direction (beta = 0); 0 = never
    residual_replace: int = 0

    @classmethod
    def from_options(cls, o: Options) -> "SolveParams":
        return cls(
            smoother=o.smoother,
            preSmooth=o.preSmooth,
            postSmooth=o.postSmooth,
            jacobi_omega=o.jacobi_omega,
            direct_solver=o.direct_solver,
            CG_coarsest_max_iter=o.CG_coarsest_max_iter,
            CG_coarsest_tol=o.CG_coarsest_tol,
        )


@dataclasses.dataclass
class SetupInfo:
    """Per-level summary for print_lev_info-style reporting
    (ref saena_object.cpp:111-145) plus the host-side CSR hierarchy."""

    sizes: list
    nnzs: list
    densities: list
    formats: list
    dtypes: list
    thetas: list
    coarsen_kinds: list  # "h" or "-"
    csr_levels: list = dataclasses.field(default_factory=list, repr=False)
    Ps: list = dataclasses.field(default_factory=list, repr=False)
    Rs: list = dataclasses.field(default_factory=list, repr=False)
    # per coarsening step, (agg, wq) when the structural transfers apply
    # (symmetric A), else None
    structs: list = dataclasses.field(default_factory=list, repr=False)
    # per-phase setup seconds (phases overlap across threads, so the sum
    # may exceed the "wall" entry) and, apart from them, the bytes uploaded
    phases: dict = dataclasses.field(default_factory=dict, repr=False)
    # each phase interval, (name, start_s, end_s, thread_id) on
    # time.perf_counter (runtime.PhaseTimer.spans)
    phase_spans: list = dataclasses.field(default_factory=list, repr=False)
    # each sparse product of the Galerkin phase, a runtime.Product (level,
    # engine "card" or "host", multiply-adds, seconds), in the order they
    # ended (PhaseTimer.products)
    products: list = dataclasses.field(default_factory=list, repr=False)
    upload_bytes: int = 0
    # per level, how a lazy devicify (``reuse=``) built it: "whole" (the
    # old level kept), "values" (A and inv_diag rebuilt on the old plans,
    # the old eig estimate and P/R kept), "rebuilt" (A planned and built
    # from scratch and its eig estimate computed again; the old P/R kept
    # where the host P/R are the same); None after a full setup
    reuse: Optional[list] = None
    comm: object = None   # CommMeter when built by parallel/dist_setup.py
    n_shards: int = 0     # shard count of the setup that built this
    native: bool = False  # whether the native host kernels were used

    def shard_stats(self, n_shards: int = 0) -> list:
        """Per level, per-shard (M_min, M_avg, M_max, nnz_min, nnz_avg,
        nnz_max) under the nnz-balanced 1-D row split at ``n_shards``
        (default: the setup's shard count, or 1), the fields the
        reference's print_lev_info reports across ranks
        (saena_object.cpp:111-145)."""
        from saena_tpu_torch.parallel.partition import nnz_balanced_split

        d = n_shards or self.n_shards or 1
        out = []
        for A in self.csr_levels:
            split = nnz_balanced_split(A.tocsr(), d)
            M = np.diff(split)
            csum = np.concatenate([[0], np.cumsum(np.diff(A.tocsr().indptr))])
            nnz = csum[split[1:]] - csum[split[:-1]]
            out.append((int(M.min()), int(M.mean()), int(M.max()),
                        int(nnz.min()), int(nnz.mean()), int(nnz.max())))
        return out

    def table(self, shards: int = 0) -> str:
        """Level summary; with ``shards`` (or a shard-parallel setup) it
        adds the reference's per-rank M / nnz min-avg-max columns
        (print_lev_info, saena_object.cpp:111-145)."""
        d = shards or self.n_shards
        stats = self.shard_stats(d) if d > 1 else None
        lines = ["lvl       rows          nnz    density  format       dtype     coarsen"]
        if stats is not None:
            lines[0] += "  M(min,avg,max)            nnz(min,avg,max)"
        for i in range(len(self.sizes)):
            row = (f"{i:<3} {self.sizes[i]:>10} {self.nnzs[i]:>12}  "
                   f"{self.densities[i]:>9.2e}  {self.formats[i]:<12} "
                   f"{self.dtypes[i]:<9} {self.coarsen_kinds[i]}")
            if stats is not None:
                m0, m1, m2, z0, z1, z2 = stats[i]
                row += f"  ({m0},{m1},{m2})".ljust(26) + f"({z0},{z1},{z2})"
            lines.append(row)
        share = self.card_mac_share()
        if share is not None:
            lines.append(f"galerkin: {len(self.products)} products, "
                         f"{share:.2f}% of their multiply-adds on the card")
        return "\n".join(lines)

    def card_mac_share(self) -> Optional[float]:
        """The percentage of the Galerkin products' multiply-adds that ran
        on the card; None without products."""
        total = sum(p.macs for p in self.products)
        if not total:
            return None
        return 100.0 * sum(p.macs for p in self.products if p.engine == "card") / total


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------


def coarsen_csr(A: sp.csr_matrix, lvl: int, opts: Options, timer: PhaseTimer,
                device=None):
    """One h-coarsening step: aggregation -> P -> R -> filtered Galerkin Ac.
    Returns (P, R, Ac, last_flag, theta_used, struct) or None when
    coarsening is not possible (ref coarsen(), saena_object.cpp:409-538);
    ``struct`` is (agg, wq) when the structural transfers apply.
    ``Options(rap="device")`` takes the Galerkin product through the
    block-sparse engine on ``device`` in f64 (the JAX package's x64 branch,
    saena_tpu/amg/hierarchy.py:335-343)."""
    n = A.shape[0]
    with timer.phase("aggregation"):
        if opts.aggregation == "double":
            agg, n_c, theta = find_aggregation_double(
                A, opts.connStrength, opts.adaptive_coarsening)
        else:
            agg, n_c, theta = find_aggregation(
                A, opts.connStrength, opts.adaptive_coarsening)
    if n_c == 0 or n_c >= n:
        return None
    last = False
    if opts.dynamic_levels:
        if n_c <= opts.least_row_threshold:
            last = True
        elif n_c / n > opts.row_reduction_up_thrshld:
            last = True
    with timer.phase("prolongation"):
        P = smoothed_prolongator(A, agg, n_c, omega=opts.Pomega,
                                 psmoother=opts.PSmoother)
        R = restriction(P)
    with timer.phase("rap"):
        if opts.rap == "device":
            # host symbolic, batched block products on the device
            # (ops/bspgemm.py)
            from saena_tpu_torch.ops.bspgemm import spgemm_blocks

            dev = resolve_device(device)
            Ac = spgemm_blocks(spgemm_blocks(R, A, device=dev), P, device=dev)
        else:
            Ac = galerkin_product(R, A, P, device=device, timer=timer, level=lvl)
    with timer.phase("coarsen_tail"):
        P, R, Ac, agg, struct = coarsen_tail(A, P, R, Ac, agg, lvl, opts)
    return P, R, Ac, last, theta, struct


def coarsen_tail(A, P, R, Ac, agg, lvl: int, opts: Options):
    """Post-Galerkin finishing: filter/lumping, optional sparsification,
    the RCM reordering (ref saena_object_setup2.cpp:161-341) and the
    structural-transfer eligibility. Returns (P, R, Ac, agg, struct): agg
    follows the reordering, struct is (agg, wq) when A is symmetric."""
    thre = filter_threshold(lvl + 1, opts.filter_thre, opts.filter_max,
                            opts.filter_start, opts.filter_rate)
    Ac = filter_lump(Ac, thre)
    if opts.sample_sz_percent < 1.0:
        Ac = sparsify_majid(Ac, opts.sample_sz_percent)
    if opts.reorder_coarse and Ac.shape[0] > 256:
        # symmetric RCM renumbering of the coarse operator, kept only when
        # the permuted pattern has the smaller (8, 128)-block footprint. The
        # JAX package takes the same decision for its block formats; the
        # port keeps it because the coarse ordering decides the next level's
        # MIS(1) aggregation, and with it the hierarchy and the iterations.
        perm = rcm_permutation(Ac)
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(perm.size)
        coo = Ac.tocoo()
        n_br, W_p = bsr_block_width(iperm[coo.row], iperm[coo.col], Ac.shape)
        if n_br * W_p * 1024 * 4 < bsr_bytes_estimate(Ac):
            Ac = Ac[perm][:, perm].tocsr()
            Ac.sort_indices()
            set_bsr_geometry(Ac, n_br, W_p)
            P = P[:, perm].tocsr()
            R = R[perm].tocsr()
            agg = iperm[agg]
    # the structural transfers need R = P^T to decompose through a
    # symmetric A; sparsified hierarchies break it
    struct = None
    if opts.structural_transfers and opts.sample_sz_percent >= 1.0 \
            and is_symmetric(A):
        struct = (agg, smoothing_diag(A, opts.Pomega, opts.PSmoother))
        # Galerkin with R = P^T keeps symmetry to roundoff: pre-seed the
        # flag so the next level skips the transpose compare
        mark_symmetric(Ac)
    return P, R, Ac, agg, struct


def setup(
    A: sp.csr_matrix,
    opts: Optional[Options] = None,
    dtype=None,
    device=None,
    use_dense: bool = False,
    p_levels=None,
    coarsen_fn=None,
) -> tuple[Hierarchy, SetupInfo]:
    """Build the AMG hierarchy of a host CSR matrix on ``device`` (the card
    unless named) at ``dtype`` (torch's default unless named).

    ``p_levels``: host prolongation CSRs applied first (the p-coarsening
    path for high-order FEM, ref saena_object_pcoarsen_modal.cpp), each
    with R = P^T and the host Galerkin product, before h-coarsening takes
    over; built by amg/pcoarsen.py.

    ``coarsen_fn``: a replacement for :func:`coarsen_csr` with the same
    (A, lvl, opts, timer, device) -> (P, R, Ac, last, theta, struct) | None
    contract; the shard-parallel setup (parallel/dist_setup.py) plugs in
    here."""
    opts = opts or Options()
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    timer = PhaseTimer()
    t_wall0 = time.perf_counter()

    A = A.tocsr().astype(np.float64)
    A.sort_indices()
    if opts.debug:
        if not np.isfinite(A.data).all():
            raise FloatingPointError("matrix values contain NaN/Inf")
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"AMG needs a square matrix, got {A.shape}")
    n_zero = int(np.sum(A.diagonal() == 0))
    if n_zero:
        raise ValueError(
            f"matrix has {n_zero} zero diagonal entr{'y' if n_zero == 1 else 'ies'}: "
            "AMG smoothing needs D^-1 (the reference divides by the diagonal "
            "too, saena_matrix_setup.cpp inverse_diag)")

    inv_sq_diag = None
    if opts.scale:
        d = A.diagonal()
        isd = 1.0 / np.sqrt(np.abs(np.where(d == 0, 1.0, d)))
        D = sp.diags(isd)
        A = (D @ A @ D).tocsr()
        inv_sq_diag = isd

    csr_levels = [A]
    Ps, Rs, thetas, kinds, structs = [], [], [], [], []
    eig_futs: dict = {}

    def _timed_eig(Acur):
        with timer.phase("eig"):
            return eig_max_invdiag_host(Acur)

    def _add_level(P, R, Ac, theta, kind, struct):
        """Append a coarse level; the level it came from is now final, so
        its eig estimate starts on the executor."""
        lvl = len(csr_levels) - 1
        Ps.append(P)
        Rs.append(R)
        thetas.append(theta)
        kinds.append(kind)
        structs.append(struct)
        if opts.smoother == "chebyshev" and not (lvl == 0 and opts.eig > 0):
            eig_futs[lvl] = exe.submit(_timed_eig, csr_levels[lvl])
        csr_levels.append(Ac)

    # the executor runs each level's Lanczos eig estimate behind the
    # coarsening of deeper levels (a level's lambda_max is final once its
    # coarse level exists), then devicify's level builds; FIFO order puts
    # every eig ahead of the builds that wait on it
    exe = ThreadPoolExecutor(max_workers=_setup_workers())
    try:
        for P in p_levels or ():
            R = restriction(P)
            with timer.phase("rap"):
                Ac = galerkin_product(R, csr_levels[-1], P, device=device,
                                      timer=timer, level=len(csr_levels) - 1)
            _add_level(P, R, Ac, None, "p", None)
        while len(csr_levels) - 1 < opts.max_level:
            Acur = csr_levels[-1]
            lvl = len(csr_levels) - 1
            if opts.dynamic_levels and \
                    Acur.shape[0] <= opts.least_row_threshold:
                break
            out = (coarsen_fn or coarsen_csr)(Acur, lvl, opts, timer, device)
            if out is None:
                break
            P, R, Ac, last, theta, struct = out
            _add_level(P, R, Ac, theta, "h", struct)
            if last:
                break

        hierarchy, info = devicify(
            csr_levels, Ps, Rs, opts, dtype=dtype, device=device,
            use_dense=use_dense, inv_sq_diag=inv_sq_diag, structs=structs,
            eig_futures=eig_futs, timer=timer, executor=exe)
    finally:
        exe.shutdown(wait=True, cancel_futures=True)
    timer.add("wall", time.perf_counter() - t_wall0)
    info.phases = timer.seconds
    info.phase_spans = timer.spans
    info.upload_bytes = timer.upload_bytes
    info.thetas = thetas + [None]
    info.coarsen_kinds = kinds + ["-"]
    return hierarchy, info


def _setup_workers() -> int:
    """The setup executor's workers: the host's cores, between 2 and 4
    (the level builds are CPU-bound planners; more workers than cores
    thrash)."""
    return max(2, min(4, os.cpu_count() or 2))


class _DoneFuture:
    """A completed future, for devicify's eig_futures."""

    def __init__(self, v):
        self._v = v

    def result(self):
        return self._v


def _same_pattern(a: sp.csr_matrix, b: sp.csr_matrix) -> bool:
    """True when two CSRs share shape and sparsity pattern (values may
    differ), the precondition of every lazy-update reuse."""
    if a is b:
        return True
    if a.shape != b.shape or a.nnz != b.nnz:
        return False
    return np.array_equal(a.indptr, b.indptr) and \
        np.array_equal(a.indices, b.indices)


# the symmetry memo (ops/transfers.py) is deliberately not moved: symmetry
# is a property of the values, which a same-pattern refresh may change
_PLAN_MEMO_ATTRS = ("_saena_torch_strip_pick", "_saena_torch_bsr_geom")


def _transfer_plan_memos(old: sp.csr_matrix, new: sp.csr_matrix) -> None:
    """Copy the pattern-only planning memos from ``old`` onto ``new`` (same
    pattern, new values): the strip pick, the BSR geometry and the strip8
    plan, whose layout is pattern-only; its stored COO is taken from the
    new matrix so that value scatters see the new values."""
    if not _same_pattern(old, new):
        return
    for attr in _PLAN_MEMO_ATTRS:
        tok = getattr(old, attr, None)
        if tok is not None:
            setattr(new, attr, tok)
    tok = getattr(old, "_saena_torch_strip8_plan", None)
    if tok is not None:
        new.sort_indices()
        new._saena_torch_strip8_plan = (tok[0], (new.tocoo(), tok[1][1]))


def devicify(
    csr_levels,
    Ps,
    Rs,
    opts: Options,
    dtype=None,
    device=None,
    use_dense: bool = False,
    inv_sq_diag=None,
    structs=None,
    eig_futures=None,
    timer: Optional[PhaseTimer] = None,
    executor=None,
    reuse=None,
) -> tuple[Hierarchy, SetupInfo]:
    """Convert a host CSR hierarchy into device levels. ``structs``: per
    coarsening step (agg, wq) or None, from setup(); without them every
    level gets direct P/R. ``eig_futures``: per-level futures of
    eig_max_invdiag_host started by setup(); levels without one compute it
    inline. ``executor``: a thread pool that builds the levels (their
    planning and uploads are independent), assembled in level order;
    bitwise the serial build. Builders launch no kernel, so no gather
    kernel runs on a worker thread.

    ``reuse``: (old_hierarchy, old_csrs, old_Ps, old_Rs) of the previous
    devicify, the lazy-update path (ref ITER_LAZY, saena_object.h:19):
    levels whose CSR object is unchanged are reused whole; levels whose
    pattern is unchanged keep the old eig estimate, format plans (moved
    onto the new CSR) and P/R device objects, and the coarse LU is kept
    when the coarsest CSR is unchanged. A level whose own pattern moved
    is planned and built anew, its eig estimate computed again, and keeps
    the old P/R device objects while its host P/R are the same.
    ``SetupInfo.reuse`` records what each level took.
    ``timer`` (a fresh one unless given) gathers the phases into
    ``SetupInfo.phases`` and ``phase_spans``."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    timer = timer or PhaseTimer()
    n_lv = len(csr_levels)
    structs = list(structs) if structs else [None] * len(Ps)
    info = SetupInfo([], [], [], [], [], [None] * n_lv, ["-"] * n_lv,
                     csr_levels=list(csr_levels), Ps=list(Ps), Rs=list(Rs),
                     structs=structs, native=_native.have_native())

    reuse_eigs: dict = {}
    same_pats: set = set()
    if reuse is not None:
        old_hier, old_csrs, old_Ps, old_Rs = reuse
        for l in range(min(n_lv, len(old_csrs))):
            if _same_pattern(old_csrs[l], csr_levels[l]):
                same_pats.add(l)
                _transfer_plan_memos(old_csrs[l], csr_levels[l])
                if old_hier.levels[l].eig_max is not None:
                    # a values-only refresh keeps lambda_max, the lazy
                    # path's approximation (set_matrix recomputes it)
                    reuse_eigs[l] = old_hier.levels[l].eig_max

    def build_level(l):
        is_coarsest = l == n_lv - 1
        kept_eig = {l: _DoneFuture(reuse_eigs[l])} if l in reuse_eigs else None
        if reuse is not None and l < len(old_csrs):
            old_lv = old_hier.levels[l]
            same_A = old_csrs[l] is csr_levels[l]
            same_PR = is_coarsest or (
                l < len(old_Ps) and old_Ps[l] is Ps[l] and old_Rs[l] is Rs[l])
            if same_A and same_PR:
                Acsr = csr_levels[l]
                n = Acsr.shape[0]
                return old_lv, (n, int(Acsr.nnz), Acsr.nnz / max(1, n * n),
                                type(old_lv.A).__name__,
                                dtype_name(old_lv.A.dtype)), "whole"
            if same_PR:
                # rebuild A and inv_diag (on the old plans and eig estimate
                # where the pattern held), graft the old P/R unchanged.
                # Structural SmoothedP/R embed the A they were smoothed
                # with, and only that A matches the host Ps/Rs the coarse
                # operators were built through: keep it
                lv, row = _level_task(
                    l, is_coarsest, csr_levels, Ps, Rs, None, opts, dtype,
                    device, use_dense, kept_eig, timer, skip_transfers=True)
                return (dataclasses.replace(lv, P=old_lv.P, R=old_lv.R), row,
                        "values" if l in same_pats else "rebuilt")
        return (*_level_task(l, is_coarsest, csr_levels, Ps, Rs, structs, opts,
                             dtype, device, use_dense, eig_futures, timer),
                "rebuilt")

    if executor is not None and n_lv > 1:
        built = list(executor.map(build_level, range(n_lv)))
    else:
        built = [build_level(l) for l in range(n_lv)]
    levels = []
    if reuse is not None:
        info.reuse = [how for *_, how in built]
    for level, (n, nnz, dens, fmt, dts), _ in built:
        levels.append(level)
        info.sizes.append(n)
        info.nnzs.append(nnz)
        info.densities.append(dens)
        info.formats.append(fmt)
        info.dtypes.append(dts)

    # ---- coarsest factorization (cached across solves) ----
    t0 = time.perf_counter()
    coarse_lu = None
    if (reuse is not None and opts.direct_solver == "LU"
            and len(old_csrs) == n_lv and old_csrs[-1] is csr_levels[-1]
            and old_hier.coarse_lu is not None):
        coarse_lu = old_hier.coarse_lu        # coarsest level untouched
    elif opts.direct_solver == "LU":
        Acoarse = csr_levels[-1]
        n = Acoarse.shape[0]
        # the coarse direct solve runs at the vector dtype, at least f32
        # (the reference's SuperLU always factors in f64)
        dt = dtype if dtype.itemsize >= 4 else torch.float32
        n_pad = pad_to(n)
        inv_nn = None
        if n_pad <= 2048:
            # host f64 inverse; a singular coarsest operator (pure Neumann)
            # has none and takes the unit-diagonal-padded LU instead
            coarse_dense = Acoarse.toarray()
            try:
                inv_nn = np.linalg.inv(coarse_dense)
                if not np.isfinite(inv_nn).all():
                    inv_nn = None
            except np.linalg.LinAlgError:
                inv_nn = None
        if inv_nn is not None:
            inv = np.zeros((n_pad, n_pad))
            inv[:n, :n] = inv_nn
            ad = np.zeros((n_pad, n_pad))
            ad[:n, :n] = coarse_dense
            coarse_lu = CoarseLU(lu=None, piv=None,
                                 inv=to_device(inv, dt, device, timer),
                                 adense=to_device(ad, dt, device, timer), n=n)
        else:
            dm = dense_from_csr(Acoarse, dt, device, unit_diag_pad=True, timer=timer)
            lu, piv = torch.linalg.lu_factor(dm.data)
            coarse_lu = CoarseLU(lu=lu, piv=piv, inv=None, adense=None, n=n)
    timer.add("coarse_lu", time.perf_counter() - t0)

    if inv_sq_diag is not None:
        n0 = csr_levels[0].shape[0]
        inv_sq_diag = to_device(np.pad(inv_sq_diag, (0, pad_to(n0) - n0)),
                                dtype, device, timer)
    hierarchy = Hierarchy(levels=tuple(levels), coarse_lu=coarse_lu,
                          inv_sq_diag=inv_sq_diag)
    info.phases = timer.seconds
    info.phase_spans = timer.spans
    info.products = timer.products
    info.upload_bytes = timer.upload_bytes
    return hierarchy, info


def _transfer_from_csr(M: sp.csr_matrix, dtype, device, timer):
    """Direct P/R: the fastest gather format by estimate on the card, ELL
    on the CPU."""
    if accelerator_branch(device) and M.nnz > 0:
        builder = pick_gather_format(M, dtype)
        if builder is not None:
            return builder(M, dtype, device, timer=timer)
    return ell_from_csr(M, dtype, device, width_quantile=0.98, timer=timer)


def _structural_wins(l, agg, n_c, Adev, Ps, Rs, dt, dt_next) -> bool:
    """Whether the structural transfers' estimate beats the direct P/R's.
    The quick direct estimate decides first, with a 3x margin, so strip8's
    full-pattern plan of P and R runs only on close calls."""
    est_s = structural_estimate(agg, n_c, Adev, dt)
    if not np.isfinite(est_s):
        return False
    est_dq = (gather_time_estimate_quick(Ps[l], dt_next)
              + gather_time_estimate_quick(Rs[l], dt_next))
    if est_s < est_dq / 3.0:
        return True
    return est_s < (gather_time_estimate(Ps[l], dt_next)
                    + gather_time_estimate(Rs[l], dt_next))


def _level_task(l, is_coarsest, csr_levels, Ps, Rs, structs, opts, dtype,
                device, use_dense, eig_futures, timer, skip_transfers=False):
    """Build one level's device objects (A format, inv_diag, eig and, unless
    ``skip_transfers``, P/R)."""
    low_dtype = getattr(torch, opts.low_dtype)
    Acsr = csr_levels[l]
    # storage reduction only under the opt-in float_storage flag
    dt = low_dtype if (opts.float_storage and l >= opts.float_level) else dtype
    # the smoothers' twin of A, from the same host arrays (none on the
    # coarsest level, none at the level's own dtype)
    sm_dt = None
    if opts.smooth_dtype and not is_coarsest:
        sm_dt = getattr(torch, opts.smooth_dtype)
        if sm_dt == dt:
            sm_dt = None
    A_smooth = None
    with timer.phase("devicify_A"):
        if is_coarsest and opts.direct_solver == "LU":
            Adev = dense_from_csr(Acsr, dt, device, unit_diag_pad=True, timer=timer)
        else:
            Adev = device_matrix_from_csr(
                Acsr, dt, device,
                dense_thre=opts.dense_thre,
                dense_sz_thre=opts.dense_sz_thre,
                switch_to_dense=opts.switch_to_dense and (l > 0 or use_dense),
                smooth_dtype=sm_dt, timer=timer)
            if sm_dt is not None:
                Adev, A_smooth = Adev
    n = Acsr.shape[0]
    n_pad = pad_to(n)
    diag = Acsr.diagonal()
    inv_diag = np.zeros(n_pad)
    inv_diag[:n] = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 0.0)

    eig = None
    if opts.smoother == "chebyshev" and not is_coarsest:
        if l == 0 and opts.eig > 0:
            eig = float(opts.eig)    # user-provided (ref set_eig)
        elif eig_futures is not None and l in eig_futures:
            with timer.phase("eig_wait"):
                eig = float(eig_futures[l].result())
        else:
            with timer.phase("eig"):
                eig = float(eig_max_invdiag_host(Acsr))

    P_dev = R_dev = None
    if not is_coarsest and not skip_transfers:
        with timer.phase("devicify_PR"):
            dt_next = low_dtype if (opts.float_storage
                                    and (l + 1) >= opts.float_level) else dtype
            struct = structs[l] if structs else None
            force = opts.structural_transfers == "force"
            if struct is not None and (force or accelerator_branch(device)):
                agg, wq = struct
                n_c = csr_levels[l + 1].shape[0]
                if force or _structural_wins(l, agg, n_c, Adev, Ps, Rs, dt,
                                             dt_next):
                    P_dev, R_dev = build_structural(
                        agg, n_c, wq, Adev, int(Ps[l].nnz), dt, dt_next,
                        device, timer=timer)
            if P_dev is None:
                P_dev = _transfer_from_csr(Ps[l], dt_next, device, timer)
                R_dev = _transfer_from_csr(Rs[l], dt_next, device, timer)

    # inv_diag carries the VECTOR dtype: smoother arithmetic stays at full
    # precision while a float_storage operator's matvec runs reduced
    level = Level(A=Adev, inv_diag=to_device(inv_diag, dtype, device, timer),
                  P=P_dev, R=R_dev, A_smooth=A_smooth, n=n, lvl=l,
                  eig_max=eig)
    return level, (n, int(Acsr.nnz), Acsr.nnz / max(1, n * n),
                   type(Adev).__name__, dtype_name(dt))
