"""Public API mirroring the reference's pImpl surface (saena.hpp:14-265):
``Matrix`` ~ saena::matrix, ``Vector`` ~ saena::vector and ``AMG`` ~
saena::amg, with ``Options`` from saena_tpu_torch.config ~ saena::options.

Matrix wraps host CSR assembly and file I/O plus a device matrix; AMG wraps
hierarchy setup (shard-parallel by default, ``Options.setup_shards``), the
solvers (graph replays on the card, amg/graphs.py), the lazy updates, the
profiling surfaces and the host matrix product. Both run on the CUDA card
unless the caller names another device (``device="cpu"``); without a card
and without that request they raise. ``dtype`` defaults to torch's default
dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch.amg import hierarchy as _hier
from saena_tpu_torch.amg import solvers as _solvers
from saena_tpu_torch.amg.galerkin import (
    filter_lump,
    filter_threshold,
    galerkin_product,
)
from saena_tpu_torch.config import Options
from saena_tpu_torch.core.coo import CooBuilder, remove_boundary_nodes
from saena_tpu_torch.io.readers import read_matrix, write_bin, write_mtx
from saena_tpu_torch.ops.formats import device_matrix_from_csr, pad_to
from saena_tpu_torch.parallel.dist_setup import dist_setup
from saena_tpu_torch.runtime import (
    PhaseTimer,
    copied,
    resolve_device,
    resolve_dtype,
    span,
)
from saena_tpu_torch.vector import SaenaVector as Vector


class Matrix:
    """saena::matrix analog: set()/set_csr() then assemble()
    (ref saena_matrix_setup.cpp:4-18)."""

    def __init__(self, add_duplicates: bool = False):
        self._builder = CooBuilder(add_duplicates=add_duplicates)
        self._csr: Optional[sp.csr_matrix] = None
        self._device_matrix = None
        self._use_dense = False
        self._scale = False
        self._device = None
        self._dtype = None
        self.p_order = 1          # ref saena_matrix.h p_order (p-coarsening)
        self.prodim = 2

    # ---- ingest (ref saena.cpp:10-262, the set overloads) ----
    def read_file(self, path: str) -> None:
        """Read a .mtx, .bin or .sbin file (io/readers.read_matrix)."""
        self._csr = read_matrix(path)

    def set(self, rows, cols, vals) -> None:
        self._builder.set(rows, cols, vals)

    def set_csr(self, A: sp.spmatrix) -> None:
        self._csr = A.tocsr()

    def add_duplicates(self, add: bool) -> None:
        self._builder.add_duplicates = add

    def set_p_order(self, p: int) -> None:
        """The p-coarsening order, stored as saena_tpu stores it; the setup
        does not read it (``AMG.set_matrix(p_levels=)`` selects the
        p-path)."""
        self.p_order = p

    def set_prodim(self, d: int) -> None:
        self.prodim = d

    def assemble(self, scale: bool = False, use_dense: bool = False, *,
                 device=None, dtype=None) -> "Matrix":
        """Build the CSR from the buffered entries (if any) and its device
        matrix on ``device`` at ``dtype``. ``scale`` is stored, as in
        saena_tpu; the symmetric scaling is Options.scale's."""
        if self._builder.nnz_buffered:
            self._csr = self._builder.assemble()
        if self._csr is None:
            raise ValueError("no entries set before assemble()")
        self._scale = scale
        self._use_dense = use_dense
        self._device, self._dtype = resolve_device(device), resolve_dtype(dtype)
        self._device_matrix = device_matrix_from_csr(
            self._csr, self._dtype, self._device,
            switch_to_dense=use_dense, dense_thre=0.0 if use_dense else 0.1,
            dense_sz_thre=1 << 30 if use_dense else 5000)
        return self

    def update_values(self, vals) -> None:
        """Replace the nonzero values, keeping the pattern (the lazy-update
        ingredient, ref erase_lazy_update / matrix_setup_lazy_update); an
        assembled matrix is assembled again on its device."""
        vals = np.asarray(vals)
        if self._csr is None or vals.shape != self._csr.data.shape:
            raise ValueError("pattern mismatch in update_values")
        self._csr.data[:] = vals
        if self._device_matrix is not None:
            self.assemble(self._scale, self._use_dense, device=self._device,
                          dtype=self._dtype)

    def get_num_rows(self) -> int:
        return self.csr.shape[0]

    def get_nnz(self) -> int:
        return int(self.csr.nnz)

    def get_internal_matrix(self):
        """The device matrix (None before assemble())."""
        return self._device_matrix

    def writeMatrixToFile(self, path: str) -> None:
        """Write the CSR as .bin (by extension) or Matrix Market."""
        if path.endswith(".bin"):
            write_bin(path, self.csr)
        else:
            write_mtx(path, self.csr)

    def erase(self) -> None:
        self._builder = CooBuilder(add_duplicates=self._builder.add_duplicates)
        self._csr = None
        self._device_matrix = None

    destroy = erase

    @property
    def csr(self) -> sp.csr_matrix:
        if self._csr is None:
            raise ValueError("assemble() first")
        return self._csr

    def matvec(self, v) -> np.ndarray:
        """A @ v on the device matrix; v and the result are host arrays."""
        if self._device_matrix is None:
            raise ValueError("assemble() first")
        M = self._device_matrix
        n, m = self.csr.shape
        x = torch.zeros(pad_to(m), dtype=M.dtype, device=M.device)
        x[:m] = torch.as_tensor(np.asarray(v), dtype=M.dtype)
        return M.matvec(x)[:n].cpu().numpy()


class _SolveVectors:
    """A solve's vectors between the caller's host arrays and ``device``,
    for a system of ``n_full`` rows; made by ``AMG.set_matrix``.

    ``split`` is the host boundary split of remove_boundary_nodes (interior
    indices, boundary indices, boundary diagonal), or None. The indices are
    kept as tensors and the diagonal as a float64 vector on ``device``;
    ``set_bound_diag`` refreshes the diagonal after a lazy update (the
    indices are pattern-only). Two host staging buffers of n_full float64,
    pinned on a CUDA device, carry the rhs in and the answer out: a solve
    makes one copy each way (counted in ``runtime.copies``), and the
    gather, the zero padding, the casts, the boundary division and the
    merge run on the device, with the host path's arithmetic, so the
    answers are the same bit for bit."""

    def __init__(self, n_full: int, device: torch.device, split=None):
        self.n_full, self.device, self.split = n_full, device, None
        pinned = device.type == "cuda"
        self.route = "pinned" if pinned else "host"
        self._in, self._out = (torch.empty(n_full, dtype=torch.float64, pin_memory=pinned)
                               for _ in range(2))
        # on the card, the rhs's copy out of self._in is asynchronous: the
        # next solve waits for it before writing the buffer again
        self._in_read = torch.cuda.Event() if pinned else None
        if split is not None:
            self.split = split
            self._interior, self._bound = (torch.as_tensor(ix, device=device)
                                           for ix in split[:2])
            self.set_bound_diag(split[2])

    def set_bound_diag(self, diag: np.ndarray) -> None:
        self.split = (*self.split[:2], diag)
        self._diag = torch.as_tensor(diag, dtype=torch.float64, device=self.device)

    def upload(self, rhs: np.ndarray, n: int, n_pad: int, dtype):
        """(the interior rhs, zero padded to ``n_pad`` at ``dtype`` on the
        device, the boundary solution rhs_b / diag_b in float64 or None)."""
        if rhs.shape != (self.n_full,):
            raise ValueError(f"rhs of shape {rhs.shape} for a system of "
                             f"{self.n_full} rows")
        if self._in_read is not None:
            self._in_read.synchronize()
        np.copyto(self._in.numpy(), rhs)
        full = self._in.to(self.device, non_blocking=True)
        if self._in_read is not None:
            self._in_read.record(torch.cuda.current_stream(self.device))
        copied("h2d", self.route, 8 * self.n_full)
        rhs_p = torch.zeros(n_pad, dtype=dtype, device=self.device)
        if self.split is None:
            rhs_p[:n] = full
            return rhs_p, None
        rhs_p[:n] = full[self._interior]
        # a division, not a product with the reciprocal: the host's bits
        return rhs_p, full[self._bound] / self._diag

    def merge(self, u: torch.Tensor, bound_sol) -> torch.Tensor:
        """The full float64 solution on the device: the interior ``u`` (n
        rows) with the boundary solution scattered in (ref
        add_boundary_sol, saena_object.cpp:753)."""
        u = u.to(torch.float64)
        if self.split is None:
            return u
        full = torch.empty(self.n_full, dtype=torch.float64, device=self.device)
        full.index_copy_(0, self._interior, u)
        full.index_copy_(0, self._bound, bound_sol)
        return full

    def download(self, full: torch.Tensor) -> np.ndarray:
        """``full`` as a new host array, which a later solve leaves as it
        is. The copy into the staging buffer synchronises the stream."""
        self._out.copy_(full)
        copied("d2h", self.route, 8 * self.n_full)
        return self._out.numpy().copy()


class AMG:
    """saena::amg analog (saena.hpp:195-265). The hierarchy lives on
    ``device`` (the card unless named) at ``dtype`` (torch's default unless
    named)."""

    def __init__(self, device=None, dtype=None):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.opts = Options()
        self.hierarchy: Optional[_hier.Hierarchy] = None
        self.info: Optional[_hier.SetupInfo] = None
        self.params: Optional[_hier.SolveParams] = None
        self._rhs: Optional[np.ndarray] = None
        self._rhs_vector: Optional[Vector] = None
        self._io: Optional[_SolveVectors] = None   # a solve's host <-> device vectors
        self.verbose = False

    def set_matrix(self, A: Matrix, opts: Optional[Options] = None,
                   p_levels=None) -> "AMG":
        """Set up the hierarchy of A. ``Options.setup_shards`` picks the
        host setup as saena_tpu does: -1 (the default) runs the
        shard-parallel setup (one shard per 4 cores, at least 2), a
        positive value forces that shard count, 0 runs the serial setup.
        All give the same hierarchy bit for bit. A solve's graphs live on
        the hierarchy, so a new one starts without them. ``p_levels`` (host
        injections from amg/pcoarsen.py) are applied first, then
        h-coarsening; as in saena_tpu, ``A.p_order`` is stored and not
        read."""
        if opts is not None:
            self.opts = opts
        with span("saena.set_matrix"):
            csr, split = A.csr, None
            n_full = csr.shape[0]
            if self.opts.remove_boundary:
                Ai, interior, bound, bound_diag, _ = remove_boundary_nodes(csr)
                if bound.size:
                    split, csr = (interior, bound, bound_diag), Ai
            if self.opts.setup_shards:
                self.hierarchy, self.info = dist_setup(
                    csr, self.opts, dtype=self.dtype, device=self.device,
                    n_shards=max(self.opts.setup_shards, 0),
                    use_dense=A._use_dense, p_levels=p_levels)
            else:
                self.hierarchy, self.info = _hier.setup(
                    csr, self.opts, dtype=self.dtype, device=self.device,
                    use_dense=A._use_dense, p_levels=p_levels)
            self._io = _SolveVectors(n_full, self.device, split)
        self.params = _hier.SolveParams.from_options(self.opts)
        if self.opts.verbose or self.verbose:
            print(self.info.table())
            if self.info.comm is not None:
                print(self.info.comm.table())   # setup wire volume by phase
        return self

    def set_rhs(self, rhs) -> "AMG":
        """The right-hand side: a host array or an assembled Vector."""
        if isinstance(rhs, Vector):
            self._rhs_vector = rhs
            rhs = rhs.get_vec()
        self._rhs = np.asarray(rhs, dtype=np.float64)
        return self

    # ---- solves: each returns (u, SolveResult), u the host solution of the
    # full system (boundary rows merged back when they were removed). The
    # vectors cross between host and device once each way (_SolveVectors).
    # Under a torch profiler a solve is the span saena.solve, the rhs's copy
    # to the device and its split there saena.api.rhs, the merge of u with
    # the boundary rows saena.api.merge and its copy to the host
    # saena.api.download ----

    def _run(self, fn, **kw):
        if self.hierarchy is None or self._rhs is None:
            raise ValueError("set_matrix() and set_rhs() first")
        H = self.hierarchy
        with span("saena.solve"):
            with span("saena.api.rhs"):
                if self.opts.debug and not np.isfinite(self._rhs).all():
                    raise FloatingPointError("rhs contains NaN/Inf")
                rhs_p, bound_sol = self._io.upload(self._rhs, H.n, H.n_pad, H.dtype)
            res = fn(H, rhs_p, params=self.params,
                     tol=kw.pop("tol", self.opts.tol),
                     max_iter=kw.pop("max_iter", self.opts.max_iter), **kw)
            with span("saena.api.merge"):
                u = self._io.merge(res.u[:H.n], bound_sol)
            with span("saena.api.download"):
                u = self._io.download(u)
        if self.opts.debug and not np.isfinite(u).all():
            raise FloatingPointError(
                f"solution contains NaN/Inf after {res.iters} iterations "
                f"(init_res={float(res.init_res):.3e}); residual history: "
                f"{res.history[:res.iters + 1].cpu().numpy()}")
        return u, res

    def solve_pCG(self, **kw):
        return self._run(_solvers.solve_pCG, **kw)

    def solve(self, **kw):
        return self._run(_solvers.solve, **kw)

    def solve_CG(self, **kw):
        return self._run(_solvers.solve_CG, **kw)

    def solve_smoother(self, **kw):
        return self._run(_solvers.solve_smoother, **kw)

    def solve_GMRES(self, **kw):
        return self._run(_solvers.solve_GMRES, **kw)

    def solve_pGMRES(self, **kw):
        kw.setdefault("precondition", True)
        return self._run(_solvers.solve_GMRES, **kw)

    # ---- lazy updates (ref saena.hpp:236-241, saena_object_lazy.cpp) ----

    def _strip_boundary(self, csr):
        """Apply set_matrix's boundary removal to an updated matrix: the
        stored interior / boundary index sets (pattern-only, so a
        same-pattern refresh keeps them) cut the new full matrix down to
        the interior system, and the boundary diagonal takes the new
        values (u_b = rhs_b / diag_b), on the host and on the device."""
        io = self._io
        if io.split is None or csr.shape[0] != io.n_full:
            return csr   # no split, or the caller passed an interior-sized matrix
        interior, bound, _ = io.split
        io.set_bound_diag(csr.diagonal()[bound])
        return csr[interior][:, interior].tocsr()

    def _check_updatable(self) -> None:
        if self.info is None:
            raise ValueError("set_matrix() first")
        if self.opts.scale:
            # the host levels hold the scaled operator: an unscaled update
            # would mix two systems in one hierarchy
            raise NotImplementedError(
                "lazy updates of a hierarchy built with Options(scale=True)")

    # Under a torch profiler an update is the span saena.update; in it each
    # level's Galerkin product is saena.update.galerkin (and the phase
    # saena.setup.galerkin), and the device rebuild saena.update.devicify.
    # The new SetupInfo's phases and phase_spans are the update's: one
    # "galerkin" a level (update2, update3), "devicify" around the rebuild
    # and the rebuild's own phases; SetupInfo.reuse says how each level
    # was rebuilt.

    def update1(self, A_new: Matrix) -> "AMG":
        """Replace only the finest level's values (same pattern)."""
        self._check_updatable()
        with span("saena.update"):
            old = self._snapshot()
            self.info.csr_levels[0] = self._strip_boundary(A_new.csr)
            self._redevicify(old)
        return self

    def update2(self, A_new: Matrix) -> "AMG":
        """Recompute every coarse operator through the existing P/R."""
        self._check_updatable()
        with span("saena.update"):
            old = self._snapshot()
            timer = PhaseTimer()
            levels = [self._strip_boundary(A_new.csr)]
            for l, (P, R) in enumerate(zip(self.info.Ps, self.info.Rs)):
                with span("saena.update.galerkin"), timer.phase("galerkin"):
                    Ac = galerkin_product(R, levels[-1], P, device=self.device,
                                          timer=timer, level=l)
                    thre = filter_threshold(
                        l + 1, self.opts.filter_thre, self.opts.filter_max,
                        self.opts.filter_start, self.opts.filter_rate)
                    levels.append(filter_lump(Ac, thre))
            self.info.csr_levels = levels
            self._redevicify(old, timer)
        return self

    def update3(self, A_new: Matrix) -> "AMG":
        """Diff-propagating update (ref saena_object_lazy.cpp:1169-2316,
        local_diff + compute_coarsen_update_Ac): the sparse delta D =
        A_new - A_old goes through the existing transfers, Ac += R D P on
        every level. Falls back to update2 when the shape changed or the
        diff holds more than 25% of A's nonzeros. As in the reference, the
        per-level filter is not applied again to the propagated diff."""
        self._check_updatable()
        with span("saena.update"):
            snap = self._snapshot()
            old = self.info.csr_levels[0]
            csr = self._strip_boundary(A_new.csr)
            if old.shape != csr.shape:
                return self.update2(A_new)
            D = (csr - old).tocsr()
            D.eliminate_zeros()
            if D.nnz == 0:
                return self
            if D.nnz > 0.25 * max(1, csr.nnz):
                return self.update2(A_new)
            timer = PhaseTimer()
            levels = [csr]
            for l, (P, R, Ac_old) in enumerate(zip(
                    self.info.Ps, self.info.Rs, self.info.csr_levels[1:])):
                with span("saena.update.galerkin"), timer.phase("galerkin"):
                    D = (R @ D @ P).tocsr()
                    Ac = (Ac_old + D).tocsr()
                    Ac.sort_indices()
                    levels.append(Ac)
            self.info.csr_levels = levels
            self._redevicify(snap, timer)
        return self

    def _snapshot(self):
        """(hierarchy, csrs, Ps, Rs) before an update changes info: the
        reuse baseline of devicify's lazy path."""
        return (self.hierarchy, list(self.info.csr_levels),
                list(self.info.Ps), list(self.info.Rs))

    def _redevicify(self, old, timer: Optional[PhaseTimer] = None) -> None:
        """Rebuild the device levels after a host-CSR refresh, reusing what
        the refresh left unchanged (devicify's ``reuse``): an update1
        uploads one level's values instead of running each level's Lanczos
        and strip planning again. ``timer`` holds the update's phases so
        far."""
        timer = timer or PhaseTimer()
        # devicify hands out timer.seconds and timer.spans themselves, so
        # the "devicify" phase, closed after it returns, is in them too
        with span("saena.update.devicify"), timer.phase("devicify"):
            self.hierarchy, info = _hier.devicify(
                self.info.csr_levels, self.info.Ps, self.info.Rs, self.opts,
                dtype=self.dtype, device=self.device, reuse=old, timer=timer)
        info.thetas, info.coarsen_kinds = self.info.thetas, self.info.coarsen_kinds
        info.comm, info.n_shards = self.info.comm, self.info.n_shards
        self.info = info

    def matrix_diff(self, A: Matrix, B: Matrix) -> float:
        """Largest absolute entry of A - B."""
        d = A.csr - B.csr
        return float(np.abs(d.data).max()) if d.nnz else 0.0

    def matmat(self, A: Matrix, B: Matrix, mesh=None, mode: str = "auto",
               dtype=None) -> Matrix:
        """The product A B (ref saena::amg::matmat, saena.cpp:~930 ->
        setup_matmat.cpp:1164-1487), assembled on this AMG's device at
        ``dtype`` (this AMG's unless named).

        With ``mesh`` (a ``parallel.comm.Mesh``) the product runs on the
        mesh's rings at ``dtype``: the dense ring or the block-sparse ring,
        picked by operand density like the reference's matmat_thre1 switch
        (``mode`` forces "dense" / "sparse"; ops/spgemm.matmat). Without a
        mesh it is the host scipy product."""
        dt = dtype or self.dtype
        C = Matrix()
        if mesh is not None:
            from saena_tpu_torch.ops.spgemm import matmat as device_matmat

            C.set_csr(device_matmat(A.csr, B.csr, mesh, dtype=dt, mode=mode).tocsr())
        else:
            C.set_csr((A.csr @ B.csr).tocsr())
        C.assemble(device=self.device, dtype=dt)
        return C

    # ---- profiling (ref profile_matvecs, print_vcycle_time,
    # solve_pCG_profile; saena_tpu/api.py:374-421) ----

    def _hierarchy(self) -> _hier.Hierarchy:
        if self.hierarchy is None:
            raise ValueError("set_matrix() first")
        return self.hierarchy

    def profile_matvecs(self, n_iter: int = 20):
        """Per-level matvec times (profiling.profile_matvecs)."""
        from saena_tpu_torch.profiling import profile_matvecs

        return profile_matvecs(self._hierarchy(), n_iter=n_iter)

    def profile_matvecs_breakdown(self, n_iter: int = 20):
        """The V-cycle's component times (profiling.vcycle_breakdown) on a
        rhs of ones."""
        from saena_tpu_torch.profiling import vcycle_breakdown

        H = self._hierarchy()
        rhs = np.zeros(H.n_pad)
        rhs[: H.n] = 1.0
        return vcycle_breakdown(H, self.params, rhs, n_iter=n_iter)

    def profile_trace(self, logdir: str, **kw):
        """One pCG solve under torch.profiler (the card's activity with the
        host's), its Chrome trace written to ``logdir/solve_pCG.trace.json``
        (open it in Perfetto or chrome://tracing; the span "solve_pCG"
        holds the solve, ``profiling.device_busy`` reads the device's busy
        and idle share in it). Returns (u, SolveResult)."""
        from saena_tpu_torch.profiling import trace

        out, _ = trace(lambda: self.solve_pCG(**kw), logdir, "solve_pCG",
                       self.device)
        return out

    def solve_pCG_profile(self, **kw):
        """A pCG solve and its phase report (ref solve_pCG_profile,
        saena_object_solve.cpp:2804-3597): (u, SolveResult, breakdown),
        the breakdown being profile_matvecs_breakdown's with
        ``pcg_phases``, the pCG iteration's split (profiling.pcg_profile)."""
        from saena_tpu_torch.profiling import pcg_profile

        u, res = self.solve_pCG(**kw)
        bd = self.profile_matvecs_breakdown(n_iter=5)
        bd["pcg_phases"] = pcg_profile(self.hierarchy, self.params, n_iter=5)
        return u, res, bd

    # ---- setters (ref saena.hpp:236-265; saena_tpu/api.py:423-468) ----

    def set_verbose(self, v: bool) -> None:
        self.verbose = v

    def set_multigrid_max_level(self, n: int) -> None:
        self.opts.max_level = n

    def set_scale(self, s: bool) -> None:
        self.opts.scale = s

    def set_sample_sz_percent(self, p: float) -> None:
        self.opts.sample_sz_percent = p

    def switch_to_dense(self, b: bool) -> None:
        self.opts.switch_to_dense = b

    def set_dense_threshold(self, thre: float, sz: int) -> None:
        self.opts.dense_thre = thre
        self.opts.dense_sz_thre = sz

    def set_shrink_levels(self, levels) -> None:
        """Which levels may shrink their device subset (ref
        set_shrink_levels); read by parallel/sharded.shard_hierarchy."""
        self.opts.shrink_levels = tuple(bool(b) for b in levels)

    def set_shrink_values(self, values) -> None:
        """Per-level divisors of the device count (ref set_shrink_values);
        read by parallel/sharded.shard_hierarchy."""
        self.opts.shrink_values = tuple(int(v) for v in values)

    def switch_repart(self, val: bool = True) -> None:
        """The density-triggered equi-row partition switch (ref
        switch_repart, saena.cpp:717); read by the row splits of
        parallel/sharded.shard_hierarchy."""
        self.opts.switch_repart = bool(val)

    def set_repart_thre(self, thre: float) -> None:
        """Density threshold of the equi-row switch (ref set_repart_thre);
        read by the row splits of parallel/sharded.shard_hierarchy."""
        self.opts.repart_thre = float(thre)

    def destroy(self) -> None:
        self.hierarchy = None
        self.info = None
        self._io = None
