"""Row-sharded matrices and the sharded AMG solve, ported from
saena_tpu/parallel/sharded.py.

The design follows the JAX package's re-design of the reference's
distributed layer:

- 1-D row partition (saena_matrix.h split[]) -> an nnz-balanced ``split``
  and a blocked-padded vector layout over a ``comm.Mesh``.
- Halo-exchange SpMV (saena_matrix_matvec.cpp:9-113) -> ``ShardedEll``,
  ``ShardedBsr``, ``ShardedStrip8``: a static gather-pack, one
  ``all_to_all`` and a local gather SpMV over the extended vector
  (halo.py); ``ShardedDia`` for stencils, whose halo is two contiguous
  slabs moved by ``ppermute``; ``ShardedDense``, a ring of ``ppermute``
  steps (saena_matrix_dense.cpp:181-260).
- Processor shrinking (saena_matrix_shrink.cpp) -> levels whose halo
  dominates their work re-balance over a halved subset of the shards
  (the rest hold zero rows), by the static ratio, a measurement, or
  Options.shrink_values; levels below ``replicate_threshold`` form a
  replicated tail that runs the serial levels (amg/hierarchy.devicify).
- repart_u / repart_back_u (grid.cpp:3-163) -> the transition: the
  restriction is column-sharded, so the coarse residual is one ``psum``;
  the prolongation reads the replicated correction directly.
- Distributed dots -> local dots and one ``psum``.

Every sharded tensor is stacked ``(k, ...)`` over this process's k shards
(comm.py). Per-shard work is batched over that axis where it is a plain
torch op (the ELL gather, the BSR block products, the dense panels); the two
kernels on this path run one shard at a time: K1 (ops/dia_spmv.py) on a
``ShardedDia`` shard's halo-extended block in rectangular mode, K3
(ops/strip8_spmv.py) on a ``ShardedStrip8`` shard's tiles. A shard that
holds no rows (a shrunk level's inactive shards) launches nothing: every
vector is zero there, the invariant the ``psum`` dots rely on, so its block
of a product is zero.

The solve (``sharded_solve_pCG``) is an ``amg.graphs.Loop`` like the serial
pCG: on the card its iteration body, halo exchanges and replicated tail
included, replays as CUDA graphs; on the CPU the body runs directly. It is
the counterpart of the JAX package's one ``shard_map`` region per solve.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch.amg import graphs as _g
from saena_tpu_torch.amg.cycles import vcycle as serial_vcycle
from saena_tpu_torch.amg.eig import eig_max_invdiag_host
from saena_tpu_torch.amg.hierarchy import Hierarchy, SolveParams, devicify
from saena_tpu_torch.amg.smoothers import smooth, smooth_operator
from saena_tpu_torch.config import Options
from saena_tpu_torch.ops import dia_spmv as _dia
from saena_tpu_torch.ops import strip8_spmv as _s8
from saena_tpu_torch.ops.formats import (
    BSR_STREAM_BPS,
    BSR_TIME_FACTOR,
    GATHER_MAX_BYTES,
    GATHER_MAX_BYTES_PER_NNZ,
    dia_offsets_of,
    pad_to,
    to_device,
)
from saena_tpu_torch.ops.ell_spmv import spill_segments, spill_sums
from saena_tpu_torch.parallel.comm import Mesh, make_mesh  # noqa: F401 (the JAX module has make_mesh)
from saena_tpu_torch.parallel.halo import (
    HaloPlan,
    build_halo_plan,
    int8_block_decode,
    int8_block_encode,
    plan_on,
    wire_dtype,
)
from saena_tpu_torch.parallel.partition import nnz_balanced_split, subset_split
from saena_tpu_torch.runtime import resolve_dtype


def _local(mesh: Mesh, arr: np.ndarray, dtype=None) -> torch.Tensor:
    """This process's shards of a host array of all D, on the mesh's
    device: values at ``dtype``, else indices as int64."""
    part = arr[mesh.local]
    if dtype is None:
        return torch.from_numpy(np.array(part, dtype=np.int64)).to(mesh.device)
    return to_device(part, dtype, mesh.device)


def _int32(mesh: Mesh, arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr[mesh.local], dtype=np.int32)).to(mesh.device)


def _gather(ext: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ext[d][idx[d]] for a stacked ext (k, L), or ext[idx] for one vector
    shared by every shard."""
    if ext.dim() == 1:
        return ext[idx]
    k = idx.shape[0]
    return torch.gather(ext, 1, idx.reshape(k, -1)).reshape(idx.shape)


# ---------------------------------------------------------------------------
# sharded formats
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedEll:
    """Row-sharded slot-major ELL, columns remapped into each shard's
    extended space (plan.extend), with a COO spill for rows longer than the
    quantile width. ``reduce_rows``: the rows are replicated over the shards
    (a column-sharded restriction) and the product is psum-reduced."""

    cols: torch.Tensor                 # (k, width, n_rows_pad) int64
    vals: torch.Tensor                 # (k, width, n_rows_pad)
    plan: HaloPlan
    spill_rows: Optional[torch.Tensor] = None   # (k, S) int64 local rows
    spill_cols: Optional[torch.Tensor] = None   # (k, S) int64 extended cols
    spill_vals: Optional[torch.Tensor] = None   # (k, S)
    shape: tuple = (0, 0)              # logical global (n_rows, n_cols)
    nnz: int = 0
    reduce_rows: bool = False

    def __post_init__(self):
        # the spill summed row by row in a fixed order, then added once to
        # each row (ell_spmv.spill_segments): a scatter of the triples would
        # add a row's entries with atomics in no fixed order on the card
        seg = None
        if self.spill_rows is not None and self.spill_rows.shape[-1]:
            seg_rows, seg_idx = spill_segments(self.spill_rows.cpu().numpy())
            dev = self.spill_rows.device
            seg = (torch.from_numpy(seg_rows).to(dev), torch.from_numpy(seg_idx).to(dev))
        object.__setattr__(self, "_seg", seg)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def mesh(self) -> Mesh:
        return self.plan.mesh

    def astype(self, dtype) -> "ShardedEll":
        return dataclasses.replace(
            self, vals=self.vals.to(dtype),
            spill_vals=None if self.spill_vals is None else self.spill_vals.to(dtype))

    def matvec(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        """x: this process's blocks of the column space (k, n_cols_loc_pad),
        or a vector shared by every shard in direct mode. Returns the row
        blocks (k, n_rows_pad), or the replicated product when
        reduce_rows."""
        ext = self.plan.extend(x.to(self.dtype), exact=exact)
        y = (self.vals * _gather(ext, self.cols)).sum(1)
        if self._seg is not None:
            seg_rows, seg_idx = self._seg
            prod = self.spill_vals * _gather(ext, self.spill_cols)
            y.scatter_add_(1, seg_rows, spill_sums(prod, seg_idx))
        if self.reduce_rows:
            y = self.mesh.psum(y)
        return y


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBsr:
    """Row-sharded (8, 128)-block BSR with a chunk-granular halo: bcols
    index the extended chunk space [local chunks | halo chunks] built by
    plan.extend_chunks; halos move as whole 128-value chunks."""

    blocks: torch.Tensor               # (k, n_br, W, 8, 128)
    bcols: torch.Tensor                # (k, n_br, W) int64, extended chunk ids
    plan: HaloPlan
    shape: tuple = (0, 0)
    nnz: int = 0

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def mesh(self) -> Mesh:
        return self.plan.mesh

    def astype(self, dtype) -> "ShardedBsr":
        return dataclasses.replace(self, blocks=self.blocks.to(dtype))

    def matvec(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        ext = self.plan.extend_chunks(x.to(self.dtype), exact=exact)
        if ext.dim() == 2:                                     # shared
            g = ext[self.bcols]
        else:
            k, C = ext.shape[:2]
            off = torch.arange(k, device=ext.device).view(k, 1, 1) * C
            g = ext.reshape(-1, 128)[self.bcols + off]         # (k, n_br, W, 128)
        y = torch.einsum("drwik,drwk->dri", self.blocks, g)
        return y.reshape(y.shape[0], -1)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedStrip8:
    """Row-sharded strip8 gather SpMV: each shard holds its row block's
    tiles with lane indices into its extended x ([local | halo], the plan of
    ShardedEll). All shards share one (perrow, mode, n_tiles) geometry.
    ``views`` are the per-shard ``Strip8Matrix``s K3 runs on, each with its
    own real-tile list and work tables (its padding tiles dropped), None
    for a shard with no tiles."""

    idx: torch.Tensor                  # (k, n_tiles, 8, 128) int8
    vals: torch.Tensor                 # (k, n_tiles, 8, 128)
    strips: torch.Tensor               # (k, n_tiles[*8]) int32
    gather_idx: torch.Tensor           # (k, n_rb, t_max) int32
    plan: HaloPlan
    shape: tuple = (0, 0)
    nnz: int = 0
    perrow: int = 1
    mode: str = "general"
    n_cols_pad: int = 0                # 128-multiple extended-x length
    n_out: int = 0                     # per-shard padded row count
    views: tuple = dataclasses.field(default=(), init=False, repr=False)

    def __post_init__(self):
        views = []
        for d in range(self.idx.shape[0]):
            gi = self.gather_idx[d]
            if not bool((gi < self.idx.shape[1]).any()):
                views.append(None)
                continue
            views.append(_s8.Strip8Matrix(
                self.idx[d], self.vals[d], self.strips[d], gi,
                shape=(self.n_out, self.n_cols_pad), nnz=self.nnz,
                perrow=self.perrow, mode=self.mode, n_cols_pad=self.n_cols_pad,
                n_out=self.n_out, shard=self.mesh.lo + d))
        object.__setattr__(self, "views", tuple(views))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def mesh(self) -> Mesh:
        return self.plan.mesh

    def astype(self, dtype) -> "ShardedStrip8":
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def matvec(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        cdt = _dia.compute_dtype(self.dtype)
        ext = self.plan.extend(x.to(cdt), exact=exact)
        ext = torch.nn.functional.pad(ext, (0, self.n_cols_pad - ext.shape[-1]))
        ys = []
        for d, M in enumerate(self.views):
            if M is None:
                ys.append(ext.new_zeros(self.n_out))
                continue
            y = _s8.strip8_spmv(M, ext if ext.dim() == 1 else ext[d])
            ys.append(y[: self.n_out])
        return torch.stack(ys)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedDia:
    """Row-sharded DIA over a 128-aligned EQUAL row split: every active
    shard owns n_loc rows, the blocked-padded global vector is the real one
    and the offsets are the same in every block. The halo is two contiguous
    slabs, the left neighbour's tail and the right one's head, moved by one
    ppermute each (up to k chained hops when a slab is wider than a block).
    Each shard's block is a rectangular DIA over [left | own | right]: K1
    with len(x) > n_loc, and the fused update with x_row0 = lo_pad / 128."""

    data: torch.Tensor                 # (k, ndiag, n_loc)
    mesh: Mesh
    shape: tuple = (0, 0)              # logical global (n, n)
    nnz: int = 0
    offsets: tuple = ()                # GLOBAL diagonal offsets
    n_loc: int = 0                     # rows of a shard, a multiple of 128
    lo_pad: int = 0                    # left halo slab, a multiple of 128
    hi_pad: int = 0                    # right halo slab, a multiple of 128
    compress: str = ""

    def __post_init__(self):
        ext = tuple(int(o) + self.lo_pad for o in self.offsets)
        plan = None
        if self.data.device.type == "cuda":
            plan = _dia.dia_plan(ext, self.n_loc, self.data.dtype,
                                 _dia.sm_count(self.data.device))
            ext = plan.offsets
        n_active = -(-self.shape[0] // self.n_loc)
        for name, v in (("ext_offsets", ext), ("plan", plan),
                        ("offsets_dev", torch.tensor(ext, dtype=torch.int64,
                                                     device=self.data.device)),
                        ("active", tuple(g < n_active for g in self.mesh.shard_ids()))):
            object.__setattr__(self, name, v)

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "ShardedDia":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def _extend(self, x: torch.Tensor, exact: bool) -> torch.Tensor:
        """[left slab | x | right slab] per shard; shards at the domain's
        ends receive zeros beyond it, keeping the zero padding."""
        D = self.mesh.size

        def xfer(v, perm):
            # one hop; slabs and blocks are 128-multiples, so the int8_block
            # codec applies, and its power-of-2 scales make re-encoding on
            # the next hop exact
            if self.compress == "int8_block" and not exact:
                return int8_block_decode(
                    self.mesh.ppermute(int8_block_encode(v), perm), x.dtype)
            if self.compress and not exact:
                v = v.to(wire_dtype(self.compress))
            return self.mesh.ppermute(v, perm).to(x.dtype)

        def hops(send, perm, k, take_tail):
            blocks = []
            for _ in range(k):
                send = xfer(send, perm)
                blocks.append(send)
            if k == 1:
                return blocks[0]
            cat = torch.cat(blocks[::-1] if take_tail else blocks, dim=1)
            return cat[:, -self.lo_pad:] if take_tail else cat[:, : self.hi_pad]

        parts = []
        if self.lo_pad:
            k = -(-self.lo_pad // self.n_loc)
            send = x[:, -self.lo_pad:] if k == 1 else x
            parts.append(hops(send, [(j, j + 1) for j in range(D - 1)], k, True))
        parts.append(x)
        if self.hi_pad:
            k = -(-self.hi_pad // self.n_loc)
            send = x[:, : self.hi_pad] if k == 1 else x
            parts.append(hops(send, [(j, j - 1) for j in range(1, D)], k, False))
        return torch.cat(parts, dim=1) if len(parts) > 1 else x

    def _per_shard(self, ext, **kw) -> torch.Tensor:
        ys = []
        for d, on in enumerate(self.active):
            if not on:
                ys.append(ext.new_zeros(self.n_loc))
                continue
            sk = {k: (v[d] if isinstance(v, torch.Tensor) else v)
                  for k, v in kw.items()}
            ys.append(_dia.dia_spmv(self.data[d], ext[d], self.ext_offsets,
                                    offsets_dev=self.offsets_dev, plan=self.plan,
                                    **sk))
        return torch.stack(ys)

    def matvec(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        """A x at the compute dtype promote(dtype, f32): a bf16 twin reduces
        only the streamed diagonals."""
        cdt = _dia.compute_dtype(self.dtype)
        return self._per_shard(self._extend(x.to(cdt), exact))

    def fused_update(self, x, rhs, dinv=None, c: float = 1.0,
                     add_x: bool = True) -> torch.Tensor:
        """[x +] c * [dinv *] (rhs - A x), the halo exchange in front of K1's
        one-pass update (the preconditioner's path: the lossy halo is
        allowed)."""
        cdt = _dia.compute_dtype(self.dtype)
        x = x.to(cdt)
        return self._per_shard(
            self._extend(x, False), rhs=rhs.to(cdt),
            dinv=None if dinv is None else dinv.to(cdt), c=c, add_x=add_x,
            x_row0=self.lo_pad // 128)


def _ring_panels(data: torch.Tensor, ids) -> torch.Tensor:
    """Dense row blocks (k, n, D * n) over the blocked-padded columns,
    reordered so that column panel s of shard d is the original panel
    (d + s) % D: the panel ring step s multiplies."""
    k, n, Dn = data.shape
    D = Dn // n
    ids = torch.as_tensor(list(ids), device=data.device)
    order = (ids[:, None] + torch.arange(D, device=data.device)[None, :]) % D
    blk = data.reshape(k, n, D, n)
    out = blk[torch.arange(k, device=data.device)[:, None], :, order, :]
    return out.permute(0, 2, 1, 3).reshape(k, n, Dn)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedDense:
    """Row-sharded dense block with a ring matvec: x blocks rotate around
    the mesh by ppermute while each shard multiplies its matching column
    panel (saena_matrix_dense.cpp:181-260). ``panels`` hold each shard's
    row block with its column panels in ring order (``_ring_panels``).
    ``compress``: the rotating block rides that wire ("int8_block" coded
    once, exact from then on; a float name cast), the own panel exact, as
    the reference's matvec_comp (saena_matrix_dense.cpp:262 ff.);
    preconditioner only."""

    panels: torch.Tensor               # (k, n_loc_pad, D * n_loc_pad)
    mesh: Mesh
    shape: tuple = (0, 0)
    nnz: int = 0
    compress: str = ""

    @property
    def dtype(self):
        return self.panels.dtype

    def astype(self, dtype) -> "ShardedDense":
        return dataclasses.replace(self, panels=self.panels.to(dtype))

    def matvec(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        D, n = self.mesh.size, x.shape[1]
        x = x.to(self.dtype)
        comp = self.compress if not exact else ""
        if comp == "int8_block":
            enc = lambda v: int8_block_encode(v.to(torch.float32))
            dec = lambda b: int8_block_decode(b, self.dtype)
        elif comp:
            enc = lambda v: v.to(wire_dtype(comp))
            dec = lambda b: b.to(self.dtype)
        else:
            enc = dec = lambda v: v
        perm = [(j, (j - 1) % D) for j in range(D)]
        y = torch.matmul(self.panels[:, :, :n], x[..., None])
        cur = enc(x)
        for s in range(1, D):
            cur = self.mesh.ppermute(cur, perm)
            y = y + torch.matmul(self.panels[:, :, s * n:(s + 1) * n],
                                 dec(cur)[..., None])
        return y[..., 0]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedLevel:
    """One sharded grid level (Grid over an active communicator); it has
    the fields the serial smoothers read (amg/smoothers.py)."""

    A: object                          # a Sharded* operator
    inv_diag: torch.Tensor             # (k, n_rows_pad), the vector dtype
    R_next: Optional[object]           # to level lvl + 1 (None on the last)
    P_next: Optional[object]
    # the smoothers' reduced-precision twin (Options.smooth_dtype); pCG's
    # outer matvec uses A with exact=True
    A_smooth: Optional[object] = None
    n: int = 0
    lvl: int = 0
    eig_max: Optional[float] = None

    @property
    def dtype(self):
        return self.inv_diag.dtype


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedHierarchy:
    sharded: tuple                     # ShardedLevel, ... (at least one)
    trans_R: Optional[ShardedEll]      # column-sharded: last sharded -> tail
    trans_P: Optional[ShardedEll]      # row-sharded, direct on the tail's vector
    replicated: Optional[Hierarchy]    # the serial tail, one per process
    mesh: Mesh
    d_active: tuple = ()               # active shards per sharded level
    # the solve's loops (amg/graphs.Loop) by (SolveParams, max_iter)
    graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.sharded[0].n

    @property
    def dtype(self):
        return self.sharded[0].dtype


# ---------------------------------------------------------------------------
# the sharded V-cycle and pCG
# ---------------------------------------------------------------------------


def pdot(mesh: Mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot of two sharded vectors: per-shard dots, then one psum."""
    return mesh.psum(torch.linalg.vecdot(a, b))


def sharded_vcycle(sh: ShardedHierarchy, params: SolveParams, u, rhs,
                   lvl: int = 0, u_is_zero: bool = True):
    """The V-cycle over the sharded levels and the replicated tail, as the
    serial one (amg/cycles.py), with the transition at the last sharded
    level: psum-reduced restriction, the serial V-cycle on the replicated
    coarse vector, collective-free prolongation."""
    level = sh.sharded[lvl]
    u = smooth(level, params, u, rhs, params.preSmooth, u_is_zero=u_is_zero)
    # vectors stay at u's dtype; reduced-precision levels reduce only the
    # matvec (ref float_level, saena_object.cpp:241-285). The fused form
    # c = -1 gives the same bits as A u - rhs
    A = smooth_operator(level)
    fu = getattr(A, "fused_update", None)
    if fu is not None and A.dtype == u.dtype:
        res = fu(u, rhs, c=-1.0, add_x=False)
    else:
        res = A.matvec(u).to(u.dtype) - rhs
    if lvl < len(sh.sharded) - 1:
        res_c = level.R_next.matvec(res).to(u.dtype)
        e_c = sharded_vcycle(sh, params, torch.zeros_like(res_c), res_c, lvl + 1)
        u = u - level.P_next.matvec(e_c).to(u.dtype)
    else:
        res_c = sh.trans_R.matvec(res).to(u.dtype)          # replicated
        e_c = serial_vcycle(sh.replicated, params, torch.zeros_like(res_c), res_c)
        u = u - sh.trans_P.matvec(e_c).to(u.dtype)
    return smooth(level, params, u, rhs, params.postSmooth)


def _sharded_pcg(sh: ShardedHierarchy, params: SolveParams, rhs, max_iter: int):
    """The sharded pCG as a graphs.Loop: the serial loop's body
    (amg/solvers._pcg) with sharded vectors, the sharded V-cycle and psum
    dots; saena_tpu/parallel/sharded.py:_pcg_body computes the same
    iterates."""
    A = sh.sharded[0].A
    mesh = sh.mesh
    k = params.residual_replace
    s = _g.new_state(rhs, max_iter, vectors=("u", "r", "rho", "p"),
                     scalars=("rr", "rz", "thr", "init_dot", "init_res",
                              "final_res"),
                     flags=("replaced",))

    def init():
        u = torch.zeros_like(s.rhs)
        r = A.matvec(u) - s.rhs
        init_dot = pdot(mesh, r, r)
        s.u.copy_(u)
        s.r.copy_(r)
        s.p.zero_()
        s.init_dot.copy_(init_dot)
        s.rr.copy_(init_dot)
        s.thr.copy_(init_dot * s.tol * s.tol)
        s.rz.fill_(1.0)
        s.replaced.fill_(True)                        # the first p is z
        _g.start(s, torch.sqrt(init_dot), init_dot >= s.thr)

    def step():
        go = s.go
        rho = sharded_vcycle(sh, params, torch.zeros_like(s.r), s.r)
        rz = pdot(mesh, s.r, rho)
        beta = torch.where(s.replaced, 0.0, rz / s.rz)
        p = rho + beta * s.p
        h = A.matvec(p, exact=True)       # the outer CG sees the exact operator
        alpha = rz / pdot(mesh, p, h)
        u = s.u - alpha * p
        r = s.r - alpha * h
        if k > 0:
            replaced = (s.i + 1) % k == 0
            r = torch.where(replaced, A.matvec(u, exact=True) - s.rhs, r)
        else:
            replaced = torch.zeros_like(s.replaced)
        rr = pdot(mesh, r, r)
        _g.keep(go, (s.rho, rho), (s.p, p), (s.u, u), (s.r, r), (s.rz, rz),
                (s.rr, rr), (s.replaced, replaced))
        _g.advance(s, go, torch.sqrt(rr), rr >= s.thr)

    def fini():
        s.init_res.copy_(torch.sqrt(s.init_dot))
        s.final_res.copy_(torch.sqrt(s.rr))

    return _g.Loop(s, init, step, fini, "sharded pCG")


# ---------------------------------------------------------------------------
# builders: host CSR -> sharded operators
# ---------------------------------------------------------------------------


def _ranges(counts: np.ndarray) -> np.ndarray:
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    return np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)


def _shard_csr_rows(A: sp.csr_matrix, split: np.ndarray, n_rows_pad: int,
                    width_quantile: float = 0.98):
    """Per-shard row blocks: (cols, vals, spill, rowcols, width), slot-major
    with one width for every shard, cut at the global row-nnz quantile;
    longer rows spill to per-shard COO triples."""
    D = len(split) - 1
    A = A.tocsr()
    nnz_per_row = np.diff(A.indptr)
    if nnz_per_row.size == 0 or A.nnz == 0:
        width = 1
    elif width_quantile >= 1.0:
        width = int(nnz_per_row.max())
    else:
        width = max(1, int(np.quantile(nnz_per_row, width_quantile)))
        if int(np.maximum(nnz_per_row - width, 0).sum()) > 0.1 * A.nnz:
            width = int(nnz_per_row.max())      # spill at most ~10% of nnz
    cols = np.zeros((D, width, n_rows_pad), dtype=np.int64)
    vals = np.zeros((D, width, n_rows_pad), dtype=np.float64)
    sp_r, sp_c, sp_v, rowcols = [], [], [], []
    for d in range(D):
        B = A[split[d]: split[d + 1]]
        nb = B.shape[0]
        cnt = np.diff(B.indptr)
        take = np.minimum(cnt, width)
        rows_idx = np.repeat(np.arange(nb), take)
        slot = _ranges(take)
        src = B.indptr[:-1].repeat(take) + slot
        cols[d, slot, rows_idx] = B.indices[src]
        vals[d, slot, rows_idx] = B.data[src]
        over = cnt - take
        s_src = (B.indptr[:-1] + take).repeat(over) + _ranges(over)
        sp_r.append(np.repeat(np.arange(nb), over).astype(np.int64))
        sp_c.append(B.indices[s_src].astype(np.int64))
        sp_v.append(B.data[s_src])
        rowcols.append(np.unique(B.indices))
    S = max(len(r) for r in sp_r) if sp_r else 0
    spill = None
    if S:
        srows = np.zeros((D, S), dtype=np.int64)
        scols = np.zeros((D, S), dtype=np.int64)
        svals = np.zeros((D, S), dtype=np.float64)
        for d in range(D):
            m = len(sp_r[d])
            srows[d, :m], scols[d, :m], svals[d, :m] = sp_r[d], sp_c[d], sp_v[d]
        spill = (srows, scols, svals)
    return cols, vals, spill, rowcols, width


def _remap_cols(cols: np.ndarray, vals: np.ndarray, remap) -> np.ndarray:
    """The per-shard global -> extended-local remap; padding slots (val 0)
    go to index 0."""
    out = np.zeros(cols.shape, dtype=np.int64)
    for d in range(cols.shape[0]):
        nz = vals[d] != 0
        if nz.any():
            out[d][nz] = remap(d, cols[d][nz])
    return out


def _build_sharded_ell(A: sp.csr_matrix, row_split, col_split, dtype, mode: str,
                       mesh: Mesh, compress: str = "",
                       reduce_rows: bool = False) -> ShardedEll:
    D = len(row_split) - 1
    n_rows_pad = pad_to(int(np.max(np.diff(row_split))) if D else 1)
    cols, vals, spill, rowcols, _ = _shard_csr_rows(A, row_split, n_rows_pad)
    send_idx, n_local, max_send, remap = build_halo_plan(
        rowcols, col_split, mode=mode, compress=compress)
    plan = plan_on(mesh, send_idx, n_local, max_send, mode, compress)
    sr = sc = sv = None
    if spill is not None:
        srows, scols, svals = spill
        sc = _local(mesh, _remap_cols(scols[:, None, :], svals[:, None, :],
                                      remap)[:, 0, :])
        sr, sv = _local(mesh, srows), _local(mesh, svals, dtype)
    return ShardedEll(
        cols=_local(mesh, _remap_cols(cols, vals, remap)),
        vals=_local(mesh, vals, dtype), plan=plan, spill_rows=sr,
        spill_cols=sc, spill_vals=sv, shape=A.shape, nnz=int(A.nnz),
        reduce_rows=reduce_rows)


def _bsr_layout(A: sp.csr_matrix, row_split, col_split):
    """Per-shard block maps of the chunk-granular BSR: (n_br, n_ch_loc, W,
    per-shard (blk, own, gch, br, uniq, inv, u_br, u_ch))."""
    D = len(row_split) - 1
    n_br = pad_to(int(np.max(np.diff(row_split)))) // 8
    n_ch_loc = pad_to(int(np.max(np.diff(col_split)))) // 128
    A = A.tocsr()
    dev, W = [], 1
    for d in range(D):
        blk = A[row_split[d]: row_split[d + 1]].tocoo()
        own = np.searchsorted(col_split, blk.col, side="right") - 1
        gch = own * n_ch_loc + (blk.col - col_split[own]) // 128
        br = blk.row // 8
        key = br.astype(np.int64) * (D * n_ch_loc) + gch
        uniq, inv = np.unique(key, return_inverse=True)
        u_br, u_ch = uniq // (D * n_ch_loc), uniq % (D * n_ch_loc)
        if uniq.size:
            W = max(W, int(np.bincount(u_br, minlength=n_br).max()))
        dev.append((blk, own, gch, br, uniq, inv, u_br, u_ch))
    return n_br, n_ch_loc, W, dev


def _build_sharded_bsr(A: sp.csr_matrix, row_split, col_split, dtype, mode: str,
                       mesh: Mesh, compress: str = "") -> ShardedBsr:
    """Row-sharded BSR with a chunk-granular halo plan."""
    D = len(row_split) - 1
    n_br, n_ch_loc, W, dev = _bsr_layout(A, row_split, col_split)
    needed = [np.unique(u_ch[(u_ch // n_ch_loc) != d])
              for d, (*_, u_ch) in enumerate(dev)]
    if mode == "allgather":
        max_send = 0
        send_idx = np.zeros((D, D, 1), dtype=np.int32)
    else:
        max_send = max(1, max((len(n) for n in needed), default=1))
        send_idx = np.zeros((D, D, max_send), dtype=np.int32)
        for d in range(D):
            for e in range(D):
                if e != d:
                    need = needed[d][needed[d] // n_ch_loc == e]
                    send_idx[e, d, : need.size] = need - e * n_ch_loc
    blocks = np.zeros((D, n_br, W, 8, 128))
    bcols = np.zeros((D, n_br, W), dtype=np.int64)
    for d in range(D):
        blk, own, gch, br, uniq, inv, u_br, u_ch = dev[d]
        if uniq.size == 0:
            continue
        # global chunk -> extended local chunk
        if mode == "allgather":
            ext = u_ch.astype(np.int64)
        else:
            ext = np.empty(uniq.size, dtype=np.int64)
            e_of = u_ch // n_ch_loc
            local = e_of == d
            ext[local] = u_ch[local] - d * n_ch_loc
            # needed[d] is sorted, so within owner e a chunk's rank among
            # e's needed chunks is its position past e's first
            pos = np.searchsorted(needed[d], u_ch[~local])
            first = np.searchsorted(needed[d], e_of[~local] * n_ch_loc)
            ext[~local] = n_ch_loc + e_of[~local] * max_send + (pos - first)
        counts = np.bincount(u_br, minlength=n_br)
        order = np.argsort(u_br, kind="stable")
        slot = np.empty(uniq.size, dtype=np.int64)
        slot[order] = np.arange(uniq.size) - (np.cumsum(counts) - counts)[u_br[order]]
        bcols[d, u_br, slot] = ext
        # offset within the owner's blocked-padded chunk (col % 128 would be
        # wrong where the owner's block does not start on a 128 boundary)
        in_chunk = (blk.col - col_split[own]) % 128
        blocks[d, u_br[inv], slot[inv], blk.row % 8, in_chunk] = blk.data
    plan = plan_on(mesh, send_idx, n_ch_loc * 128, max_send, mode, compress)
    return ShardedBsr(blocks=_local(mesh, blocks, dtype), bcols=_local(mesh, bcols),
                      plan=plan, shape=A.shape, nnz=int(A.nnz))


def _sharded_bsr_bytes(A: sp.csr_matrix, row_split, col_split, dtype) -> int:
    D = len(row_split) - 1
    n_br, _, W, _ = _bsr_layout(A, row_split, col_split)
    return D * n_br * W * 8 * 128 * torch.empty(0, dtype=dtype).element_size()


def _sharded_strip8_geometry(A: sp.csr_matrix, row_split, col_split, mode: str,
                             compress: str = ""):
    """Host prep shared by the sharded strip8 build and its cost: per-shard
    extended-local CSR blocks and the common (perrow, mode) of the least
    modelled time of the slowest shard (its padded tiles at the mode's H100
    ns per tile, ``strip8_spmv.STRIP8_NS_PER_TILE``). Returns None when no
    candidate plans."""
    D = len(row_split) - 1
    n_rows_pad = pad_to(int(np.max(np.diff(row_split))) if D else 1)
    A = A.tocsr()
    blocks = [A[row_split[d]: row_split[d + 1]] for d in range(D)]
    # compress shapes the geometry: int8_block pads max_send, which moves
    # every remote slot of the extended layout the tiles index into
    halo = build_halo_plan([np.unique(B.indices) for B in blocks], col_split,
                           mode=mode, compress=compress)
    send_idx, n_local, max_send, remap = halo
    if mode == "allgather":
        ext_len = D * n_local
    elif mode == "direct":
        ext_len = pad_to(A.shape[1])
    else:
        ext_len = n_local + D * max_send
    n_cols_pad = pad_to(ext_len)
    coos = []
    for d, B in enumerate(blocks):
        cols_ext = remap(d, B.indices) if B.nnz else np.zeros(0, dtype=np.int32)
        indptr = np.concatenate([B.indptr, np.full(n_rows_pad - B.shape[0],
                                                   B.indptr[-1], dtype=B.indptr.dtype)])
        Bx = sp.csr_matrix((B.data, cols_ext.astype(np.int64), indptr),
                           shape=(n_rows_pad, n_cols_pad))
        Bx.sort_indices()
        coos.append(Bx.tocoo())
    best = None
    for pr in _s8._PERROW8:
        for m8 in ("interval", "general"):
            plans, worst = [], 0
            for c in coos:
                p = _s8._plan8_one(c.row, c.col, n_rows_pad, n_cols_pad, pr, m8)
                if p is None:
                    plans = None
                    break
                plans.append(p)
                worst = max(worst, _s8._padded_tiles(p[3].shape[0]))
            if plans is None:
                continue
            cost = worst * _s8.STRIP8_NS_PER_TILE[m8]
            if best is None or cost < best[0]:
                best = (cost, pr, m8, plans, worst)
    if best is None:
        return None
    _, pr, m8, plans, worst = best
    return (coos, plans, halo, n_rows_pad, n_cols_pad, pr, m8, worst)


def sharded_strip8_time(A: sp.csr_matrix, row_split, col_split,
                        mode: str = "exchange") -> float:
    """Modelled seconds of a sharded strip8 matvec: the slowest shard's
    padded tiles at the H100 ns per tile; inf when not plannable."""
    geo = _sharded_strip8_geometry(A, row_split, col_split, mode)
    if geo is None:
        return float("inf")
    return geo[7] * _s8.STRIP8_NS_PER_TILE[geo[6]] * 1e-9


def _build_sharded_strip8(A, row_split, col_split, dtype, mode: str, mesh: Mesh,
                          compress: str = "") -> ShardedStrip8:
    geo = _sharded_strip8_geometry(A, row_split, col_split, mode, compress)
    if geo is None:
        raise ValueError("sharded strip8: no plannable layout")
    coos, plans, halo, n_rows_pad, n_cols_pad, pr, m8, _ = geo
    send_idx, n_local, max_send, _ = halo
    D = len(row_split) - 1
    Q = 128 // pr
    n_rb = n_rows_pad // Q
    n_tiles_pad = max(_s8._padded_tiles(p[3].shape[0]) for p in plans)
    t_max = max([1] + [int(p[4].max()) for p in plans if p[4].size])
    idx = np.zeros((D, n_tiles_pad, 8, 128), dtype=np.int8)
    vals = np.zeros((D, n_tiles_pad, 8, 128), dtype=np.float64)
    strips = np.zeros((D, n_tiles_pad if m8 == "interval" else n_tiles_pad * 8),
                      dtype=np.int32)
    gather_idx = np.full((D, n_rb, t_max), n_tiles_pad, dtype=np.int32)
    for d in range(D):
        coo = coos[d]
        e_tile, e_sub, e_krem, tile_strips, rb_tiles = plans[d][:5]
        n_tiles = tile_strips.shape[0]
        if n_tiles:
            strips[d, : tile_strips.size] = tile_strips.reshape(-1)
            lane = e_krem.astype(np.int64) * Q + coo.row % Q
            idx[d, e_tile, e_sub, lane] = coo.col % 128
            vals[d, e_tile, e_sub, lane] = coo.data
        off = np.cumsum(rb_tiles) - rb_tiles
        for t in range(t_max):
            m = rb_tiles > t
            gather_idx[d, m, t] = off[m] + t
    return ShardedStrip8(
        idx=torch.from_numpy(np.ascontiguousarray(idx[mesh.local])).to(mesh.device),
        vals=_local(mesh, vals, dtype), strips=_int32(mesh, strips),
        gather_idx=_int32(mesh, gather_idx),
        plan=plan_on(mesh, send_idx, n_local, max_send, mode, compress),
        shape=A.shape, nnz=int(A.nnz), perrow=pr, mode=m8,
        n_cols_pad=n_cols_pad, n_out=n_rows_pad)


def dia_takes(dtype, device) -> bool:
    """Whether a ShardedDia of ``dtype`` data is built for ``device``: on
    the card, every data dtype K1 takes (f32, bf16, f64); on the CPU, the
    JAX package's picks there (f32 and bf16 data; its VMEM budget, which
    the port does not carry, admits every shape the tests build)."""
    if torch.device(device).type == "cuda":
        return dtype in _dia._DTYPE_CODE
    return dtype in (torch.float32, torch.bfloat16)


def sharded_dia_plan(A: sp.csr_matrix, D: int, d_active: int, dtype, device,
                     dia_fill_thre: float = 0.3):
    """(split, n_loc, lo_pad, hi_pad, offsets) of a ShardedDia, or None: a
    square banded operator (at most 256 diagonals at fill >= dia_fill_thre),
    at least two active shards, halos within (d_active - 1) blocks (wider,
    the operator is effectively dense), and data K1 takes (``dia_takes``)."""
    n = A.shape[0]
    if A.shape[0] != A.shape[1] or A.nnz == 0 or d_active < 2:
        return None
    offs = dia_offsets_of(A)
    if offs.size > _dia.MAX_DIAGS or A.nnz / (offs.size * n) < dia_fill_thre:
        return None
    n_loc = pad_to(-(-n // d_active))
    lo_pad = pad_to(max(0, -int(offs.min())))
    hi_pad = pad_to(max(0, int(offs.max())))
    if max(lo_pad, hi_pad) > (d_active - 1) * n_loc or not dia_takes(dtype, device):
        return None
    split = np.minimum(np.arange(D + 1) * n_loc, n)
    split[d_active:] = n
    return split, n_loc, lo_pad, hi_pad, tuple(int(o) for o in offs)


def _build_sharded_dia(A: sp.csr_matrix, plan, dtype, mesh: Mesh,
                       compress: str = "") -> ShardedDia:
    """Per-shard DIA blocks: the equal 128-multiple block height makes the
    blocked-padded layout the real global vector, so data[d][k][i] =
    A[r0 + i, r0 + i + off_k]."""
    split, n_loc, lo_pad, hi_pad, offsets = plan
    coo = A.tocoo()
    k_of = np.searchsorted(np.asarray(offsets), coo.col.astype(np.int64) - coo.row)
    data = np.zeros((mesh.size, len(offsets), n_loc))
    np.add.at(data, (coo.row // n_loc, k_of, coo.row % n_loc), coo.data)
    return ShardedDia(data=_local(mesh, data, dtype), mesh=mesh, shape=A.shape,
                      nnz=int(A.nnz), offsets=offsets, n_loc=n_loc,
                      lo_pad=lo_pad, hi_pad=hi_pad, compress=compress)


def _sharded_operator(A, row_split, col_split, dtype, mode: str, mesh: Mesh,
                      compress: str = "", fmt: str = "auto"):
    """ShardedStrip8, ShardedBsr or ShardedEll of a sharded operator.
    "auto" on the card ranks strip8 against BSR by modelled matvec time with
    the port's H100 constants (ops/formats.py, ops/strip8_spmv.py); on the
    CPU it keeps ELL, as the JAX package does there."""
    if fmt == "strip8":
        return _build_sharded_strip8(A, row_split, col_split, dtype, mode, mesh,
                                     compress)
    use_bsr, use_s8 = fmt == "bsr", False
    if fmt == "auto" and mesh.device.type == "cuda" and A.nnz > 0:
        est = _sharded_bsr_bytes(A, row_split, col_split, dtype)
        bsr_ok = est <= GATHER_MAX_BYTES and est <= GATHER_MAX_BYTES_PER_NNZ * A.nnz
        t_bsr = (est / (len(row_split) - 1) / BSR_STREAM_BPS * BSR_TIME_FACTOR
                 if bsr_ok else float("inf"))
        use_s8 = sharded_strip8_time(A, row_split, col_split, mode) < t_bsr
        use_bsr = bsr_ok and not use_s8
    if use_s8:
        return _build_sharded_strip8(A, row_split, col_split, dtype, mode, mesh,
                                     compress)
    if use_bsr:
        return _build_sharded_bsr(A, row_split, col_split, dtype, mode, mesh,
                                  compress)
    return _build_sharded_ell(A, row_split, col_split, dtype, mode, mesh, compress)


def _build_sharded_dense(A: sp.csr_matrix, split: np.ndarray, dtype, mesh: Mesh,
                         compress: str = "") -> ShardedDense:
    """Dense row blocks over the blocked-padded columns (the reference's
    generate_dense_matrix), in ring order for the panel ring."""
    D = mesh.size
    n_loc_pad = pad_to(int(np.max(np.diff(split))))
    data = np.zeros((D, n_loc_pad, D * n_loc_pad))
    Ac = A.tocsr()
    for d in range(D):
        blk = Ac[split[d]: split[d + 1]].tocoo()
        own = np.searchsorted(split, blk.col, side="right") - 1
        data[d][blk.row, own * n_loc_pad + (blk.col - split[own])] = blk.data
    return ShardedDense(
        panels=_ring_panels(_local(mesh, data, dtype), mesh.shard_ids()),
        mesh=mesh, shape=A.shape, nnz=int(A.nnz), compress=compress)


def _col_sharded_restriction(R: sp.csr_matrix, fine_split: np.ndarray, dtype,
                             mesh: Mesh) -> ShardedEll:
    """R split by fine COLUMNS: shard d holds R[:, fine block d] over all
    coarse rows; the products psum to the replicated coarse vector."""
    D = len(fine_split) - 1
    n_c = R.shape[0]
    n_c_pad = pad_to(n_c)
    Rcsc = R.tocsc()
    pieces = [Rcsc[:, fine_split[d]: fine_split[d + 1]].tocsr() for d in range(D)]
    width = max([1] + [int(np.diff(p.indptr).max()) for p in pieces if p.nnz])
    cols = np.zeros((D, width, n_c_pad), dtype=np.int64)
    vals = np.zeros((D, width, n_c_pad), dtype=np.float64)
    for d, piece in enumerate(pieces):
        cnt = np.diff(piece.indptr)
        rows_idx = np.repeat(np.arange(n_c), cnt)
        slot = _ranges(cnt)
        cols[d, slot, rows_idx] = piece.indices      # local fine indices
        vals[d, slot, rows_idx] = piece.data
    plan = plan_on(mesh, np.zeros((D, D, 1), np.int32),
                   pad_to(int(np.max(np.diff(fine_split)))), 0, "direct")
    return ShardedEll(cols=_local(mesh, cols), vals=_local(mesh, vals, dtype),
                      plan=plan, shape=R.shape, nnz=int(R.nnz), reduce_rows=True)


# ---------------------------------------------------------------------------
# shrinking
# ---------------------------------------------------------------------------


def halo_comm_work_ratio(A: sp.csr_matrix, split: np.ndarray) -> float:
    """The static comm/compute model of one sharded level: the worst
    shard's halo volume (unique remote columns) over its local nnz, the
    counted stand-in for decide_shrinking's timed dummy matvecs
    (saena_matrix_shrink.cpp:3-65: comm > 2x compute -> shrink)."""
    A = A.tocsr()
    worst = 0.0
    for d in range(len(split) - 1):
        blk = A[split[d]: split[d + 1]]
        if blk.nnz:
            cols = np.unique(blk.indices)
            remote = np.sum((cols < split[d]) | (cols >= split[d + 1]))
            worst = max(worst, float(remote) / blk.nnz)
    return worst


def measured_shrink_time(A: sp.csr_matrix, split: np.ndarray, dtype, mode: str,
                         mesh: Mesh, n_iter: int = 24) -> float:
    """Seconds per sharded dummy matvec of ``A`` under ``split`` on the mesh,
    the measured leg of the shrink decision (decide_shrinking's
    matvec_dummy timing, saena_matrix_shrink.cpp:3-65, 455-531): a
    throwaway operator, a chain of n_iter matvecs after a warm one, CUDA
    events on the card and perf_counter on the CPU, the median of 3; over
    ranks, the slowest rank's."""
    Ash = _sharded_operator(A, split, split, dtype, mode, mesh)
    x = torch.ones(mesh.k, pad_to(int(np.max(np.diff(split)))), dtype=Ash.dtype,
                   device=mesh.device)

    def chain(n):
        v = x
        for _ in range(n):
            w = Ash.matvec(v)
            v = w / (1.0 + w.abs().max())
        return v

    chain(3)
    reps = []
    for _ in range(3):
        if mesh.device.type == "cuda":
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            chain(n_iter)
            e1.record()
            e1.synchronize()
            reps.append(e0.elapsed_time(e1) * 1e-3 / n_iter)
        else:
            t0 = time.perf_counter()
            chain(n_iter)
            reps.append((time.perf_counter() - t0) / n_iter)
    return mesh.pmax_host(max(1e-9, float(np.median(reps))))


# ---------------------------------------------------------------------------
# setup: a ShardedHierarchy from the host CSR hierarchy
# ---------------------------------------------------------------------------


def shard_hierarchy(info, opts: Options, mesh: Mesh, dtype=None,
                    eigs: Optional[list] = None, sharded_format: str = "auto"):
    """Partition the fine levels of a host hierarchy (``info``: a SetupInfo
    with csr_levels, Ps, Rs) over the mesh; levels with fewer rows than
    opts.replicate_threshold, or shrunk to one shard, form the replicated
    tail. ``sharded_format``: "auto", "ell", "bsr", "dia" or "strip8".
    Returns (ShardedHierarchy, splits)."""
    D = mesh.size
    dtype = resolve_dtype(dtype)
    low_dtype = getattr(torch, opts.low_dtype)
    csr_levels, Ps, Rs = info.csr_levels, info.Ps, info.Rs
    n_lv = len(csr_levels)

    def level_dtype(l):
        return low_dtype if opts.float_storage and l >= opts.float_level else dtype

    # Per-level splits with shard-subset shrinking (saena_matrix_shrink.cpp):
    # when a level's halo dominates its local work (decide_shrinking's comm
    # > 2x compute test, :3-65) the active shard count halves, the rows
    # re-balance over the leading shards and the rest hold zero rows
    # (shrink_cpu :167). Options.shrink_values / shrink_levels (ref
    # set_shrink_*) take precedence. Shrinking to one shard ends the sharded
    # levels: the replicated tail is the one-shard case (shrink_cpu_c).
    def may_shrink(l):
        return (not opts.shrink_levels or
                (l < len(opts.shrink_levels) and bool(opts.shrink_levels[l])))

    def manual_factor(l):
        if l < len(opts.shrink_values) and int(opts.shrink_values[l] or 0) > 1:
            return int(opts.shrink_values[l])
        return None

    def split_of(A, d):
        return subset_split(A, D, d, opts.repart_thre, opts.switch_repart)

    def by_ratio(A, d_act):
        if opts.shrink_comm_ratio > 0:
            while d_act > 1 and halo_comm_work_ratio(
                    A, split_of(A, d_act)) > opts.shrink_comm_ratio:
                d_act //= 2
        return d_act

    splits, d_active, dia_plans = [], [], []
    d_act = D
    for l, A in enumerate(csr_levels):
        if A.shape[0] < opts.replicate_threshold or l >= n_lv - 1:
            break
        if l > 0 and may_shrink(l):
            fac = manual_factor(l)
            if fac is not None:
                d_act = max(1, d_act // fac)
            elif opts.shrink_measure:
                # time a dummy sharded matvec at the current subset and at
                # half of it and keep the faster (the reference's
                # decide_shrinking); a failed measurement warns and takes
                # the static ratio
                try:
                    cands = [d_act] + ([d_act // 2] if d_act > 1 else [])
                    times = {d: measured_shrink_time(
                        A, split_of(A, d), level_dtype(l), opts.halo_mode, mesh)
                        for d in cands}
                    d_act = min(times, key=times.get)
                except (RuntimeError, ValueError) as e:
                    warnings.warn(f"measured shrinking of level {l} failed "
                                  f"({type(e).__name__}: {e}); the static "
                                  f"halo/work ratio decides", RuntimeWarning)
                    d_act = by_ratio(A, d_act)
            else:
                d_act = by_ratio(A, d_act)
            if d_act <= 1:
                break      # fully shrunk: the replicated tail from here down
        # banded levels take ShardedDia, on a 128-aligned EQUAL split over
        # the active shards; the others keep the nnz-balanced split
        plan = None
        if sharded_format in ("auto", "dia"):
            plan = sharded_dia_plan(A, D, d_act, level_dtype(l), mesh.device)
        dia_plans.append(plan)
        splits.append(plan[0] if plan is not None else split_of(A, d_act))
        d_active.append(d_act)
    if not splits:                      # always shard the finest level
        splits = [nnz_balanced_split(csr_levels[0], D, opts.repart_thre,
                                     opts.switch_repart)]
        d_active, dia_plans = [D], [None]
    n_sharded = len(splits)

    compress = opts.halo_dtype if opts.compress_halo else ""
    mode = opts.halo_mode

    def level_compress(l, dt):
        # float_level's reference semantics: levels >= it ship their halos
        # at low_dtype (matvec_sparse_float's vSend_f wire,
        # saena_matrix_matvec.cpp:448-520) while values keep the level
        # dtype; an explicit compress_halo wins; no wire that would not
        # shrink the payload
        if compress:
            return compress
        if l >= opts.float_level and low_dtype.itemsize < dt.itemsize:
            return opts.low_dtype
        return ""

    levels = []
    for l in range(n_sharded):
        A = csr_levels[l]
        dt = level_dtype(l)
        comp = level_compress(l, dt)
        density = A.nnz / max(1, A.shape[0] ** 2)
        if (opts.switch_to_dense and l > 0 and density > opts.dense_thre
                and A.shape[0] <= opts.dense_sz_thre):
            Ash = _build_sharded_dense(A, splits[l], dt, mesh, comp)
        elif dia_plans[l] is not None:
            Ash = _build_sharded_dia(A, dia_plans[l], dt, mesh, comp)
        else:
            Ash = _sharded_operator(A, splits[l], splits[l], dt, mode, mesh,
                                    comp, sharded_format)
        n_rows_pad = pad_to(int(np.max(np.diff(splits[l]))))
        inv_d = np.zeros((D, n_rows_pad))
        diag = A.diagonal()
        for d in range(D):
            blk = diag[splits[l][d]: splits[l][d + 1]]
            inv_d[d, : blk.size] = np.where(blk != 0, 1.0 / np.where(blk == 0, 1.0, blk), 0.0)
        eig = None
        if opts.smoother == "chebyshev":
            eig = (eigs[l] if eigs and l < len(eigs) and eigs[l] is not None
                   else float(eig_max_invdiag_host(A)))
        R_next = P_next = None
        if l + 1 < n_sharded:
            dt_next = level_dtype(l + 1)
            comp_next = level_compress(l + 1, dt_next)
            # R: rows on the coarse split, columns in the fine split's space;
            # P: rows on the fine split, columns in the coarse split's
            R_next = _sharded_operator(Rs[l], splits[l + 1], splits[l], dt_next,
                                       mode, mesh, comp_next, sharded_format)
            P_next = _sharded_operator(Ps[l], splits[l], splits[l + 1], dt_next,
                                       mode, mesh, comp_next, sharded_format)
        A_smooth = None
        if opts.smooth_dtype:
            sm_dt = getattr(torch, opts.smooth_dtype)
            # a ShardedDia keeps its twin only where K1 takes its dtype, as
            # the serial DIA does
            if sm_dt != dt and (not isinstance(Ash, ShardedDia)
                                or dia_takes(sm_dt, mesh.device)):
                A_smooth = Ash.astype(sm_dt)
        levels.append(ShardedLevel(
            A=Ash, inv_diag=_local(mesh, inv_d, dtype), R_next=R_next,
            P_next=P_next, A_smooth=A_smooth, n=A.shape[0], lvl=l, eig_max=eig))

    if n_sharded >= n_lv:
        raise NotImplementedError(
            "fully-sharded hierarchy without a replicated tail: lower "
            "replicate_threshold so at least the coarsest level replicates")
    lt = n_sharded - 1          # the transition uses the last sharded level's P/R
    dt_next = level_dtype(lt + 1)
    trans_R = _col_sharded_restriction(Rs[lt], splits[lt], dt_next, mesh)
    # P: rows on the fine split, the replicated correction read directly
    trans_P = _build_sharded_ell(Ps[lt], splits[lt], np.asarray([0, Ps[lt].shape[1]]),
                                 dt_next, "direct", mesh)
    tail_opts = dataclasses.replace(opts, float_level=max(0, opts.float_level - n_sharded))
    # the tail's vectors stay at the full dtype; its operators below
    # float_level are devicified reduced (matvec-only mixed precision)
    replicated, _ = devicify(csr_levels[n_sharded:], Ps[n_sharded:], Rs[n_sharded:],
                             tail_opts, dtype=dtype, device=mesh.device)
    return ShardedHierarchy(sharded=tuple(levels), trans_R=trans_R,
                            trans_P=trans_P, replicated=replicated, mesh=mesh,
                            d_active=tuple(d_active)), splits


# ---------------------------------------------------------------------------
# host-facing solve
# ---------------------------------------------------------------------------


def update_sharded_values(sh_old: ShardedHierarchy, info, opts: Options,
                          mesh: Mesh, dtype=None, sharded_format: str = "auto"):
    """Values-only refresh of a sharded hierarchy (the sharded leg of the
    lazy update): rebuilt from the updated host CSRs, keeping the old
    per-level eig estimates (same pattern, no new Lanczos). Returns
    (sh_new, splits)."""
    eigs = [lv.eig_max for lv in sh_old.sharded]
    return shard_hierarchy(info, opts, mesh, dtype=dtype, eigs=eigs,
                           sharded_format=sharded_format)


def blocked_pad_vector(v: np.ndarray, split: np.ndarray) -> np.ndarray:
    """A plain (n,) host vector -> blocked-padded (D, n_loc_pad)."""
    D = len(split) - 1
    out = np.zeros((D, pad_to(int(np.max(np.diff(split))))), dtype=v.dtype)
    for d in range(D):
        blk = v[split[d]: split[d + 1]]
        out[d, : blk.size] = blk
    return out


def unblock_vector(vb: np.ndarray, split: np.ndarray) -> np.ndarray:
    D = len(split) - 1
    return np.concatenate([vb[d, : split[d + 1] - split[d]] for d in range(D)])


def sharded_solve_pCG(sh: ShardedHierarchy, splits, rhs: np.ndarray, mesh: Mesh,
                      params: Optional[SolveParams] = None, tol: float = 1e-8,
                      max_iter: int = 100, graphs=None):
    """Host entry: the plain (n,) rhs in, (u, iters, ||r0||, ||r||,
    history) out, u plain (n,) on every rank. On the card the loop replays
    CUDA graphs (``graphs=None``) or runs uncaptured (``graphs=False``, what
    checks compare the graphs with); on the CPU it runs directly."""
    if mesh is not sh.mesh:
        raise ValueError("the mesh is not the hierarchy's")
    params = params or SolveParams()
    rhs_b = blocked_pad_vector(np.asarray(rhs, dtype=np.float64), splits[0])
    rhs_t = torch.as_tensor(rhs_b[mesh.local], device=mesh.device).to(sh.dtype)
    loop = sh.graphs.get((params, max_iter))
    if loop is None:                  # made at the first solve of these
        loop = sh.graphs[params, max_iter] = _sharded_pcg(sh, params, rhs_t, max_iter)
    s = loop.s
    s.rhs.copy_(rhs_t)
    s.tol.fill_(tol)
    if graphs is None:
        graphs = mesh.device.type == "cuda"
    iters = loop.run(graphs)
    u = unblock_vector(mesh.all_gather(s.u).cpu().numpy(), splits[0])
    return (u, iters, float(s.init_res), float(s.final_res),
            s.hist.cpu().numpy())

