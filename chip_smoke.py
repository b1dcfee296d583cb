#!/usr/bin/env python3
"""Smoke run of the saena_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. Card and build: the card's name and power limit, then an nvcc build of
   every CUDA kernel of the port from saena_tpu_torch/csrc/ (DIA, strip,
   strip8, ELL, the row-wise SpGEMM), all nvcc processes started together. Then the host levels of the
   48^3 Poisson interior (the poisson3d_48 golden's levels), whose operators
   give the kernels their main-path shapes. The native host kernels of the
   setup (saena_tpu_torch/_native, g++) must build and load.
2. Each kernel against its plain PyTorch version on the card, in f32, f64
   and with bf16 values (f32 x and sums; the worst error of each bf16 mode
   is printed). Tolerance: row-sum-scaled
   error (|kernel - plain| over the same expression evaluated on absolute
   values) <= 1e-5 for f32 and bf16 data, <= 1e-12 for f64; zero padding
   preserved exactly.
   - DIA: the 48^3 level-0 operator (7 diagonals), the wide-stencil level 1
     (101 diagonals), a wide-offset band, a 300-diagonal band (more than
     the tiled kernel takes by value) and a rectangular block with
     x_row0 > 0; plain SpMV, Jacobi sweep, Chebyshev scaled residual and
     V-cycle residual; in every configuration of the kernel's plan (its
     pick, x through L1, x staged in shared memory, the row kernel), two
     launches bit-equal and x, rhs and dinv given as views that are not
     16-byte aligned bit-equal to the aligned call.
   - strip: the level-0 tentative prolongator Pt as the planner builds it
     and the level-2 A at every perrow (1, 2, 4, 8, 16); some case must
     have krb > 1.
   - strip8: Pt^T of level 0 as the planner builds it, the level-2 A at
     every perrow (1, 2, 4) in general and in interval mode (the port's
     native planner) and a synthetic interval-mode layout whose last
     tile's strip base reaches past the last strip of x.
   - the sharded shapes: shard 1 of each ShardedDia level of the D = 4
     f64 sharded hierarchy of the host levels (K1 in rectangular mode: the
     shard's rows over its halo-extended x, x_row0 = lo_pad / 128), and
     shard 1 of the level-2 A in strip8 (K3 on a shard's tiles).
   - ELL (K4): a level-3-shaped operator (tests/test_torch_ell_spmv.py's
     ``level3_like``: 20,835 rows of 510-4,917 entries on a lattice, ELL
     width 4,044, its 32-row tiles reading 66.6 M of 84.4 M slots, as the
     96^3 Poisson level 3 reads 68.0 M of 84.2 M at width 4,037), the 48^3
     A with ten long rows (spill), a prolongator and a restrictor shape,
     and a block whose x outgrows shared memory and the L1; two launches
     bit-equal, the error a number within its tolerance.
   - row-wise SpGEMM (K5): both Galerkin products of every coarsening of
     the 48^3 host levels (A_l P_l, R_l W_l) against the host kernel
     (_native.spgemm_csr): equal indptr and indices, values equal as
     uint64, two launches bit-equal.
   - strip / strip8: an operator of one real pair / tile, and layouts cut into small
     chunks so that row blocks are cut (unit counts no multiple of the
     chunk). Every case runs on both paths of its kernel (rows and stream),
     twice, and with x a view that is not 16-byte aligned: the results must
     agree bit for bit, and the tickets must be left zero.
3. The main path on the card, each run's kernel launches counted by
   runtime.launches_of. The solves (pCG, solve, solve_smoother, solve_CG)
   replay CUDA graphs of their loop body, captured at a hierarchy's first
   solve; runtime.launches counts a replay's launches as the uncaptured
   loop makes them.
   (a) the 48^3 Poisson pCG solve through Matrix/AMG
       (Options(remove_boundary=True), so the default shard-parallel host
       setup) with the formats the port's picker chooses on the card. f64
       must reproduce the poisson3d_48 golden
       (tests/goldens/convergence.json: levels, iterations, residual history
       at rtol 1e-6) with wide DIA at level 1; f32 must reach rel_res < 1e-8
       within 100 iterations.
   (b) the same f64 solve on the same host levels, with the device formats
       chosen here by the port's own builders: every Pt in strip, every Pt^T
       in strip8 (inside SmoothedP/SmoothedR), the level-2 A in whichever of
       strip and strip8 the picker did not choose, and the level-3 A (dense
       in the picker's hierarchy) in ELL at the 0.98 quantile, so that K4
       runs on the main path. Same golden check.
   (c) the 48^3 setup on the card's host, default (setup_shards=-1, shard-
       parallel) and serial (setup_shards=0): wall seconds and phases, the
       shard count, the setup wire volume, whether the native library was
       used (it must be), and every host level, P and R of the two setups
       equal bit for bit.
   (d) the other entry points on the phase-(a) hierarchies, f64 and f32:
       solve and solve_pGMRES to 1e-8, solve_CG, solve_smoother and
       solve_GMRES(precondition=False) for 30 iterations; ms by CUDA events
       after a warm call, and the kernels' launches. The f64 runs are held
       against the port's own CPU f64 runs of the same entry points (a
       hierarchy devicified on the CPU from the same host levels): equal
       iteration counts, histories at rtol 1e-6.
   (e) lazy updates on the card, f64: update1 (A x 1.5), update2 (a shifted
       diagonal), update3 (three diagonal entries), a pCG solve after each,
       held against the same sequence on that CPU hierarchy (equal
       iterations, histories at rtol 1e-6); update1 must reuse every level
       below 0, the eig values and the coarse LU, and each solve after an
       update must capture its graphs anew.
   (f) the graph solves of (a) f64 and f32 and (b), each against the same
       loop run uncaptured on the card: equal iterations, history and u bit
       for bit, equal launches by kernel, path and K1 shape; the golden (f64)
       or rel_res < 1e-8 (f32); the first solve's capture ms. Then pCG with
       direct_solver="CG" (the coarsest CG inside the graph) against the CPU
       twin, the profiles of the f32 hierarchy (profile_matvecs,
       vcycle_breakdown per level, pcg_profile), and a capture
       with a host copy, which must raise GraphCaptureError naming the op
       while the card works on.
   (g) FGMRES(30) for 30 steps without a preconditioner and pFGMRES to
       1e-8 (f64, the phase-(a) hierarchy, a seeded rhs) through graphs
       (an Arnoldi step and a restart boundary each a graph), bit-equal to
       the same loop run uncaptured with its launches, equal iterations and
       histories at rtol 1e-6 against the CPU twin.
   (h) Options.smooth_dtype: f32 with bf16 twins (the card's picks), the
       same hierarchy forced as in (b) (the level-2 A's twin in strip, the
       level-3 A's in ELL), and
       f64 with f32 twins; each must reach 1e-8 within one iteration of the
       same solve without twins, and every kernel must launch with bf16
       values.
   (i) p-coarsening: A = kron(L, K), L the interior 3-D Poisson on 30^3
       units and K = E E^T / 5 + 2 I (E from --seed), set up on the card with
       modal_block_plevels(27000, 5): kinds p, p, p, then h; pCG in f64 to
       1e-8 against the CPU twin on the same host levels; setup seconds by
       phase.
   (j) rap="device" against rap="host" in the 48^3 f64 serial setup:
       equal level sizes, every level within 1e-11 of its max |A|, the
       golden's iterations both ways; rap seconds and block pairs.
   (k) the sharded solve (saena_tpu_torch/parallel/) on the same host
       levels, f64, in one process with every shard on the card: D = 1, 2,
       4 and 8 shards with the defaults (replicate_threshold 5000, the
       shrink_comm_ratio rule), each with the golden's iterations and the
       history at rtol 1e-6 against the serial graph solve of (a), its
       formats and active shards, its launches, the capture ms, and the
       graph solve against the same loop uncaptured (u and history bit for bit, equal launches);
       then at D = 4: sharded_format "ell", "bsr", "strip8" and "dia",
       halo_mode "allgather", compress_halo with a bf16 and an int8_block
       wire, shrink_values (0, 2, 2), a dense ring level, f32 and f32 with
       bf16 smoothers' twins, each to rel_res < 1e-8 within the iterations
       tests/test_parallel.py allows for the option; the sharded profile
       (profile_sharded_matvecs); update1 through update_sharded_values;
       and the D = 4 solve through parallel/multihost.py on an NCCL group
       of world size 1 (4 shards on its one rank), its u within 1e-12 of
       the single-process one, captured where the capture takes NCCL's
       all_reduce (the row says whether it was). K1 must launch in
       rectangular mode (a ShardedDia shard's block) and K3 on shards.
   (l) the device products over a mesh (ops/spgemm.py, the ring of
       ops/bspgemm.py), no kernel of the port on their path: the 48^3
       Galerkin product R A P (the level-0 aggregation at theta 0.3, the
       smoothed P, R = P^T) by triple_product in f64, "auto" (the
       block-sparse ring), at D = 1, 2, 4, 8 shards of the card, within
       1e-12 x max |Ac| of the host native product and bit-equal to a
       second run, with each product's plan, upload, numeric (median of 5
       after a warm run, CUDA events), assembly, block MB a shard, pairs
       and bound, beside the host product's seconds and torch.sparse.mm
       (cuSPARSE) of the same CSR pairs; examples/gemm.py's sweep (5000^2,
       densities 0.001, 0.005, 0.01, f32 and f64, D = 1 and 4): the ring
       "auto" picks, its product against scipy (f32: within f32 rounding,
       so TF32 is off; f64: 1e-12), the dense ring on prepared operands
       beside torch.matmul and the sparse ring's numeric phase;
       AMG.matmat(mesh=Mesh(4)) against the host product (1e-12); an
       EllMatrix with spill, two matvecs bit-equal, both through K4;
       spgemm_blocks of the
       48^3 R A, two calls bit-equal.
   Every kernel must have launched in phase 3 (K4 on (b)'s level-3 A, and
   with bf16 values on (h)'s twin of it; K5 in the setups' Galerkin
   products, which take the card from amg/galerkin.CARD_MIN_MACS
   multiply-adds), the strip and strip8 kernels on
   both of their paths, the DIA kernel in both of its designs:
   the tiled kernel for every operator of more than 8 diagonals (level 1),
   the row kernel for the others (level 0), as its plan picks.
   runtime.launches also counts K1's launches by (n_pad, ndiag, variant);
   those counts must add up to its launches, and the timed solves' counts
   are the launches per solve of phase 4. It also counts K3's launches on
   interval-mode layouts.
4. Times at the main path's shapes, by CUDA events over graph-replayed
   calls (an empty kernel replayed the same way gives the launch floor):
   kernel, plain version, one cuSPARSE CSR product of the same
   operator as a yardstick, and the bound (bytes over memory rate vs
   operations over peak rate; bytes count the format's arrays the kernel
   reads, x and y once each). The DIA kernel is timed at every shape the
   solve launches it (levels 0 and 1 x SpMV, Chebyshev update, residual x
   f32, f64) in its plan's pick, on both x paths and as the row kernel (one
   thread per row, the design it replaced), with the host cost of a
   launch and its launches per solve; the run fails if a shape is slower
   than the row kernel by more than 5%. A strip / strip8
   layout is timed on the path
   its wrapper picks and on the other one; the rows path is PR 2's kernel,
   so its time stands beside the new one, with its launches in one picker
   and one forced solve of phase 3. Every strip / strip8 operator of the
   f32 solve is timed with its launches per solve. The bf16 modes are timed
   on phase 3h's twins (K1 SpMV at levels 0 and 1; K3 on the picker's and
   K2 on the forced level-2 A, both paths) with their bound at bf16 value
   bytes and their launches per solve; cuSPARSE has no bf16-A / f32-x
   SpMV, so their yardstick is its f32 product. Then the H100 cost
   constants of the format picker, fitted from these times. The sharded
   path's shapes (phase 3k, D = 4): K1 rectangular on shard 1 of level 0
   (f32, f64; SpMV, Chebyshev update, residual) and K3 on shard 1 of the
   level-2 A, each with its plain version, cuSPARSE's SpMV of the same
   block and its launches per sharded solve; and the level-2 ShardedStrip8
   matvec split into its halo extension, K3 per shard (alone and all
   shards in a row) and the stack. K4 on the level-3-shaped ELL, f64 and
   f32, with the L2 flushed before each launch, beside its bound, the plain
   torch version and cuSPARSE's CSR product. K5 on the 48^3 level-2
   Galerkin products (A_2 P_2, R_2 W_2): the kernel alone, the card route
   with its transfers, and the host kernel on all cores, beside the bound
   of the Y stream (12 bytes a multiply-add).

The second-to-last line is one JSON object listing every ported kernel,
each kernel's bf16-values mode as an entry of its own, and K1's rectangular
mode and K3 on a shard (the sharded path) likewise, and K4 and K5 (no
Pallas kernel: ``replaces`` null); the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no
result, when no CUDA card is present or the port's package is missing.
"""
from __future__ import annotations

import copy
import dataclasses
from collections import Counter
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
M = 48                                   # the bench's headline grid
GOLDEN = "poisson3d_48"
TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bytes/s, and FLOP/s outside the tensor cores per vector dtype
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 67e12, "float64": 34e12}


def fail(msg: str) -> int:
    print(f"FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing --
# graph_ms (device ms per call, graph-replayed, CUDA events) is
# saena_tpu_torch.profiling.graph_ms, imported where it is used


def eager_ms(fn, reps: int = 200) -> float:
    """ms per call issued from Python, host launch cost included."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes: int, flops: int, dname: str) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations") at the published peaks."""
    b_bytes = nbytes / HBM_BPS * 1e3
    b_ops = flops / PEAK_FLOPS[dname] * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")


# ------------------------------------------------------------ host levels --


def _poisson_interior(m):
    from saena_tpu_torch.core.coo import remove_boundary_nodes
    from saena_tpu_torch.generators import laplacian3D

    return remove_boundary_nodes(laplacian3D(m, m, m))[0]


def host_levels():
    """SetupInfo of the port's host setup of the m^3 Poisson interior (f64,
    CPU device levels): csr_levels, Ps, Rs and the structural (agg, wq)."""
    import torch

    from saena_tpu_torch.amg.hierarchy import setup
    from saena_tpu_torch.config import Options

    _, info = setup(_poisson_interior(M), Options(), dtype=torch.float64,
                    device="cpu")
    return info


def main_path_operators(info) -> dict:
    """Host CSR of the gather kernels' main-path operators."""
    from saena_tpu_torch.amg.prolongation import tentative_prolongator

    Pt = tentative_prolongator(info.structs[0][0], info.sizes[1])
    return {"L0_A": info.csr_levels[0], "L0_Pt": Pt, "L0_PtT": Pt.T.tocsr(),
            "L1_A": info.csr_levels[1],
            "L2_A": info.csr_levels[2]}


# ------------------------------------------------- phase 2: DIA kernel --

VARIANTS = {                      # name: (has_rhs, has_dinv, c, add_x)
    "spmv": (False, False, 1.0, False),
    "jacobi": (True, True, 2.0 / 3.0, True),
    "cheb": (True, True, 0.37, False),
    "residual": (True, False, -1.0, False),
}


def kernel_cases(dev, ops):
    """(name, data f64 (ndiag, n_pad), offsets, m_pad, x_row0, n) cases at
    f64 on the card; n = rows that are not padding."""
    import scipy.sparse as sp
    import torch

    from saena_tpu_torch.ops.formats import dia_from_csr

    def band(n, diags, seed):
        return sp.diags([np.random.default_rng(seed + k).standard_normal(n - abs(d))
                         for k, d in enumerate(diags)], diags, format="csr")

    cases = []
    A = _poisson_interior(M)
    D = dia_from_csr(A, torch.float64, dev)
    cases.append((f"poisson{M}", D.data, D.offsets, D.n_pad, 0, A.shape[0]))
    A1 = ops["L1_A"]
    D = dia_from_csr(A1, torch.float64, dev)
    cases.append((f"level1_{len(D.offsets)}diag", D.data, D.offsets, D.n_pad, 0,
                  A1.shape[0]))
    D = dia_from_csr(band(2000, [0, 1, -1, 300, -300, 1500, -1500], 0),
                     torch.float64, dev)
    cases.append(("band_wide", D.data, D.offsets, D.n_pad, 0, 2000))
    # more diagonals than the tiled kernel takes by value: the row kernel
    D = dia_from_csr(band(3000, list(range(-150, 150)), 40), torch.float64, dev)
    cases.append((f"band_{len(D.offsets)}diag", D.data, D.offsets, D.n_pad, 0, 3000))
    # rectangular row block of 4096 rows reading a halo-extended x
    # [256 halo | 4096 own | 128 halo]; offsets in extended coordinates, the
    # data dense so reads past either end of x hit the bounds check
    rng = np.random.default_rng(11)
    offs = (-5, 255, 256, 257, 385)
    data = torch.tensor(rng.standard_normal((len(offs), 4096)), device=dev)
    cases.append(("rect_x_row0_2", data, offs, 256 + 4096 + 128, 2, 4096))
    return cases


def dia_plans(offs, n_pad, dt, dev):
    """[(label, plan)] of every configuration of the DIA kernel's plan for
    the operator: the plan's own pick ("auto", what DiaMatrix holds), then
    each other configuration the plan can take (x through L1, x staged in
    shared memory, the row kernel), each distinct plan once."""
    from saena_tpu_torch.ops import dia_spmv as dmod

    sms = dmod.sm_count(dev)
    out, seen = [], set()
    for label in ("auto", *dmod.CONFIGS):
        try:
            plan = dmod.dia_plan(offs, n_pad, dt, sms,
                                 config=None if label == "auto" else label)
        except ValueError:
            continue
        key = json.dumps(plan.describe())
        if key not in seen:
            seen.add(key)
            out.append((label, plan))
    return out


def unaligned(t):
    """The same values as a view whose storage starts one element in (not
    16-byte aligned)."""
    store = t.new_empty(t.numel() + 1)
    store[1:] = t
    return store[1:]


def check_kernels(dev, ops, extra=()):
    """DIA kernel vs plain for every case (``extra``: more cases in
    kernel_cases' form) x plan configuration x dtype x variant; two launches must agree bit for bit, and x, rhs and dinv given
    as views that are not 16-byte aligned must give the aligned call's bits.
    Returns (rows of (case, config, variant, dtype, scaled_err,
    max_abs_err), worst failure or None)."""
    import torch

    from saena_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain

    rows, bad, configs = [], None, set()
    for case, data64, offs, m_pad, x_row0, n in kernel_cases(dev, ops) + list(extra):
        n_pad = data64.shape[1]
        rng = np.random.default_rng(len(case))
        nx = n if m_pad == n_pad else m_pad      # zero-padded in square mode
        x64 = torch.zeros(m_pad, dtype=torch.float64, device=dev)
        x64[:nx] = torch.tensor(rng.standard_normal(nx), device=dev)
        vec = lambda: torch.tensor(np.pad(rng.uniform(0.5, 1.5, n),
                                          (0, n_pad - n)), device=dev)
        rhs64, dinv64 = vec(), vec()
        for dname in ("float32", "bfloat16", "float64"):
            ddt = getattr(torch, dname)
            cdt = torch.promote_types(ddt, torch.float32)
            data = data64.to(ddt)
            x, rhs, dinv = x64.to(cdt), rhs64.to(cdt), dinv64.to(cdt)
            xu, rhsu, dinvu = unaligned(x), unaligned(rhs), unaligned(dinv)
            # |terms|: the same expression on absolute values, in f64
            acc_abs = dia_spmv_plain(data.abs().double(), x64.abs(), offs)
            for label, plan in dia_plans(offs, n_pad, ddt, dev):
                configs.add(f"{plan.config}/G{'>1' if plan.groups > 1 else '1'}")
                worst = (0.0, 0.0)
                ok_all = True
                for vname, (has_rhs, has_dinv, c, add_x) in VARIANTS.items():
                    kw = dict(c=c, add_x=add_x, x_row0=x_row0, plan=plan)
                    yk = dia_spmv(data, x, offs, rhs=rhs if has_rhs else None,
                                  dinv=dinv if has_dinv else None, **kw)
                    same = torch.equal(yk, dia_spmv(
                        data, x, offs, rhs=rhs if has_rhs else None,
                        dinv=dinv if has_dinv else None, **kw))
                    same_u = torch.equal(yk, dia_spmv(
                        data, xu, offs, rhs=rhsu if has_rhs else None,
                        dinv=dinvu if has_dinv else None, **kw))
                    kw.pop("plan")
                    yp = dia_spmv_plain(data, x, offs, rhs=rhs if has_rhs else None,
                                        dinv=dinv if has_dinv else None, **kw)
                    torch.cuda.synchronize()
                    scale = acc_abs
                    if has_rhs:
                        scale = abs(c) * (rhs64.abs() + acc_abs)
                        if has_dinv:
                            scale = scale * dinv64.abs()
                        if add_x:
                            x0 = 128 * x_row0
                            scale = scale + x64[x0:x0 + n_pad].abs()
                    diff = (yk.double() - yp.double()).abs()
                    err = float((diff / scale.clamp_min(1e-300)).max())
                    abs_err = float(diff.max())
                    pad_ok = bool((yk[n:] == 0).all()) if n < n_pad else True
                    ok = (yk.dtype == cdt and yk.shape == (n_pad,) and pad_ok
                          and same and same_u and np.isfinite(err)
                          and err <= TOL[dname])
                    rows.append((case, label, vname, dname, err, abs_err))
                    worst = max(worst, (err, abs_err))
                    ok_all = ok_all and ok
                    if not ok and bad is None:
                        bad = (f"{case}/{label}/{vname}/{dname}: err {err:.3e}, pad "
                               f"{pad_ok}, runs equal {same}, unaligned equal {same_u}")
                p = plan.describe()
                print(f"  {case:<16} {label:<5} {dname:<9} {plan.config:<4} "
                      f"G={p['groups']} W={p['row_warps']} grid={p['grid']} "
                      f"worst scaled_err={worst[0]:.3e} "
                      f"max_abs_err={worst[1]:.3e} {'ok' if ok_all else 'FAIL'}")
    need = {"l1/G1", "l1/G>1", "smem/G1", "smem/G>1", "rows/G1"}
    if bad is None and not need <= configs:
        bad = f"configurations not checked: {sorted(need - configs)}"
    return rows, bad


# ----------------------------------------- phase 2: strip / strip8 kernels --


def with_vals(Mx, vals):
    """The same layout (shared index arrays) with other values."""
    out = copy.copy(Mx)
    out.vals = vals
    return out


def synthetic_interval(dev, n_rb, tiles_per_rb, n_strips, perrow, seed):
    """An interval-mode Strip8Matrix (f64) with dense random tiles. Row
    block rb holds tiles_per_rb tiles (the last row block one fewer, so
    gather_idx has a padding entry); bases are random in [0, n_strips - 8]
    and the last tile's base is n_strips - 3, so its sublanes 3..7 read past
    the last strip (zeros)."""
    import torch

    from saena_tpu_torch.ops.strip8_spmv import Strip8Matrix, _padded_tiles

    rng = np.random.default_rng(seed)
    Q = 128 // perrow
    counts = np.full(n_rb, tiles_per_rb)
    counts[-1] -= 1
    n_tiles = int(counts.sum())
    n_pad = _padded_tiles(n_tiles)
    idx = np.zeros((n_pad, 8, 128), dtype=np.int8)
    vals = np.zeros((n_pad, 8, 128))
    idx[:n_tiles] = rng.integers(0, 128, (n_tiles, 8, 128))
    vals[:n_tiles] = rng.standard_normal((n_tiles, 8, 128))
    bases = np.zeros(n_pad, dtype=np.int32)
    bases[:n_tiles] = rng.integers(0, max(1, n_strips - 7), n_tiles)
    bases[n_tiles - 1] = n_strips - 3
    gather = np.full((n_rb, tiles_per_rb), n_pad, dtype=np.int32)
    off = np.cumsum(counts) - counts
    for t in range(tiles_per_rb):
        mask = counts > t
        gather[mask, t] = off[mask] + t
    t = lambda a: torch.from_numpy(a).to(dev)
    n_rows = n_rb * Q
    return Strip8Matrix(t(idx), t(vals), t(bases), t(gather),
                        shape=(n_rows, n_strips * 128),
                        nnz=int(np.count_nonzero(vals)), perrow=perrow,
                        mode="interval", n_cols_pad=n_strips * 128,
                        n_out=n_rows)


def rechunked(Mx, chunk_min):
    """The same layout on the stream path, its work cut into equal chunks
    of about chunk_min units (pairs or tiles)."""
    return copy.copy(Mx).rechunk(chunk_min, whole_max=0)


def on_path(Mx, path):
    """The same layout sent down the kernel's rows or stream path."""
    out = copy.copy(Mx)
    if path == "stream":
        return out.rechunk()
    out.chunks = None
    return out


def path_of(Mx) -> str:
    return "rows" if Mx.chunks is None else "stream"


def gather_cases(dev, ops):
    """{name: (kind, f64 layout on the card, host CSR or None)} for the
    strip and strip8 checks and times. Besides the main-path shapes: an
    operator of one real pair / tile (the rest zero padding), a layout cut
    into chunks of 7 units (a unit count that is no multiple of the chunk,
    row blocks cut by chunk boundaries) and the interval-mode edge case cut
    into chunks of 2 tiles."""
    import torch

    from saena_tpu_torch.ops.strip8_spmv import strip8_from_csr
    from saena_tpu_torch.ops.strip_spmv import strip_from_csr

    f64 = torch.float64
    cases = {"L0_Pt": ("strip", strip_from_csr(ops["L0_Pt"], f64, dev),
                       ops["L0_Pt"]),
             "L0_PtT": ("strip8", strip8_from_csr(ops["L0_PtT"], f64, dev),
                        ops["L0_PtT"])}
    A2 = ops["L2_A"]
    for pr in (1, 2, 4, 8, 16):
        cases[f"L2_A_strip_pr{pr}"] = (
            "strip", strip_from_csr(A2, f64, dev, perrow=pr), A2)
    for pr in (1, 2, 4):
        cases[f"L2_A_strip8_pr{pr}"] = (
            "strip8", strip8_from_csr(A2, f64, dev, perrow=pr), A2)
        cases[f"L2_A_strip8i_pr{pr}"] = (
            "strip8", strip8_from_csr(A2, f64, dev, perrow=pr, mode="interval"),
            A2)
    interval = synthetic_interval(dev, 16, 3, 10, 2, 3)
    cases["interval_edge"] = ("strip8", interval, None)
    cases["interval_edge_chunk2"] = ("strip8", rechunked(interval, 2), None)
    tiny = tiny_operator()
    cases["one_pair"] = ("strip", strip_from_csr(tiny, f64, dev), tiny)
    cases["one_tile"] = ("strip8", strip8_from_csr(tiny, f64, dev), tiny)
    cases["L0_Pt_chunk7"] = ("strip", rechunked(cases["L0_Pt"][1], 7), ops["L0_Pt"])
    cases["L0_PtT_chunk7"] = ("strip8", rechunked(cases["L0_PtT"][1], 7),
                              ops["L0_PtT"])
    return cases


def check_gather(dev, cases):
    """strip / strip8 kernel vs plain in f32, with bf16 values (an f32 x)
    and in f64 for every case, on the path its wrapper picks and on the
    other one (the cases cut into chunks on the stream path only); two
    launches must agree bit for bit, and x passed as a view that is not
    16-byte aligned must give the same result. Returns (rows of (case,
    path, values dtype, scaled_err, max_abs_err), failure or None)."""
    import torch

    from saena_tpu_torch.ops import strip8_spmv as s8
    from saena_tpu_torch.ops import strip_spmv as s1

    rows, bad = [], None
    for case, (kind, M_case, _) in cases.items():
        mod = s1 if kind == "strip" else s8
        kern = mod.strip_spmv if kind == "strip" else mod.strip8_spmv
        plain = mod.strip_spmv_plain if kind == "strip" else mod.strip8_spmv_plain
        n = M_case.shape[0]
        rng = np.random.default_rng(len(case))
        x64 = torch.zeros(M_case.n_cols_pad, dtype=torch.float64, device=dev)
        x64[: M_case.shape[1]] = torch.tensor(rng.standard_normal(M_case.shape[1]),
                                              device=dev)
        y_abs = plain(with_vals(M_case, M_case.vals.abs()), x64.abs())
        paths = ["stream"] if "chunk" in case else ["rows", "stream"]
        for path, dname in ((p, d) for p in paths
                            for d in ("float32", "bfloat16", "float64")):
            M64 = M_case if path_of(M_case) == path else on_path(M_case, path)
            dt = getattr(torch, dname)
            Mx = M64 if dt == torch.float64 else with_vals(M64, M64.vals.to(dt))
            cdt = torch.promote_types(dt, torch.float32)       # x, y
            x = x64.to(cdt)
            store = torch.zeros(x.numel() + 1, dtype=cdt, device=dev)
            store[1:] = x
            yk = kern(Mx, x)
            same = torch.equal(yk, kern(Mx, x)) and torch.equal(yk, kern(Mx, store[1:]))
            yp = plain(Mx, x)
            torch.cuda.synchronize()
            diff = (yk.double() - yp.double()).abs()
            err = float((diff / y_abs.clamp_min(1e-300)).max())
            abs_err = float(diff.max())
            pad_ok = bool((yk[n:] == 0).all())
            C = Mx.chunks
            tickets_ok = not (Mx.counter.any() or C is not None and C.counter.any())
            ok = (yk.dtype == cdt and yk.shape == yp.shape and pad_ok and same
                  and tickets_ok and np.isfinite(err) and err <= TOL[dname])
            rows.append((case, path, dname, err, abs_err))
            geo = (f"perrow={Mx.perrow} krb={Mx.krb} pairs={Mx.idx.shape[0]}"
                   if kind == "strip" else
                   f"perrow={Mx.perrow} mode={Mx.mode} tiles={Mx.tile_list.numel()}")
            grid = (f"warps={C.n_chunks} cut_row_blocks={C.n_cuts}" if C is not None
                    else f"split={Mx.n_split}")
            print(f"  {kind:<6} {case:<20} {path:<6} {dname:<8} {geo:<36} {grid:<28} "
                  f"scaled_err={err:.3e} max_abs_err={abs_err:.3e} "
                  f"pad_zero={pad_ok} runs_equal={same} {'ok' if ok else 'FAIL'}")
            if not ok and bad is None:
                bad = (f"{kind}/{case}/{path}/{dname}: err {err:.3e}, pad {pad_ok}, "
                       f"runs equal {same}, tickets zero {tickets_ok}")
    if bad is None and not any(k == "strip" and M.krb > 1
                               for k, M, _ in cases.values()):
        bad = "no strip case has krb > 1"
    if bad is None and not all(any(k == kind and M.chunks is not None and M.chunks.n_cuts
                                   for k, M, _ in cases.values())
                               for kind in ("strip", "strip8")):
        bad = "no case of a gather kernel has a cut row block"
    return rows, bad


# ---------------------------------------------------- phase 2: ELL kernel --

ELL_WIDE_X = 70_000           # columns whose f64 / f32 x outgrows an SM's L1
FLUSH_BYTES = 256 * 2**20     # written before each flushed launch: > 4 x the L2


def ell_cases() -> dict:
    """K4's shapes: the level-3-shaped operator, the 48^3 A with ten long
    rows (spill), a prolongator and a restrictor shape, and a block whose x
    outgrows an SM's L1."""
    import scipy.sparse as sp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_ell_spmv import level3_like

    A = _poisson_interior(M).tocsr().tolil()
    rng = np.random.default_rng(7)
    for r in range(10):
        A[r, rng.choice(A.shape[1], 200, replace=False)] = rng.standard_normal(200)
    rand = lambda n, m, d, seed: sp.random(n, m, density=d, format="csr",
                                           random_state=np.random.default_rng(seed))
    return {"L3_like": level3_like(), "spill_48": A.tocsr(),
            "rect_P": rand(7000, 900, 0.003, 2), "rect_R": rand(900, 7000, 0.003, 4),
            "x_past_smem": rand(3000, ELL_WIDE_X, 0.002, 8)}


def ell_with(Mx, f):
    """An EllMatrix with Mx's layout and values f(values)."""
    from saena_tpu_torch.ops.formats import EllMatrix

    return EllMatrix(Mx.cols, f(Mx.vals), Mx.spill_rows, Mx.spill_cols,
                     f(Mx.spill_vals), Mx.shape, Mx.nnz)


def check_ell(dev, cases):
    """K4 against ell_spmv_plain on the card in f64, f32 and bf16 values
    (f32 x and sums, against the plain f32 sum of the same values):
    row-sum-scaled error within TOL, the zero padding kept, two launches
    bit-equal and counted. Returns (rows, failure or None)."""
    import torch

    from saena_tpu_torch.ops import ell_spmv as K
    from saena_tpu_torch.ops.formats import ell_from_csr
    from saena_tpu_torch.runtime import launches_of

    rows, bad = [], None
    for case, A in cases.items():
        M64 = ell_from_csr(A, torch.float64, dev, width_quantile=0.98)
        for dname in ("float64", "float32", "bfloat16"):
            Mx = ell_with(M64, lambda v: v.to(getattr(torch, dname)))
            cdt = K.compute_dtype(Mx.dtype)
            x = torch.zeros(Mx.plan.n_x, dtype=cdt, device=dev)
            x[: A.shape[1]] = torch.tensor(
                np.random.default_rng(5).standard_normal(A.shape[1]), dtype=cdt)
            (y1, y2), made = launches_of(lambda: (Mx.matvec(x), Mx.matvec(x)))
            torch.cuda.synchronize()
            ref = K.ell_spmv_plain(ell_with(Mx, lambda v: v.to(cdt)), x)
            scale = K.ell_spmv_plain(ell_with(Mx, lambda v: v.to(cdt).abs()),
                                     x.abs()).clamp_min(torch.finfo(cdt).tiny)
            err = float(((y1 - ref).abs() / scale).max())
            row = {"case": case, "dtype": dname, "shape": list(A.shape), "nnz": int(A.nnz),
                   "width": Mx.vals.shape[0], "slots_read": int(Mx.tile_bound.sum()) * K.TILE,
                   "spill": int(Mx.spill_rows.numel()), "blocks": Mx.plan.n_blocks,
                   "err": err,
                   "bit_equal": bool(torch.equal(y1, y2)),
                   "pad_zero": bool((y1[A.shape[0]:] == 0).all()),
                   "launches": made["ell"]}
            rows.append(row)
            print("  " + json.dumps(row))
            if bad is None and (not err <= TOL[dname] or not row["bit_equal"]
                                or not row["pad_zero"] or row["launches"] != 2):
                bad = f"K4 {row}"
        del M64
    return rows, bad


def spgemm_cases(info) -> dict:
    """K5's operands: both Galerkin products of each coarsening of the 48^3
    host levels (A_l P_l and R_l W_l, W_l the host kernel's A_l P_l), by
    "L<l>_AP" / "L<l>_RW"."""
    from saena_tpu_torch import _native

    cases = {}
    for l, (P, R) in enumerate(zip(info.Ps, info.Rs)):
        A = info.csr_levels[l]
        # the stored P's columns follow the coarse level's reordering,
        # unsorted; the route sorts them, which changes no bit
        P = P.sorted_indices()
        cases[f"L{l}_AP"] = (A, P)
        cases[f"L{l}_RW"] = (R, _native.spgemm_csr(A, P))
    return cases


def check_spgemm(dev, cases):
    """K5 against the host kernel on the card: equal indptr and indices,
    values equal as uint64, two launches bit-equal and counted. Returns
    (rows, failure or None)."""
    import torch

    from saena_tpu_torch import _native
    from saena_tpu_torch.amg.galerkin import spgemm_macs
    from saena_tpu_torch.ops import csr_spgemm as K
    from saena_tpu_torch.runtime import launches_of

    rows, bad = [], None
    for case, (X, Y) in cases.items():
        Z = _native.spgemm_csr(X, Y)
        Xd, Yd = K.DeviceCsr.from_host(X, dev), K.DeviceCsr.from_host(Y, dev)
        (C1, C2), made = launches_of(lambda: (K.csr_spgemm(Xd, Yd), K.csr_spgemm(Xd, Yd)))
        torch.cuda.synchronize()
        C = C1.to_host()
        same = (np.array_equal(C.indptr, Z.indptr.astype(np.int64))
                and np.array_equal(C.indices, Z.indices)
                and np.array_equal(C.data.view(np.uint64), Z.data.view(np.uint64)))
        row = {"case": case, "shape": [X.shape[0], Y.shape[1]], "macs": spgemm_macs(X, Y),
               "nnz": int(Z.nnz), "windows": K.windows(Y.shape[1])[0],
               "host_bit_equal": bool(same),
               "bit_equal": all(torch.equal(a, b) for a, b in (
                   (C1.indptr, C2.indptr), (C1.indices, C2.indices),
                   (C1.values.view(torch.int64), C2.values.view(torch.int64)))),
               "launches": made["csr_spgemm"]}
        rows.append(row)
        print("  " + json.dumps(row))
        if bad is None and not (same and row["bit_equal"] and row["launches"] == 4):
            bad = f"K5 {row}"
    return rows, bad


def time_spgemm(dev, cases) -> list:
    """K5 on the 48^3 level-2 products beside the host kernel: the kernel
    alone (count, scan and fill; median of 20 calls by CUDA events, operands
    on the card), the card route with its transfers (operands up, product
    back; least of 5) and the host kernel on all cores (least of 5); the
    bound is the Y stream, 12 bytes a multiply-add, over HBM_BPS."""
    import statistics

    import torch

    from saena_tpu_torch import _native
    from saena_tpu_torch.amg.galerkin import spgemm_macs
    from saena_tpu_torch.ops import csr_spgemm as K

    rows = []
    for case in ("L2_AP", "L2_RW"):
        X, Y = cases[case]
        Xd, Yd = K.DeviceCsr.from_host(X, dev), K.DeviceCsr.from_host(Y, dev)
        K.csr_spgemm(Xd, Yd)
        kern = []
        for _ in range(20):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            K.csr_spgemm(Xd, Yd)
            e1.record()
            torch.cuda.synchronize()
            kern.append(e0.elapsed_time(e1))
        route, host = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            K.csr_spgemm(K.DeviceCsr.from_host(X, dev), K.DeviceCsr.from_host(Y, dev)).to_host()
            route.append(time.perf_counter() - t)
            t = time.perf_counter()
            _native.spgemm_csr(X, Y)
            host.append(time.perf_counter() - t)
        macs = spgemm_macs(X, Y)
        row = {"case": case, "shape": [X.shape[0], Y.shape[1]], "macs": macs,
               "ms": statistics.median(kern), "route_ms": min(route) * 1e3,
               "host_ms": min(host) * 1e3, "bound_ms": 12.0 * macs / HBM_BPS * 1e3}
        rows.append(row)
        print("  " + json.dumps(row))
    return rows


# --------------------------------------------------- phase 3: main path --


def level_formats(H) -> list:
    """Per level: A, P and R formats, with the Pt/PtT inside SmoothedP/R."""
    def name(Mx):
        if Mx is None:
            return None
        inner = getattr(Mx, "Pt", None) or getattr(Mx, "PtT", None)
        s = type(Mx).__name__
        if inner is not None:
            s += f"[{name(inner)}]"
        if type(Mx).__name__ == "StripMatrix":
            s += f"(pr{Mx.perrow},krb{Mx.krb})"
        elif type(Mx).__name__ == "Strip8Matrix":
            s += f"(pr{Mx.perrow},{Mx.mode})"
        return s
    return [{"A": name(L.A), "P": name(L.P), "R": name(L.R)} for L in H.levels]


def run_solve(solver, dev, golden, label):
    """Warm solve, then a timed solve with the golden check. Returns
    (report dict, failure or None)."""
    import torch

    from saena_tpu_torch import generators

    (u, res), ms, made = timed(solver.solve_pCG)
    per_shape = dia_shapes(made)          # K1's launches in the timed solve
    it = res.iters
    rel = float(res.rel_res)
    hist = res.history[: it + 1].cpu().numpy()
    err = float(np.abs(u - generators.laplacian3D_solution(M, M, M)).max())
    info = solver.info
    on_card = all(t.device.type == dev.type for t in solver.hierarchy.tensors())
    rep = {"run": label, "dtype": str(solver.dtype), "levels": info.sizes,
           "formats": level_formats(solver.hierarchy), "iters": it,
           "rel_res": rel, "true_res": float(res.true_res),
           "max_err_vs_solution": err, "solve_ms": ms,
           "all_tensors_on_card": on_card, "dia_launches_per_solve": per_shape}
    print("  " + json.dumps(rep))
    if sum(per_shape.values()) != made["dia"]:
        return rep, (f"DIA launches by shape {per_shape} do not add up to the "
                     f"{made['dia']} launches of the solve")
    if not on_card:
        return rep, "a hierarchy tensor is not on the card"
    if not np.isfinite(u).all():
        return rep, "non-finite solution"
    if golden is not None:
        if info.sizes != golden["levels"]:
            return rep, f"levels {info.sizes} != golden {golden['levels']}"
        if it != golden["iters"]:
            return rep, f"iterations {it} != golden {golden['iters']}"
        gh = np.asarray(golden["history"])
        if not np.allclose(hist, gh, rtol=1e-6, atol=0.0):
            return rep, f"history off golden by {np.max(np.abs(hist / gh - 1)):.3e}"
    elif not (rel < 1e-8 and it <= 100):
        return rep, f"f32 solve: rel_res {rel:.3e} after {it} iterations"
    return rep, None


def solve_main_path(dev, dtype, golden):
    """48^3 pCG through Matrix/AMG on the card. Returns (solver, report
    dict, failure message or None)."""
    from saena_tpu_torch import AMG, Matrix, Options, generators

    A = Matrix()
    A.set_csr(generators.laplacian3D(M, M, M))
    A.assemble(device=dev, dtype=dtype)
    solver = AMG(device=dev, dtype=dtype)
    t0 = time.perf_counter()
    solver.set_matrix(A, Options(remove_boundary=True))
    setup_s = time.perf_counter() - t0
    solver.set_rhs(generators.laplacian3D_set_rhs(M, M, M))
    print(solver.info.table())
    rep, bad = run_solve(solver, dev, golden, "picker")
    rep["setup_s"] = setup_s
    rep["setup_phases_s"] = {k: round(v, 3) for k, v in solver.info.phases.items()}
    print(f"  setup {setup_s:.3f} s: {json.dumps(rep['setup_phases_s'])}")
    return solver, rep, bad


def forced_hierarchy(solver):
    """The picker's hierarchy with every transfer structural, Pt in strip
    and Pt^T in strip8, the level-2 A (and its smoothers' twin, if it has
    one) in whichever of strip and strip8 the picker did not choose, and
    the level-3 A (and its twin) in ELL; the host levels are the solver's
    own."""
    from saena_tpu_torch.amg.prolongation import tentative_prolongator
    from saena_tpu_torch.ops.formats import ell_from_csr, pad_to, to_device
    from saena_tpu_torch.ops.strip8_spmv import strip8_from_csr
    from saena_tpu_torch.ops.strip_spmv import StripMatrix, strip_from_csr
    from saena_tpu_torch.ops.transfers import SmoothedP, SmoothedR

    H, info = solver.hierarchy, solver.info
    dev, dt = H.device, H.dtype
    levels = list(H.levels)
    other = strip8_from_csr if isinstance(levels[2].A, StripMatrix) else strip_from_csr
    ell = functools.partial(ell_from_csr, width_quantile=0.98)
    for l, build in ((2, other), (3, ell)):
        twin = levels[l].A_smooth
        if twin is None:
            levels[l] = dataclasses.replace(levels[l], A=build(info.csr_levels[l], dt, dev))
        else:
            A_l, twin = build(info.csr_levels[l], dt, dev, smooth_dtype=twin.dtype)
            levels[l] = dataclasses.replace(levels[l], A=A_l, A_smooth=twin)
    for l in range(len(levels) - 1):
        agg, wq = info.structs[l]
        n, n_c = info.sizes[l], info.sizes[l + 1]
        Pt = tentative_prolongator(agg, n_c)
        wq_dev = to_device(np.pad(wq, (0, pad_to(n) - n)), dt, dev)
        A_l = levels[l].A
        nnz = int(info.Ps[l].nnz)
        P = SmoothedP(strip_from_csr(Pt, dt, dev), A_l, wq_dev, (n, n_c), nnz)
        R = SmoothedR(strip8_from_csr(Pt.T.tocsr(), dt, dev), A_l, wq_dev,
                      (n_c, n), nnz)
        levels[l] = dataclasses.replace(levels[l], P=P, R=R)
    return dataclasses.replace(H, levels=tuple(levels))


def pick_estimates(info, H, dtype) -> list:
    """Per level, the estimates (µs) the picker ranked: the level's A over
    the gather formats, and the structural transfers against the direct
    P/R (through the level's device A in ``H``)."""
    from saena_tpu_torch.ops.formats import (
        bsr_time_estimate, gather_time_estimate, gather_time_estimate_quick)
    from saena_tpu_torch.ops.strip8_spmv import strip8_time_estimate
    from saena_tpu_torch.ops.strip_spmv import strip_time_estimate
    from saena_tpu_torch.ops.transfers import structural_estimate

    us = lambda s: round(s * 1e6, 3)
    out = []
    for l, A in enumerate(info.csr_levels):
        row = {"level": l, "format": info.formats[l]}
        if info.formats[l] not in ("DiaMatrix", "DenseMatrix"):
            row["A"] = {"strip": us(strip_time_estimate(A, dtype)),
                        "strip8": us(strip8_time_estimate(A, dtype)),
                        "bsr": us(bsr_time_estimate(A, dtype))}
        if l < len(info.Ps) and info.structs[l] is not None:
            P, R = info.Ps[l], info.Rs[l]
            row["structural"] = us(structural_estimate(
                info.structs[l][0], info.sizes[l + 1], H.levels[l].A, dtype))
            row["direct_quick"] = us(gather_time_estimate_quick(P, dtype)
                                     + gather_time_estimate_quick(R, dtype))
            row["direct"] = us(gather_time_estimate(P, dtype)
                               + gather_time_estimate(R, dtype))
        out.append(row)
    return out


# ------------------------------- phase 3c-3e: host setup, entry points, updates --


def host_levels_differ(i1, i2):
    """None when every level, P and R of two SetupInfos agree bit for bit
    (indptr, indices, data), else what differs first."""
    if i1.sizes != i2.sizes:
        return f"levels {i1.sizes} != {i2.sizes}"
    for name, As, Bs in (("A", i1.csr_levels, i2.csr_levels),
                         ("P", i1.Ps, i2.Ps), ("R", i1.Rs, i2.Rs)):
        if len(As) != len(Bs):
            return f"{name}: {len(As)} != {len(Bs)} operators"
        for l, (X, Y) in enumerate(zip(As, Bs)):
            for attr in ("indptr", "indices"):
                if not np.array_equal(getattr(X, attr), getattr(Y, attr)):
                    return f"{name}{l} {attr} differs"
            if X.data.shape != Y.data.shape or \
                    X.data.astype(np.float64).tobytes() != Y.data.astype(np.float64).tobytes():
                return f"{name}{l} data differs"
    return None


def setup_on_host(dev):
    """The 48^3 f64 setup on the card's host through Matrix/AMG, default
    (setup_shards=-1) and serial (setup_shards=0). Returns (report, failure
    or None)."""
    import torch

    from saena_tpu_torch import AMG, Matrix, Options, generators
    from saena_tpu_torch.amg.hierarchy import _setup_workers
    from saena_tpu_torch.parallel.dist_setup import default_shards

    A = Matrix()
    A.set_csr(generators.laplacian3D(M, M, M))
    A.assemble(device=dev, dtype=torch.float64)
    rep = {"cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads(),
           "setup_workers": _setup_workers(), "default_shards": default_shards(),
           "OMP_WAIT_POLICY": os.environ.get("OMP_WAIT_POLICY")}
    print("  host: " + json.dumps(rep))
    infos = {}
    for label, shards in (("default", -1), ("serial", 0), ("default_again", -1)):
        s = AMG(device=dev, dtype=torch.float64)
        t0 = time.perf_counter()
        s.set_matrix(A, Options(remove_boundary=True, setup_shards=shards))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info = infos[label] = s.info
        rep[label] = {"setup_shards": shards, "wall_s": wall,
                      "phases_s": {k: round(v, 3) for k, v in info.phases.items()},
                      "n_shards": info.n_shards, "native": info.native,
                      "upload_bytes": info.upload_bytes,
                      "comm_bytes": None if info.comm is None else info.comm.total_bytes,
                      "dist_levels": None if info.comm is None else info.comm.dist_levels}
        print(f"  {label}: " + json.dumps(rep[label]))
        if info.comm is not None:
            print("    " + info.comm.table().replace("\n", "\n    "))
    print("  " + infos["default"].table().replace("\n", "\n  "))
    bad = None
    if not all(i.native for i in infos.values()):
        bad = "the native host kernels were not used"
    else:
        diff = host_levels_differ(infos["default"], infos["serial"])
        if diff:
            bad = f"default and serial setups differ: {diff}"
    return rep, bad


# entry points of phase 3d: (AMG method, keyword arguments)
ENTRY_POINTS = (("solve", {}), ("solve_pGMRES", {}),
                ("solve_CG", {"max_iter": 30}),
                ("solve_smoother", {"max_iter": 30}),
                ("solve_GMRES", {"max_iter": 30, "precondition": False}))


# what phase 3 must launch, as runtime.launches keys and launch_table's
# paths: every kernel and its bf16 mode, both designs of K1 and both paths
# of K2 and K3 (either strip8 mode will do), K1 over a shard's rectangular
# block and K3 on a shard's view
MUST_LAUNCH = ("dia", "dia.tiled", "dia.rows", "dia.rect", "dia.bf16",
               "strip", "strip.rows", "strip.stream", "strip.bf16",
               "strip8", "strip8.rows", "strip8.stream", "strip8.shard", "strip8.bf16",
               "ell", "ell.bf16", "csr_spgemm")


def launch_table(made) -> dict:
    """``made`` (a count of runtime.launches) for JSON: a shape key's parts
    joined by spaces, and the paths that have no key of their own: K1's
    tiled kernel, K2's and K3's rows path and K3 on general layouts."""
    out = {k if isinstance(k, str) else " ".join(map(str, k)): made[k]
           for k in sorted(made, key=str)}
    out["dia.tiled"] = made["dia"] - made["dia.rows"]
    for k in ("strip", "strip8"):
        out[f"{k}.rows"] = made[k] - made[f"{k}.stream"]
    out["strip8.general"] = made["strip8"] - made["strip8.interval"]
    return out


def dia_shapes(made) -> dict:
    """K1's launches in ``made`` by shape, "<n_pad>x<ndiag> <variant>"."""
    keys = sorted(k for k in made if isinstance(k, tuple) and k[0] == "dia")
    return {f"{k[1]}x{k[2]} {k[3]}": made[k] for k in keys}


def launch_failure(made):
    """None when K1's launches in ``made`` by shape add up to its launches
    and the row kernel took exactly those of operators of at most CHUNK
    diagonals, else how they do not."""
    from saena_tpu_torch.ops.dia_spmv import CHUNK

    shapes = {k: v for k, v in made.items() if isinstance(k, tuple) and k[0] == "dia"}
    narrow = sum(v for (_, _, nd, _), v in shapes.items() if nd <= CHUNK)
    if sum(shapes.values()) != made["dia"]:
        return (f"DIA launches by shape ({sum(shapes.values())}) do not add up "
                f"to its {made['dia']} launches")
    if made["dia.rows"] != narrow:
        return (f"{made['dia.rows']} DIA launches took the row kernel, "
                f"{narrow} were of operators of at most {CHUNK} diagonals")
    return None


def cpu_twin(solver):
    """An f64 AMG on the CPU holding the card solver's host levels,
    devicified on the CPU (the port's CPU branch: direct P/R), with the
    card solver's eig estimates of the same host CSRs, its options, rhs and
    boundary bookkeeping."""
    import torch

    from saena_tpu_torch import AMG
    from saena_tpu_torch.amg.hierarchy import _DoneFuture, devicify
    from saena_tpu_torch.api import _SolveVectors

    info = solver.info
    cpu = AMG(device="cpu", dtype=torch.float64)
    cpu.opts, cpu.params = solver.opts, solver.params
    cpu._io = _SolveVectors(solver._io.n_full, cpu.device, solver._io.split)
    cpu._rhs = solver._rhs
    eigs = {l: _DoneFuture(L.eig_max)
            for l, L in enumerate(solver.hierarchy.levels) if L.eig_max is not None}
    cpu.hierarchy, cpu.info = devicify(
        info.csr_levels, info.Ps, info.Rs, solver.opts, dtype=torch.float64,
        device="cpu", eig_futures=eigs)
    cpu.info.thetas, cpu.info.coarsen_kinds = info.thetas, info.coarsen_kinds
    return cpu


def agree(res, ref):
    """None when two SolveResults took the same iterations with histories
    at rtol 1e-6, else how they differ."""
    if res.iters != ref.iters:
        return f"iterations {res.iters} != CPU {ref.iters}"
    h = res.history[: res.iters + 1].cpu().numpy()
    hr = ref.history[: ref.iters + 1].cpu().numpy()
    if not np.allclose(h, hr, rtol=1e-6, atol=0.0):
        return f"history off the CPU run by {np.max(np.abs(h / hr - 1)):.3e}"
    return None


def timed(fn):
    """(result of fn(), ms by CUDA events, its launches) of one call after
    a warm call."""
    import torch

    from saena_tpu_torch.runtime import launches_of

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def call():
        e0.record()
        out = fn()
        e1.record()
        return out

    out, made = launches_of(call)
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1), made


def entry_points(solver, cpu):
    """Phase 3d on one solver; ``cpu``, its CPU twin or None (f32), holds
    the f64 runs. The rhs is a seeded random vector (the Poisson rhs is
    close to an eigenvector, which plain CG solves at once), the solver's
    own rhs again afterwards. Returns (rows, failure or None)."""
    saved = solver._rhs
    rhs = np.random.default_rng(11).standard_normal(saved.size)
    for s in (solver, cpu):
        if s is not None:
            s.set_rhs(rhs)
    rows, bad = [], None
    for name, kw in ENTRY_POINTS:
        (u, res), ms, launched = timed(lambda: getattr(solver, name)(tol=1e-8, **kw))
        r = {"entry": name, "dtype": str(solver.dtype), **kw, "iters": res.iters,
             "rel_res": float(res.rel_res), "ms": ms, "launches": launch_table(launched)}
        if not np.isfinite(u).all():
            bad = bad or f"{name} ({solver.dtype}): non-finite solution"
        if cpu is not None:
            _, ref = getattr(cpu, name)(tol=1e-8, **kw)
            r["cpu_iters"] = ref.iters
            why = agree(res, ref)
            if why:
                bad = bad or f"{name} (f64) against the CPU run: {why}"
            if name in ("solve", "solve_pGMRES") and not float(res.rel_res) < 1e-8:
                bad = bad or f"{name} (f64): rel_res {float(res.rel_res):.3e}"
        rows.append(r)
        print("  " + json.dumps(r))
    for s in (solver, cpu):
        if s is not None:
            s.set_rhs(saved)
    return rows, bad


def lazy_updates(solver, cpu):
    """Phase 3e: update1 (A x 1.5), update2 (then plus 0.1 I), update3
    (three diagonal entries more), a pCG solve after each, on the card and
    on its CPU twin. Returns (rows, failure or None)."""
    import scipy.sparse as sp
    import torch

    from saena_tpu_torch import Matrix, generators

    A0 = generators.laplacian3D(M, M, M).tocsr()
    A1 = (1.5 * A0).tocsr()
    A2 = (A1 + sp.diags(np.full(A0.shape[0], 0.1))).tocsr()
    A3 = A2.tolil()
    for c in (1, M // 2, M - 2):                 # interior grid points
        i = (c * M + c) * M + c
        A3[i, i] += 0.5
    A3 = A3.tocsr()

    def matrix(A, dev):
        mat = Matrix()
        mat.set_csr(A.copy())
        mat.assemble(device=dev, dtype=torch.float64)
        return mat

    rows, bad = [], None
    for name, A in (("update1", A1), ("update2", A2), ("update3", A3)):
        H0 = solver.hierarchy
        t0 = time.perf_counter()
        getattr(solver, name)(matrix(A, solver.device))
        torch.cuda.synchronize()
        upd_s = time.perf_counter() - t0
        getattr(cpu, name)(matrix(A, "cpu"))
        H1 = solver.hierarchy
        fresh = not H1.graphs          # the update dropped the graphs
        (u, res), ms, launched = timed(solver.solve_pCG)
        _, ref = cpu.solve_pCG()
        r = {"update": name, "update_s": upd_s, "iters": res.iters,
             "cpu_iters": ref.iters, "rel_res": float(res.rel_res),
             "solve_ms": ms, "launches": launch_table(launched),
             "formats": level_formats(H1),
             "recaptured": fresh and any(L.graphs is not None
                                         for L in H1.graphs.values())}
        if not r["recaptured"]:
            bad = bad or f"{name}: the solve after it was not captured anew"
        if name == "update1":
            r["reused_levels"] = all(H1.levels[l] is H0.levels[l]
                                     for l in range(1, H0.n_levels))
            r["reused_eigs"] = [L.eig_max for L in H1.levels] == \
                [L.eig_max for L in H0.levels]
            r["reused_coarse_lu"] = H1.coarse_lu is H0.coarse_lu
            if not (r["reused_levels"] and r["reused_eigs"] and r["reused_coarse_lu"]):
                bad = bad or f"update1 did not reuse what it should: {r}"
        why = agree(res, ref)
        if why:
            bad = bad or f"{name}: {why}"
        if not np.isfinite(u).all():
            bad = bad or f"{name}: non-finite solution"
        rows.append(r)
        print("  " + json.dumps(r))
    return rows, bad


# ------------------------------------------------ phase 3f: graph solves --


def eager_pcg(H, rhs, **kw):
    """pCG with its loop body called directly on the card, no graph: the
    uncaptured loop the graph replays are held against."""
    from saena_tpu_torch.amg import solvers

    return solvers._solve(solvers._pcg, H, rhs, graphs=False, **kw)


def graph_solve(solver, label, golden):
    """Phase 3f on the solver's hierarchy: the pCG solve through graphs
    against the same loop uncaptured (equal iterations, bit-equal history
    and u, equal launches), the golden or the f32 bound, and the capture
    time. Returns (row, failure or None)."""
    from saena_tpu_torch.runtime import launches_of

    H = solver.hierarchy
    (ug, rg), lg = launches_of(solver.solve_pCG)
    (ue, re_), le = launches_of(lambda: solver._run(eager_pcg))
    loop = H.graphs[("_pcg", solver.params, H.dtype, solver.opts.max_iter)]
    it = rg.iters
    row = {"run": label, "dtype": str(solver.dtype), "iters": it,
           "eager_iters": re_.iters, "rel_res": float(rg.rel_res),
           "capture_ms": loop.capture_ms, "launches_graph": launch_table(lg),
           "launches_eager": launch_table(le)}
    bad = None
    if rg.iters != re_.iters:
        bad = f"graph {rg.iters} != uncaptured {re_.iters} iterations"
    elif not (np.array_equal(ug, ue) and
              np.array_equal(rg.history[: it + 1].cpu().numpy(),
                             re_.history[: it + 1].cpu().numpy())):
        d = np.max(np.abs(ug - ue)) / np.max(np.abs(ue))
        bad = f"graph and uncaptured solves differ (u by {d:.3e} relative)"
    elif lg != le:
        bad = f"launches a solve: graph {dict(lg)} != uncaptured {dict(le)}"
    elif golden is not None:
        gh = np.asarray(golden["history"])
        hist = rg.history[: it + 1].cpu().numpy()
        if it != golden["iters"] or not np.allclose(hist, gh, rtol=1e-6, atol=0.0):
            bad = f"graph solve off the golden: {it} iterations, {hist}"
    elif not (float(rg.rel_res) < 1e-8 and it <= 100):
        bad = f"f32 graph solve: rel_res {float(rg.rel_res):.3e} after {it}"
    print("  " + json.dumps(row))
    return row, bad


def coarse_cg(solver, cpu):
    """pCG with direct_solver="CG" (the coarsest CG inside the captured
    V-cycle) on the card and on the CPU twin: equal iterations, histories
    at rtol 1e-6. Returns (row, failure or None)."""
    saved = solver.params
    solver.params = cpu.params = dataclasses.replace(saved, direct_solver="CG")
    try:
        (u, res), ms, launched = timed(solver.solve_pCG)
        _, ref = cpu.solve_pCG()
    finally:
        solver.params = cpu.params = saved
    row = {"entry": "solve_pCG", "direct_solver": "CG", "iters": res.iters,
           "cpu_iters": ref.iters, "rel_res": float(res.rel_res), "ms": ms,
           "launches": launch_table(launched)}
    print("  " + json.dumps(row))
    return row, agree(res, ref) or (None if np.isfinite(u).all() else "non-finite u")


def capture_failure(dev):
    """A part that syncs with the host (Matrix.matvec copies from host
    memory) must raise GraphCaptureError naming the op; the card must work
    on afterwards. Returns (message, failure or None)."""
    import torch

    from saena_tpu_torch import Matrix, generators
    from saena_tpu_torch.amg.graphs import Graph, GraphCaptureError

    A = Matrix()
    A.set_csr(generators.laplacian3D(8, 8, 8))
    A.assemble(device=dev, dtype=torch.float64)
    v = np.ones(A.get_num_rows())
    try:
        Graph(lambda: A.matvec(v), "a host copy")
    except GraphCaptureError as e:
        msg = str(e)
    else:
        return None, "a capture with a host copy did not raise"
    ok = np.allclose(A.matvec(v), A.csr @ v)
    return msg, (None if ok and "saena_tpu_torch/api.py" in msg else
                 f"after a failed capture: matvec ok {ok}, message {msg!r}")


def profiles(solver):
    """profile_matvecs, vcycle_breakdown(per_level=True) and pcg_profile of
    the solver's hierarchy (20 calls a timing)."""
    from saena_tpu_torch import profiling as P

    H = solver.hierarchy
    rhs = np.zeros(H.n_pad)
    rhs[: H.n] = 1.0
    bd = P.vcycle_breakdown(H, solver.params, rhs, n_iter=20, per_level=True)
    out = {"profile_matvecs": P.profile_matvecs(H, n_iter=20),
           "vcycle_breakdown": bd,
           "pcg_profile": P.pcg_profile(H, solver.params, n_iter=20)}
    for k, v in out.items():
        print(f"  {k}: " + json.dumps(v))
    print("  " + P.format_breakdown(bd).replace("\n", "\n  "))
    return out


# ----------------------------- phase 3g-3j: FGMRES, twins, p-levels, rap --

# phase 3g's loops: (label, solve_GMRES keyword arguments)
GMRES_RUNS = (("GMRES", {"max_iter": 30, "precondition": False}),
              ("pGMRES", {"precondition": True}))


def fgmres_graphs(solver, cpu):
    """Phase 3g on the f64 picker hierarchy, seeded random rhs: FGMRES(30)
    30 steps without a preconditioner, and pFGMRES to 1e-8, each through
    graphs against the same loop uncaptured (equal iterations, bit-equal
    history and u, equal launches) and against the CPU twin (equal
    iterations, histories at rtol 1e-6). Returns (rows, failure or None)."""
    from saena_tpu_torch.amg import solvers
    from saena_tpu_torch.runtime import launches_of

    saved = solver._rhs
    rhs = np.random.default_rng(11).standard_normal(saved.size)
    solver.set_rhs(rhs)
    cpu.set_rhs(rhs)
    rows, bad = [], None
    for label, kw in GMRES_RUNS:
        def eager(**k):
            return solver._run(lambda H, r, **kk: solvers._solve(
                solvers._gmres, H, r, graphs=False, restart=30,
                precondition=kw["precondition"], **kk), **k)
        run_kw = {k: v for k, v in kw.items() if k == "max_iter"}
        graph = lambda: solver.solve_GMRES(tol=1e-8, **kw)
        (ug, rg), lg = launches_of(graph)
        (ue, re_), le = launches_of(lambda: eager(tol=1e-8, **run_kw))
        _, ref = cpu.solve_GMRES(tol=1e-8, **kw)
        it = rg.iters
        key = ("_gmres", solver.params, solver.hierarchy.dtype,
               kw.get("max_iter", solver.opts.max_iter),
               ("precondition", kw["precondition"]), ("restart", 30))
        loop = solver.hierarchy.graphs[key]
        row = {"run": label, "dtype": str(solver.dtype), **kw, "iters": it,
               "eager_iters": re_.iters, "cpu_iters": ref.iters,
               "rel_res": float(rg.rel_res), "capture_ms": loop.capture_ms,
               "graphs": len(loop.graphs or ()), "launches_graph": launch_table(lg),
               "launches_eager": launch_table(le)}
        why = agree(rg, ref)
        if rg.iters != re_.iters:
            why = f"graph {rg.iters} != uncaptured {re_.iters} iterations"
        elif not (np.array_equal(ug, ue) and np.array_equal(
                rg.history[: it + 1].cpu().numpy(),
                re_.history[: it + 1].cpu().numpy())):
            why = "graph and uncaptured solves differ"
        elif lg != le:
            why = f"launches: graph {dict(lg)} != uncaptured {dict(le)}"
        elif label == "pGMRES" and not float(rg.rel_res) < 1e-8:
            why = f"rel_res {float(rg.rel_res):.3e}"
        elif len(loop.graphs or ()) != 4:
            why = "the loop did not replay its four graphs"
        if why:
            bad = bad or f"{label}: {why}"
        rows.append(row)
        print("  " + json.dumps(row))
    solver.set_rhs(saved)
    cpu.set_rhs(saved)
    return rows, bad


def twin_formats(H) -> list:
    """Per level: A's format and the twin's dtype (None without one)."""
    return [(type(L.A).__name__,
             None if L.A_smooth is None else str(L.A_smooth.dtype).split(".")[-1])
            for L in H.levels]


def twin_solve(solver, label, base_iters):
    """A warm and a timed pCG solve of a hierarchy with twins: rel_res
    below 1e-8 within one iteration of ``base_iters`` (the same solve
    without twins). Returns (row, failure or None)."""
    (u, res), ms, launched = timed(solver.solve_pCG)
    row = {"run": label, "dtype": str(solver.dtype),
           "twins": twin_formats(solver.hierarchy), "iters": res.iters,
           "iters_without_twins": base_iters, "rel_res": float(res.rel_res),
           "ms": ms, "launches": launch_table(launched)}
    print("  " + json.dumps(row))
    bad = None
    if not (float(res.rel_res) < 1e-8 and abs(res.iters - base_iters) <= 1):
        bad = (f"{label}: {res.iters} iterations to rel_res "
               f"{float(res.rel_res):.3e} ({base_iters} without twins)")
    elif not np.isfinite(u).all():
        bad = f"{label}: non-finite solution"
    return row, bad


def smooth_dtype_solves(dev, solver32, solver64):
    """Phase 3h: the 48^3 solves with Options.smooth_dtype, through
    Matrix/AMG: (a) f32 with bf16 twins (the card's picks: K1 bf16 SpMV on
    levels 0-1, K3 on the level-2 A), (b) the same hierarchy forced as in
    phase 3b (the level-2 A and its twin in strip: K2 with bf16 values),
    (c) f64 with f32 twins; each against the same solve without twins.
    Returns (rows, {label: solver}, failure or None)."""
    import torch

    from saena_tpu_torch import AMG, Matrix, Options, generators

    def setup(dtype, twin):
        A = Matrix()
        A.set_csr(generators.laplacian3D(M, M, M))
        A.assemble(device=dev, dtype=dtype)
        s = AMG(device=dev, dtype=dtype)
        t0 = time.perf_counter()
        s.set_matrix(A, Options(remove_boundary=True, smooth_dtype=twin))
        torch.cuda.synchronize()
        s.set_rhs(generators.laplacian3D_set_rhs(M, M, M))
        print(f"  setup {dtype} with {twin} twins: {time.perf_counter() - t0:.3f} s")
        return s

    def base(solver):
        """Iterations of the solver's solve without twins."""
        return solver.solve_pCG()[1].iters

    rows, solvers, bad = [], {}, None
    base32 = base(solver32)
    s_bf = solvers["f32_bf16"] = setup(torch.float32, "bfloat16")
    row, why = twin_solve(s_bf, "f32_bf16_picker", base32)
    rows.append(row)
    bad = bad or why
    picker_bf = s_bf.hierarchy
    s_bf.hierarchy = forced_hierarchy(s_bf)
    saved32 = solver32.hierarchy
    solver32.hierarchy = forced_hierarchy(solver32)
    base_forced = base(solver32)
    solver32.hierarchy = saved32
    row, why = twin_solve(s_bf, "f32_bf16_forced", base_forced)
    rows.append(row)
    bad = bad or why
    solvers["f32_bf16_forced"] = s_bf.hierarchy
    s_bf.hierarchy = picker_bf
    s64 = solvers["f64_f32"] = setup(torch.float64, "float32")
    row, why = twin_solve(s64, "f64_f32_picker", base(solver64))
    rows.append(row)
    bad = bad or why
    return rows, solvers, bad


# the synthetic modal problem of phase 3i: kron(L, K), L the interior 3-D
# Poisson on P_UNITS^3 units, K a P_MODES x P_MODES SPD modal block
P_UNITS, P_MODES = 30, 5


def modal_problem(seed):
    """A = kron(L, K) with K = E E^T / 5 + 2 I (E standard normal from
    ``seed``, as tests/test_pcoarsen.py builds its element blocks), the
    order-4 modal unit layout that detect_modal_blocks accepts, and a
    seeded rhs."""
    import scipy.sparse as sp

    from saena_tpu_torch import generators
    from saena_tpu_torch.core.coo import remove_boundary_nodes

    rng = np.random.default_rng(seed)
    E = rng.standard_normal((P_MODES, P_MODES))
    K = E @ E.T / P_MODES + 2 * np.eye(P_MODES)
    m = P_UNITS + 2
    L = remove_boundary_nodes(generators.laplacian3D(m, m, m))[0]
    A = sp.kron(L, K).tocsr()
    return A, rng.standard_normal(A.shape[0])


def pcoarsen_solve(dev, seed):
    """Phase 3i: the modal problem set up on the card (f64, the default
    shard-parallel setup) with modal_block_plevels(P_UNITS^3, P_MODES): three
    p-levels, then h; pCG to 1e-8 held against the port's CPU run on the
    same host levels (kinds, sizes, iterations, histories at rtol 1e-6) and
    the setup seconds by phase. Returns (row, failure or None)."""
    import torch

    from saena_tpu_torch import AMG, Matrix, Options
    from saena_tpu_torch.amg.pcoarsen import detect_modal_blocks, modal_block_plevels

    t0 = time.perf_counter()
    A, rhs = modal_problem(seed)
    n_units = detect_modal_blocks(A, P_MODES)
    Ps = modal_block_plevels(n_units, P_MODES)
    build_s = time.perf_counter() - t0
    mat = Matrix()
    mat.set_csr(A)
    mat.assemble(device=dev, dtype=torch.float64)
    s = AMG(device=dev, dtype=torch.float64)
    t0 = time.perf_counter()
    s.set_matrix(mat, Options(), p_levels=Ps)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    s.set_rhs(rhs)
    print("  " + s.info.table().replace("\n", "\n  "))
    (u, res), ms, launched = timed(s.solve_pCG)
    cpu = cpu_twin(s)
    _, ref = cpu.solve_pCG()
    row = {"n": A.shape[0], "nnz": int(A.nnz), "n_units": n_units,
           "p_levels": [list(P.shape) for P in Ps], "build_s": build_s,
           "setup_s": setup_s,
           "setup_phases_s": {k: round(v, 3) for k, v in s.info.phases.items()},
           "sizes": s.info.sizes, "kinds": s.info.coarsen_kinds,
           "formats": s.info.formats, "iters": res.iters, "cpu_iters": ref.iters,
           "rel_res": float(res.rel_res), "ms": ms, "launches": launch_table(launched)}
    print("  " + json.dumps(row))
    bad = agree(res, ref)
    kinds = s.info.coarsen_kinds
    if bad is None and not (kinds[:3] == ["p", "p", "p"] and "h" in kinds[3:]):
        bad = f"coarsen kinds {kinds}"
    elif bad is None and cpu.info.sizes != s.info.sizes:
        bad = f"sizes {s.info.sizes} != CPU {cpu.info.sizes}"
    elif bad is None and not float(res.rel_res) < 1e-8:
        bad = f"rel_res {float(res.rel_res):.3e} after {res.iters}"
    elif bad is None and not np.isfinite(u).all():
        bad = "non-finite solution"
    return row, bad


def rap_device(dev, golden):
    """Phase 3j: the 48^3 f64 serial setup (setup_shards=0) on the card
    with rap="device" and rap="host": equal level sizes, every coarse
    level within 1e-11 of its max |A|, pCG in the golden's iterations both
    ways; the rap phase seconds and the block pairs multiplied. Returns
    (row, failure or None)."""
    import torch

    from saena_tpu_torch import AMG, Matrix, Options, generators
    from saena_tpu_torch.ops import bspgemm

    A = Matrix()
    A.set_csr(generators.laplacian3D(M, M, M))
    A.assemble(device=dev, dtype=torch.float64)
    out, row = {}, {}
    for rap in ("host", "device"):
        s = AMG(device=dev, dtype=torch.float64)
        p0 = bspgemm.pairs_total
        t0 = time.perf_counter()
        s.set_matrix(A, Options(remove_boundary=True, setup_shards=0, rap=rap))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s.set_rhs(generators.laplacian3D_set_rhs(M, M, M))
        _, res = s.solve_pCG()
        out[rap] = s
        row[rap] = {"wall_s": wall, "rap_s": s.info.phases.get("rap"),
                    "phases_s": {k: round(v, 3) for k, v in s.info.phases.items()},
                    "block_pairs": bspgemm.pairs_total - p0, "sizes": s.info.sizes,
                    "iters": res.iters, "rel_res": float(res.rel_res)}
    dev_lv, host_lv = out["device"].info.csr_levels, out["host"].info.csr_levels
    row["level_err"] = [float(abs(a - b).max() / abs(b).max())
                        for a, b in zip(dev_lv, host_lv)]
    print("  " + json.dumps(row))
    bad = None
    if row["device"]["sizes"] != row["host"]["sizes"]:
        bad = f"sizes {row['device']['sizes']} != host {row['host']['sizes']}"
    elif max(row["level_err"]) > 1e-11:
        bad = f"a level differs from the host product by {max(row['level_err']):.3e}"
    elif not row["device"]["iters"] == row["host"]["iters"] == golden["iters"]:
        bad = (f"iterations device {row['device']['iters']}, host "
               f"{row['host']['iters']}, golden {golden['iters']}")
    elif row["device"]["block_pairs"] <= 0:
        bad = "the device engine multiplied no block pairs"
    return row, bad


# ---------------------------------------------- phase 3k: sharded solves --

SHARD_COUNTS = (1, 2, 4, 8)
SHARD_D = 4                      # the shard count of phase 2's and 3k's options


def sharded_problem():
    """(A, rhs): the 48^3 Poisson interior system the golden solves."""
    from saena_tpu_torch.core.coo import remove_boundary_nodes
    from saena_tpu_torch.generators import laplacian3D, laplacian3D_set_rhs

    A, _, _, _, rhs = remove_boundary_nodes(laplacian3D(M, M, M),
                                            laplacian3D_set_rhs(M, M, M))
    return A, rhs


def sharded_build(info, mesh, dtype, eigs=None, fmt="auto", **kw):
    """(ShardedHierarchy, splits, Options, build seconds) of the host levels
    on ``mesh``."""
    from saena_tpu_torch.config import Options
    from saena_tpu_torch.parallel.sharded import shard_hierarchy

    opts = Options(**kw)
    t0 = time.perf_counter()
    sh, splits = shard_hierarchy(info, opts, mesh, dtype=dtype, eigs=eigs,
                                 sharded_format=fmt)
    return sh, splits, opts, time.perf_counter() - t0


def sharded_formats(sh) -> list:
    """Per sharded level: its operator's format with its shape, and its
    active shards; then the replicated tail's formats."""
    from saena_tpu_torch.parallel import sharded as S

    out = []
    for lv, act in zip(sh.sharded, sh.d_active):
        A = lv.A
        f = type(A).__name__
        if isinstance(A, S.ShardedDia):
            f += (f"({len(A.offsets)}x{A.n_loc}, x {A.lo_pad}+{A.n_loc}+{A.hi_pad}"
                  f", {A.plan.config if A.plan is not None else 'plain'})")
        elif isinstance(A, S.ShardedStrip8):
            f += f"(pr{A.perrow},{A.mode},{A.idx.shape[1]} tiles)"
        out.append({"level": lv.lvl, "n": lv.n, "A": f, "active": act,
                    "R": type(lv.R_next).__name__ if lv.R_next is not None else None,
                    "twin": str(lv.A_smooth.dtype) if lv.A_smooth is not None else None})
    out.append({"tail": level_formats(sh.replicated)})
    return out


def sharded_solve(sh, splits, mesh, opts, rhs, graphs=None, tol=1e-8):
    from saena_tpu_torch.amg.hierarchy import SolveParams
    from saena_tpu_torch.parallel.sharded import sharded_solve_pCG

    return sharded_solve_pCG(sh, splits, rhs, mesh,
                             params=SolveParams.from_options(opts), tol=tol,
                             max_iter=100, graphs=graphs)


def sharded_check(label, sh, splits, mesh, opts, rhs, ref_hist, golden):
    """The sharded pCG on ``sh`` through graphs against the same loop
    uncaptured (equal iterations, u and history bit for bit, equal
    launches), the golden's iterations and the history at rtol 1e-6
    against the serial graph solve (``ref_hist``; None: rel_res < 1e-8 in
    at most 100 iterations), and the capture ms. Returns (row, out of the
    graph solve, its launches, failure or None)."""
    from saena_tpu_torch.runtime import launches_of

    (ue, ite, r0e, rfe, he), le = launches_of(
        lambda: sharded_solve(sh, splits, mesh, opts, rhs, graphs=False))
    out, lg = launches_of(lambda: sharded_solve(sh, splits, mesh, opts, rhs))
    ug, itg, r0g, rfg, hg = out
    loop = next(iter(sh.graphs.values()))
    row = {"run": label, "formats": sharded_formats(sh), "iters": itg,
           "rel_res": rfg / r0g, "capture_ms": loop.capture_ms,
           "launches_graph": launch_table(lg), "launches_eager": launch_table(le)}
    bad = None
    if not np.isfinite(ug).all():
        bad = "non-finite solution"
    elif itg != ite or not (np.array_equal(ug, ue)
                            and np.array_equal(hg, he, equal_nan=True)):
        bad = (f"graph and uncaptured solves differ: {itg} / {ite} iterations, u by "
               f"{np.max(np.abs(ug - ue)):.3e}")
    elif lg != le:
        bad = f"launches a solve: graph {dict(lg)} != uncaptured {dict(le)}"
    elif ref_hist is not None:
        hist = hg[: itg + 1]
        if itg != golden["iters"] or not np.allclose(hist, ref_hist, rtol=1e-6, atol=0.0):
            bad = (f"{itg} iterations (golden {golden['iters']}), history off the "
                   f"serial solve by {np.max(np.abs(hist / ref_hist[: itg + 1] - 1)):.3e}")
    elif not (rfg / r0g < 1e-8 and itg <= 100):
        bad = f"rel_res {rfg / r0g:.3e} after {itg} iterations"
    print("  " + json.dumps(row))
    return row, out, lg, bad


def nccl_world_one(dev, info, eigs, rhs, ref):
    """The D = 4 default solve through parallel/multihost.py: an NCCL
    process group of world size 1 holding 4 shards. A mesh with a group
    runs its all_to_all, all_gather and psum through the group at any
    world size (comm.py), so the halo exchange is an NCCL
    all_to_all_single and the dots NCCL all_reduces; its ppermutes stay on
    the rank. Captured when the capture takes NCCL's collectives, else run
    uncaptured (the row says which); the row counts the collectives the
    first solve called (with graphs: the warm-up's and the captured ones).
    Returns (row, failure or None)."""
    import gc
    import socket

    import torch
    import torch.distributed as dist

    from saena_tpu_torch.amg.graphs import GraphCaptureError
    from saena_tpu_torch.parallel.multihost import global_mesh, init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                     backend="nccl" if torch.device(dev).type == "cuda" else "gloo")
    sh = None
    try:
        mesh = global_mesh(SHARD_D, device=dev)
        sh, splits, opts, _ = sharded_build(info, mesh, ref["dtype"], eigs)
        row = {"backend": mesh.backend, "world": mesh.world, "shards": mesh.size}
        graphs = mesh.device.type == "cuda"
        calls = dict.fromkeys(("all_to_all_single", "all_gather_into_tensor",
                               "all_reduce"), 0)
        saved = {k: getattr(dist, k) for k in calls}

        def counted(name):
            def call(*a, **kw):
                calls[name] += 1
                return saved[name](*a, **kw)
            return call

        for k in calls:
            setattr(dist, k, counted(k))
        try:
            out = sharded_solve(sh, splits, mesh, opts, rhs, graphs=graphs)
            row["captured"] = graphs
        except GraphCaptureError as e:
            row["captured"] = False
            row["capture_error"] = str(e)[:300]
            sh.graphs.clear()
            out = sharded_solve(sh, splits, mesh, opts, rhs, graphs=False)
        finally:
            for k, fn in saved.items():
                setattr(dist, k, fn)
        row["nccl_calls"] = dict(calls)
        u, it, r0, rf, hist = out
        row.update(iters=it, rel_res=rf / r0,
                   u_diff=float(np.max(np.abs(u - ref["u"]))) / float(np.max(np.abs(ref["u"]))))
        print("  " + json.dumps(row))
        bad = None
        if it != ref["iters"] or not row["u_diff"] <= 1e-12:
            bad = f"NCCL world-1 solve: {it} iterations, u off by {row['u_diff']:.3e}"
        elif min(calls["all_to_all_single"], calls["all_reduce"]) <= 0:
            bad = f"NCCL world-1 solve called no NCCL collective: {calls}"
        return row, bad
    finally:
        # the graphs that hold NCCL's kernels go before their communicator
        if sh is not None:
            sh.graphs.clear()
            gc.collect()
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
        dist.destroy_process_group()


def sharded_update1(dev, mesh):
    """update1 (A x 1.5) through update_sharded_values: an AMG on the card,
    its D = 4 sharded hierarchy, the API's update1, the values-only
    sharded refresh (eig estimates kept), and a sharded solve of the
    updated system against the serial solve after the update. Returns
    (row, failure or None)."""
    import torch

    from saena_tpu_torch import AMG, Matrix, Options, generators
    from saena_tpu_torch.parallel.sharded import shard_hierarchy, update_sharded_values

    def matrix(A):
        mat = Matrix()
        mat.set_csr(A)
        mat.assemble(device=dev, dtype=torch.float64)
        return mat

    A0 = generators.laplacian3D(M, M, M).tocsr()
    sv = AMG(device=dev, dtype=torch.float64)
    sv.set_matrix(matrix(A0), Options(remove_boundary=True))
    sv.set_rhs(generators.laplacian3D_set_rhs(M, M, M))
    opts = Options()
    sh0, _ = shard_hierarchy(sv.info, opts, mesh, dtype=torch.float64)
    sv.update1(matrix((1.5 * A0).tocsr()))
    t0 = time.perf_counter()
    sh1, splits = update_sharded_values(sh0, sv.info, opts, mesh, dtype=torch.float64)
    upd_s = time.perf_counter() - t0
    _, rhs = sharded_problem()
    u, it, r0, rf, hist = sharded_solve(sh1, splits, mesh, opts, rhs)
    _, ref = sv.solve_pCG()
    row = {"update": "update1", "refresh_s": upd_s, "iters": it,
           "serial_iters": ref.iters, "rel_res": rf / r0,
           "eigs_kept": [lv.eig_max for lv in sh1.sharded] ==
           [lv.eig_max for lv in sh0.sharded]}
    print("  " + json.dumps(row))
    ok = row["eigs_kept"] and it == ref.iters and rf / r0 < 1e-8 and np.isfinite(u).all()
    return row, None if ok else f"update1 through update_sharded_values: {row}"


# the option runs at D = SHARD_D: (label, dtype, sharded_format, Options
# keywords, iteration rule). The rule is what tests/test_parallel.py
# allows for the option: "serial" the serial solve's iterations, ("near",
# run, k) within k of that run's, "max" at most 100; every run must reach
# rel_res < 1e-8
SHARD_OPTIONS = (
    ("ell", "float64", "ell", {}, "serial"),
    ("bsr", "float64", "bsr", {}, "serial"),
    ("strip8", "float64", "strip8", {}, "serial"),
    ("dia", "float64", "dia", {}, "max"),
    ("allgather", "float64", "auto", {"halo_mode": "allgather"}, "serial"),
    ("halo_bf16", "float64", "auto", {"compress_halo": True}, "max"),
    ("halo_int8_block", "float64", "auto",
     {"compress_halo": True, "halo_dtype": "int8_block"}, ("near", "default", 2)),
    ("shrink_values", "float64", "auto", {"shrink_values": (0, 2, 2)}, "serial"),
    ("dense_ring", "float64", "auto",
     {"replicate_threshold": 2000, "dense_thre": 0.005, "dense_sz_thre": 3000}, "max"),
    ("f32", "float32", "auto", {}, "max"),
    ("f32_bf16_twins", "float32", "auto", {"smooth_dtype": "bfloat16"},
     ("near", "f32", 1)),
)


def sharded_solves(dev, info, golden, serial, d4):
    """Phase 3k. ``serial``: (iterations, history) of the serial f64 graph
    solve on the same host levels; ``d4``: phase 2's (hierarchy, splits,
    mesh) at D = SHARD_D, the run at that D. Returns (report, launches of
    the phase, failure or None)."""
    from collections import Counter

    import torch

    from saena_tpu_torch import profiling
    from saena_tpu_torch.config import Options
    from saena_tpu_torch.parallel.comm import Mesh
    from saena_tpu_torch.runtime import launches_of

    A, rhs = sharded_problem()
    rep = {"by_D": [], "options": []}
    total = Counter()
    f64 = torch.float64

    def run(label, sh, splits, mesh, opts, ref_hist):
        """One run of sharded_check, its launches added to the phase's; K1's
        launches in its graph solve by shape."""
        (row, out, lg, bad), made = launches_of(lambda: sharded_check(
            label, sh, splits, mesh, opts, rhs, ref_hist, golden))
        total.update(made)
        return row, out, dia_shapes(lg), bad or launch_failure(made)

    eigs = None
    meshes, default = {}, {}
    for D in SHARD_COUNTS:
        if D == SHARD_D:
            sh, splits, mesh = d4
            opts, build_s = Options(), None
        else:
            mesh = Mesh(D, dev)
            sh, splits, opts, build_s = sharded_build(info, mesh, f64, eigs)
        meshes[D] = mesh
        eigs = eigs or [lv.eig_max for lv in sh.sharded] + \
            [L.eig_max for L in sh.replicated.levels]
        row, out, shapes, bad = run(f"D={D}", sh, splits, mesh, opts, serial[1])
        row["build_s"] = build_s
        rep["by_D"].append(row)
        if bad:
            return rep, total, f"D = {D}: {bad}"
        if D == SHARD_D:
            default = {"sh": sh, "splits": splits, "mesh": mesh, "opts": opts,
                       "u": out[0], "iters": out[1], "dtype": f64,
                       "per_shape": shapes}
            rep["default"] = default
    mesh = meshes[SHARD_D]
    iters = {"default": default["iters"]}
    for label, dname, fmt, kw, rule in SHARD_OPTIONS:
        sh, splits, opts, build_s = sharded_build(info, mesh, getattr(torch, dname),
                                                  eigs, fmt, **kw)
        row, out, shapes, bad = run(label, sh, splits, mesh, opts, None)
        row["build_s"] = build_s
        iters[label] = out[1]
        if label == "f32":
            rep["f32_per_shape"] = shapes
        rep["options"].append(row)
        kinds = [f["A"].split("(")[0] for f in row["formats"][:-1]]
        want = {"ell": "ShardedEll", "bsr": "ShardedBsr", "strip8": "ShardedStrip8",
                "dia": "ShardedDia", "dense_ring": "ShardedDense"}.get(label)
        if bad is None and want is not None and want not in kinds:
            bad = f"no {want} level: {kinds}"
        if bad is None and label == "shrink_values" and \
                sh.d_active[:2] != (SHARD_D, SHARD_D // 2):
            bad = f"active shards {sh.d_active}"
        if bad is None and label == "f32_bf16_twins" and \
                not any(lv.A_smooth is not None for lv in sh.sharded):
            bad = "no bf16 twin"
        if bad is None:
            if rule == "serial" and out[1] != serial[0]:
                bad = f"{out[1]} iterations, the serial solve {serial[0]}"
            elif isinstance(rule, tuple) and abs(out[1] - iters[rule[1]]) > rule[2]:
                bad = f"{out[1]} iterations, {rule[1]} {iters[rule[1]]}"
        if bad:
            return rep, total, f"{label}: {bad}"

    def rest():
        print("  profile_sharded_matvecs, D = 4, f64:")
        rows = profiling.profile_sharded_matvecs(default["sh"], mesh, n_iter=20)
        rep["profile"] = rows
        print("  " + profiling.format_sharded_profile(rows).replace("\n", "\n  "))
        rep["update1"], bad = sharded_update1(dev, mesh)
        rep["nccl"], bad2 = nccl_world_one(dev, info, eigs, rhs, default)
        return bad or bad2

    bad, made = launches_of(rest)
    total.update(made)
    return rep, total, bad or launch_failure(made)


def shard_cases(dev, info):
    """Phase 2's sharded shapes: the D = SHARD_D f64 sharded hierarchy of
    the host levels as shard_hierarchy builds it on the card, K1's cases
    (shard 1 of each ShardedDia level: its rectangular block, x the
    halo-extended block, x_row0 = lo_pad / 128) and K3's case (shard 1 of
    the level-2 A in strip8: the hierarchy's own layout where the picker
    took strip8 there, else sharded_format="strip8"'s), with its block in
    extended-local columns as a host CSR. Returns (hierarchy, splits, mesh,
    K1 cases, {name: (kind, layout, host CSR)})."""
    import torch

    from saena_tpu_torch.parallel import sharded as S
    from saena_tpu_torch.parallel.comm import Mesh
    from saena_tpu_torch.parallel.partition import subset_split

    mesh = Mesh(SHARD_D, dev)
    sh, splits, _, build_s = sharded_build(info, mesh, torch.float64)
    print(f"  D = {SHARD_D} sharded hierarchy built in {build_s:.1f} s: "
          + json.dumps(sharded_formats(sh)))
    dia = []
    for lv in sh.sharded:
        A = lv.A
        if isinstance(A, S.ShardedDia):
            dia.append((f"shard1_L{lv.lvl}_{len(A.offsets)}diag", A.data[1],
                        A.ext_offsets, A.lo_pad + A.n_loc + A.hi_pad,
                        A.lo_pad // 128, A.n_loc))
    A2 = info.csr_levels[2]
    split2 = splits[2] if len(splits) > 2 else subset_split(A2, SHARD_D, SHARD_D)
    op = sh.sharded[2].A if len(sh.sharded) > 2 else None
    if not isinstance(op, S.ShardedStrip8):
        op = S._build_sharded_strip8(A2, split2, split2, torch.float64, "exchange", mesh)
    geo = S._sharded_strip8_geometry(A2, split2, split2, "exchange")
    gather = {"shard1_L2_A": ("strip8", op.views[1], geo[0][1].tocsr())}
    return sh, splits, mesh, dia, gather


def sharded_strip8_breakdown(dev, sh) -> dict:
    """µs of the level-2 ShardedStrip8 matvec of ``sh`` (f64, graph-
    replayed) and of its parts: the halo extension, the pad to n_cols_pad,
    K3 on each shard alone (its tiles stay in L2 from call to call), K3 on
    every shard in a row (as the matvec runs them) and the stack."""
    import torch

    from saena_tpu_torch.ops import strip8_spmv as s8
    from saena_tpu_torch.profiling import graph_ms

    lv = sh.sharded[2]
    A = lv.A
    x = torch.ones(lv.inv_diag.shape, dtype=torch.float64, device=dev)
    ext = A.plan.extend(x)
    pad = lambda: torch.nn.functional.pad(ext, (0, A.n_cols_pad - ext.shape[-1]))
    xp = pad()
    views = [(d, M) for d, M in enumerate(A.views) if M is not None]
    ys = [s8.strip8_spmv(M, xp[d]) for d, M in views]
    us = lambda fn: graph_ms(fn) * 1e3
    out = {"matvec_us": us(lambda: A.matvec(x)), "extend_us": us(lambda: A.plan.extend(x)),
           "pad_us": us(pad),
           "k3_alone_us": [us(lambda M=M, d=d: s8.strip8_spmv(M, xp[d])) for d, M in views],
           "k3_in_a_row_us": us(lambda: [s8.strip8_spmv(M, xp[d]) for d, M in views]),
           "stack_us": us(lambda: torch.stack(ys)),
           "tiles": [int(M.tile_list.numel()) for _, M in views],
           "tile_bytes": int(sum(M.idx[: M.tile_list.numel()].numel()
                                 * (1 + M.vals.element_size()) for _, M in views))}
    print("  " + json.dumps(out))
    return out


def time_rect_dia(dev, sh, info, per_shape: dict) -> list:
    """K1 in rectangular mode on shard 1 of the level-0 ShardedDia (f32,
    f64; SpMV, Chebyshev update, residual): kernel ms graph-replayed, the
    plain version, cuSPARSE's CSR SpMV of the same block (rows of the shard,
    columns of its extended x), the bound (data, x over the extended block,
    rhs / dinv, y each once) and launches per sharded solve (``per_shape``:
    {dtype name: {"<n_loc>x<ndiag> <variant>": launches}} of one D = SHARD_D
    solve at that dtype, phase 3k's default f64 run and its f32 run)."""
    import scipy.sparse as sp
    import torch

    from saena_tpu_torch.ops import dia_spmv as dmod
    from saena_tpu_torch.profiling import graph_ms

    A0 = sh.sharded[0].A
    n_loc, nd, lo = A0.n_loc, len(A0.offsets), A0.lo_pad
    m_pad = lo + n_loc + A0.hi_pad
    r0 = n_loc                                     # shard 1's first row
    Ah = info.csr_levels[0]
    blk = Ah[r0: r0 + n_loc].tocoo()
    block = sp.csr_matrix((blk.data, (blk.row, blk.col - r0 + lo)),
                          shape=(n_loc, m_pad))
    rows = []
    for dname in ("float32", "float64"):
        dt = getattr(torch, dname)
        data = A0.data[1].to(dt).contiguous()
        plan = dmod.dia_plan(A0.ext_offsets, n_loc, dt, dmod.sm_count(dev))
        rng = np.random.default_rng(5)
        x = torch.tensor(rng.standard_normal(m_pad), dtype=dt, device=dev)
        rhs = torch.tensor(rng.standard_normal(n_loc), dtype=dt, device=dev)
        dinv = torch.tensor(1.0 / Ah.diagonal()[r0: r0 + n_loc], dtype=dt, device=dev)
        Acsr = csr_on_card(block, dt, dev, n_loc, m_pad)
        isz = data.element_size()
        for vname in ("spmv", "cheb", "residual"):
            has_rhs, has_dinv, c, add_x = VARIANTS[vname]
            kw = dict(rhs=rhs if has_rhs else None, dinv=dinv if has_dinv else None,
                      c=c, add_x=add_x, x_row0=lo // 128)
            nbytes = nd * isz * n_loc + m_pad * isz + (1 + has_rhs + has_dinv) * isz * n_loc
            flops = (2 * nd + 3 * has_rhs) * n_loc
            b_ms, b_by = bound(nbytes, flops, dname)
            r = {"kernel": "dia_spmv", "shape": f"L0 shard {nd}x{n_loc} on x of {m_pad}",
                 "dtype": dname, "variant": vname, "plan": plan.describe(),
                 "ms": graph_ms(lambda: dmod.dia_spmv(
                     data, x, A0.ext_offsets, offsets_dev=A0.offsets_dev, plan=plan,
                     **kw)),
                 "plain_ms": graph_ms(lambda: dmod.dia_spmv_plain(
                     data, x, A0.ext_offsets, **kw), reps=10, replays=5),
                 "library_ms": graph_ms(lambda: Acsr @ x) if vname == "spmv" else None,
                 "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
                 "launches_per_solve": per_shape[dname].get(f"{n_loc}x{nd} {vname}", 0)}
            r["share_of_bound"] = b_ms / r["ms"]
            rows.append(r)
            print("  " + json.dumps(r))
    return rows


# ------------------------------------------- phase 3l: products over a mesh --

RING_COUNTS = (1, 2, 4, 8)           # shard counts of the 48^3 Galerkin product
SWEEP_N = 5000                       # examples/gemm.py's default size
SWEEP_DENS = (0.001, 0.005, 0.01)
SWEEP_D = (1, 4)
SWEEP_REPS, SWEEP_WARM = 20, 10
# peak FLOP/s of one H100 SXM at 700 W for a matrix product without TF32
# (NVIDIA data sheet): f32 outside the tensor cores, f64 on them
MATMUL_FLOPS = {"float32": 67e12, "float64": 67e12}


def events_ms(fn, reps: int, warm: int = 1) -> dict:
    """Median, min and max ms of ``reps`` calls of ``fn`` after ``warm``,
    each between two CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return {"median": float(np.median(ms)), "min": min(ms), "max": max(ms)}


def matmul_bound(nbytes: int, flops: int, dname: str) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations") of a matrix product."""
    b_bytes = nbytes / HBM_BPS * 1e3
    b_ops = flops / MATMUL_FLOPS[dname] * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")


def galerkin_operands():
    """(R, A, P) of the M^3 Poisson interior's first level: aggregation at
    theta 0.3 and the smoothed prolongator, by the port's host functions."""
    from saena_tpu_torch.amg.prolongation import restriction, smoothed_prolongator
    from saena_tpu_torch.amg.strength import find_aggregation

    A = _poisson_interior(M).tocsr()
    agg, n_c, _ = find_aggregation(A, 0.3)
    P = smoothed_prolongator(A, agg, n_c)
    return restriction(P), A, P


def ring_product(X, Y, mesh, dtype, tol, reps: int = 5):
    """X @ Y on the block-sparse ring by its parts, as matmat_sparse runs
    them: the host plan with its upload, the numeric phase (median of
    ``reps`` after a warm run), the gather and assembly. Returns (C, row)."""
    import torch

    from saena_tpu_torch.ops import bspgemm
    from saena_tpu_torch.parallel.partition import equal_row_split

    D = mesh.size
    bk = bspgemm.pick_bk(X, Y)
    plan = bspgemm._ring_plan(X, Y, D, bk, equal_row_split(X.shape[0], D),
                              equal_row_split(Y.shape[0], D), dtype, mesh)
    out = {}
    t = events_ms(lambda: out.__setitem__("C", bspgemm._ring_bsp_numeric(plan, mesh)),
                  reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C = bspgemm._assemble_ring(mesh.all_gather(out["C"]).cpu().numpy(), plan, tol)
    asm = time.perf_counter() - t0
    dname = str(dtype).split(".")[-1]
    nbytes = (plan.Ab.numel() + plan.Bb.numel() + out["C"].numel()) * plan.Ab.element_size()
    flops = 2 * plan.pairs * 8 * bk * 128
    b_ms, b_by = matmul_bound(nbytes, flops, dname)
    row = {"shape": f"{X.shape[0]}x{X.shape[1]} @ {Y.shape[0]}x{Y.shape[1]}",
           "D": D, "bk": bk, "pairs": plan.pairs, "nC_max": plan.nC_max,
           "chunks": int(plan.NCK.sum()), "plan_s": plan.seconds["plan"],
           "upload_s": plan.seconds["upload"], "numeric_ms": t["median"],
           "numeric_min_ms": t["min"], "numeric_max_ms": t["max"],
           "assemble_s": asm, "block_MB_per_shard": nbytes / D / 1e6,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
           "nnz": int(C.nnz)}
    return C, row


def same_csr(a, b) -> bool:
    return a.shape == b.shape and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in ("indptr", "indices", "data"))


def galerkin_on_mesh(dev, card):
    """Phase 3l (1): the 48^3 Galerkin product R A P on D = 1, 2, 4, 8 shards
    of the card, f64, mode "auto": its parts timed, then triple_product
    once more, bit-equal to the first; each within 1e-12 x max |Ac| of the
    host native product. Beside them the host product's seconds and
    torch.sparse.mm (cuSPARSE SpGEMM) of the same CSR pairs on the card.
    Returns (rows, failure or None)."""
    import torch

    from saena_tpu_torch.amg.galerkin import _spgemm
    from saena_tpu_torch.ops.spgemm import _use_dense_ring, triple_product
    from saena_tpu_torch.parallel.comm import Mesh

    t0 = time.perf_counter()
    R, A, P = galerkin_operands()
    print(f"  R {R.shape[0]}x{R.shape[1]} nnz {R.nnz}, A nnz {A.nnz}, P nnz {P.nnz} "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    RA_h = _spgemm(R, A)
    Ac_h = _spgemm(RA_h, P)
    host_s = time.perf_counter() - t0
    Ac_h.sum_duplicates()
    Ac_h.sort_indices()
    scale = abs(Ac_h).max()

    def on_card(X):
        X = X.tocsr()
        with warnings.catch_warnings():          # sparse CSR is beta in torch
            warnings.simplefilter("ignore")
            return torch.sparse_csr_tensor(
                torch.from_numpy(X.indptr.astype(np.int64)),
                torch.from_numpy(X.indices.astype(np.int64)),
                torch.from_numpy(X.data), size=X.shape, dtype=torch.float64).to(dev)

    lib = {}
    for name, X, Y in (("R@A", R, A), ("RA@P", RA_h, P)):
        Xc, Yc = on_card(X), on_card(Y)
        lib[name] = events_ms(lambda: torch.sparse.mm(Xc, Yc), 5)["median"]
        del Xc, Yc
    print("  " + json.dumps({"host_native_s": host_s, "nnz_Ac": int(Ac_h.nnz),
                             "torch_sparse_mm_ms": lib, "card": card}))
    rows = []
    for D in RING_COUNTS:
        mesh = Mesh(D, dev)
        route = ["dense" if _use_dense_ring(X, Y, D) else "sparse"
                 for X, Y in ((R, A), (RA_h, P))]
        torch.cuda.reset_peak_memory_stats(dev)
        RA, r1 = ring_product(R, A, mesh, torch.float64, 1e-14)
        Ac, r2 = ring_product(RA, P, mesh, torch.float64, 1e-14)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Ac2 = triple_product(R, A, P, mesh, dtype=torch.float64)
        wall = time.perf_counter() - t0
        err = float(abs(Ac2 - Ac_h).max()) / scale
        row = {"D": D, "route": route, "triple_product_s": wall,
               "peak_GB": torch.cuda.max_memory_allocated(dev) / 1e9,
               "rel_err_vs_host": err, "bit_equal_runs": same_csr(Ac, Ac2),
               "products": [r1, r2], "card": card}
        rows.append(row)
        for r, name in ((r1, "R@A"), (r2, "RA@P")):
            print("  " + json.dumps(dict(product=name, **r,
                                         torch_sparse_mm_ms=lib[name], card=card)))
        print("  " + json.dumps({k: v for k, v in row.items() if k != "products"}))
        if route != ["sparse", "sparse"]:
            return rows, f"D = {D}: auto routed the Galerkin products {route}"
        if not row["bit_equal_runs"]:
            return rows, f"D = {D}: two runs of triple_product differ"
        if err > 1e-12:
            return rows, f"D = {D}: Ac differs from the host product by {err:.3e} of max |Ac|"
        del RA, Ac, Ac2
    return rows, None


def gemm_sweep(dev, card):
    """Phase 3l (2): examples/gemm.py's sweep, random_symm_matrix(5000,
    dens, seed=1) @ (..., seed=2) for dens 0.001, 0.005, 0.01 in f32 and
    f64 at D = 1 and 4: the ring "auto" picks and its product against
    scipy (f32 rounding: 8 eps32 x max(|A||B|); f64: 1e-12 x max |C|), the
    dense ring on prepared operands (median of 20 after 10 warm) beside
    torch.matmul of the dense 5000^2 product, and the block-sparse ring's
    numeric phase (one run after a warm one). Returns (rows, failure or
    None)."""
    import torch

    from saena_tpu_torch import oracles
    from saena_tpu_torch.generators import random_symm_matrix
    from saena_tpu_torch.ops import bspgemm
    from saena_tpu_torch.ops.spgemm import (_use_dense_ring, matmat, matmat_prepare,
                                            matmat_run)
    from saena_tpu_torch.parallel.comm import Mesh
    from saena_tpu_torch.parallel.partition import equal_row_split

    if torch.backends.cuda.matmul.allow_tf32:
        return [], "TF32 is on for matrix products"
    rows = []
    for dens in SWEEP_DENS:
        A = random_symm_matrix(SWEEP_N, dens, seed=1)
        B = random_symm_matrix(SWEEP_N, dens, seed=2)
        absAB = float(abs(abs(A) @ abs(B)).max())
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            Ad = torch.from_numpy(A.toarray()).to(dev, dt)
            Bd = torch.from_numpy(B.toarray()).to(dev, dt)
            dense_ms = events_ms(lambda: torch.matmul(Ad, Bd), SWEEP_REPS,
                                 SWEEP_WARM)["median"]
            del Ad, Bd
            for D in SWEEP_D:
                mesh = Mesh(D, dev)
                auto = "dense" if _use_dense_ring(A, B, D) else "sparse"
                C = matmat(A, B, mesh, dtype=dt)
                err = oracles.check_matmat(A, B, C)
                lim = 8 * float(np.finfo(np.float32).eps) * absAB \
                    if dname == "float32" else 1e-12 * float(abs(C).max())
                Ab, Bb, _ = matmat_prepare(A, B, mesh, dt)
                ring = events_ms(lambda: matmat_run(Ab, Bb, mesh), SWEEP_REPS,
                                 SWEEP_WARM)
                del Ab, Bb
                plan = bspgemm._ring_plan(A, B, D, bspgemm.pick_bk(A, B),
                                          equal_row_split(A.shape[0], D),
                                          equal_row_split(B.shape[0], D), dt, mesh)
                sparse = events_ms(lambda: bspgemm._ring_bsp_numeric(plan, mesh), 1)
                row = {"dens": dens, "dtype": dname, "D": D, "auto": auto,
                       "check_matmat": err, "bound": lim,
                       "dense_ring_ms": ring["median"], "dense_ring_min_ms": ring["min"],
                       "dense_ring_max_ms": ring["max"], "torch_matmul_ms": dense_ms,
                       "sparse_ring_numeric_ms": sparse["median"],
                       "sparse_plan_s": plan.seconds["plan"],
                       "sparse_pairs": plan.pairs, "bk": plan.Ab.shape[-1],
                       "card": card}
                del plan
                rows.append(row)
                print("  " + json.dumps(row))
                if not err <= lim:
                    return rows, (f"dens {dens} {dname} D = {D}: check_matmat {err:.3e} "
                                  f"> {lim:.3e}")
    return rows, None


def api_and_repairs(dev, card):
    """Phase 3l (3): AMG.matmat(A, B, mesh=Mesh(4, card)) against
    AMG.matmat(A, B) on the sweep's density 0.005 pair (1e-12 relative);
    an EllMatrix with spill (the 48^3 A with ten long rows), two matvecs
    bit-equal and within 1e-12 of the CPU's; spgemm_blocks of the 48^3 R A,
    two calls bit-equal and within 1e-12 of the host product. Returns
    (row, failure or None)."""
    import torch

    from saena_tpu_torch import AMG, Matrix
    from saena_tpu_torch.amg.galerkin import _spgemm
    from saena_tpu_torch.generators import random_symm_matrix
    from saena_tpu_torch.ops.bspgemm import spgemm_blocks
    from saena_tpu_torch.ops.formats import ell_from_csr
    from saena_tpu_torch.parallel.comm import Mesh
    from saena_tpu_torch.runtime import launches_of

    mats = []
    for seed in (1, 2):
        X = Matrix()
        X.set_csr(random_symm_matrix(SWEEP_N, 0.005, seed=seed))
        X.assemble(device=dev, dtype=torch.float64)
        mats.append(X)
    amg = AMG(device=dev, dtype=torch.float64)
    t0 = time.perf_counter()
    Cm = amg.matmat(*mats, mesh=Mesh(4, dev)).csr
    mesh_s = time.perf_counter() - t0
    Ch = amg.matmat(*mats).csr
    api_err = float(abs(Cm - Ch).max()) / float(abs(Ch).max())

    A = _poisson_interior(M).tocsr().tolil()
    rng = np.random.default_rng(7)
    for r in range(10):
        A[r, rng.choice(A.shape[1], 200, replace=False)] = rng.standard_normal(200)
    A = A.tocsr()
    E = ell_from_csr(A, torch.float64, dev, width_quantile=0.98)
    x = torch.tensor(rng.standard_normal(E.n_pad), dtype=torch.float64, device=dev)
    (y1, y2), made = launches_of(lambda: (E.matvec(x), E.matvec(x)))
    k4 = made["ell"]
    y_cpu = ell_from_csr(A, torch.float64, "cpu", width_quantile=0.98).matvec(x.cpu())
    ell_err = float((y1.cpu() - y_cpu).abs().max() / y_cpu.abs().max())

    R, A0, _ = galerkin_operands()
    t0 = time.perf_counter()
    S1 = spgemm_blocks(R, A0, device=dev)
    blocks_s = time.perf_counter() - t0
    S2 = spgemm_blocks(R, A0, device=dev)
    ref = _spgemm(R, A0)
    sb_err = float(abs(S1 - ref).max()) / float(abs(ref).max())
    row = {"api_mesh_vs_host_rel": api_err, "api_mesh_s": mesh_s,
           "ell_spill": int(E.spill_rows.numel()), "ell_bit_equal": bool(torch.equal(y1, y2)),
           "ell_k4_launches": k4,
           "ell_vs_cpu_rel": ell_err, "spgemm_blocks_bit_equal": same_csr(S1, S2),
           "spgemm_blocks_vs_host_rel": sb_err, "spgemm_blocks_s": blocks_s, "card": card}
    print("  " + json.dumps(row))
    bad = None
    if api_err > 1e-12:
        bad = f"AMG.matmat on a mesh differs from the host product by {api_err:.3e}"
    elif not (row["ell_spill"] and row["ell_bit_equal"]) or ell_err > 1e-12 or k4 != 2:
        bad = f"EllMatrix spill: {row}"
    elif not row["spgemm_blocks_bit_equal"] or sb_err > 1e-12:
        bad = f"spgemm_blocks: {row}"
    return row, bad


# ---------------------------------------------------------- phase 4: times --


# K1's times before the tiled kernel (µs, f32, graph-replayed; PERF.md §6,
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's times of the
# row kernel, K1's "rows" configuration, which they were taken of
BEFORE_US = {("L0", "spmv"): 2.334, ("L0", "cheb"): 2.680, ("L1", "spmv"): 11.46}


def time_dia(dev, ops, per_shape: dict) -> list:
    """DIA kernel ms at every shape of the main path (L0 and L1 x spmv,
    Chebyshev update, residual x f32, f64): the plan's pick (``ms``), the
    row kernel (``rows_ms``), both x paths of the tiled kernel (``l1_ms``,
    ``smem_ms``), the plain version, one cuSPARSE CSR product for the
    SpMV, the bound, and launches per solve from ``per_shape`` ({dtype
    name: {"<n_pad>x<ndiag> <variant>": launches}}, the phase-3 solves).
    Returns rows of dicts."""
    from saena_tpu_torch.profiling import graph_ms

    import torch

    from saena_tpu_torch.ops import dia_spmv as dmod
    from saena_tpu_torch.ops.formats import dia_from_csr

    rows = []
    for lname, A in (("L0", ops["L0_A"]), ("L1", ops["L1_A"])):
        n = A.shape[0]
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            D = dia_from_csr(A, dt, dev)
            n_pad, nd = D.n_pad, len(D.offsets)
            rng = np.random.default_rng(5)
            x, rhs = (torch.tensor(np.pad(rng.standard_normal(n), (0, n_pad - n)),
                                   dtype=dt, device=dev) for _ in range(2))
            dinv = torch.tensor(np.pad(1.0 / A.diagonal(), (0, n_pad - n)),
                                dtype=dt, device=dev)
            Acsr = csr_on_card(A, dt, dev, n_pad, n_pad)
            plans = {}
            for cfg in dmod.CONFIGS:
                try:
                    plans[cfg] = dmod.dia_plan(D.offsets, n_pad, dt,
                                               dmod.sm_count(dev), config=cfg)
                except ValueError:           # x windows too large to stage
                    pass
            auto = D.plan if D.plan is not None else dmod.dia_plan(
                D.offsets, n_pad, dt, dmod.sm_count(dev))             # card / CPU
            isz = D.data.element_size()
            for vname in ("spmv", "cheb", "residual"):
                has_rhs, has_dinv, c, add_x = VARIANTS[vname]
                kw = dict(rhs=rhs if has_rhs else None,
                          dinv=dinv if has_dinv else None, c=c, add_x=add_x)
                # bytes the function must move: data once, x once, rhs/dinv
                # once, y written once; operations: a multiply-add per stored
                # element plus the epilogue's 3 per row
                nvec = 2 + has_rhs + has_dinv
                nbytes = (nd * isz + nvec * isz) * n_pad
                flops = (2 * nd + 3 * has_rhs) * n_pad
                b_ms, b_by = bound(nbytes, flops, dname)
                run = lambda plan: (lambda: dmod.dia_spmv(
                    D.data, x, D.offsets, offsets_dev=D.offsets_dev, plan=plan, **kw))
                # the plan's pick and the row kernel in turns (new, rows, rows,
                # new), the lesser of each pair
                t = [graph_ms(run(p)) for p in (auto, plans["rows"], plans["rows"], auto)]
                r = {"kernel": "dia_spmv", "shape": f"{lname} {nd}x{n_pad}",
                     "dtype": dname, "variant": vname, "plan": auto.describe(),
                     "ms": min(t[0], t[3]), "rows_ms": min(t[1], t[2]),
                     "before_us_f32": BEFORE_US.get((lname, vname)) if dname == "float32"
                     else None}
                for cfg in ("l1", "smem"):
                    if cfg in plans:
                        r[f"{cfg}_ms"] = (r["ms"] if plans[cfg].describe() == r["plan"]
                                          else graph_ms(run(plans[cfg])))
                if nd <= dmod.CHUNK and vname == "spmv":
                    # the tiled kernel with one diagonal group: every
                    # row-warp count, and x as an unaligned view (scalar loads)
                    r["row_warps_ms"] = {
                        f"W{w}": graph_ms(run(dmod.dia_plan(
                            D.offsets, n_pad, dt, dmod.sm_count(dev), row_warps=w)))
                        for w in (1, 2, 4, 8)}
                    r["groups_ms"] = {
                        f"l1/G{g}": graph_ms(run(dmod.dia_plan(
                            D.offsets, n_pad, dt, dmod.sm_count(dev), groups=g)))
                        for g in range(2, min(nd, 4) + 1)}
                    xu = unaligned(x)
                    r["scalar_x_ms"] = graph_ms(lambda: dmod.dia_spmv(
                        D.data, xu, D.offsets, plan=plans["l1"]))
                    # a copy of x, the least a kernel over these rows costs
                    y = torch.empty_like(x)
                    r["x_copy_ms"] = graph_ms(lambda: y.copy_(x))
                if dmod.CHUNK < nd <= dmod.MAX_DIAGS and vname == "spmv":
                    # the tiled kernel at every group count, both x paths
                    r["groups_ms"] = {
                        f"{cfg}/G{g}": graph_ms(run(dmod.dia_plan(
                            D.offsets, n_pad, dt, dmod.sm_count(dev), config=cfg,
                            groups=g)))
                        for cfg in ("l1", "smem") for g in range(1, dmod.MAX_GROUPS + 1)}
                r["eager_ms"] = eager_ms(run(auto))
                r["rows_eager_ms"] = eager_ms(run(plans["rows"]))
                r["plain_ms"] = graph_ms(lambda: dmod.dia_spmv_plain(
                    D.data, x, D.offsets, **kw), reps=10, replays=5)
                r["library_ms"] = graph_ms(lambda: Acsr @ x) if vname == "spmv" else None
                r.update(bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / r["ms"],
                         rows_share_of_bound=b_ms / r["rows_ms"],
                         vs_rows=r["ms"] / r["rows_ms"], bytes=nbytes, flops=flops,
                         launches_per_solve=per_shape[dname].get(f"{n_pad}x{nd} {vname}", 0))
                rows.append(r)
                print("  " + json.dumps(r))
    return rows


def time_dia_bf16(dev, solver, per_op) -> list:
    """K1 with bf16 data: the twins of levels 0 and 1 of the solver's
    hierarchy (Options.smooth_dtype="bfloat16", f32 vectors), SpMV with an
    f32 x (the V-cycle's twins take the SpMV, not the fused update, since
    their dtype is not the vectors'): kernel, plain version, bound at bf16
    data bytes, cuSPARSE's f32 product of the same operator (it has no
    bf16-A / f32-x SpMV) and launches per solve (``per_op``, from
    launches_per_operator)."""
    from saena_tpu_torch.profiling import graph_ms

    import torch

    from saena_tpu_torch.ops import dia_spmv as dmod

    rows = []
    for l in (0, 1):
        D, A = solver.hierarchy.levels[l].A_smooth, solver.info.csr_levels[l]
        n, n_pad, nd = A.shape[0], D.n_pad, len(D.offsets)
        x = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        x[:n] = torch.tensor(np.random.default_rng(5).standard_normal(n), device=dev)
        nbytes = nd * D.data.element_size() * n_pad + 2 * 4 * n_pad
        flops = 2 * nd * n_pad
        b_ms, b_by = bound(nbytes, flops, "float32")
        Acsr = csr_on_card(A, torch.float32, dev, n_pad, n_pad)
        r = {"kernel": "dia_spmv", "shape": f"L{l} {nd}x{n_pad}", "dtype": "bfloat16",
             "variant": "spmv", "plan": D.plan.describe(),
             "ms": graph_ms(lambda: dmod.dia_spmv(
                 D.data, x, D.offsets, offsets_dev=D.offsets_dev, plan=D.plan)),
             "plain_ms": graph_ms(lambda: dmod.dia_spmv_plain(D.data, x, D.offsets),
                                  reps=10, replays=5),
             "library_ms": graph_ms(lambda: Acsr @ x),
             "library_note": "cuSPARSE f32 SpMV (no bf16-A / f32-x call)",
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
             "launches_per_solve": per_op.get(id(D.data), 0)}
        r["share_of_bound"] = b_ms / r["ms"]
        rows.append(r)
        print("  " + json.dumps(r))
    return rows


def csr_on_card(A, dt, dev, n_rows_pad, n_cols_pad):
    """A as a torch CSR tensor padded to (n_rows_pad, n_cols_pad)."""
    import torch

    crow = np.concatenate([A.indptr, np.full(n_rows_pad - A.shape[0], A.indptr[-1])])
    return torch.sparse_csr_tensor(
        torch.tensor(crow, dtype=torch.int64, device=dev),
        torch.tensor(A.indices, dtype=torch.int64, device=dev),
        torch.tensor(A.data, dtype=dt, device=dev), size=(n_rows_pad, n_cols_pad))


def gather_bytes(kind, Mx) -> int:
    """Bytes the kernel must move on its path: the layout arrays and work
    tables it reads, x and y (at the compute dtype: f32 for bf16 values)."""
    csz = 8 if Mx.vals.element_size() == 8 else 4
    nb = Mx.idx.numel() + Mx.vals.numel() * Mx.vals.element_size() + Mx.n_cols_pad * csz
    C = Mx.chunks
    if C is not None:
        nb += 4 * sum(t.numel() for t in C.tensors()[:3])
    if kind == "strip":
        nb += 4 * Mx.strip_of.numel() + Mx.n_rows_pad * csz
        nb += 4 * Mx.rb_ptr_dev.numel() if C is None else 0
    else:
        nb += Mx.gather_idx.shape[0] * (128 // Mx.perrow) * csz
        if C is None:
            nb += 4 * (Mx.strips.numel() + Mx.gather_idx.numel())
        else:
            nb += 4 * (Mx.unit_strips.numel()
                       + (0 if Mx.tile_identity else Mx.tile_list.numel()))
    return int(nb)


# PR 2's final times of the gather kernels (ms, f32, graph-replayed) on
# NVIDIA H100 80GB HBM3 at 700.00 W, from PR 2's chip_smoke.py (PERF.md);
# printed beside this run's times, as is this run's time of the rows path,
# which is PR 2's kernel
PR2_MS = {"L0_Pt": 9.331e-3, "L2_A_strip_pr8": 52.42e-3,
          "L2_A_strip_pr1": 68.41e-3, "L0_PtT": 2.636e-3,
          "L2_A_strip8_pr4": 24.07e-3, "L2_A_strip8_pr1": 30.36e-3}


def time_gather(dev, case, kind, M64, A_host, plain=True, library=True,
                vdt="float32", **extra):
    """Kernel (and plain, cuSPARSE) ms of one strip/strip8 layout with
    values at ``vdt`` (float32 or bfloat16; x and y f32), on the path its
    wrapper picks (``ms``) and on each path (``rows_ms``, ``stream_ms``).
    cuSPARSE has no SpMV of a bf16 A with an f32 x: its yardstick is the
    f32 product of the same operator."""
    from saena_tpu_torch.profiling import graph_ms

    import torch

    from saena_tpu_torch.ops import strip8_spmv as s8
    from saena_tpu_torch.ops import strip_spmv as s1

    Mx = with_vals(M64, M64.vals.to(getattr(torch, vdt)))
    if Mx.chunks is not None and vdt == "bfloat16":
        # the stream path's work cut for bf16's resident warps, as the
        # twin's own layout has it
        Mx.rechunk()
    kern = s1.strip_spmv if kind == "strip" else s8.strip8_spmv
    pl_fn = s1.strip_spmv_plain if kind == "strip" else s8.strip8_spmv_plain
    x = torch.zeros(Mx.n_cols_pad, dtype=torch.float32, device=dev)
    x[: Mx.shape[1]] = torch.tensor(
        np.random.default_rng(7).standard_normal(Mx.shape[1]), device=dev)
    nnz = int(A_host.nnz) if A_host is not None else Mx.nnz
    nbytes = gather_bytes(kind, Mx)
    b_ms, b_by = bound(nbytes, 2 * nnz, "float32")
    units = int(Mx.idx.shape[0] if kind == "strip" else Mx.tile_list.numel())
    path = path_of(Mx)
    r = {"kernel": f"{kind}_spmv", "case": case, "dtype": vdt,
         "perrow": Mx.perrow, "units": units, "path": path,
         "ms": graph_ms(lambda: kern(Mx, x)), "pr2_ms": PR2_MS.get(case),
         "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
         "flops": 2 * nnz, "fill": nnz / Mx.idx.numel(), **extra}
    r["share_of_bound"] = b_ms / r["ms"]
    other = "stream" if path == "rows" else "rows"
    Mo = on_path(Mx, other)
    r[f"{path}_ms"] = r["ms"]
    r[f"{other}_ms"] = graph_ms(lambda: kern(Mo, x))
    C = Mx.chunks if Mx.chunks is not None else Mo.chunks
    r["stream_warps"], r["stream_cut_row_blocks"] = C.n_chunks, C.n_cuts
    r["rows_split"] = Mx.n_split
    if kind == "strip":
        r["krb"] = Mx.krb
    else:
        r["mode"] = Mx.mode
    if plain:
        r["eager_ms"] = eager_ms(lambda: kern(Mx, x))
        r["plain_ms"] = graph_ms(lambda: pl_fn(Mx, x), reps=10, replays=5)
    if library and A_host is not None:
        n_rows = Mx.n_rows_pad if kind == "strip" else \
            Mx.gather_idx.shape[0] * (128 // Mx.perrow)
        Acsr = csr_on_card(A_host, torch.float32, dev, n_rows, Mx.n_cols_pad)
        r["library_ms"] = graph_ms(lambda: Acsr @ x)
        if vdt != "float32":
            r["library_note"] = "cuSPARSE f32 SpMV (no bf16-A / f32-x call)"
    print("  " + json.dumps(r))
    return r


def flushed_us(fn, dev, reps: int = 50) -> float:
    """Median device µs of ``fn()`` over ``reps`` calls, each after a write of
    FLUSH_BYTES that evicts the L2 (CUDA events around the call alone)."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for _ in range(3):
        fn()
    us = []
    for i in range(reps):
        flush.fill_(i & 0x7F)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        us.append(e0.elapsed_time(e1) * 1e3)
    return float(np.median(us))


def time_ell(dev, A, case="L3_like"):
    """K4 on the level-3-shaped operator, f64 and f32, in µs with the L2
    flushed before each launch: beside its bound (bytes free of the format,
    (nnz + rows + cols) x itemsize, as amgbench/roofline.py counts them),
    the bound of the slots it streams (each slot below its tile's bound, the
    spill triples, x and y), the plain torch version and cuSPARSE's CSR
    product of the same operator; and graph-replayed with warm x and y."""
    import torch

    from saena_tpu_torch.ops import ell_spmv as K
    from saena_tpu_torch.ops.formats import ell_from_csr
    from saena_tpu_torch.profiling import graph_ms

    M64 = ell_from_csr(A, torch.float64, dev, width_quantile=0.98)
    rows = []
    for dname in ("float64", "float32"):
        dt = getattr(torch, dname)
        Mx = ell_with(M64, lambda v: v.to(dt))
        sz = Mx.vals.element_size()
        x = torch.zeros(Mx.plan.n_x, dtype=dt, device=dev)
        x[: A.shape[1]] = torch.tensor(
            np.random.default_rng(7).standard_normal(A.shape[1]), dtype=dt)
        slots = int(Mx.tile_bound.sum()) * K.TILE
        free_bytes = (A.nnz + A.shape[0] + A.shape[1]) * sz
        stream_bytes = ((slots + Mx.spill_rows.numel()) * (sz + 4)
                        + (Mx.plan.n_x + Mx.n_pad) * sz)
        Acsr = csr_on_card(A, dt, dev, Mx.n_pad, Mx.plan.n_x)
        r = {"kernel": "ell_spmv", "case": case, "dtype": dname, "rows": A.shape[0],
             "nnz": int(A.nnz), "width": Mx.vals.shape[0],
             "stored_slots": Mx.vals.numel(), "slots_read": slots,
             "blocks": Mx.plan.n_blocks, "us": flushed_us(lambda: Mx.matvec(x), dev),
             "plain_us": flushed_us(lambda: K.ell_spmv_plain(Mx, x), dev, reps=10),
             "library_us": flushed_us(lambda: Acsr @ x, dev, reps=20),
             "warm_us": graph_ms(lambda: Mx.matvec(x), reps=10) * 1e3,
             "bound_us": free_bytes / HBM_BPS * 1e6,
             "stream_bound_us": stream_bytes / HBM_BPS * 1e6}
        r["share_of_bound"] = r["bound_us"] / r["us"]
        r["stream_share"] = r["stream_bound_us"] / r["us"]
        rows.append(r)
        print("  " + json.dumps(r))
        del Acsr
    return rows


def solve_gather_ops(solver) -> list:
    """(label, kind, layout, host CSR) of every strip / strip8 operator in
    the solver's hierarchy: a level's A, its direct P and R, and the Pt /
    Pt^T inside its structural SmoothedP / SmoothedR."""
    from saena_tpu_torch.amg.prolongation import tentative_prolongator
    from saena_tpu_torch.ops.strip8_spmv import Strip8Matrix
    from saena_tpu_torch.ops.strip_spmv import StripMatrix

    H, info = solver.hierarchy, solver.info
    kinds = {StripMatrix: "strip", Strip8Matrix: "strip8"}
    out = []
    for l, L in enumerate(H.levels):
        cands = [(f"L{l}_A", L.A, lambda: info.csr_levels[l])]
        for name, Mx, direct, inner in (("P", L.P, info.Ps, "Pt"),
                                        ("R", L.R, info.Rs, "PtT")):
            if Mx is None:
                continue
            if hasattr(Mx, inner):
                Pt = lambda: tentative_prolongator(info.structs[l][0],
                                                   info.sizes[l + 1])
                csr = Pt if inner == "Pt" else (lambda: Pt().T.tocsr())
                cands.append((f"L{l}_{name}[{inner}]", getattr(Mx, inner), csr))
            else:
                cands.append((f"L{l}_{name}", Mx, lambda d=direct: d[l]))
        for label, Mx, csr in cands:
            if type(Mx) in kinds:
                out.append((label, kinds[type(Mx)], Mx, csr()))
    return out


def launches_per_operator(solve) -> dict:
    """{id(layout) or id(DIA data): kernel launches in one call of
    ``solve``, an uncaptured loop}, counted by wrapping the kernels'
    wrappers (a graph replay calls no wrapper; phase 3f shows the two
    launch the same)."""
    import torch

    from saena_tpu_torch.ops import formats
    from saena_tpu_torch.ops import strip8_spmv as s8
    from saena_tpu_torch.ops import strip_spmv as s1

    counts: dict = {}
    saved = (s1.strip_spmv, s8.strip8_spmv, formats.dia_spmv)

    def counting(fn):
        def wrapped(A, x, *args, **kw):
            counts[id(A)] = counts.get(id(A), 0) + 1
            return fn(A, x, *args, **kw)
        return wrapped

    s1.strip_spmv, s8.strip8_spmv, formats.dia_spmv = map(counting, saved)
    try:
        solve()
        torch.cuda.synchronize()
    finally:
        s1.strip_spmv, s8.strip8_spmv, formats.dia_spmv = saved
    return counts


def gather_launch_map(solver) -> dict:
    """{(label, kind, perrow, mode): launches in one pCG solve} of every
    strip / strip8 operator of the solver's hierarchy."""
    per_op = launches_per_operator(lambda: solver._run(eager_pcg))
    return {(label, kind, Mx.perrow, getattr(Mx, "mode", None)): per_op.get(id(Mx), 0)
            for label, kind, Mx, _ in solve_gather_ops(solver)}


def case_key(case, kind, Mx):
    """The gather_launch_map key of a phase-2 case's operator."""
    label = {"L0_Pt": "L0_P[Pt]", "L0_PtT": "L0_R[PtT]"}.get(
        case, "L2_A" if case.startswith("L2_A_") else case)
    return (label, kind, Mx.perrow, getattr(Mx, "mode", None))


def tiny_operator():
    """A 128 x 128 operator with one entry: one pair, one tile."""
    import scipy.sparse as sp

    return sp.csr_matrix((np.ones(1), (np.zeros(1, int), np.zeros(1, int))),
                         shape=(128, 128))


def fit_constants(dev, ops, rows) -> dict:
    """The picker's H100 cost constants from this run's times (f32)."""
    from saena_tpu_torch.profiling import graph_ms

    import torch

    from saena_tpu_torch.ops.formats import bsr_from_csr, pad_to
    from saena_tpu_torch.ops.strip8_spmv import _plan8, strip8_from_csr
    from saena_tpu_torch.ops.strip_spmv import strip_from_csr

    f32 = torch.float32
    tiny = tiny_operator()
    t_strip0 = time_gather(dev, "tiny", "strip",
                           strip_from_csr(tiny, torch.float64, dev), tiny,
                           plain=False)["ms"]
    t_strip80 = time_gather(dev, "tiny", "strip8",
                            strip8_from_csr(tiny, torch.float64, dev), tiny,
                            plain=False)["ms"]
    c = {"STRIP_LAUNCH_S": t_strip0 * 1e-3, "KERNEL_LAUNCH_S": t_strip80 * 1e-3}
    by = {(r["kernel"], r["case"]): r for r in rows}
    c["STRIP_NS_BY_PERROW"] = {
        pr: (by[("strip_spmv", f"L2_A_strip_pr{pr}")]["ms"] * 1e-3
             - c["STRIP_LAUNCH_S"]) / by[("strip_spmv", f"L2_A_strip_pr{pr}")]["units"] * 1e9
        for pr in (1, 2, 4, 8, 16)}
    # general mode at the perrow the planner picks for the level-2 A
    pr8 = _plan8(ops["L2_A"])[1][7]
    g = by[("strip8_spmv", f"L2_A_strip8_pr{pr8}")]
    ns_g = (g["ms"] * 1e-3 - c["KERNEL_LAUNCH_S"]) / g["units"] * 1e9
    # interval mode on a synthetic layout of about the same tile count
    Q = 128 // pr8
    n_rb = -(-ops["L2_A"].shape[0] // Q)
    syn = synthetic_interval(dev, n_rb, max(2, -(-g["units"] // n_rb)),
                             -(-ops["L2_A"].shape[1] // 128), pr8, 9)
    ti = time_gather(dev, "interval_synth", "strip8", syn, None, plain=False,
                     library=False)
    ns_i = (ti["ms"] * 1e-3 - c["KERNEL_LAUNCH_S"]) / ti["units"] * 1e9
    c["STRIP8_NS_PER_TILE"] = {"general": ns_g, "interval": ns_i}
    # BSR: the read rate of a sum over the blocks, and the matvec against it
    B = bsr_from_csr(ops["L2_A"], f32, dev)
    nb = B.blocks.numel() * 4
    xb = torch.randn(pad_to(ops["L2_A"].shape[1]), dtype=f32, device=dev)
    t_sum = graph_ms(lambda: B.blocks.sum(), reps=20, replays=10)
    t_bsr = graph_ms(lambda: B.matvec(xb), reps=20, replays=10)
    c["BSR_STREAM_BPS"] = nb / (t_sum * 1e-3)
    c["BSR_TIME_FACTOR"] = t_bsr * 1e-3 / (nb / c["BSR_STREAM_BPS"])
    c["bsr_L2_A"] = {"bytes": nb, "sum_ms": t_sum, "matvec_ms": t_bsr,
                     "W": int(B.bcols.shape[1])}
    return c


# ------------------------------------------------------------------- main --


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 3i's synthetic modal problem")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "saena_tpu_torch")):
        return fail(f"the saena_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, ROOT)
    from saena_tpu_torch.ops import cuda_build
    from saena_tpu_torch.ops import dia_spmv as dia_mod
    from saena_tpu_torch.runtime import launches_of

    total = Counter()

    def counted(fn):
        """(fn(), its launches, launch_failure of them); the launches are
        added to phase 3's."""
        out, made = launches_of(fn)
        total.update(made)
        return out, made, launch_failure(made)

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- 1. card, build, host levels
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"[1] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, (_, log) in logs.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", log))
        print(f"    {name}: {len(regs)} kernel instantiations, at most "
              f"{max(regs, default=0)} registers, {spills} bytes spilled")
        for fn, sp in re.findall(r"entry function '(\w+)'[^\n]*\n(?:.*Function "
                                 r"properties.*\n)?\s*\d+ bytes stack frame, (\d+) "
                                 r"bytes spill stores", log):
            if int(sp):
                print(f"      {sp} bytes spilled by {fn}")
    from saena_tpu_torch import _native
    t0 = time.perf_counter()
    if not _native.have_native():            # raises when g++ fails
        return fail("no g++ on PATH: the native host kernels were not built")
    print(f"[1] native host kernels {os.path.basename(_native.library_path(shutil.which('g++')))}"
          f" loaded in {time.perf_counter() - t0:.2f} s (flags {' '.join(_native.CXX_FLAGS)})")
    with open(os.path.join(ROOT, "tests", "goldens", "convergence.json")) as f:
        golden = json.load(f)[GOLDEN]
    t0 = time.perf_counter()
    info = host_levels()
    if info.sizes != golden["levels"]:
        return fail(f"host levels {info.sizes} != golden {golden['levels']}")
    ops = main_path_operators(info)
    print(f"[1] host levels {info.sizes} in {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"{k} {v.shape[0]}x{v.shape[1]} nnz {v.nnz}"
                      for k, v in ops.items()))

    # ---- 2. kernels vs plain
    print(f"[2] the sharded shapes: the D = {SHARD_D} f64 sharded hierarchy of the "
          "host levels")
    sh4, splits4, mesh4, dia_shards, gather_shards = shard_cases(dev, info)
    print("[2] DIA kernel vs plain version")
    checks, bad = check_kernels(dev, ops, dia_shards)
    if bad:
        return fail(f"DIA kernel disagrees with its plain version: {bad}")
    print("[2] strip / strip8 kernels vs plain versions")
    cases = gather_cases(dev, ops)
    cases.update(gather_shards)
    gchecks, bad = check_gather(dev, cases)
    if bad:
        return fail(f"gather kernel disagrees with its plain version: {bad}")
    print("[2] ELL kernel (K4) vs plain version")
    ecases = ell_cases()
    erows, bad = check_ell(dev, ecases)
    if bad:
        return fail(f"ELL kernel disagrees with its plain version: {bad}")
    print("[2] row-wise SpGEMM (K5) vs the host kernel, the 48^3 Galerkin products")
    scases = spgemm_cases(info)
    srows, bad = check_spgemm(dev, scases)
    if bad:
        return fail(f"K5 disagrees with the host kernel: {bad}")
    worst_bf16 = {"dia_spmv": max(r[4] for r in checks if r[3] == "bfloat16")}
    for k in ("strip", "strip8"):
        worst_bf16[f"{k}_spmv"] = max(r[3] for r in gchecks
                                      if r[2] == "bfloat16" and cases[r[0]][0] == k)
    worst_bf16["ell_spmv"] = max(r["err"] for r in erows if r["dtype"] == "bfloat16")
    print("[2] worst row-sum-scaled error with bf16 values (f32 x and sums), "
          "every case, configuration and path: " + json.dumps(worst_bf16))

    # ---- 3. main path
    print(f"[3a] main path f64, {M}^3, the card's picks (golden {GOLDEN})")
    (solver64, rep64, bad), launches_a64, bad_count = counted(
        lambda: solve_main_path(dev, torch.float64, golden))
    if bad or bad_count:
        return fail(f"f64 main path: {bad or bad_count}")
    if solver64.info.formats[1] != "DiaMatrix":
        return fail(f"level 1 is {solver64.info.formats[1]}, not wide DIA")
    _, res64 = solver64.solve_pCG()          # phase 3k's serial reference
    serial64 = (res64.iters, res64.history[: res64.iters + 1].cpu().numpy())
    print(f"[3a] main path f32, {M}^3")
    (solver32, rep32, bad), launches_a32, bad_count = counted(
        lambda: solve_main_path(dev, torch.float32, None))
    if bad or bad_count:
        return fail(f"f32 main path: {bad or bad_count}")
    per_shape = {"float64": rep64["dia_launches_per_solve"],
                 "float32": rep32["dia_launches_per_solve"]}
    print("[3a] DIA launches per solve by n_pad x ndiag, variant: "
          + json.dumps(per_shape))
    print(f"[3a] launches: f64 {launch_table(launches_a64)}, "
          f"f32 {launch_table(launches_a32)}")
    est = pick_estimates(solver32.info, solver32.hierarchy, torch.float32)
    print("[3a] picker estimates (f32, µs): " + json.dumps(est))
    print(f"[3b] forced path f64, {M}^3: Pt strip, Pt^T strip8, level-2 A the other, "
          "level-3 A ELL")
    picker64 = solver64.hierarchy
    forced64 = solver64.hierarchy = forced_hierarchy(solver64)
    (rep_b, bad), launches_b, bad_count = counted(
        lambda: run_solve(solver64, dev, golden, "forced"))
    if bad or bad_count:
        return fail(f"forced main path: {bad or bad_count}")
    print(f"[3b] launches: {launch_table(launches_b)}")
    forced_map = gather_launch_map(solver64)
    solver64.hierarchy = picker64

    print(f"[3c] {M}^3 f64 setup on the card's host: default (shard-parallel) "
          "and serial")
    setup_rep, bad = setup_on_host(dev)
    if bad:
        return fail(f"host setup: {bad}")
    print(f"[3d] the other entry points on the phase-3a hierarchies "
          f"(f64 against the port's CPU f64 runs; f32)")
    t0 = time.perf_counter()
    cpu64 = cpu_twin(solver64)
    print(f"  CPU twin devicified in {time.perf_counter() - t0:.1f} s")
    ((entry64, bad), (entry32, bad32)), launches_d, bad_count = counted(
        lambda: (entry_points(solver64, cpu64), entry_points(solver32, None)))
    if bad or bad32 or bad_count:
        return fail(f"entry points: {bad or bad32 or bad_count}")
    print(f"[3d] launches: {launch_table(launches_d)}")
    loops = {k[0] for k, L in solver64.hierarchy.graphs.items() if L.graphs}
    if not {"_vcycle_iter", "_smoother_iter", "_cg", "_gmres"} <= loops:
        return fail(f"phase 3d's loops did not run through graphs: {sorted(loops)}")
    print(f"[3e] lazy updates on the card, f64, against the same sequence on the CPU")
    saved64 = [(sv, sv.hierarchy, sv._io.split[2]) for sv in (solver64, cpu64)]
    (lazy, bad), launches_e, bad_count = counted(lambda: lazy_updates(solver64, cpu64))
    if bad or bad_count:
        return fail(f"lazy updates: {bad or bad_count}")
    print(f"[3e] launches: {launch_table(launches_e)}")
    for sv, H, bound_diag in saved64:            # back to the phase-3a state
        sv.hierarchy = H
        sv._io.set_bound_diag(bound_diag)

    print(f"[3f] the {M}^3 solves as graph replays against the uncaptured loop, "
          f"the coarsest CG in the graph, a failed capture, the f32 profiles; {card}")
    t3f = time.perf_counter()

    def graph_phase():
        for solver, H, label, g in ((solver64, picker64, "f64_picker", golden),
                                    (solver32, solver32.hierarchy, "f32_picker", None),
                                    (solver64, forced64, "f64_forced", golden)):
            solver.hierarchy = H
            _, bad = graph_solve(solver, label, g)
            if bad:
                return f"graph solve {label}: {bad}"
        solver64.hierarchy = picker64
        _, bad = coarse_cg(solver64, cpu64)
        if bad:
            return f"pCG with the coarsest CG in the graph: {bad}"
        profiles(solver32)
        msg, bad = capture_failure(dev)
        if bad:
            return f"capture failure: {bad}"
        print(f"  a failed capture raised: {msg}")
        return None

    bad, launches_f, bad_count = counted(graph_phase)
    if bad:
        return fail(bad)
    if bad_count:
        return fail(f"graph solves: {bad_count}")
    print(f"[3f] launches: {launch_table(launches_f)}; "
          f"wall {time.perf_counter() - t3f:.1f} s")

    print(f"[3g] FGMRES(30) and pFGMRES through graphs against the uncaptured "
          f"loop and the CPU, f64, {M}^3; {card}")
    t0 = time.perf_counter()
    (gmres_rows, bad), launches_g, bad_count = counted(lambda: fgmres_graphs(solver64, cpu64))
    if bad or bad_count:
        return fail(f"FGMRES graphs: {bad or bad_count}")
    print(f"[3g] launches: {launch_table(launches_g)}; "
          f"wall {time.perf_counter() - t0:.1f} s")
    print(f"[3h] {M}^3 solves with smooth_dtype twins (f32 + bf16 picker and "
          "forced, f64 + f32), each against the same solve without twins")
    t0 = time.perf_counter()
    (twin_rows, twins, bad), launches_h, bad_count = counted(
        lambda: smooth_dtype_solves(dev, solver32, solver64))
    if bad or bad_count:
        return fail(f"smooth_dtype solves: {bad or bad_count}")
    if min(launches_h[f"{k}.bf16"] for k in ("dia", "strip", "strip8", "ell")) <= 0:
        return fail(f"a kernel never launched with bf16 values: {launch_table(launches_h)}")
    print(f"[3h] launches: {launch_table(launches_h)}; "
          f"wall {time.perf_counter() - t0:.1f} s")
    print(f"[3i] p-coarsening: kron(3-D Poisson {P_UNITS}^3 units, a {P_MODES}x"
          f"{P_MODES} SPD modal block), seed {args.seed}, f64, against the CPU")
    t0 = time.perf_counter()
    (p_row, bad), launches_i, bad_count = counted(lambda: pcoarsen_solve(dev, args.seed))
    if bad or bad_count:
        return fail(f"p-coarsening: {bad or bad_count}")
    print(f"[3i] launches: {launch_table(launches_i)}; "
          f"wall {time.perf_counter() - t0:.1f} s")
    print(f"[3j] rap=\"device\" against rap=\"host\", {M}^3 f64 serial setup")
    t0 = time.perf_counter()
    (rap_row, bad), launches_j, bad_count = counted(lambda: rap_device(dev, golden))
    if bad or bad_count:
        return fail(f"rap=device: {bad or bad_count}")
    print(f"[3j] launches: {launch_table(launches_j)}; "
          f"wall {time.perf_counter() - t0:.1f} s")
    print(f"[3k] the sharded solve (saena_tpu_torch/parallel/), {M}^3 f64 on "
          f"{', '.join(map(str, SHARD_COUNTS))} shards of the card against the serial "
          f"graph solve; the options at D = {SHARD_D}; the sharded profile; update1 "
          f"through update_sharded_values; an NCCL group of world size 1; {card}")
    t0 = time.perf_counter()
    rep3k, launches_k, bad = sharded_solves(dev, info, golden, serial64,
                                            (sh4, splits4, mesh4))
    total.update(launches_k)
    if bad:
        return fail(f"sharded solves: {bad}")
    print(f"[3k] K1 rectangular launches {launches_k['dia.rect']}, K3 launches "
          f"on shards {launches_k['strip8.shard']}; launches: {launch_table(launches_k)}; "
          f"wall {time.perf_counter() - t0:.1f} s")
    if min(launches_k["dia.rect"], launches_k["strip8.shard"]) <= 0:
        return fail("K1 in rectangular mode or K3 on a shard never launched on the "
                    "sharded path")
    print(f"[3l] the products over a mesh (ops/spgemm.py, ops/bspgemm.py's ring): the "
          f"{M}^3 Galerkin product on {', '.join(map(str, RING_COUNTS))} shards of the "
          f"card against the host product; examples/gemm.py's sweep; AMG.matmat(mesh=); "
          f"the fixed-order ELL spill and block sums; {card}")
    t0 = time.perf_counter()

    def products():
        for what, check in (("Galerkin product on a mesh", galerkin_on_mesh),
                            ("gemm sweep", gemm_sweep),
                            ("matmat(mesh=) and the repairs", api_and_repairs)):
            _, bad = check(dev, card)
            if bad:
                return f"{what}: {bad}"
        return None

    bad, launches_l, bad_count = counted(products)
    if bad:
        return fail(bad)
    if bad_count:
        return fail(f"products over a mesh: {bad_count}")
    print(f"[3l] launches (the products run no kernel of the port): "
          f"{launch_table(launches_l)}; wall {time.perf_counter() - t0:.1f} s")
    launches = launch_table(total)
    print(f"[3] launches on the main path: {launches}")
    if min(launches[k] for k in MUST_LAUNCH) <= 0:
        return fail(f"a kernel or a path never launched on the main path: {launches}")

    # ---- 4. times
    print("[4] times (ms per call; bound = max(bytes/HBM, ops/peak))")
    from saena_tpu_torch.profiling import graph_ms
    floor = graph_ms(lambda: dia_mod.empty_launch(dev))
    print(f"  launch floor (empty kernel, graph-replayed): {floor * 1e3:.3f} µs")
    times = time_dia(dev, ops, per_shape)
    slow = [f"{r['shape']} {r['dtype']} {r['variant']}: {r['vs_rows']:.3f}x"
            for r in times if r["vs_rows"] > 1.05]
    print("[4] K1 against the row kernel, same run: "
          + (f"slower beyond 5% on {slow}" if slow else "no shape slower beyond 5%"))
    if min(r["launches_per_solve"] for r in times) <= 0:
        return fail("a K1 shape of phase 4 never launched in the phase-3 solves")
    picker_map = gather_launch_map(solver32)
    grows = []
    for case, (kind, M64, A_host) in cases.items():
        if case.startswith(("L0_", "L2_A_")) and "chunk" not in case:
            key = case_key(case, kind, M64)
            grows.append(time_gather(
                dev, case, kind, M64, A_host, launches_per_solve={
                    "picker": picker_map.get(key, 0),
                    "forced": forced_map.get(key, 0)}))
    print("[4] every strip / strip8 operator of the f32 solve (phase 3a), "
          "with its launches per solve")
    per_op = launches_per_operator(lambda: solver32._run(eager_pcg))
    solve_rows = [time_gather(dev, label, kind, Mx, A_host,
                              launches_per_solve=per_op.get(id(Mx), 0))
                  for label, kind, Mx, A_host in solve_gather_ops(solver32)]
    if not solve_rows or min(r["launches_per_solve"] for r in solve_rows) <= 0:
        return fail("a strip / strip8 operator of the f32 solve never launched: "
                    + json.dumps({r["case"]: r["launches_per_solve"] for r in solve_rows}))
    print("[4] bf16 values (phase 3h's twins, f32 x): K1 SpMV at levels 0 and 1, "
          "K3 on the picker's and K2 on the forced level-2 A, with launches per "
          "solve")
    from saena_tpu_torch.ops.strip_spmv import StripMatrix
    s_bf = twins["f32_bf16"]
    picker_bf = s_bf.hierarchy
    per_bf = launches_per_operator(lambda: s_bf._run(eager_pcg))
    bf_rows = time_dia_bf16(dev, s_bf, per_bf)
    s_bf.hierarchy = twins["f32_bf16_forced"]
    per_forced = launches_per_operator(lambda: s_bf._run(eager_pcg))
    s_bf.hierarchy = picker_bf
    for label, H, per in (("L2_A_twin", picker_bf, per_bf),
                          ("L2_A_twin_forced", twins["f32_bf16_forced"], per_forced)):
        T = H.levels[2].A_smooth
        kind = "strip" if isinstance(T, StripMatrix) else "strip8"
        bf_rows.append(time_gather(dev, label, kind, T, s_bf.info.csr_levels[2],
                                   vdt="bfloat16",
                                   launches_per_solve=per.get(id(T), 0)))
    # K4's bf16 mode: phase 2's error and phase 3h's launches
    if min(r["launches_per_solve"] for r in bf_rows) <= 0 or \
            {r["kernel"] for r in bf_rows} != {"dia_spmv", "strip_spmv", "strip8_spmv"}:
        return fail("a bf16 operator of phase 4 never launched in its solve: "
                    + json.dumps([(r["kernel"], r["launches_per_solve"]) for r in bf_rows]))
    print(f"[4] the sharded path's shapes (phase 3k, D = {SHARD_D}): K1 rectangular on "
          "shard 1 of level 0, K3 on shard 1 of the level-2 A, launches per "
          "sharded solve")
    d = rep3k["default"]
    rect_rows = time_rect_dia(dev, d["sh"], info,
                              {"float64": d["per_shape"],
                               "float32": rep3k["f32_per_shape"]})
    _, rhs_k = sharded_problem()
    op2 = d["sh"].sharded[2].A if len(d["sh"].sharded) > 2 else None
    per_solve = 0
    if isinstance(getattr(op2, "views", None), tuple):
        per_view = launches_per_operator(lambda: sharded_solve(
            d["sh"], d["splits"], d["mesh"], d["opts"], rhs_k, graphs=False))
        per_solve = sum(per_view.get(id(M), 0) for M in op2.views if M is not None)
    _, view, block = gather_shards["shard1_L2_A"]
    shard_row = time_gather(dev, "shard1_L2_A", "strip8", view, block,
                            launches_per_solve=per_solve)
    print(f"[4] the level-2 ShardedStrip8 matvec at D = {SHARD_D} (f64) and its parts, µs")
    sharded_strip8_breakdown(dev, d["sh"])
    if min(r["launches_per_solve"] for r in rect_rows + [shard_row]) <= 0:
        return fail("a K1 rectangular shape or the level-2 A's K3 views of phase 4 "
                    f"never launched in the D = {SHARD_D} sharded solve")
    print("[4] K4 on level3_like (20,835 rows, width 4,044, 66.6 M of 84.4 M slots "
          "read; the 96^3 level 3 reads 68.0 M of 84.2 M at width 4,037), L2 flushed "
          "before each launch, µs; the kernels line's K4 entry is this operator in f64")
    ell_times = time_ell(dev, ecases["L3_like"])
    print("[4] K5 on the 48^3 level-2 Galerkin products beside the host kernel, ms; "
          "the kernels line's K5 entry is A_2 P_2")
    spg_times = time_spgemm(dev, scases)
    consts = fit_constants(dev, ops, grows)
    print("[4] fitted cost constants: " + json.dumps(consts))
    print(f"[4] total {time.perf_counter() - t_start:.1f} s")
    if slow:
        return fail(f"K1 slower than the row kernel by more than 5%: {slow}")

    head = next(r for r in times if r["shape"].startswith("L0")
                and r["dtype"] == "float32" and r["variant"] == "spmv")
    head_err = max(e for case, cfg, v, d, _, e in checks
                   if case == f"poisson{M}" and cfg == "auto" and v == "spmv"
                   and d == "float32")
    gerr = {c: max(e for c2, _, d, _, e in gchecks if c2 == c and d == "float32")
            for c, *_ in gchecks}
    grow = {r["case"]: r for r in grows}
    # bf16 modes: phase 2's worst error of the mode, phase 4's time of the
    # twin the solves ran (K1 on level 0)
    bf_err = {"dia_spmv": max(e for case, cfg, v, d, _, e in checks
                              if case == f"poisson{M}" and v == "spmv"
                              and d == "bfloat16")}
    for k in ("strip", "strip8"):
        bf_err[f"{k}_spmv"] = max(e for c, _, d, _, e in gchecks
                                  if d == "bfloat16" and cases[c][0] == k)
    bf_row = {r["kernel"]: r for r in reversed(bf_rows)}
    # the sharded path's modes: K1 rectangular (level-0 shard, f32 SpMV), K3
    # on a shard (the level-2 A's shard 1, f32)
    rect_head = next(r for r in rect_rows if r["dtype"] == "float32"
                     and r["variant"] == "spmv")
    rect_err = max(e for case, cfg, v, dn, _, e in checks
                   if case.startswith("shard1_L0") and cfg == "auto" and v == "spmv"
                   and dn == "float32")

    def entry(name, source, replaces, r, err):
        # "strip8_spmv/shard" counts as launches["strip8.shard"]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name.replace("_spmv", "").replace("/", ".")],
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    print(card)
    print(json.dumps({"kernels": [
        entry("dia_spmv", "saena_tpu_torch/csrc/dia_spmv.cu",
              "saena_tpu/ops/pallas_dia_spmv.py:148", head, head_err),
        entry("strip_spmv", "saena_tpu_torch/csrc/strip_spmv.cu",
              "saena_tpu/ops/pallas_strip_spmv.py:116", grow["L0_Pt"],
              gerr["L0_Pt"]),
        entry("strip8_spmv", "saena_tpu_torch/csrc/strip8_spmv.cu",
              "saena_tpu/ops/pallas_strip8_spmv.py:96", grow["L0_PtT"],
              gerr["L0_PtT"])] + [
        entry(f"{k}/bf16", f"saena_tpu_torch/csrc/{k}.cu", src, bf_row[k], bf_err[k])
        for k, src in (("dia_spmv", "saena_tpu/ops/pallas_dia_spmv.py:148"),
                       ("strip_spmv", "saena_tpu/ops/pallas_strip_spmv.py:116"),
                       ("strip8_spmv", "saena_tpu/ops/pallas_strip8_spmv.py:96"))] + [
        entry("dia_spmv/rect", "saena_tpu_torch/csrc/dia_spmv.cu",
              "saena_tpu/ops/pallas_dia_spmv.py:148", rect_head, rect_err),
        entry("strip8_spmv/shard", "saena_tpu_torch/csrc/strip8_spmv.cu",
              "saena_tpu/ops/pallas_strip8_spmv.py:96", shard_row,
              gerr["shard1_L2_A"])] + [
        {"name": "ell_spmv", "route": "cuda", "source": "saena_tpu_torch/csrc/ell_spmv.cu",
         "replaces": None, "launches": launches["ell"],
         "max_abs_err": max(r["err"] for r in erows if r["dtype"] == "float64"),
         "ms": r["us"] * 1e-3, "plain_ms": r["plain_us"] * 1e-3,
         "bound_ms": r["bound_us"] * 1e-3, "bound_by": "bytes",
         "library_ms": r["library_us"] * 1e-3}
        for r in ell_times if r["dtype"] == "float64"] + [
        {"name": "csr_spgemm", "route": "cuda", "source": "saena_tpu_torch/csrc/csr_spgemm.cu",
         "replaces": None, "launches": launches["csr_spgemm"], "max_abs_err": 0.0,
         "ms": r["ms"], "plain_ms": None, "host_ms": r["host_ms"], "route_ms": r["route_ms"],
         "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None}
        for r in spg_times[:1]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
