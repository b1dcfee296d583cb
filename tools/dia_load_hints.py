#!/usr/bin/env python3
"""K1 (csrc/dia_spmv.cu) with other cache hints on its data loads, timed in
turns on the card.

    python3 tools/dia_load_hints.py [--turns 3] [--solves 20]

Builds the DIA kernel once per hint with -DSAENA_DIA_DATA_LOAD=<hint>
(__ldg, the kernel's own; __ldcs, evict-first; __ldcg, L2 only) and, on
the 48^3 Poisson interior's level 1 (101 diagonals) in f32, f64 and bf16
data, times the plan's tiled kernel under each hint and the row kernel:
"hot", 100 graph-replayed calls on one operator (the operator stays in L2
as far as it fits), and "cold", the same calls rotated over copies of the
data that together exceed L2. Then the 48^3 pCG graph solve, f64 and f32,
with each hint's library behind the wrapper (median of ``--solves``
solves a turn). Turns alternate the order; the least time of the turns is
reported. Prints the card's name and power limit, one JSON line per row
and a summary JSON line last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HINTS = ("__ldg", "__ldcs", "__ldcg")


def build(hints) -> dict:
    """{hint: (rows, tiled, empty) ctypes functions}, one nvcc a hint, all
    started together."""
    from saena_tpu_torch.ops import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.CSRC_DIR, "dia_spmv.cu")
    procs = {}
    for h in hints:
        so = os.path.join(cuda_build.BUILD_DIR, f"libdia_spmv-hint{h}.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
               f"-DSAENA_DIA_DATA_LOAD={h}", "-o", so, src]
        procs[h] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for h, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {h} failed:\n{log}")
        lib = ctypes.CDLL(so)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        rows, tiled, empty = lib.saena_dia_apply, lib.saena_dia_tiled, lib.saena_dia_empty
        rows.argtypes = [i, p, p, p, i, i64, i64, p, p, ctypes.c_double, i, i64, p, p]
        tiled.argtypes = [i, p, i, p, p, i64, i64, p, p, ctypes.c_double, i64, p, p]
        empty.argtypes = [p]
        rows.restype = tiled.restype = empty.restype = ctypes.c_int
        fns[h] = (rows, tiled, empty)
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--solves", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from saena_tpu_torch import AMG, Matrix, Options, generators
    from saena_tpu_torch.ops import dia_spmv as dmod
    from saena_tpu_torch.ops.formats import dia_from_csr
    from saena_tpu_torch.profiling import graph_ms

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    fns = build(HINTS)
    own = dmod._kernel_fns

    def use(h):
        dmod._kernel_fns = lambda: fns[h]

    def turns(names):
        return [names if t % 2 == 0 else names[::-1] for t in range(args.turns)]

    rows_out = []
    A = cs.main_path_operators(cs.host_levels())["L1_A"]
    n = A.shape[0]
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for dname in ("float32", "float64", "bfloat16"):
        dt = getattr(torch, dname)
        cdt = dmod.compute_dtype(dt)
        D = dia_from_csr(A, dt, dev)
        n_pad = D.n_pad
        rng = np.random.default_rng(5)
        x, rhs = (torch.tensor(np.pad(rng.standard_normal(n), (0, n_pad - n)),
                               dtype=cdt, device=dev) for _ in range(2))
        dinv = torch.tensor(np.pad(1.0 / A.diagonal(), (0, n_pad - n)), dtype=cdt,
                            device=dev)
        plan = dmod.dia_plan(D.offsets, n_pad, dt, dmod.sm_count(dev))
        rows_plan = dmod.dia_plan(D.offsets, n_pad, dt, config="rows")
        ncopy = max(2, -(-3 * l2 // D.data.nbytes))
        copies = [D.data.clone() for _ in range(ncopy)]
        for vname in (("spmv", "cheb", "residual") if dname != "bfloat16"
                      else ("spmv",)):
            has_rhs, has_dinv, c, add_x = cs.VARIANTS[vname]
            kw = dict(rhs=rhs if has_rhs else None, dinv=dinv if has_dinv else None,
                      c=c, add_x=add_x)
            ref = dmod.dia_spmv_plain(D.data, x, D.offsets, **kw)
            names = list(HINTS) + ["rows"]
            hot = {k: [] for k in names}
            cold = {k: [] for k in names}
            err = {}
            for h in HINTS:
                use(h)
                y = dmod.dia_spmv(D.data, x, D.offsets, plan=plan, **kw)
                err[h] = float((y - ref).abs().max())
            for order in turns(names):
                for k in order:
                    use("__ldg" if k == "rows" else k)
                    pl = rows_plan if k == "rows" else plan
                    hot[k].append(graph_ms(lambda: dmod.dia_spmv(
                        D.data, x, D.offsets, offsets_dev=D.offsets_dev, plan=pl,
                        **kw)) * 1e3)
                    at = [0]

                    def rotated():
                        at[0] += 1
                        return dmod.dia_spmv(copies[at[0] % ncopy], x, D.offsets,
                                             offsets_dev=D.offsets_dev, plan=pl, **kw)
                    cold[k].append(graph_ms(rotated) * 1e3)
            r = {"shape": f"L1 {len(D.offsets)}x{n_pad}", "dtype": dname,
                 "variant": vname, "plan": plan.describe(), "data_bytes": D.data.nbytes,
                 "l2_bytes": l2, "cold_copies": ncopy, "max_abs_err": err,
                 "hot_us": {k: min(v) for k, v in hot.items()},
                 "cold_us": {k: min(v) for k, v in cold.items()},
                 "hot_turns_us": hot, "cold_turns_us": cold}
            rows_out.append(r)
            print(json.dumps(r), flush=True)
        del copies
    solves = []
    for dtype in (torch.float64, torch.float32):
        M = Matrix()
        M.set_csr(generators.laplacian3D(cs.M, cs.M, cs.M))
        M.assemble(device=dev, dtype=dtype)
        solver = AMG(device=dev, dtype=dtype)
        solver.set_matrix(M, Options(remove_boundary=True))
        solver.set_rhs(generators.laplacian3D_set_rhs(cs.M, cs.M, cs.M))
        med = {h: [] for h in HINTS}
        for order in turns(list(HINTS)):
            for h in order:
                use(h)
                solver.hierarchy.graphs.clear()       # capture with this library
                med[h].append(cs.spread(solver.solve_pCG, args.solves)["median_ms"])
        r = {"solve": f"48^3 pCG graph {dtype}", "median_ms_turns": med,
             "median_ms": {h: min(v) for h, v in med.items()}}
        solves.append(r)
        print(json.dumps(r), flush=True)
    dmod._kernel_fns = own
    print(json.dumps({"hot_us": {f"{r['dtype']} {r['variant']}": r["hot_us"]
                                 for r in rows_out},
                      "cold_us": {f"{r['dtype']} {r['variant']}": r["cold_us"]
                                  for r in rows_out},
                      "solve_median_ms": {r["solve"]: r["median_ms"] for r in solves}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
