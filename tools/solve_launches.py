#!/usr/bin/env python3
"""The kernels' launches in one pCG solve, by kernel and by shape, the API's
copies of the solve's vectors between host and card, and every ELL
operator of the hierarchy timed through the ELL kernel and its plain torch
version, for the m^3 Poisson interior on the card.

    python3 tools/solve_launches.py [--m 96] [--solves 4] [--seed 0]

Sets the interior up in float64 as the benchmark's configurations do
(Options(remove_boundary=True)), prints the levels and their formats, runs
a warm solve (the graph capture), then counts the kernels' launches over
``--solves`` solves of seeded uniform(-1, 1) right-hand sides
(runtime.launches: graph replays counted as the uncaptured loop makes
them) and the API's vector copies by direction and route with their bytes
(runtime.copies), and prints both per solve. Each ELL operator (a level's
A, P or R) is then timed with the L2 flushed before each launch (CUDA
events; its rows' and tiles' lengths beside it), through the kernel and
through ``ell_spmv_plain`` (chip_smoke.flushed_us). The first line is the
card's name and power limit; the last is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--solves", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from chip_smoke import flushed_us
    from saena_tpu_torch import AMG, Matrix, Options, generators
    from saena_tpu_torch.ops import ell_spmv as K
    from saena_tpu_torch.ops.formats import EllMatrix
    from saena_tpu_torch.runtime import copies_of, launches_of

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    m = args.m
    A = Matrix()
    A.set_csr(generators.laplacian3D(m, m, m))
    A.assemble(device=dev, dtype=torch.float64)
    amg = AMG(device=dev, dtype=torch.float64)
    t0 = time.perf_counter()
    amg.set_matrix(A, Options(remove_boundary=True))
    torch.cuda.synchronize()
    print(f"set_matrix {time.perf_counter() - t0:.1f} s; levels {amg.info.sizes}; "
          f"formats {amg.info.formats}", flush=True)
    rng = np.random.default_rng(args.seed)
    amg.set_rhs(rng.uniform(-1, 1, m ** 3))
    amg.solve_pCG()                                  # the capture
    ms, iters = [], []

    def solves():
        for _ in range(args.solves):
            amg.set_rhs(rng.uniform(-1, 1, m ** 3))
            t0 = time.perf_counter()
            _, res = amg.solve_pCG()
            ms.append((time.perf_counter() - t0) * 1e3)
            iters.append(int(res.iters))

    (_, made), copied = copies_of(lambda: launches_of(solves))
    per = {k: v / args.solves for k, v in made.items()}
    out = {"grid": m, "solve_ms": ms, "iters": iters,
           "copies_per_solve": {k: v / args.solves for k, v in copied.items()},
           "launches_per_solve": {k: v for k, v in per.items() if isinstance(k, str)},
           "shapes_per_solve": {" ".join(map(str, k)): v for k, v in per.items()
                                if isinstance(k, tuple)}}
    ell = []
    for lv, L in enumerate(amg.hierarchy.levels):
        for name in ("A", "P", "R"):
            M = getattr(L, name)
            if not isinstance(M, EllMatrix):
                continue
            csr = {"A": amg.info.csr_levels[lv]}.get(name)
            x = torch.randn(M.plan.n_x, dtype=M.dtype, device=dev,
                            generator=torch.Generator(dev).manual_seed(lv))
            x[M.shape[1]:] = 0
            row = {"level": lv, "op": name, "shape": list(M.shape), "nnz": M.nnz,
                   "width": M.vals.shape[0], "stored_slots": M.vals.numel(),
                   "slots_read": int(M.tile_bound.sum()) * K.TILE,
                   "tile_bound_min_max": [int(M.tile_bound[: -(-M.shape[0] // K.TILE)].min()),
                                          int(M.tile_bound.max())],
                   "spill_triples": int(M.spill_rows.numel()),
                   "spill_rows": int(M.spill_rows.unique().numel()),
                   "blocks": M.plan.n_blocks,
                   "k4_us": flushed_us(lambda: M.matvec(x), dev, 100),
                   "plain_us": flushed_us(lambda: K.ell_spmv_plain(M, x), dev, 20)}
            if csr is not None:
                lengths = np.diff(csr.indptr)
                row["row_nnz_min_max_mean"] = [int(lengths.min()), int(lengths.max()),
                                               float(lengths.mean())]
                row["bound_us"] = (csr.nnz + sum(csr.shape)) * 8 / 3.35e12 * 1e6
            print(json.dumps(row), flush=True)
            ell.append(row)
    out["ell_operators"] = ell
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
