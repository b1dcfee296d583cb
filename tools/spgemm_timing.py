#!/usr/bin/env python3
"""Seconds of the setup's Galerkin products on the host kernel and on the
card (K5, ops/csr_spgemm.py), product by product, on the hierarchy of the
m^3 Poisson interior.

    python3 tools/spgemm_timing.py [--m 48 96] [--host-reps 3] [--card-reps 5]

For each grid it sets the hierarchy up through ``AMG.set_matrix`` on the
card (the default shard-parallel setup, f64; its own products take their
route and are printed as the setup recorded them), then times, for each
level l, A_l P_l and R_l W_l (W_l = A_l P_l) in turn:

- ``host_s``: the native host kernel on all cores (``_native.spgemm_csr``),
  the least of ``--host-reps`` calls;
- ``card_s``: the card route as the setup takes it: both operands uploaded,
  K5, the product copied back (the least of ``--card-reps`` calls);
- ``kernel_ms``: K5 alone on operands already on the card, by CUDA events,
  the median of ``--card-reps`` calls (count pass, scan and fill);
- ``bound_ms``: the Y stream, 12 bytes a multiply-add, over 3.35 TB/s.

Every card product is held against the host kernel's, bit for bit (uint64
values). One JSON line per product, then the card's name and power limit;
``crossover`` lists, by multiply-adds, where the card route (transfers
included) first beat the host and stayed ahead.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, nargs="+", default=[48])
    ap.add_argument("--host-reps", type=int, default=3)
    ap.add_argument("--card-reps", type=int, default=5)
    ap.add_argument("--max-host-macs", type=float, default=float("inf"),
                    help="time products above this many multiply-adds once on the host")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from saena_tpu_torch import AMG, Matrix, Options, _native, generators
    from saena_tpu_torch.amg.galerkin import spgemm_macs
    from saena_tpu_torch.ops import csr_spgemm as K

    if not torch.cuda.is_available():
        print("spgemm_timing: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; host cores {os.cpu_count()}", flush=True)
    rows = []
    for m in args.m:
        A = generators.laplacian3D(m, m, m)
        M = Matrix()
        M.set_csr(A)
        M.assemble(device=dev, dtype=torch.float64)
        amg = AMG(device=dev, dtype=torch.float64)
        t0 = time.perf_counter()
        amg.set_matrix(M, Options(remove_boundary=True))
        torch.cuda.synchronize(dev)
        info = amg.info
        print(f"[{m}^3] set_matrix {time.perf_counter() - t0:.2f} s, levels {info.sizes}, "
              f"rap {info.phases.get('rap', 0.0):.2f} thread-s", flush=True)
        print(info.table(), flush=True)
        for p in info.products:
            print(json.dumps({"grid": m, "setup_product": p._asdict()}), flush=True)
        for l in range(len(info.Ps)):
            # the stored P's columns follow the coarse level's reordering,
            # unsorted; the route sorts them, which changes no bit
            A_l, P_l, R_l = info.csr_levels[l], info.Ps[l].sorted_indices(), info.Rs[l]
            W = _native.spgemm_csr(A_l, P_l)
            for name, X, Y in (("AP", A_l, P_l), ("RW", R_l, W)):
                macs = spgemm_macs(X, Y)
                reps = 1 if macs > args.max_host_macs else args.host_reps
                host = []
                for _ in range(reps):
                    t = time.perf_counter()
                    Z = _native.spgemm_csr(X, Y)
                    host.append(time.perf_counter() - t)
                tot, kern = [], []
                for _ in range(args.card_reps):
                    torch.cuda.synchronize(dev)
                    t = time.perf_counter()
                    C = K.csr_spgemm(K.DeviceCsr.from_host(X, dev), K.DeviceCsr.from_host(Y, dev))
                    Ch = C.to_host()
                    tot.append(time.perf_counter() - t)
                Xd, Yd = K.DeviceCsr.from_host(X, dev), K.DeviceCsr.from_host(Y, dev)
                for _ in range(args.card_reps):
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record()
                    K.csr_spgemm(Xd, Yd)
                    e1.record()
                    torch.cuda.synchronize(dev)
                    kern.append(e0.elapsed_time(e1))
                same = (np.array_equal(Ch.indptr, Z.indptr.astype(np.int64))
                        and np.array_equal(Ch.indices, Z.indices)
                        and np.array_equal(Ch.data.view(np.uint64), Z.data.view(np.uint64)))
                row = {"grid": m, "level": l, "product": name, "n": X.shape[0],
                       "m": Y.shape[1], "x_nnz": int(X.nnz), "y_nnz": int(Y.nnz),
                       "c_nnz": int(Z.nnz), "macs": macs, "windows": K.windows(Y.shape[1])[0],
                       "host_s": min(host), "card_s": min(tot),
                       "kernel_ms": statistics.median(kern),
                       "bound_ms": 12.0 * macs / 3.35e12 * 1e3, "bit_equal": bool(same)}
                rows.append(row)
                print(json.dumps(row), flush=True)
                if not same:
                    print("spgemm_timing: K5 differs from the host kernel", file=sys.stderr)
                    return 1
                del Xd, Yd, C
        del amg, M
        torch.cuda.empty_cache()
    rows.sort(key=lambda r: r["macs"])
    ahead = [r["card_s"] < r["host_s"] for r in rows]
    first = next((i for i in range(len(rows)) if all(ahead[i:])), None)
    print(json.dumps({"card": card, "crossover": None if first is None else {
        "first_macs_ahead": rows[first]["macs"],
        "last_macs_behind": rows[first - 1]["macs"] if first else None}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
