#!/usr/bin/env python3
"""Wall seconds of the port's host setup of the m^3 Poisson interior, by
setup configuration, taken in turns on one machine.

    python3 tools/setup_timing.py [--m 48] [--reps 2] [--device cuda]

Configurations: the serial setup (setup_shards=0) and the shard-parallel
setup (parallel/dist_setup.py) at 2, 4 and 8 shards with the GR wire codec
(the default) and with raw windows. Every configuration builds the same
hierarchy bit for bit (the script checks it against the serial one); only
the time differs. Each round runs every configuration once, rounds
alternate the order, after one untimed serial setup (library loads, first
uploads). On the card it first prints the card's name and power limit;
then one JSON line per run and a summary line with the least wall seconds
per configuration.
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
    ap.add_argument("--m", type=int, default=48)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from saena_tpu_torch import Options, generators
    from saena_tpu_torch.amg.hierarchy import setup
    from saena_tpu_torch.core.coo import remove_boundary_nodes
    from saena_tpu_torch.parallel.dist_setup import dist_setup

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    m = args.m
    A = remove_boundary_nodes(generators.laplacian3D(m, m, m))[0].tocsr()
    kw = dict(dtype=torch.float64, device=args.device)
    configs = [("serial", None, None)] + [
        (f"dist{d}_{codec}", d, codec) for d in (2, 4, 8) for codec in ("gr", "none")]

    def run(name, shards, codec):
        t0 = time.perf_counter()
        if shards is None:
            _, info = setup(A, Options(), **kw)
        else:
            _, info = dist_setup(A, Options(), n_shards=shards, wire_codec=codec, **kw)
        if args.device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, info

    ref = run("warm-up", None, None)[1]    # library loads, first uploads
    best: dict = {}
    for rnd in range(args.reps):
        order = configs if rnd % 2 == 0 else configs[::-1]
        for name, shards, codec in order:
            wall, info = run(name, shards, codec)
            same = all(np.array_equal(X.data, Y.data) and np.array_equal(X.indices, Y.indices)
                       for X, Y in zip(ref.csr_levels + ref.Ps + ref.Rs,
                                       info.csr_levels + info.Ps + info.Rs))
            if not same:
                print(f"{name}: the hierarchy differs from the serial one", file=sys.stderr)
                return 1
            best[name] = min(best.get(name, wall), wall)
            print(json.dumps({"config": name, "round": rnd, "wall_s": wall,
                              "phases_s": {k: round(v, 3) for k, v in info.phases.items()},
                              "comm_bytes": None if info.comm is None else info.comm.total_bytes}))
    print(json.dumps({"m": m, "device": args.device, "cpu_count": os.cpu_count(),
                      "best_wall_s": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
