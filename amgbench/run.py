"""The benchmark of saena_tpu_torch: one cell of ``BENCHMARK.json``, one run.

    python3 amgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the start of this script): CUDA, the inputs from
the seed, ``Matrix.assemble`` and ``AMG.set_matrix`` (which load or build
the program's kernels in its checkout), and one warm request, which
captures the solve's graphs. Then the mix's closed loop runs for
``--seconds``; then the answers are judged against the plain reference,
and the last line of standard output is the result. ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read
after a traced run of ``traced_records`` more requests.

``--control`` runs the configuration's ``control_dtype`` in place of its
``dtype``: the lower-precision control, which has to come out not correct.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script: the checkout's root in place of this script's folder,
# whose module names are the benchmark's own
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402

CACHE = os.path.join(ROOT, "amgbench", ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "saena_tpu")


def _cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


_cache_env()

import torch  # noqa: E402

from amgbench import check, devtrace, spec  # noqa: E402
from amgbench import traffic as tr  # noqa: E402


@dataclasses.dataclass
class Run:
    """What a metric's reader may read."""
    cell: spec.Cell
    device: torch.device
    amg: object
    setup_s: float
    set_matrix_s: float
    records: list          # the window's requests
    wall_s: float          # the window: first start to last end
    traced: list           # the traced requests (--trace 1)
    trace: dict | None     # devtrace.summary of the traced requests


def forbidden_modules() -> list:
    return sorted({n.split(".", 1)[0] for n in sys.modules} & set(FORBIDDEN))


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def main(argv=None, *, root: str = ROOT, device=None) -> int:
    """One run. ``root`` holds BENCHMARK.json and the benchmark's data
    files; ``device`` (tests only) skips the look for a card and runs there."""
    args = _args(argv)
    cell = spec.load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"amgbench: the cell needs {cell.chips} CUDA card(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    torch.zeros(1, device=device)
    parts = {"start_to_device": time.perf_counter() - T_START}

    from saena_tpu_torch import AMG, Matrix, Options

    config, mix = cell.config, cell.traffic
    dtype = getattr(torch, config["control_dtype" if args.control else "dtype"])
    t = time.perf_counter()
    A, pool = check.inputs(root, config, mix, args.seed)
    parts["inputs"] = time.perf_counter() - t
    M = Matrix()
    M.set_csr(A)
    M.assemble(device=device, dtype=dtype)
    amg = AMG(device=device, dtype=dtype)
    t = time.perf_counter()
    parts["import_and_assemble"] = t - T_START - parts["start_to_device"] - parts["inputs"]
    amg.set_matrix(M, Options(**config["options"]))
    sync()
    set_matrix_s = parts["set_matrix"] = time.perf_counter() - t
    print("levels:", amg.info.sizes, "formats:", amg.info.formats, file=sys.stderr)
    print("set_matrix phases s:", json.dumps(amg.info.phases), file=sys.stderr)
    loop = tr.ClosedLoop(mix, amg, A, pool, args.seed, matrix_cls=Matrix,
                         device=device, dtype=dtype)
    t = time.perf_counter()
    warm = loop.run(1, first=0)
    sync()
    setup_s = time.perf_counter() - T_START
    parts["warm_request"] = setup_s - (t - T_START)
    print("setup parts s:", json.dumps(parts), file=sys.stderr)
    if warm[0].error:
        print(warm[0].error, file=sys.stderr)

    records, wall_s = loop.window(args.seconds, first=1)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    traced, summary = [], None
    if args.trace:
        loop.span = torch.profiler.record_function
        with devtrace.profiled(cuda) as events:
            with torch.profiler.record_function("amgbench.window"):
                traced = loop.run(int(mix["traced_records"]), first=1 + len(records))
            sync()
        loop.span = lambda name: contextlib.nullcontext()
        summary = devtrace.summary(events, "amgbench.window")
        del events

    run = Run(cell, device, amg, setup_s, set_matrix_s, records, wall_s, traced, summary)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs
    del run, loop, amg, M
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    verdict = check.judge(root, config, mix, args.seed, records + traced)
    bad = forbidden_modules()
    if bad:
        print(f"amgbench: modules loaded that the port must not load: {bad}",
              file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = _power_limit_w()
    out = {"correct": bool(verdict["correct"]), "attempted": len(records) + len(traced),
           "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        out["breakdown"] = {k: summary[k] for k in ("device_ops", "idle_gaps")}
    errors = [r.error for r in records + traced if r.error]
    if errors:
        print(f"amgbench: {len(errors)} request(s) raised; the first:\n{errors[0]}",
              file=sys.stderr)
    checks = {k: {kk: (vv if math.isfinite(vv) else 1e300) for kk, vv in c.items()}
              for k, c in verdict["checks"].items()}
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: " + ", ".join(f"{kk} {vv!r}" for kk, vv in c.items()),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
