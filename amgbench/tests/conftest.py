"""Helpers of the harness's CPU tests: a copy of the benchmark's data files
at a small grid, and one run of a cell in this process."""
import contextlib
import io
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


LAZY = "poisson3d_48.lazy_update2"

# The lazy-update cell, which the benchmark does not run yet: its mix and
# its two readers are new files, and the generator's update branch
# (amgbench/traffic.py) serves it unchanged.
_LAZY_FILES = {
    "traffic/lazy_update2.json": json.dumps({
        "rhs_pool": 1, "manufactured_rhs": 0, "update": "update2",
        "value_scale": {"amp": 0.3, "period": 16}, "solver": "solve_pCG",
        "check_share": 1.0, "traced_records": 4}),
    "metrics/step_ms.py": (
        "def read(run):\n"
        "    done = sum(1 for r in run.records if not r.error)\n"
        "    return 1e3 * run.wall_s / done if done else None\n"),
    "metrics/update_ms.py": (
        "def read(run):\n"
        "    t = [r.phases['update'] for r in run.traced\n"
        "         if not r.error and 'update' in r.phases]\n"
        "    return 1e3 * sum(t) / len(t) if t else None\n"),
}


def _add_lazy(root: str) -> None:
    """Enter the lazy-update cell into the copy at ``root``: its files and
    its BENCHMARK.json entries, and nothing else."""
    for rel, body in _LAZY_FILES.items():
        with open(os.path.join(root, "amgbench", rel), "w") as f:
            f.write(body)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["workloads"].append({"name": LAZY, "config": "poisson3d_48",
                           "traffic": "lazy_update2", "chips": 1, "why": "lazy updates"})
    b["end_to_end"].append({"name": "step_ms", "unit": "ms", "better": "lower",
                            "bound": 0.25, "source": "host_clock", "workloads": [LAZY]})
    for name, unit in (("pcg_iters.step", "iters"), ("update_ms.step", "ms"),
                       ("device_idle_share.step", "%")):
        b["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                               "source": "host_clock", "layer": "solve",
                               "moves": "step_ms", "workloads": [LAZY]})
    with open(path, "w") as f:
        json.dump(b, f)


def make_root(tmp, grid: int = 8, lazy: bool = False) -> str:
    """A root holding BENCHMARK.json and the benchmark's data folders, each
    configuration's grid set to ``grid``; with ``lazy``, the lazy-update
    cell entered too."""
    root = os.path.join(str(tmp), "root")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for sub in ("configs", "traffic", "metrics", "reference"):
        shutil.copytree(os.path.join(REPO, "amgbench", sub),
                        os.path.join(root, "amgbench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    if lazy:
        _add_lazy(root)
    for f in os.listdir(os.path.join(root, "amgbench", "configs")):
        path = os.path.join(root, "amgbench", "configs", f)
        with open(path) as fh:
            conf = json.load(fh)
        conf["grid"] = grid
        with open(path, "w") as fh:
            json.dump(conf, fh)
    return root


def run_cell(root: str, cell: str, seed: int = 2**31 + 11, seconds: float = 0.5,
             trace: int = 0, control: bool = False):
    """(exit code, the last stdout line as JSON or None, stderr) of one run
    on the CPU."""
    from amgbench import run

    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)] + (["--control"] if control else [])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(argv, root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def root8(tmp_path):
    return make_root(tmp_path, 8)
