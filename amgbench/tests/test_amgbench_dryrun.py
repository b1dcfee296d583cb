"""Each cell run end to end on the CPU at grid 8: the result line has the
result format's keys, is correct, and reports the cell's metrics; the process
that ran it holds no JAX and no saena_tpu."""
import json
import os
import subprocess
import sys

import pytest

from conftest import LAZY, REPO, make_root, run_cell

from amgbench import spec

CELLS = [w["name"] for w in json.load(open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", CELLS + [LAZY])
def test_dry_run(tmp_path, cell):
    root8 = make_root(tmp_path, 8, lazy=True)
    rc, res, err = run_cell(root8, cell)
    assert rc == 0, err
    assert set(res) == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    want = {m["name"] for m in spec.load_cell(root8, cell).end_to_end}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["checks"]["rel_res_worst"]["value"] <= res["checks"]["rel_res_worst"]["limit"]
    # the compared numbers are the last lines of standard error
    assert err.strip().splitlines()[-len(res["checks"]):][0].startswith("check ")


@pytest.mark.parametrize("cell,want", [
    ("poisson3d_48.solve_stream", {"pcg_iters.solve_l2", "set_matrix_s"}),
    (LAZY, {"pcg_iters.step", "update_ms.step"})])
def test_traced_dry_run(tmp_path, cell, want):
    """--trace 1 on the CPU: the per-layer metrics from counters and the
    host clock; no device, so no device metric and no busy time."""
    rc, res, err = run_cell(make_root(tmp_path, 8, lazy=True), cell, trace=1)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == want
    assert "busy_s" not in res["device"]


_CHILD = """
import contextlib, io, json, sys
sys.path.insert(0, {tests!r}); sys.path.insert(0, {repo!r})
from conftest import make_root, run_cell
rc, res, err = run_cell(make_root({tmp!r}, 8), "poisson3d_48.solve_stream")
tops = sorted({{n.split(".", 1)[0] for n in sys.modules}})
print(json.dumps({{"rc": rc, "correct": res["correct"], "tops": tops}}))
"""


def test_no_jax_in_the_process(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _CHILD.format(tests=os.path.dirname(__file__), repo=REPO, tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=600)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and got["correct"]
    assert "saena_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "saena_tpu"} & set(got["tops"])


def test_needs_a_card_without_one(root8):
    """From the command line, without a card, the run prints no result and
    exits non-zero."""
    out = subprocess.run([sys.executable, os.path.join(REPO, "amgbench", "run.py"),
                          "--workload", CELLS[0], "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card(tmp_path, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(REPO, "amgbench", "run.py"),
                          "--workload", cell, "--seed", str(2**31 + 5), "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True, timeout=1200)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and res["correct"], out.stderr[-3000:]
    assert res["device"]["busy_s"] > 0
