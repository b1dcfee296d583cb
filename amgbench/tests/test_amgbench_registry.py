"""BENCHMARK.json against the registry and the benchmark format's shape: every
configuration, mix and metric it names has its file, and a new problem, mix
or metric is files and entries, with no file of the harness edited."""
import json
import os
import re

import pytest

from conftest import REPO, make_root, run_cell

from amgbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_named_file_is_found():
    b = _bench()
    for cell in b["workloads"]:
        c = spec.load_cell(REPO, cell["name"])
        assert c.config["name"] == cell["config"]
        for m in c.end_to_end + c.per_layer:
            assert callable(spec.reader(REPO, m["name"]))
    for conf in b["configs"]:
        path = os.path.join(REPO, conf["file"])
        assert os.path.exists(path) and conf["file"].startswith("amgbench/")
        with open(path) as f:
            body = json.load(f)
        assert sorted(body["reduced"]) == sorted(conf["reduced"])
        assert body["source"] == conf["source"]


def test_benchmark_format():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        c = spec.load_cell(REPO, w["name"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
        for m in c.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_extra_mix_and_metric_are_data(tmp_path):
    """A cell with a mix and a per-layer metric that only new files and new
    entries define, run on the CPU."""
    root = make_root(tmp_path, 8)
    with open(os.path.join(root, "amgbench", "traffic", "vcycle_stream.json"), "w") as f:
        json.dump({"rhs_pool": 3, "manufactured_rhs": 1, "solver": "solve",
                   "check_share": 1.0, "traced_records": 2}, f)
    with open(os.path.join(root, "amgbench", "metrics", "rhs_distinct.py"), "w") as f:
        f.write("def read(run):\n    return len({r.rhs for r in run.traced})\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["workloads"].append({"name": "poisson3d_48.vcycle_stream", "config": "poisson3d_48",
                           "traffic": "vcycle_stream", "chips": 1, "why": "test"})
    next(m for m in b["end_to_end"] if m["name"] == "solve_ms.l2")["workloads"].append(
        "poisson3d_48.vcycle_stream")
    b["per_layer"].append({"name": "rhs_distinct", "unit": "rhs", "better": "higher",
                           "source": "program_counter", "layer": "solve",
                           "moves": "solve_ms.l2", "workloads": ["poisson3d_48.vcycle_stream"]})
    with open(path, "w") as f:
        json.dump(b, f)
    rc, res, err = run_cell(root, "poisson3d_48.vcycle_stream", trace=1)
    assert rc == 0 and res["correct"], err
    assert res["metrics"]["rhs_distinct"]["value"] == 2
    rc, res, err = run_cell(root, "poisson3d_48.vcycle_stream", trace=0)
    assert rc == 0 and set(res["metrics"]) == {"solve_ms.l2", "setup_s"}


_LAPLACIAN2D = """
import numpy as np
import scipy.sparse as sp


def matrix(config):
    m = int(config["grid"])
    T = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)], [-1, 0, 1])
    return sp.csr_matrix(sp.kron(T, sp.identity(m)) + sp.kron(sp.identity(m), T))


def manufactured_rhs(config):
    return np.ones(int(config["grid"]) ** 2)
"""


def test_extra_problem_is_data(tmp_path):
    """A configuration of another problem, the 5-point 2-D Laplacian on the
    interior nodes, that only a new reference module, a new configuration
    file and new entries define, run on the CPU."""
    root = make_root(tmp_path, 8)
    with open(os.path.join(root, "amgbench", "reference", "laplacian2D.py"), "w") as f:
        f.write(_LAPLACIAN2D)
    conf = {"name": "laplacian2D_12", "source": "test", "problem": "laplacian2D",
            "grid": 12, "dtype": "float64", "control_dtype": "float32",
            "options": {"remove_boundary": False, "tol": 1e-8, "max_iter": 100},
            "limits": {"rel_res": 1e-8}, "reduced": {}}
    with open(os.path.join(root, "amgbench", "configs", "laplacian2D_12.json"), "w") as f:
        json.dump(conf, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    cell = "laplacian2D_12.solve_stream"
    b["configs"].append({"name": "laplacian2D_12", "source": "test",
                         "file": "amgbench/configs/laplacian2D_12.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": cell, "config": "laplacian2D_12",
                           "traffic": "solve_stream", "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("solve_ms", "solve_ms_p95", "pcg_iters.solve"):
            m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(b, f)
    rc, res, err = run_cell(root, cell, trace=1)
    assert rc == 0 and res["correct"], err
    assert res["checks"]["answers_checked"]["value"] >= 17   # the 16 traced, the first of the window
    assert set(res["metrics"]) == {"pcg_iters.solve"}
    rc, res, err = run_cell(root, cell, trace=0)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"solve_ms", "solve_ms_p95", "setup_s"}
    # the control, in float32, comes out not correct
    rc, res, err = run_cell(root, cell, trace=0, control=True)
    assert rc == 0 and res["correct"] is False, err


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell(REPO, "no_such.cell")


def test_idle_share_takes_the_window_wall():
    """device_idle_share: the traced requests' busy seconds a request over
    the untraced window's wall a request."""
    from types import SimpleNamespace as NS

    read = spec.reader(REPO, "device_idle_share.solve")
    ok, bad = NS(error=""), NS(error="raised")
    run = NS(trace={"busy_s": 0.3, "window_s": 0.9}, traced=[ok] * 4,
             records=[ok] * 10 + [bad], wall_s=1.0)
    assert read(run) == pytest.approx(25.0)     # 75 ms busy of a 100 ms request
    assert read(NS(**(vars(run) | {"trace": None}))) is None
