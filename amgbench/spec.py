"""The benchmark's registry: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by its name:

- a configuration: the ``file`` of its entry in ``BENCHMARK.json``;
- a traffic mix: ``amgbench/traffic/<traffic>.json``, parameters that the
  one generator (``amgbench/traffic.py``) reads;
- a configuration's plain reference: ``amgbench/reference/<problem>.py``
  for the configuration's ``problem``, with ``matrix(config)`` and
  ``manufactured_rhs(config)``;
- a metric, end-to-end or per-layer: ``amgbench/metrics/<name>.py``, or
  ``amgbench/metrics/<stem>.py`` for a name ``<stem>.<suffix>`` (one reader
  serves ``pcg_iters.solve`` and ``pcg_iters.step``), with a function
  ``read(run)`` that returns the number or None.

So a later configuration, problem, mix or metric is files and
``BENCHMARK.json`` entries, and no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = "amgbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the mix's parameters
    chips: int
    end_to_end: tuple     # metric entries this cell reports with --trace 0
    per_layer: tuple      # metric entries this cell reports with --trace 1


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or, without
    a list, every cell (end-to-end) or every cell that reports the
    end-to-end metric it moves (per-layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH_DIR, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = tuple(m for m in spec["end_to_end"] if _reports(m, name, set()))
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in spec["per_layer"] if _reports(m, name, names))
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)


def _module(root: str, sub: str, stem: str):
    """The module ``root/amgbench/<sub>/<stem>.py``, or None."""
    path = os.path.join(root, BENCH_DIR, sub, f"{stem}.py")
    if not os.path.exists(path):
        return None
    name = f"amgbench_{sub}_" + stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, metric: str):
    """The ``read`` function of the metric ``metric``'s file."""
    for stem in (metric, metric.split(".", 1)[0]):
        mod = _module(root, "metrics", stem)
        if mod is not None:
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{os.path.join(root, BENCH_DIR, 'metrics')}")


def reference(root: str, problem: str):
    """The plain reference module of the problem ``problem``."""
    mod = _module(root, "reference", problem)
    if mod is None:
        raise FileNotFoundError(f"no reference for problem {problem!r} under "
                                f"{os.path.join(root, BENCH_DIR, 'reference')}")
    return mod
