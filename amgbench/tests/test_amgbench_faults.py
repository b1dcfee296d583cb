"""The control and the planted faults: a run whose timed path is broken
underneath, or runs below the configuration's precision, comes out not
correct. Runs on the CPU at a small grid; the card's run of the control is
``python3 amgbench/run.py --control ...``."""
import numpy as np
import pytest

from conftest import LAZY, make_root, run_cell

SOLVE = "poisson3d_48.solve_stream"


def _stale(orig):
    """The solve returns its first answer again: its state unchanged."""
    first = {}

    def solve(self, **kw):
        u, res = orig(self, **kw)
        first.setdefault(id(self), u)
        return first[id(self)].copy(), res
    return solve


def _half(orig):
    """Half of the answer left out."""
    def solve(self, **kw):
        u, res = orig(self, **kw)
        u = u.copy()
        u[u.size // 2:] = 0.0
        return u, res
    return solve


def _altered(orig):
    """One entry of the answer altered where it is produced."""
    def solve(self, **kw):
        u, res = orig(self, **kw)
        u = u.copy()
        k = int(np.argmax(np.abs(u)))
        u[k] *= 1.0 + 1e-6
        return u, res
    return solve


@pytest.mark.parametrize("cell", [SOLVE, LAZY])
@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_faulty_answer_is_caught(tmp_path, monkeypatch, cell, fault):
    from saena_tpu_torch import AMG

    monkeypatch.setattr(AMG, "solve_pCG", fault(AMG.solve_pCG))
    rc, res, err = run_cell(make_root(tmp_path, 12, lazy=True), cell)
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1, err


def test_update_that_changes_nothing_is_caught(tmp_path, monkeypatch):
    """The lazy update returns the hierarchy as it was."""
    from saena_tpu_torch import AMG

    monkeypatch.setattr(AMG, "update2", lambda self, A: self)
    rc, res, err = run_cell(make_root(tmp_path, 12, lazy=True), LAZY)
    assert rc == 0 and res["correct"] is False, err


@pytest.mark.parametrize("cell", [SOLVE, LAZY])
def test_lower_precision_control_fails(tmp_path, cell):
    rc, res, err = run_cell(make_root(tmp_path, 12, lazy=True), cell, control=True)
    assert rc == 0 and res["correct"] is False, err
    c = res["checks"]["rel_res_worst"]
    assert c["value"] > 3 * c["limit"]
