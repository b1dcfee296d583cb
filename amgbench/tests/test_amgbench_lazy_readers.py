"""The lazy-update cell's readers on hand-made runs: each reads its own
phase or record, and is None where its data is missing (off the card for
the program's counters, in a program that keeps no such phase, or without
updates)."""
import types

import pytest
import torch

from conftest import REPO

from amgbench import spec
from amgbench.traffic import Record

CARD, CPU = torch.device("cuda", 0), torch.device("cpu")

# the last update's phases: two overlapping Galerkin products on two
# threads, then the rebuild with its own phases inside it
SPANS = [("galerkin", 0.0, 1.0, 1), ("galerkin", 0.5, 1.5, 2),
         ("devicify_A", 1.6, 1.9, 1), ("eig", 1.9, 2.0, 1),
         ("devicify", 1.5, 2.25, 1)]


def _run(device=CARD, spans=SPANS, reuse=("values", "values", "rebuilt", "whole"),
         records=()):
    info = types.SimpleNamespace(phase_spans=list(spans),
                                 reuse=None if reuse is None else list(reuse))
    return types.SimpleNamespace(device=device, amg=types.SimpleNamespace(info=info),
                                 records=list(records), traced=[])


def _read(name, run):
    return spec.reader(REPO, name)(run)


def _rec(i, update_s=None, error=""):
    r = Record(i, 0, i)
    if update_s is not None:
        r.phases["update"] = update_s
    r.error = error
    return r


def test_update_ms_is_the_median_of_the_window():
    recs = [_rec(0, 2.0), _rec(1, 3.0), _rec(2, 10.0), _rec(3, 100.0, error="x"),
            _rec(4)]
    assert _read("update_ms.step", _run(records=recs)) == pytest.approx(3000.0)
    assert _read("update_ms.step", _run(records=[_rec(0)])) is None


def test_phase_readers_take_their_own_phase():
    run = _run()
    assert _read("update_galerkin_ms.step", run) == pytest.approx(1500.0)
    assert _read("update_devicify_ms.step", run) == pytest.approx(750.0)
    assert _read("update_rebuilt_levels.step", run) == 1
    assert _read("update_rebuilt_levels.step", _run(reuse=["values"] * 4)) == 0


@pytest.mark.parametrize("name", ["update_galerkin_ms.step", "update_devicify_ms.step",
                                  "update_rebuilt_levels.step"])
def test_counters_are_none_without_their_data(name):
    assert _read(name, _run(device=CPU)) is None
    # a program whose update keeps only the rebuild's inner phases and no
    # record of reuse, as before the update was traced
    old = _run(spans=[s for s in SPANS if s[0] not in ("galerkin", "devicify")],
               reuse=None)
    assert _read(name, old) is None
