"""amgbench/spantrace.py on hand-written Chrome traces: a solve's idle
device time split over time by the innermost ``saena.*`` span of its host
thread, ``in_graph`` by correlation, the rest ``outside``, summing to the
idle time; and the readers that take their numbers from it."""
from types import SimpleNamespace as NS

import pytest
import torch

from conftest import REPO

from amgbench import spantrace as st
from amgbench import spec


def _host(name, a, b, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a,
            "tid": tid}


def _dev(a, b, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "ts": a, "dur": b - a,
            "tid": 7, "args": {"correlation": corr}}


def _solve_trace(t=0.0):
    """One solve in [t, t + 100]: its host spans on thread 1, one span of
    another thread, and five device operations (two of one graph replay)."""
    return [
        _host(st.SPAN, t, t + 100),
        _host("saena.solve", t + 5, t + 95),
        _host("saena.api.rhs", t + 5, t + 15),
        _host("saena.api.upload", t + 15, t + 25),
        _host("saena.graph.init", t + 25, t + 30),
        _host("saena.graph.go", t + 30, t + 50),
        _host("saena.graph.step", t + 50, t + 55),
        _host("saena.graph.go", t + 55, t + 70),
        _host("saena.api.download", t + 70, t + 90),
        _host("saena.setup.eig", t, t + 100, tid=2),       # another thread
        _dev(t + 20, t + 24, 1, "gpu_memcpy"),
        _dev(t + 31, t + 40, 2),
        _dev(t + 42, t + 45, 2),                             # the same replay
        _dev(t + 52, t + 60, 3),
        _dev(t + 80, t + 85, 4, "gpu_memcpy"),
    ]


WANT = {"outside": 10, "saena.api.rhs": 10, "saena.api.upload": 6,
        "saena.graph.init": 5, "saena.graph.go": 16, "in_graph": 2,
        "saena.graph.step": 2, "saena.api.download": 15, "saena.solve": 5}


def test_split_by_span_over_time():
    """Each idle µs goes to the innermost span of the solve's thread at that
    µs (a gap that spans two spans is split between them), to in_graph
    between two operations of one launch, else to outside; the parts sum to
    the idle time."""
    out = st.split_trace(_solve_trace())
    assert len(out) == 1
    s = out[0]
    assert s["split"] == pytest.approx(WANT)
    assert s["idle_us"] == pytest.approx(100 - (4 + 9 + 3 + 8 + 5))
    assert sum(s["split"].values()) == pytest.approx(s["idle_us"])
    assert s["flag_reads"] == 2


def test_overlapping_operations_and_correlations():
    """Operations that overlap (two streams) are busy once; a gap between
    two launches with different correlations is not in_graph."""
    ev = [_host(st.SPAN, 0, 50), _host("saena.solve", 0, 50),
          _dev(0, 10, 1), _dev(5, 20, 2), _dev(25, 30, 2), _dev(35, 50, 3)]
    s = st.split_trace(ev)[0]
    assert s["split"] == pytest.approx({"in_graph": 5, "saena.solve": 5})
    assert s["idle_us"] == pytest.approx(10)


def test_one_split_per_window_and_none_without_program_spans():
    ev = _solve_trace(0.0) + _solve_trace(1000.0)
    out = st.split_trace(ev)
    assert [s["split"] for s in out] == [pytest.approx(WANT)] * 2
    bare = [e for e in ev if not e["name"].startswith("saena.")]
    assert st.split_trace(bare) is None


def test_innermost_segments_nest():
    segs = st.innermost_segments([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"), (7, 8, "d")])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 7, "a"), (7, 8, "d"),
                    (8, 10, "a")]


def test_phase_wall_counts_overlaps_once():
    spans = [("rap", 0.0, 2.0, 1), ("rap", 1.0, 3.0, 2), ("eig", 0.0, 9.0, 3),
             ("rap", 5.0, 6.0, 1)]
    assert st.phase_wall_s(spans, "rap") == pytest.approx(4.0)
    assert st.phase_wall_s(spans, "none") == 0.0


def test_readers_take_the_median_and_are_silent_off_the_card():
    split = st.split_trace(_solve_trace(0.0) + _solve_trace(1000.0))
    slow = {"split": {"saena.api.upload": 900.0, "saena.graph.go": 700.0}}
    run = NS(device=torch.device("cuda", 0), _spantrace=[slow] + split)
    api = spec.reader(REPO, "idle_api_ms.solve")(run)
    flag = spec.reader(REPO, "idle_flag_ms.solve_l2")(run)
    assert api == pytest.approx((10 + 6 + 15) / 1e3)
    assert flag == pytest.approx(16 / 1e3)
    cpu = NS(device=torch.device("cpu"), amg=None, info=None)
    for name in ("idle_api_ms.solve", "idle_flag_ms.solve", "graph_capture_ms",
                 "set_matrix_rap_s"):
        assert spec.reader(REPO, name)(cpu) is None
    loops = {0: NS(capture_ms=120.5), 1: NS(capture_ms=None)}
    card = NS(device=torch.device("cuda", 0),
              amg=NS(hierarchy=NS(graphs=loops),
                     info=NS(phase_spans=[("rap", 0.0, 2.0, 1), ("rap", 1.0, 3.0, 2)])))
    assert spec.reader(REPO, "graph_capture_ms")(card) == pytest.approx(120.5)
    assert spec.reader(REPO, "set_matrix_rap_s")(card) == pytest.approx(3.0)
    card.amg.info = NS()         # a program that keeps no intervals
    assert spec.reader(REPO, "set_matrix_rap_s")(card) is None
