"""amgbench/metrics/l3_matvec_roofline.py's split of a flushed-launch trace
on hand-written Chrome traces: the segments start at the flush's own
operations, so a trace whose first flush the profiler dropped still times
the matvec, and the reader is silent off the card."""
from types import SimpleNamespace as NS

import torch

from conftest import REPO  # noqa: F401 (puts the repo on the path)

from amgbench.metrics import l3_matvec_roofline as l3

FILL, MATVEC = "fill<unsigned char>", "ell_kernel<double, double>"


def _dev(name, a, b, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}


def _trace(n, drop_first=False):
    """n launches: an 80 µs flush, then a 290 µs matvec of a 10 µs gather
    and a 280 µs product."""
    ev, t = [], 0.0
    for i in range(n):
        if not (drop_first and i == 0):
            ev.append(_dev(FILL, t, t + 80))
        ev.append(_dev("gather", t + 81, t + 91))
        ev.append(_dev(MATVEC, t + 91, t + 371))
        ev.append(_dev("host", t, t + 400, cat="cpu_op"))
        t += 500
    return ev


def test_segments_start_at_the_flush():
    assert l3.busy_after_markers(_trace(5), {FILL}) == [290.0] * 5


def test_a_dropped_first_flush_leaves_the_matvec_timed():
    # split at the trace's first operation, the segments would be 80 µs flushes
    assert l3.busy_after_markers(_trace(5, drop_first=True), {FILL}) == [290.0] * 4


def test_no_marker_no_segment():
    assert l3.busy_after_markers(_trace(3), {"another"}) == []


def test_silent_off_the_card():
    run = NS(device=torch.device("cpu"), amg=None)
    assert l3.read(run) is None
