"""solve_ms_p95: the 95th percentile of the window's solves, each timed on
the host clock from set_rhs to the returned host solution."""
import numpy as np


def read(run):
    t = [r.end - r.start for r in run.records if not r.error]
    return float(np.percentile(t, 95)) * 1e3 if t else None
