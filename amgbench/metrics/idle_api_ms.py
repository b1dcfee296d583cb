"""idle_api_ms.<suffix>: the device's idle ms a solve (the median over the
traced solves) while the host was in the API's own spans (``saena.api.*``:
the rhs work, the upload, the download of u, the boundary merge), from
amgbench/spantrace.py. Traced ms: the profiler's cost is in them."""
from amgbench.spantrace import idle_ms


def read(run):
    return idle_ms(run, lambda name: name.startswith("saena.api."))
