"""idle_flag_ms.<suffix>: the device's idle ms a solve (the median over the
traced solves) while the host read the graph runner's stop flag
(``saena.graph.go``), from amgbench/spantrace.py. Traced ms: the profiler's
cost is in them."""
from amgbench.spantrace import idle_ms


def read(run):
    return idle_ms(run, lambda name: name == "saena.graph.go")
