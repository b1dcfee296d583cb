"""device_idle_share.<suffix>: 100 x (1 - busy / wall) of a request, the
device's busy seconds a request from the trace of the traced requests, the
wall a request from the untraced window.

The profiler's own tracing of each of a solve's ~2,000 graph kernels slows
a traced request by 5-10 ms and leaves the device idle meanwhile, while the
device's busy time a request stays as it was; so the wall comes from the
window, where nothing is traced."""


def read(run):
    t = run.trace
    done = sum(1 for r in run.records if not r.error)
    traced = sum(1 for r in run.traced if not r.error)
    if not t or t["busy_s"] <= 0 or not done or not traced:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / traced) / (run.wall_s / done))
