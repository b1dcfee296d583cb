"""graph_capture_ms: the sum of ``Loop.capture_ms`` over the hierarchy's
solver loops (a counter of the program: the warm-up and capture of each
loop's graphs, at its first solve). None off the card."""


def read(run):
    if run.device.type != "cuda":
        return None
    ms = [loop.capture_ms for loop in run.amg.hierarchy.graphs.values()
          if getattr(loop, "capture_ms", None) is not None]
    return sum(ms) if ms else None
