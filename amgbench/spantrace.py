"""A solve's device idle time split by the program's own spans.

The program marks its layers with ``saena.*`` spans while a torch profiler
records (``saena_tpu_torch.runtime.span``): the API's host work
(``saena.api.*``), the graph runner's replays and flag reads
(``saena.graph.*``). ``solve_split(run)`` runs the mix's ``traced_records``
further calls of its solver on ``run.amg``, each inside the span
``amgbench.spans``, under one profiler, once a run (cached on the run), and
splits each solve's idle device time, µs by µs, into:

- ``in_graph``: idle time between two device operations that the trace
  links to the same launching runtime call (``args.correlation``): inside
  one graph replay, where the profiler's own cost per kernel shows;
- the innermost ``saena.*`` span the solve's host thread was in at that µs;
- ``outside``: no such span.

On the CPU, and where the program has no ``saena.solve`` span (a program
without spans), it returns None.
"""
from __future__ import annotations

import bisect
import statistics
import sys

import torch

from amgbench import devtrace

SPAN = "amgbench.spans"
PREFIX = "saena."
IN_GRAPH, OUTSIDE = "in_graph", "outside"
_CACHE = "_spantrace"


def innermost_segments(spans) -> list:
    """Disjoint (start, end, name) segments, each labelled with the
    innermost of the nested (start, end, name) ``spans`` of one thread that
    covers it."""
    segs, stack, t = [], [], None
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, who = stack.pop()
            segs.append((t, end, who))
            t = end
        if stack:
            segs.append((t, a, stack[-1][1]))
        stack.append((b, name))
        t = a
    while stack:
        end, who = stack.pop()
        segs.append((t, end, who))
        t = end
    return [s for s in segs if s[1] > s[0]]


def _device_ops(events, t0: float, t1: float) -> list:
    """The device operations clipped to [t0, t1]: (start, end, correlation)."""
    out = []
    for e in events:
        if e.get("cat") in devtrace.DEVICE_CATS and "dur" in e:
            a, b = max(t0, float(e["ts"])), min(t1, float(e["ts"]) + float(e["dur"]))
            if b > a:
                out.append((a, b, (e.get("args") or {}).get("correlation")))
    return sorted(out)


def idle_gaps(ops, t0: float, t1: float) -> list:
    """The device's idle intervals in [t0, t1] between the (start, end,
    correlation) ``ops``: (start, end, in_graph), in_graph when the
    operations on both sides share a correlation."""
    gaps, end, corr = [], t0, None
    for a, b, c in ops:
        if a > end:
            gaps.append((end, a, corr is not None and corr == c))
        if b > end:
            end, corr = b, c
    if t1 > end:
        gaps.append((end, t1, False))
    return gaps


def split_window(events, t0: float, t1: float, tid) -> dict:
    """The idle µs of [t0, t1] by place (``in_graph``, a ``saena.*`` span
    name, ``outside``), with ``idle_us`` their sum and ``flag_reads`` the
    ``saena.graph.go`` spans of the host thread ``tid`` in the window."""
    host = [(max(t0, float(e["ts"])), min(t1, float(e["ts"]) + float(e["dur"])), e["name"])
            for e in events if e.get("cat") == "user_annotation" and "dur" in e
            and e.get("tid") == tid and str(e.get("name", "")).startswith(PREFIX)
            and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0]
    segs = innermost_segments(host)
    starts = [s[0] for s in segs]
    out: dict = {}
    for a, b, in_graph in idle_gaps(_device_ops(events, t0, t1), t0, t1):
        if in_graph:
            out[IN_GRAPH] = out.get(IN_GRAPH, 0.0) + (b - a)
            continue
        left = b - a
        k = max(0, bisect.bisect_right(starts, a) - 1)
        while k < len(segs) and segs[k][0] < b:
            sa, sb, who = segs[k]
            ov = min(b, sb) - max(a, sa)
            if ov > 0:
                out[who] = out.get(who, 0.0) + ov
                left -= ov
            k += 1
        if left > 0:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + left
    return {"split": out, "idle_us": sum(out.values()),
            "flag_reads": sum(1 for *_, n in host if n == "saena.graph.go")}


def split_trace(events) -> list | None:
    """``split_window`` of every ``amgbench.spans`` span of the trace, in
    order; None when the trace holds no ``saena.solve`` span."""
    if not any(e.get("name") == "saena.solve" and e.get("cat") == "user_annotation"
               for e in events):
        return None
    return [split_window(events, a, b, tid) for a, b, tid in devtrace.spans(events, SPAN)]


def solve_split(run) -> list | None:
    """The split of ``traced_records`` more solves of the mix's solver on
    ``run.amg``, traced once a run and cached on it; None off the card or
    where the program marks no solve."""
    if run.device.type != "cuda":
        return None
    if _CACHE not in vars(run):
        solve = getattr(run.amg, run.cell.traffic["solver"])
        with devtrace.profiled(True) as events:
            for _ in range(int(run.cell.traffic["traced_records"])):
                with torch.profiler.record_function(SPAN):
                    solve()
            torch.cuda.synchronize(run.device)
        out = split_trace(events)
        del events
        for k, s in enumerate(out or ()):
            ranked = sorted(s["split"].items(), key=lambda kv: -kv[1])
            print(f"spantrace: solve {k}: idle {s['idle_us']:.1f} us, flag reads "
                  f"{s['flag_reads']}, " + ", ".join(f"{n} {v:.1f}" for n, v in ranked),
                  file=sys.stderr)
        setattr(run, _CACHE, out)
    return getattr(run, _CACHE)


def idle_ms(run, match) -> float | None:
    """The idle ms a solve of the places whose name ``match`` accepts, the
    median over the traced solves (the profiler's first solves run slow)."""
    out = solve_split(run)
    if not out:
        return None
    return statistics.median(sum(v for n, v in s["split"].items() if match(n))
                             for s in out) / 1e3


def phase_wall_s(phase_spans, name: str) -> float:
    """The wall seconds the (name, start_s, end_s, thread) intervals of
    phase ``name`` cover together over all threads: overlaps count once."""
    return sum(b - a for a, b in devtrace.union([(a, b) for n, a, b, _ in phase_spans
                                                 if n == name]))
