"""Reading a torch.profiler trace: the device's busy time inside one of the
benchmark's spans, the device operations that took most of it, and the
idle gaps by what the host was doing.

The interval union is a frozen copy of ``saena_tpu_torch.profiling.
device_busy`` (kernels, copies and sets counted once where they overlap),
kept here so that a change to the program's profiling does not move the
yardstick.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


@contextlib.contextmanager
def profiled(cuda: bool = True):
    """Profile the body (the host and, with ``cuda``, the card); yields a
    list that receives the trace's events once the body has ended."""
    events = []
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield events
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events.extend(json.load(f)["traceEvents"])


def spans(events, name: str) -> list:
    """(start, end, tid) of every host span ``name``, in µs."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
                  for e in events if e.get("name") == name
                  and e.get("cat") == "user_annotation" and "dur" in e)


def device_intervals(events, t0: float, t1: float) -> list:
    """The device's operations clipped to [t0, t1]: (start, end, name)."""
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a, b = max(t0, float(e["ts"])), min(t1, float(e["ts"]) + float(e["dur"]))
            if b > a:
                out.append((a, b, e.get("name", "?")))
    return sorted(out)


def union(iv) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint (start, end)."""
    merged = []
    for a, b, *_ in sorted(iv):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy(iv) -> float:
    return sum(b - a for a, b in union(iv))


def _innermost(host, points) -> list:
    """For each time in ``points``, the name of the innermost host event
    (on one thread, so they nest) that covers it, else "host idle"."""
    evs = sorted(host, key=lambda e: (e[0], -e[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out = ["host idle"] * len(points)
    stack, j = [], 0
    for k in order:
        t = points[k]
        while j < len(evs) and evs[j][0] <= t:
            while stack and stack[-1][1] <= evs[j][0]:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[k] = stack[-1][2]
    return out


def summary(events, name: str, top: int = 10) -> dict | None:
    """The device's work inside the first host span ``name``: its wall and
    busy seconds, the device operations by total seconds, and the idle gaps
    summed by the innermost host event at their start. None when the trace
    holds no such span or no device operation in it."""
    sp = spans(events, name)
    if not sp:
        return None
    t0, t1, tid = sp[0]
    iv = device_intervals(events, t0, t1)
    if not iv:
        return None
    merged = union(iv)
    by_op: dict = {}
    for a, b, n in iv:
        by_op[n] = by_op.get(n, 0.0) + (b - a) * 1e-6
    gaps, prev = [], t0
    for a, b in merged + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
            for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("tid") == tid and e.get("name") != name]
    by_host: dict = {}
    for (a, b), who in zip(gaps, _innermost(host, [g[0] for g in gaps])):
        by_host[who] = by_host.get(who, 0.0) + (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(b - a for a, b in merged) * 1e-6,
            "device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def busy_between_markers(events) -> list:
    """The device's operations split at a marker: the trace's first device
    operation and every later one of the same name mark the starts of the
    segments (one stream, so they run in order). Returns the busy µs of
    each segment's other operations."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
                for e in events if e.get("cat") in DEVICE_CATS and "dur" in e)
    if not iv:
        return []
    marker = iv[0][2]
    out, seg = [], None
    for op in iv:
        if op[2] == marker:
            if seg:
                out.append(busy(seg))
            seg = []
        else:
            seg.append(op)
    if seg:
        out.append(busy(seg))
    return out
