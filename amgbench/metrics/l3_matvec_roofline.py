"""l3_matvec_roofline: level 3's A.matvec, L2 flushed before each launch,
as a % of its HBM bound (amgbench/roofline.py's bytes, flush and launches).

The trace is split at the flush's own device operations, whose names a
short trace of the flush alone gives, and not at the trace's first device
operation as ``roofline.flushed_launch_us`` splits it: the profiler can drop
the first kernel of a session, and its segments then time the flush (about
81 µs on an H100) in place of the matvec."""
from __future__ import annotations

import statistics

import torch

from amgbench import devtrace, roofline

LEVEL = 3


def _device_ops(events) -> list:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
                  for e in events if e.get("cat") in devtrace.DEVICE_CATS and "dur" in e)


def busy_after_markers(events, markers) -> list:
    """The busy µs of the device's operations between each operation named
    in ``markers`` and the next one (one stream, so they run in order);
    operations before the first marker are left out."""
    out, seg = [], None
    for op in _device_ops(events):
        if op[2] in markers:
            if seg:
                out.append(devtrace.busy(seg))
            seg = []
        elif seg is not None:
            seg.append(op)
    if seg:
        out.append(devtrace.busy(seg))
    return out


def flushed_launch_us(fn, device) -> float | None:
    """The median device µs of ``fn()`` over roofline.LAUNCHES launches, each
    after a write of roofline.FLUSH_BYTES; None when the trace holds too
    few."""
    flush = torch.empty(roofline.FLUSH_BYTES, dtype=torch.uint8, device=device)
    with devtrace.profiled() as alone:
        for i in range(4):
            flush.fill_(i + 1)
        torch.cuda.synchronize(device)
    markers = {name for *_, name in _device_ops(alone)}
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    with devtrace.profiled() as events:
        for i in range(roofline.LAUNCHES):
            flush.fill_(i & 0x7F)
            fn()
        torch.cuda.synchronize(device)
    del flush
    times = [t for t in busy_after_markers(events, markers) if t > 0]
    return statistics.median(times) if len(times) >= roofline.LAUNCHES // 2 else None


def read(run):
    if run.device.type != "cuda" or LEVEL >= len(run.amg.hierarchy.levels):
        return None
    lv = run.amg.hierarchy.levels[LEVEL]
    csr = run.amg.info.csr_levels[LEVEL]
    x = torch.randn(lv.n_pad, dtype=lv.dtype, device=run.device,
                    generator=torch.Generator(run.device).manual_seed(LEVEL))
    us = flushed_launch_us(lambda: lv.A.matvec(x), run.device)
    if not us:
        return None
    bound_us = roofline.spmv_bytes(csr, x.element_size()) / roofline.HBM_BYTES_PER_S * 1e6
    return 100.0 * bound_us / us
