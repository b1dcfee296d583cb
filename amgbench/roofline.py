"""The yardstick of a kernel's share of its roofline: the card's peaks, the
bytes a sparse matrix-vector product needs, and its time with the L2 cache
flushed before every launch.

Bytes are counted free of the format: (nnz + rows + cols) x itemsize, each
value, each input entry and each output entry once, from the host CSR of
the level (indices are not counted: a format may compress or drop them).
A format that stores padding, or reads x again, reads below 100%.
"""
from __future__ import annotations

import statistics

import torch

from amgbench import devtrace

# NVIDIA H100 SXM5 (data sheet), at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 256 * 2**20      # written between launches: over 4 x the 50 MB L2
LAUNCHES = 300


def spmv_bytes(csr, itemsize: int) -> int:
    return (csr.nnz + csr.shape[0] + csr.shape[1]) * itemsize


def flushed_launch_us(fn, device) -> float | None:
    """The median device µs of ``fn()`` over LAUNCHES launches, each after a
    write of FLUSH_BYTES, read from the profiler's trace (the flush is the
    marker that splits it). None when the trace holds no device time."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    with devtrace.profiled() as events:
        for i in range(LAUNCHES):
            flush.fill_(i & 0x7F)
            fn()
        torch.cuda.synchronize(device)
    times = [t for t in devtrace.busy_between_markers(events) if t > 0]
    del flush
    return statistics.median(times) if len(times) >= LAUNCHES // 2 else None


def level_matvec_share(run, level: int) -> float | None:
    """Level ``level``'s A.matvec as a % of its HBM bound."""
    if run.device.type != "cuda" or level >= len(run.amg.hierarchy.levels):
        return None
    lv = run.amg.hierarchy.levels[level]
    csr = run.amg.info.csr_levels[level]
    x = torch.randn(lv.n_pad, dtype=lv.dtype, device=run.device,
                    generator=torch.Generator(run.device).manual_seed(level))
    us = flushed_launch_us(lambda: lv.A.matvec(x), run.device)
    if not us:
        return None
    bound_us = spmv_bytes(csr, x.element_size()) / HBM_BYTES_PER_S * 1e6
    return 100.0 * bound_us / us
