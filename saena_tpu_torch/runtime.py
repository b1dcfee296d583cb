"""Device and dtype resolution, the setup phase timer, the spans that
mark the port's layers in a torch.profiler trace, the count of the
hand-written kernels' launches and the count of the API's vector copies.

``launches`` counts every launch of the five kernels in the process, by
key: the kernel (``"dia"``, ``"strip"``, ``"strip8"``, ``"ell"``,
``"csr_spgemm"``); ``"<kernel>.<route>"`` for the launches that took a
route (``"dia.rows"``: the row kernel, ``"dia.rect"``: a rectangular block,
``"strip.stream"`` / ``"strip8.stream"``: the stream path,
``"strip8.interval"``: an interval-mode layout, ``"strip8.shard"``: a
shard's view, ``"<kernel>.bf16"``: bf16 values); and K1's and K4's shapes,
``("dia", n_pad, ndiag, variant)`` and ``("ell", n_pad, n_x, width)``. A
wrapper records a launch with ``launched`` once the kernel has been
launched. A graph replay runs no wrapper: amg/graphs.py adds each replay's
launches, so the counts are those of the same loop run uncaptured.
``launches_of`` gives the launches made by one call.

``copies`` counts the copies of a solve's vectors between the caller's
host arrays and the device that the API makes (``AMG.solve*``), by
direction and route: ``"h2d.pinned"`` / ``"d2h.pinned"`` through a pinned
staging buffer (a CUDA device), ``"h2d.host"`` / ``"d2h.host"`` through an
unpinned one (the CPU), and the bytes each way, ``"h2d.bytes"`` and
``"d2h.bytes"``. ``copies_of`` gives the copies made by one call."""
from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


launches: Counter = Counter()
copies: Counter = Counter()
_LOCK = threading.Lock()      # the setup's pool threads launch K5


def launched(kernel: str, shape: tuple = (), **routes: bool) -> None:
    """Count one launch of ``kernel``: under each route that is true, and
    under ``(kernel, *shape)`` when a shape is given."""
    with _LOCK:
        launches[kernel] += 1
        for route, took in routes.items():
            if took:
                launches[f"{kernel}.{route}"] += 1
        if shape:
            launches[(kernel, *shape)] += 1


def copied(direction: str, route: str, nbytes: int) -> None:
    """Count one copy of ``nbytes`` of a solve's vector in ``direction``
    (``"h2d"`` or ``"d2h"``) by ``route`` (``"pinned"`` or ``"host"``)."""
    with _LOCK:
        copies[f"{direction}.{route}"] += 1
        copies[f"{direction}.bytes"] += nbytes


def _made(counter: Counter, fn):
    with _LOCK:
        before = counter.copy()
    out = fn()
    with _LOCK:
        return out, counter - before


def launches_of(fn):
    """(fn(), the launches it made, a Counter)."""
    return _made(launches, fn)


def copies_of(fn):
    """(fn(), the API's vector copies it made, a Counter)."""
    return _made(copies, fn)


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: the card unless the caller names
    another. Without a card and without an explicit device this raises
    rather than running quietly on the CPU.

    On the card it also sets ``torch.backends.cuda.matmul.allow_tf32 =
    False`` (PyTorch's default, made explicit): the dense coarse levels and
    the coarse inverse are f32/f64 matrix products, and TF32 would keep
    about three decimal digits of them."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "saena_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """``dtype`` or torch's default dtype (float32 unless changed)."""
    return dtype if dtype is not None else torch.get_default_dtype()


# the span while no profiler records: one shared context that does nothing
_NO_SPAN = nullcontext()


def span(name: str):
    """A span of the port's layers, ``name`` (``saena.*``), on the
    profiler's clock.

    While a torch profiler records it is ``torch.profiler.record_function(
    name)``: the span sits in the trace's timeline beside the device's work
    and is kept in memory until the trace is exported. Else it is one shared
    no-op context: one flag read, nothing allocated. Spans go around graph
    replays and host work, never inside a part that is being captured into
    a graph."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


class Product(NamedTuple):
    """One sparse product of a setup's Galerkin phase: the coarsening level
    it builds from, where it ran ("card" or "host"), its multiply-adds and
    its wall seconds, transfers included."""
    level: int
    engine: str
    macs: int
    seconds: float


class PhaseTimer:
    """Per-phase wall seconds of one setup, summed across its threads
    (phases overlap, so the sum may exceed the wall time), and the bytes
    uploaded to the device, kept apart from the seconds. ``spans`` keeps
    each ``phase`` interval as (name, start_s, end_s, thread_id) on
    ``time.perf_counter``, the thread id the OS's; while a torch profiler
    records, a phase is also the span ``saena.setup.<name>`` on the thread
    that runs it. ``products`` keeps each Galerkin product as a Product."""

    def __init__(self):
        self.seconds: dict = {}
        self.spans: list = []
        self.products: list = []
        self.upload_bytes = 0
        self._lock = threading.Lock()

    def add_product(self, level: int, engine: str, macs: int, s: float) -> None:
        with self._lock:
            self.products.append(Product(level, engine, macs, s))

    def add(self, name: str, s: float) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + s

    def add_upload(self, s: float, nbytes: int) -> None:
        with self._lock:
            self.seconds["upload"] = self.seconds.get("upload", 0.0) + s
            self.upload_bytes += nbytes

    @contextmanager
    def phase(self, name: str):
        with span("saena.setup." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.add(name, t1 - t0)
                self.spans.append((name, t0, t1, threading.get_native_id()))
