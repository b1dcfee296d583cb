"""Solver loops as CUDA graph replays: the port's counterpart of the JAX
package's ``jax.jit`` over ``lax.while_loop`` (saena_tpu/amg/solvers.py).

A solver is a ``Loop``: static tensors that hold its whole state (the
iterate, residuals, scalars, the history, the iteration counter and the
stop flag ``go``) and three parts that read and write them in place:

- ``init`` sets the state from the ``rhs`` and ``tol`` buffers;
- ``step`` is one iteration. It makes no host sync, and once ``go`` has
  dropped it leaves every state tensor as it is (``torch.where``), as a
  ``while_loop`` that has exited does;
- ``fini`` computes the exit values.

``run`` calls ``init``, then ``step`` while the host reads ``go`` as true
(one sync an iteration, the stopping test), then ``fini``. A loop may have
a fourth part, ``restart`` (FGMRES's restart boundary): ``go`` then holds
RESTART when it is due, and ``run`` calls it in place of ``step``. On the
card the parts are captured into ``torch.cuda.CUDAGraph``s at the first
run and replayed after; on the CPU the same parts are called directly. A capture
that fails raises ``GraphCaptureError`` naming the op that broke it; there
is no fallback to the uncaptured loop.

While a torch profiler records, ``run`` marks its host work with spans
(runtime.span): ``saena.graph.capture``, each replay (or direct call) of a
part as ``saena.graph.init`` / ``.step`` / ``.restart`` / ``.fini``, and
each read of ``go`` as ``saena.graph.go``.

The kernels' wrappers record their launches in ``runtime.launches``, which
a replay does not run: each graph keeps the launches its capture recorded,
takes them off, and adds them again at every replay, so the counts are
those of the same loop run without graphs.
"""
from __future__ import annotations

import gc
import os
import time
import traceback
import types

import torch

from saena_tpu_torch.ops import cuda_build
from saena_tpu_torch.runtime import launches, launches_of, span

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESTART = 2    # the value of ``go`` when a loop's restart part is next


# the side stream of every warm-up and capture on a device, one a process
# as torch.cuda.graph keeps one: cuBLAS keeps a workspace for each stream
# it has run on, so a new stream each capture would hold another workspace
# for each stream of torch's pool
_SIDE: dict = {}
# the memory pool of every capture on a device, one a process: a private
# pool each capture would stay reserved after its graph is freed, until the
# caching allocator's cache is emptied, and grow with every hierarchy that a
# lazy update makes. In the one pool a capture takes the free blocks of the
# captures before it, so the graphs of a process replay one after another,
# never on two streams at once. A graph kept for the life of the process
# holds the pool open: a pool whose last graph is freed cannot be captured
# into again (its count of users would be 0, which torch asserts against).
_POOL: dict = {}


def _side_stream(dev: int) -> torch.cuda.Stream:
    side = _SIDE.get(dev)
    if side is None:
        side = _SIDE[dev] = torch.cuda.Stream(dev)
    return side


def _pool(dev: int):
    """The capture pool of device ``dev``, the current device; made, with
    the graph that holds it open, at its first use inside a capture's
    ``gc.disable``."""
    got = _POOL.get(dev)
    if got is None:
        keep, x = torch.cuda.CUDAGraph(), torch.zeros(1, device=dev)
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            keep.capture_begin(pool=torch.cuda.graph_pool_handle(),
                               capture_error_mode="thread_local")
            x.add_(1.0)
            keep.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        got = _POOL[dev] = (keep.pool(), keep, x)
    return got[0]


class GraphCaptureError(RuntimeError):
    """A part of a solver loop could not be captured into a CUDA graph."""


def _where(exc: BaseException) -> str:
    """The deepest frame of the port's own code (this module aside) in the
    exception chain: the op that broke the capture."""
    here = os.path.abspath(__file__)
    seen, e, best = set(), exc, None
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        for fr in traceback.extract_tb(e.__traceback__):
            f = os.path.abspath(fr.filename)
            if f.startswith(_PACKAGE) and f != here:
                best = f"{os.path.relpath(f, os.path.dirname(_PACKAGE))}:{fr.lineno}: {fr.line}"
        e = e.__cause__ or e.__context__
    return best or "an op outside the package"


class Graph:
    """``fn`` captured on the card's current device, replayed by calling
    the object; ``runtime.launches`` moves as if ``fn`` had run."""

    def __init__(self, fn, what: str):
        dev = torch.cuda.current_device()
        before = launches.copy()
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        # a graph that the cyclic collector frees during the capture (one
        # of a dropped hierarchy's loops, held in a reference cycle) resets
        # inside it and invalidates the capture: the collector stays off
        # until the capture ends, and such garbage waits for its next run
        collecting = gc.isenabled()
        gc.disable()
        try:
            pool = _pool(dev)
            with torch.cuda.stream(side):
                # worker threads of the setup may still touch the card:
                # only this thread's calls are checked during the capture
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    self.graph.capture_end()
        except RuntimeError as e:
            raise GraphCaptureError(
                f"capturing {what} failed at {_where(e)}: {e}") from e
        finally:
            self.delta = launches - before
            launches.subtract(self.delta)
            if collecting:
                gc.enable()
            torch.cuda.current_stream(dev).wait_stream(side)

    def __call__(self) -> None:
        self.graph.replay()
        launches.update(self.delta)


class Loop:
    """A solver's state (``s``, static tensors) and its three parts, and
    optionally a fourth, ``restart``; see the module docstring.
    ``capture_ms`` is the wall time of the first run's warm-up and captures
    on the card, None before them. The kernels' build, which the first
    warm-up of a checkout runs, is left out of it (``cuda_build.build_s``)."""

    def __init__(self, state: types.SimpleNamespace, init, step, fini,
                 name: str, restart=None):
        self.s = state
        self.parts = (init, step, fini) + ((restart,) if restart else ())
        self.name = name
        self.graphs = None
        self.capture_ms = None

    def _capture(self) -> None:
        """Warm up each part once on a side stream (lazy module loads,
        library handles), then capture it. The warm-up runs on the static
        state, which the first replay of ``init`` sets anew; its launches
        are taken off ``runtime.launches``."""
        t0, built0 = time.perf_counter(), cuda_build.build_s
        dev = torch.cuda.current_device()
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _, warm = launches_of(lambda: [part() for part in self.parts])
        launches.subtract(warm)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs = tuple(Graph(p, f"{self.name} {w}") for p, w in
                            zip(self.parts, ("init", "step", "fini", "restart")))
        torch.cuda.synchronize(dev)
        built = cuda_build.build_s - built0
        self.capture_ms = (time.perf_counter() - t0 - built) * 1e3

    def run(self, graphs: bool) -> int:
        """Run the loop from the current ``rhs`` and ``tol`` buffers, as
        graph replays when ``graphs``; returns the iterations taken."""
        if graphs and self.graphs is None:
            with span("saena.graph.capture"):
                self._capture()
        init, step, fini, *restart = self.graphs if graphs else self.parts
        with span("saena.graph.init"):
            init()
        iters = 0
        while True:
            with span("saena.graph.go"):
                go = int(self.s.go)     # the iteration's host sync
            if not go:
                break
            if go == RESTART:
                with span("saena.graph.restart"):
                    restart[0]()
                continue
            with span("saena.graph.step"):
                step()
            iters += 1
        with span("saena.graph.fini"):
            fini()
        return iters


def new_state(rhs: torch.Tensor, max_iter: int, vectors=(), scalars=(),
              flags=()) -> types.SimpleNamespace:
    """Static buffers of a loop on ``rhs``'s device and dtype: ``rhs`` and
    ``tol``, the named vectors (rhs's shape), scalars and boolean flags,
    the history (max_iter + 1, NaN past the last iteration), the
    iteration counter ``i`` and the stop flag ``go``."""
    kw = dict(dtype=rhs.dtype, device=rhs.device)
    s = types.SimpleNamespace(
        rhs=torch.zeros_like(rhs), tol=torch.zeros((), **kw),
        hist=torch.full((max_iter + 1,), float("nan"), **kw),
        i=torch.zeros((), dtype=torch.int64, device=rhs.device),
        go=torch.zeros((), dtype=torch.bool, device=rhs.device),
        max_iter=max_iter)
    for v in vectors:
        setattr(s, v, torch.zeros_like(rhs))
    for v in scalars:
        setattr(s, v, torch.zeros((), **kw))
    for v in flags:
        setattr(s, v, torch.zeros((), dtype=torch.bool, device=rhs.device))
    return s


def start(s, res0, go) -> None:
    """History from ||r0|| (``res0``), iteration 0, and the stop flag: go
    on while ``go`` and iterations are left."""
    s.hist.fill_(float("nan"))
    s.hist[:1].copy_(res0.reshape(1))
    s.i.zero_()
    s.go.copy_(go & (s.max_iter > 0))


def keep(go, *pairs) -> None:
    """For each (state tensor, new value): take the new value while ``go``,
    else leave the state as it is."""
    for dst, new in pairs:
        torch.where(go, new, dst, out=dst)


def advance(s, go, res, more) -> None:
    """End of an iteration that ran while ``go``: record ``res`` as the
    history entry i + 1, count the iteration, and go on while ``more`` and
    iterations are left. After the flag has dropped nothing changes."""
    idx = torch.clamp(s.i + 1, max=s.max_iter).reshape(1)
    old = s.hist.index_select(0, idx)
    s.hist.index_copy_(0, idx, torch.where(go, res.reshape(1), old))
    torch.where(go, s.i + 1, s.i, out=s.i)
    s.go.copy_(go & more & (s.i < s.max_iter))
