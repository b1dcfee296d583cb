"""The port's spans (runtime.span) and the setup's phase intervals
(SetupInfo.phase_spans), on the CPU.

Off, a span is one shared no-op context that allocates nothing; under
torch.profiler a solve, a setup and an update mark their layers with
``saena.*`` spans nested in the call's own span, one ``saena.graph.go`` a
read of the stop flag. The shard-parallel setup keeps each phase interval
with the thread that ran it. The tests need no JAX; the card's case is
marked ``cuda``.
"""
import collections
import itertools
import json
import os
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from saena_tpu_torch import AMG, Matrix, Options, generators
from saena_tpu_torch import runtime
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.ops import cuda_build

F64 = dict(dtype=torch.float64, device="cpu")


def _solver(m=10, device="cpu", **opts):
    A = Matrix()
    A.set_csr(generators.laplacian3D(m, m, m))
    A.assemble(device=device, dtype=torch.float64)
    s = AMG(device=device, dtype=torch.float64)
    s.set_matrix(A, Options(remove_boundary=True, **opts))
    s.set_rhs(generators.laplacian3D_set_rhs(m, m, m))
    return s, A


def _traced(fn, tmp_path):
    """(fn's result, the trace's user spans as (name, start, end, tid)),
    fn run under torch.profiler on the CPU."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
             for e in ev if e.get("cat") == "user_annotation"]
    return out, spans


def _inside(spans, outer):
    """The spans that lie in the first span named ``outer``, by name."""
    _, a, b, tid = next(s for s in spans if s[0] == outer)
    return collections.Counter(n for n, s, e, t in spans
                               if t == tid and a <= s and e <= b and n != outer)


def test_span_off_is_one_shared_noop():
    """Without a profiler every span is the same object, and entering it
    records nothing: a profiler started afterwards sees no span of it."""
    assert not autograd_profiler._is_profiler_enabled
    assert runtime.span("saena.a") is runtime.span("saena.b")
    with runtime.span("saena.a") as v:
        assert v is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.events() if e.name.startswith("saena.")]


def test_span_off_allocates_nothing():
    """Off, a span costs the flag read: ten thousand of them allocate no
    more than ten (the loop's own few bytes)."""
    def spans(n):
        for _ in itertools.repeat(None, n):
            with runtime.span("saena.graph.go"):
                pass

    def peak(n):
        tracemalloc.start()
        try:
            before, _ = tracemalloc.get_traced_memory()
            tracemalloc.reset_peak()
            spans(n)
            return tracemalloc.get_traced_memory()[1] - before
        finally:
            tracemalloc.stop()

    spans(10)
    assert peak(10_000) == peak(10) < 1024


def test_span_follows_the_profiler_flag(monkeypatch):
    """The one gate is torch's flag: with it set a span is a
    record_function of the name, with no args."""
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    sp = runtime.span("saena.x")
    assert isinstance(sp, torch.profiler.record_function)
    assert sp.name == "saena.x" and sp.args is None


def test_solve_pcg_spans_nest_under_the_solve(tmp_path):
    s, _ = _solver()
    (u, res), spans = _traced(s.solve_pCG, tmp_path)
    got = _inside(spans, "saena.solve")
    assert got == {"saena.api.rhs": 1, "saena.api.upload": 1, "saena.graph.init": 1,
                   "saena.graph.go": res.iters + 1, "saena.graph.step": res.iters,
                   "saena.graph.fini": 1, "saena.api.download": 2,
                   "saena.api.merge": 1}
    assert res.iters > 0 and float(res.rel_res) < 1e-8
    # a second solve has the same spans
    (_, res2), spans2 = _traced(s.solve_pCG, tmp_path)
    assert _inside(spans2, "saena.solve") == got and res2.iters == res.iters


def test_fgmres_flag_reads_count_the_restarts(tmp_path):
    """FGMRES(3): one flag read an Arnoldi step, one a restart boundary,
    and the last."""
    s, _ = _solver(8)
    (u, res), spans = _traced(lambda: s.solve_pGMRES(restart=3), tmp_path)
    got = _inside(spans, "saena.solve")
    assert got["saena.graph.step"] == res.iters and got["saena.graph.restart"] >= 1
    assert got["saena.graph.go"] == res.iters + got["saena.graph.restart"] + 1


def test_set_matrix_and_update_spans(tmp_path):
    """set_matrix holds the setup's phases of its own thread; update2 and
    update3 one Galerkin span a coarse level, update1 none."""
    m = 8
    A = Matrix()
    A.set_csr(generators.laplacian3D(m, m, m))
    A.assemble(**F64)
    s = AMG(**F64)
    _, spans = _traced(lambda: s.set_matrix(A, Options(remove_boundary=True,
                                                       setup_shards=0)), tmp_path)
    got = _inside(spans, "saena.set_matrix")
    coarse = len(s.info.sizes) - 1
    assert got["saena.setup.rap"] == coarse and got["saena.setup.aggregation"] == coarse
    B = Matrix()
    B.set_csr(1.5 * generators.laplacian3D(m, m, m))
    B.assemble(**F64)
    for kind, n_gal in (("update1", 0), ("update2", coarse)):
        _, spans = _traced(lambda: getattr(s, kind)(B), tmp_path)
        assert _inside(spans, "saena.update")["saena.update.galerkin"] == n_gal, kind
    C = Matrix()
    Cc = generators.laplacian3D(m, m, m).tocsr()
    Cc.data[0] *= 1.01
    C.set_csr(Cc)
    C.assemble(**F64)
    _, spans = _traced(lambda: s.update3(C), tmp_path)
    assert _inside(spans, "saena.update")["saena.update.galerkin"] == coarse


def _covered(iv) -> float:
    """The length of the union of (start, end) intervals, by counting how
    many cover each stretch between endpoints."""
    total, depth, last = 0.0, 0, None
    for t, d in sorted([(a, 1) for a, _ in iv] + [(b, -1) for _, b in iv]):
        if depth > 0:
            total += t - last
        depth, last = depth + d, t
    return total


def test_shard_parallel_setup_keeps_phase_intervals_by_thread():
    """Each phase interval with its thread: the executor's eig and level
    builds run beside the coarsening, so more than one thread. Per phase
    the intervals sum to SetupInfo.phases, and the union over threads
    counts overlaps once: the coarsening thread's rap intervals do not
    overlap, so their union is their sum."""
    from saena_tpu_torch.parallel.dist_setup import dist_setup

    A = remove_boundary_nodes(generators.laplacian3D(12, 12, 12))[0]
    _, info = dist_setup(A, Options(), n_shards=2, tail_rows=64, **F64)
    spans = info.phase_spans
    assert info.comm.dist_levels >= 1
    assert {"rap", "eig", "devicify_A", "devicify_PR"} <= {n for n, *_ in spans}
    assert len({t for *_, t in spans}) > 1
    assert len({t for n, *_, t in spans if n == "rap"}) == 1
    for name in {n for n, *_ in spans}:
        iv = [(a, b) for n, a, b, _ in spans if n == name]
        assert all(a <= b for a, b in iv)
        assert sum(b - a for a, b in iv) == pytest.approx(info.phases[name])
        assert max(b - a for a, b in iv) <= _covered(iv) <= sum(b - a for a, b in iv) + 1e-12
    rap = [(a, b) for n, a, b, _ in spans if n == "rap"]
    assert _covered(rap) == pytest.approx(sum(b - a for a, b in rap))


def test_phase_intervals_that_overlap_on_threads():
    """Two threads in one phase at once (a barrier inside it holds both):
    two intervals of two thread ids, and a union shorter than their sum."""
    timer, barrier = runtime.PhaseTimer(), threading.Barrier(2)

    def work():
        with timer.phase("rap"):
            barrier.wait(timeout=60)
            time.sleep(0.02)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    iv = [(a, b) for _, a, b, _ in timer.spans]
    assert len({tid for *_, tid in timer.spans}) == 2
    assert sum(b - a for a, b in iv) == pytest.approx(timer.seconds["rap"])
    union = _covered(iv)
    assert max(b - a for a, b in iv) <= union < sum(b - a for a, b in iv)


def test_the_cpu_loop_never_captures(tmp_path):
    s, _ = _solver(8)
    _, spans = _traced(s.solve_pCG, tmp_path)
    assert "saena.graph.capture" not in {n for n, *_ in spans}
    loops = list(s.hierarchy.graphs.values())
    assert loops and all(l.graphs is None and l.capture_ms is None for l in loops)


@pytest.mark.cuda
def test_the_card_captures_once_under_a_span(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s, _ = _solver(16, device="cuda")
    (_, res), spans = _traced(s.solve_pCG, tmp_path)
    got = _inside(spans, "saena.solve")
    assert got["saena.graph.capture"] == 1
    assert got["saena.graph.go"] == res.iters + 1
    (loop,) = s.hierarchy.graphs.values()
    graphs, capture_ms = loop.graphs, loop.capture_ms
    assert graphs is not None and capture_ms > 0
    _, spans = _traced(s.solve_pCG, tmp_path)
    assert "saena.graph.capture" not in _inside(spans, "saena.solve")
    assert loop.graphs is graphs and loop.capture_ms == capture_ms


def test_the_loader_counts_its_build_seconds(monkeypatch):
    """cuda_build.load adds each compile's seconds to build_s, which
    Loop.capture_ms leaves out; a library already built adds nothing."""
    built = {"dia_spmv": (2.5, "")}
    monkeypatch.setattr(cuda_build, "build", lambda names: {
        n: built.pop(n, (0.0, "")) for n in names})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "build_s", 1.0)
    lib = cuda_build.load("dia_spmv")
    assert cuda_build.build_s == 3.5 and cuda_build.load("dia_spmv") is lib
    cuda_build.load("strip_spmv")
    assert cuda_build.build_s == 3.5


def test_launched_loses_no_count_across_threads():
    """runtime.launched from more threads than cores (the setup's pool
    launches K5 from its workers) loses no launch, and launches_of gives
    each key's count: the kernel, the routes taken and the shape."""
    n_threads, per = (os.cpu_count() or 4) + 4, 200

    def work():
        for _ in range(per):
            runtime.launched("probe", (3, 5), taken=True, skipped=False)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]

    def run():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, made = runtime.launches_of(run)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = n_threads * per
    assert made == collections.Counter({"probe": n, "probe.taken": n, ("probe", 3, 5): n})
