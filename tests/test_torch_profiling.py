"""The port's profiling module (saena_tpu_torch/profiling.py) against
saena_tpu's (tests/test_profiling.py), in f64 on the CPU.

Times are host times here (perf_counter on a CPU hierarchy) and are only
checked to be positive. What must equal saena_tpu's on the same matrix and
options: the rows (one per level), their keys (saena_tpu's plus "device",
which is "cpu" here), levels, n, nnz and format names, and the keys of the
V-cycle breakdown and the pCG phases. profile_trace writes a trace with
the solve's span.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saena_tpu.amg import hierarchy as jh
from saena_tpu.config import Options as JOptions
from saena_tpu.generators import laplacian2D, laplacian3D
from saena_tpu import profiling as jprof

from saena_tpu_torch import AMG, Matrix, Options
from saena_tpu_torch import profiling as tprof
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.core.coo import remove_boundary_nodes

F64 = dict(dtype=torch.float64, device="cpu")


def _both(A, **kw):
    JH, Ji = jh.setup(A, JOptions(**kw), dtype=jnp.float64)
    TH, Ti = th.setup(A, Options(**kw), **F64)
    return JH, TH


def _same_rows(rows, jrows, keys):
    assert len(rows) == len(jrows)
    for r, jr in zip(rows, jrows):
        assert set(r) == set(jr) | {"device"} and r["device"] == "cpu"
        for k in keys:
            assert r[k] == jr[k], (k, r[k], jr[k])


def test_profile_matvecs_rows_match_saena_tpu():
    JH, TH = _both(laplacian3D(8, 8, 8))
    rows = tprof.profile_matvecs(TH, n_iter=3)
    _same_rows(rows, jprof.profile_matvecs(JH, n_iter=3),
               ("level", "n", "nnz", "format", "dtype"))
    assert all(r["time_us"] > 0 and r["nnz_per_s"] > 0 for r in rows)


@pytest.fixture(scope="module")
def breakdowns():
    """(port hierarchy, rhs, saena_tpu's per-level breakdown) of a 2-D
    Laplacian; saena_tpu's is computed once (its chains compile)."""
    A = laplacian2D(24, 24)
    JH, TH = _both(A)
    rhs = np.zeros(TH.n_pad)
    rhs[: A.shape[0]] = 1.0
    return TH, rhs, jprof.vcycle_breakdown(JH, jh.SolveParams(), rhs,
                                           n_iter=3, per_level=True)


@pytest.mark.parametrize("per_level", [False, True])
def test_vcycle_breakdown_keys_match_saena_tpu(breakdowns, per_level):
    TH, rhs, jbd = breakdowns
    if not per_level:
        jbd = {k: v for k, v in jbd.items() if k != "levels"}
    bd = tprof.vcycle_breakdown(TH, th.SolveParams(), rhs, n_iter=3,
                                per_level=per_level)
    assert set(bd) == set(jbd) | {"device"} and bd["device"] == "cpu"
    assert all(bd[k] > 0 for k in ("smooth", "resid", "coarsest", "total"))
    if per_level:
        _same_rows(bd["levels"], jbd["levels"], ("level", "n"))
    out = tprof.format_breakdown(bd)
    assert "total" in out and out.splitlines()[1:] and \
        [l.split()[0] for l in out.splitlines()[1:]] == \
        [l.split()[0] for l in jprof.format_breakdown(jbd).splitlines()[1:]]


def test_pcg_profile_keys_match_saena_tpu():
    A = remove_boundary_nodes(laplacian3D(10, 10, 10))[0]
    JH, TH = _both(A)
    ph = tprof.pcg_profile(TH, th.SolveParams(), n_iter=3)
    jph = jprof.pcg_profile(JH, jh.SolveParams(), n_iter=3)
    assert set(ph) == set(jph) | {"device"}
    assert ph["iteration"] > 0 and ph["precond"] > 0 and ph["other"] >= 0


def test_solve_pcg_profile_through_the_api():
    """AMG.solve_pCG_profile: the solve, the V-cycle breakdown and the pCG
    phases (tests/test_profiling.py::test_pcg_profile_phases)."""
    m = 12
    A = Matrix()
    A.set_csr(laplacian3D(m, m, m))
    A.assemble(**F64)
    s = AMG(**F64)
    s.set_matrix(A, Options(remove_boundary=True))
    s.set_rhs(A.csr @ np.ones(A.csr.shape[0]))
    u, res, bd = s.solve_pCG_profile()
    assert float(res.rel_res) < 1e-7
    ph = bd["pcg_phases"]
    for k in ("precond", "matvec", "dots", "iteration", "other"):
        assert k in ph and ph[k] >= 0.0, (k, ph)
    assert "smooth" in bd and "total" in bd
    rows = s.profile_matvecs(n_iter=2)
    assert [r["n"] for r in rows] == s.info.sizes
    assert "coarsest" in s.profile_matvecs_breakdown(n_iter=2)


def test_profile_trace_writes_the_solve(tmp_path):
    m = 10
    A = Matrix()
    A.set_csr(laplacian3D(m, m, m))
    A.assemble(**F64)
    s = AMG(**F64)
    s.set_matrix(A, Options(remove_boundary=True))
    s.set_rhs(np.ones(m ** 3))
    u, res = s.profile_trace(str(tmp_path))
    path = os.path.join(str(tmp_path), "solve_pCG.trace.json")
    assert os.path.getsize(path) > 0 and res.iters > 0 and np.isfinite(u).all()
    busy = tprof.device_busy(path, "solve_pCG")
    # a CPU hierarchy: the span is there, and no device work in it
    assert busy["wall_ms"] > 0 and busy["busy_ms"] == 0.0
    assert busy["idle_share"] == 1.0
