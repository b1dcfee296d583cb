"""The port's profiling module (saena_tpu_torch/profiling.py) against
saena_tpu's (tests/test_profiling.py), in f64 on the CPU.

Times are host times here (perf_counter on a CPU hierarchy) and are only
checked to be positive. What must equal saena_tpu's on the same matrix and
options: the rows (one per level), their keys (saena_tpu's plus "device",
which is "cpu" here), levels, n, nnz and format names, and the keys of the
V-cycle breakdown and the pCG phases. The cost model (modeled_matvec_time)
gives a time for the strip, strip8 and BSR operators where saena_tpu's does
and None for the structurally chosen formats; its values are the port's
H100 constants, which differ from saena_tpu's, so they are checked against
those constants. profile_trace writes a trace with the solve's span.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saena_tpu.amg import hierarchy as jh
from saena_tpu.config import Options as JOptions
from saena_tpu.generators import laplacian2D, laplacian3D
from saena_tpu import profiling as jprof
from saena_tpu.ops import formats as jformats
from saena_tpu.ops import pallas_strip8_spmv as jstrip8
from saena_tpu.ops import pallas_strip_spmv as jstrip

from saena_tpu_torch import AMG, Matrix, Options
from saena_tpu_torch import profiling as tprof
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.ops import formats as tformats
from saena_tpu_torch.ops.strip8_spmv import STRIP8_NS_PER_TILE, strip8_from_csr
from saena_tpu_torch.ops.strip_spmv import (STRIP_LAUNCH_S, STRIP_NS_BY_PERROW,
                                            strip_from_csr)

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


def _layouts():
    A = remove_boundary_nodes(laplacian3D(16, 16, 16))[0].tocsr()
    return A, {
        "strip": (strip_from_csr(A, torch.float64, "cpu"),
                  jstrip.strip_from_csr(A, jnp.float64)),
        "strip8": (strip8_from_csr(A, torch.float64, "cpu"),
                   jstrip8.strip8_from_csr(A, jnp.float64)),
        "bsr": (tformats.bsr_from_csr(A, torch.float64, "cpu"),
                jformats.bsr_from_csr(A, dtype=jnp.float64)),
    }


def test_modeled_matvec_time_on_the_gather_formats():
    A, lay = _layouts()
    for kind, (M, J) in lay.items():
        t = tprof.modeled_matvec_time(M)
        assert (t is None) == (jprof.modeled_matvec_time(J) is None), kind
        assert t is not None and t > 0, kind
    S = lay["strip"][0]
    assert tprof.modeled_matvec_time(S) == pytest.approx(
        STRIP_LAUNCH_S + S.vals.shape[0] * STRIP_NS_BY_PERROW[S.perrow] * 1e-9)
    S8 = lay["strip8"][0]
    assert tprof.modeled_matvec_time(S8) == pytest.approx(
        tformats.KERNEL_LAUNCH_S
        + int(S8.rbt_ptr[-1]) * STRIP8_NS_PER_TILE[S8.mode] * 1e-9)
    for M in (tformats.dia_from_csr(A, torch.float64, "cpu"),
              tformats.ell_from_csr(A, torch.float64, "cpu")):
        assert tprof.modeled_matvec_time(M) is None


def test_model_check_rows_on_gather_levels():
    """A hierarchy whose level-1 A and level-0 P / R are strip8 and strip
    layouts: model_check gives an "A" row and a "P+R" row with saena_tpu's
    keys and the device."""
    A = remove_boundary_nodes(laplacian3D(12, 12, 12))[0]
    TH, info = th.setup(A, Options(), **F64)
    levels = list(TH.levels)
    levels[1] = dataclasses.replace(
        levels[1], A=strip8_from_csr(info.csr_levels[1], torch.float64, "cpu"))
    levels[0] = dataclasses.replace(
        levels[0], P=strip_from_csr(info.Ps[0], torch.float64, "cpu"),
        R=strip8_from_csr(info.Rs[0], torch.float64, "cpu"))
    H = dataclasses.replace(TH, levels=tuple(levels))
    rows = tprof.model_check(H, n_iter=2)
    assert [(r["level"], r["op"]) for r in rows] == [(1, "A"), (0, "P+R")]
    for r in rows:
        assert set(r) == {"level", "op", "format", "modeled_us", "measured_us",
                          "ratio", "device"}
        assert r["modeled_us"] > 0 and r["measured_us"] > 0 and r["ratio"] > 0
    assert rows[1]["format"] == "StripMatrix+Strip8Matrix"
