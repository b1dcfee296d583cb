"""The port's solve path against saena_tpu's, in f64 on the CPU.

- V-cycle and pCG on identical device state: saena_tpu's hierarchy is
  flattened to numpy arrays and loaded with ``convert.load_hierarchy``; the
  V-cycle outputs agree to rtol 1e-10 (same arithmetic, summed in another
  order), pCG to the same iteration count and histories at rtol 1e-8. The
  carried state includes structural transfers (SmoothedP/SmoothedR around
  saena_tpu's strip layouts) under structural_transfers="force".
- Under "force", the port's own setup gives the levels and the iteration
  count of saena_tpu's own setup (its layouts picked by other cost
  constants).
- The port alone, through its public API on device="cpu", reproduces the
  convergence goldens (tests/goldens/convergence.json): levels, exact
  iteration counts, residual histories at the goldens' own rtol 1e-6.
- Entry points raise without CUDA unless the caller asks for the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saena_tpu.amg import cycles as jcycles
from saena_tpu.amg import hierarchy as jh
from saena_tpu.amg import solvers as jsolvers
from saena_tpu.config import Options as JOptions
from saena_tpu.core.coo import remove_boundary_nodes
from saena_tpu.generators import laplacian3D, laplacian3D_set_rhs

import saena_tpu_torch
from saena_tpu_torch.amg import cycles as tcycles
from saena_tpu_torch.amg import solvers as tsolvers
from saena_tpu_torch.amg.hierarchy import SolveParams
from saena_tpu_torch.convert import load_hierarchy

GOLDENS = json.load(open(os.path.join(os.path.dirname(__file__), "goldens",
                                      "convergence.json")))


FIELDS = {
    "DiaMatrix": ("data",),
    "EllMatrix": ("cols", "vals", "spill_rows", "spill_cols", "spill_vals"),
    "DenseMatrix": ("data",),
    "BsrMatrix": ("blocks", "bcols"),
    "StripMatrix": ("idx", "vals", "strip_of", "rb_local", "sb_of"),
    "Strip8Matrix": ("idx", "vals", "strips", "gather_idx"),
}
META = {
    "StripMatrix": ("perrow", "krb", "n_rows_pad", "n_cols_pad", "n_out",
                    "pick_pairs"),
    "Strip8Matrix": ("perrow", "mode", "n_cols_pad", "n_out"),
}


def flatten_hierarchy(H):
    """(arrays, meta) of a saena_tpu Hierarchy (DIA / ELL / dense / BSR /
    strip / strip8 levels, direct or structural P/R, smoothers' twins), for
    convert.load_hierarchy."""
    arrays, levels = {}, []

    def put(key, M):
        if M is None:
            return None
        kind = type(M).__name__
        spec = {"format": kind, "shape": list(M.shape), "nnz": int(M.nnz)}
        if kind in ("SmoothedP", "SmoothedR"):
            inner = "Pt" if kind == "SmoothedP" else "PtT"
            spec[inner] = put(f"{key}.{inner}", getattr(M, inner))
            spec["A"] = "level"
            arrays[f"{key}.wq"] = np.array(M.wq)
            return spec
        if kind not in FIELDS:
            raise AssertionError(f"unexpected format {kind}")
        if kind == "DiaMatrix":
            spec["offsets"] = list(M.offsets)
        spec.update({k: getattr(M, k) for k in META.get(kind, ())})
        for f in FIELDS[kind]:
            arrays[f"{key}.{f}"] = np.array(getattr(M, f))
        return spec

    for l, L in enumerate(H.levels):
        for T in (L.P, L.R):
            assert getattr(T, "A", L.A) is L.A   # structural: the level's A
        arrays[f"L{l}.inv_diag"] = np.array(L.inv_diag)
        levels.append({"n": L.n, "lvl": L.lvl, "eig_max": L.eig_max,
                       "A": put(f"L{l}.A", L.A), "P": put(f"L{l}.P", L.P),
                       "R": put(f"L{l}.R", L.R)})
        if L.A_smooth is not None:      # Options.smooth_dtype's twin
            levels[-1]["A_smooth"] = dict(put(f"L{l}.A_smooth", L.A_smooth),
                                          dtype=str(L.A_smooth.dtype))
    coarse = {"kind": None}
    if H.coarse_lu is not None and H.coarse_lu.inv is not None:
        coarse = {"kind": "inv", "n": H.coarse_lu.n}
        arrays["coarse.inv"] = np.array(H.coarse_lu.inv)
        arrays["coarse.adense"] = np.array(H.coarse_lu.adense)
    elif H.coarse_lu is not None:
        # the coarsest level's A is the unit-diagonal-padded dense operator
        # that saena_tpu factored
        coarse = {"kind": "lu", "n": H.coarse_lu.n}
        arrays["coarse.dense"] = np.array(H.levels[-1].A.data)
    if H.inv_sq_diag is not None:
        arrays["inv_sq_diag"] = np.array(H.inv_sq_diag)
    return arrays, {"levels": levels, "coarse": coarse,
                    "scaled": H.inv_sq_diag is not None}


def _interior(m):
    A0 = laplacian3D(m, m, m)
    A, _, _, _, rhs = remove_boundary_nodes(A0, laplacian3D_set_rhs(m, m, m))
    return A, rhs


CASES = {
    # name: (A, rhs, JAX options)
    "poisson16": lambda: (*_interior(16), JOptions()),
    "poisson16_jacobi": lambda: (*_interior(16), JOptions(smoother="jacobi")),
    "poisson12_scaled": lambda: (*_interior(12), JOptions(scale=True)),
    "poisson12_coarse_cg": lambda: (*_interior(12), JOptions(direct_solver="CG")),
    # two levels, the coarsest of n_pad 2944 > 2048: LU, not the inverse
    "poisson20_lu": lambda: (*_interior(20), JOptions(max_level=1)),
    # structural P/R around saena_tpu's strip layouts
    "poisson16_structural": lambda: (
        *_interior(16), JOptions(structural_transfers="force")),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def same_state(request):
    A, rhs, opts = CASES[request.param]()
    H, info = jh.setup(A, opts, dtype=jnp.float64)
    T = load_hierarchy(*flatten_hierarchy(H), dtype=torch.float64, device="cpu")
    rhs_p = np.pad(rhs, (0, H.n_pad - H.n))
    return request.param, H, T, opts, rhs_p


def test_vcycle_on_identical_state(same_state):
    name, H, T, opts, rhs = same_state
    jp = jh.SolveParams.from_options(opts)
    tp = SolveParams.from_options(opts)
    r = jnp.asarray(rhs)
    ref = np.asarray(jcycles.vcycle(H, jp, jnp.zeros_like(r), r))
    rt = torch.from_numpy(rhs)
    y = tcycles.vcycle(T, tp, torch.zeros_like(rt), rt).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())
    assert (y[H.n:] == 0).all()


def test_pcg_on_identical_state(same_state):
    name, H, T, opts, rhs = same_state
    ref = jsolvers.solve_pCG(H, rhs, params=jh.SolveParams.from_options(opts),
                             max_iter=40)
    res = tsolvers.solve_pCG(T, rhs, params=SolveParams.from_options(opts),
                             max_iter=40)
    it = int(ref.iters)
    assert res.iters == it
    np.testing.assert_allclose(res.history.numpy(), np.asarray(ref.history),
                               rtol=1e-8, equal_nan=True)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(ref.u), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(ref.u)).max())
    np.testing.assert_allclose(float(res.true_res), float(ref.true_res),
                               rtol=1e-6)


def test_float_storage_matches_jax():
    """Options(float_storage=True): operators of levels >= float_level stored
    in f32, vectors and the coarse solve in f64, in both packages' own setups.
    f32 products summed in another order: V-cycle rtol 1e-5, equal pCG
    iterations."""
    from saena_tpu_torch.amg.hierarchy import setup
    from saena_tpu_torch.config import Options

    A, rhs = _interior(12)
    jo = JOptions(float_storage=True, float_level=1)
    H, jinfo = jh.setup(A, jo, dtype=jnp.float64)
    T, tinfo = setup(A, Options(float_storage=True, float_level=1),
                     dtype=torch.float64, device="cpu")
    assert tinfo.dtypes == jinfo.dtypes and tinfo.dtypes[1] == "float32"
    assert T.levels[1].A.dtype == torch.float32
    rhs = np.pad(rhs, (0, H.n_pad - H.n))
    r = jnp.asarray(rhs)
    ref = np.asarray(jcycles.vcycle(H, jh.SolveParams.from_options(jo),
                                    jnp.zeros_like(r), r))
    rt = torch.from_numpy(rhs)
    y = tcycles.vcycle(T, SolveParams(), torch.zeros_like(rt), rt).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    jres = jsolvers.solve_pCG(H, rhs, params=jh.SolveParams.from_options(jo))
    assert tsolvers.solve_pCG(T, rhs).iters == int(jres.iters)


def test_structural_case_carries_smoothed_transfers(same_state):
    name, H, T, opts, rhs = same_state
    kinds = {type(L.P).__name__ for L in T.levels[:-1]}
    assert kinds == ({"SmoothedP"} if name.endswith("structural")
                     else {"EllMatrix"})


@pytest.mark.parametrize("m", [16, 24])
def test_port_force_matches_jax_levels_and_iterations(m):
    """Each package under structural_transfers="force" with its own setup
    and its own layout picks: the same levels and pCG iterations."""
    from saena_tpu_torch.amg.hierarchy import setup
    from saena_tpu_torch.config import Options

    A, rhs = _interior(m)
    H, jinfo = jh.setup(A, JOptions(structural_transfers="force"),
                        dtype=jnp.float64)
    T, tinfo = setup(A, Options(structural_transfers="force"),
                     dtype=torch.float64, device="cpu")
    assert tinfo.sizes == jinfo.sizes
    assert all(type(L.P).__name__ == "SmoothedP" for L in T.levels[:-1])
    rhs = np.pad(rhs, (0, H.n_pad - H.n))
    ref = jsolvers.solve_pCG(H, rhs, params=jh.SolveParams(), max_iter=40)
    res = tsolvers.solve_pCG(T, rhs, params=SolveParams(), max_iter=40)
    assert res.iters == int(ref.iters)
    np.testing.assert_allclose(res.history[: res.iters + 1].numpy(),
                               np.asarray(ref.history)[: res.iters + 1],
                               rtol=1e-6)


def _golden_solve(A_csr, opts, rhs, max_iter=300):
    A = saena_tpu_torch.Matrix()
    A.set_csr(A_csr)
    A.assemble(device="cpu", dtype=torch.float64)
    solver = saena_tpu_torch.AMG(device="cpu", dtype=torch.float64)
    solver.set_matrix(A, opts)
    solver.set_rhs(rhs)
    u, res = solver.solve_pCG(max_iter=max_iter)
    assert all(t.device.type == "cpu" for t in solver.hierarchy.tensors())
    return res.iters, res.history[: res.iters + 1].numpy(), solver.info.sizes


def _check(key, it, hist, levels):
    g = GOLDENS[key]
    assert levels == g["levels"]
    assert it == g["iters"]
    np.testing.assert_allclose(hist, np.asarray(g["history"]), rtol=1e-6)


@pytest.mark.parametrize("key", ["poisson3d_16", "poisson3d_24", "poisson3d_32",
                                 "poisson3d_32_double"])
def test_port_reproduces_poisson_goldens(key):
    from saena_tpu_torch import Options, generators

    m = int(key.split("_")[1])
    agg = "double" if key.endswith("double") else "dist1"
    A = generators.laplacian3D(m, m, m)
    rhs = generators.laplacian3D_set_rhs(m, m, m)
    _check(key, *_golden_solve(A, Options(remove_boundary=True,
                                          aggregation=agg), rhs))


def test_port_reproduces_banded_golden():
    from saena_tpu_torch import Options, generators

    A = generators.band_matrix(3000, 16)
    _check("banded_3000_16", *_golden_solve(A, Options(), A @ np.ones(3000),
                                            max_iter=30))


def test_port_solution_and_boundary_merge():
    """The full-system solution: interior from pCG, boundary rows rhs/diag."""
    from saena_tpu_torch import AMG, Matrix, Options, generators

    m = 10
    A = Matrix()
    A.set_csr(generators.laplacian3D(m, m, m))
    A.assemble(device="cpu", dtype=torch.float64)
    s = AMG(device="cpu", dtype=torch.float64)
    s.set_matrix(A, Options(remove_boundary=True))
    rhs = generators.laplacian3D_set_rhs(m, m, m)
    s.set_rhs(rhs)
    u, res = s.solve_pCG()
    assert u.shape == (m ** 3,) and res.rel_res < 1e-8
    np.testing.assert_allclose(A.csr @ u, rhs, atol=1e-6 * np.abs(rhs).max())
    np.testing.assert_allclose(A.matvec(u), A.csr @ u, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("entry", ["AMG", "Matrix.assemble", "setup"])
def test_entry_points_need_cuda_unless_cpu_requested(entry, monkeypatch):
    from saena_tpu_torch import AMG, Matrix, generators
    from saena_tpu_torch.amg.hierarchy import setup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = generators.laplacian3D(4, 4, 4)
    calls = {
        "AMG": lambda **kw: AMG(**kw),
        "Matrix.assemble": lambda **kw: (lambda M: (M.set_csr(A), M.assemble(**kw)))(Matrix()),
        "setup": lambda **kw: setup(A, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry](device="cuda")
    calls[entry](device="cpu")
