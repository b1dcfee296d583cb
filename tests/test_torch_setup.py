"""The port's host setup against saena_tpu's serial setup, option by option.

Both run the same numpy/scipy algorithms, so the hierarchies must have the
same level sizes, the same sparsity patterns of every A, P and R, values
within rtol 1e-12 (SpGEMM engines may sum in another order), and eig
estimates within rtol 1e-9. Each variant turns on one setup option the
Poisson goldens leave off.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saena_tpu.amg import hierarchy as jh
from saena_tpu.amg import strength as jstrength
from saena_tpu.config import Options as JOptions
from saena_tpu.core.coo import CooBuilder as JCooBuilder
from saena_tpu.core.coo import remove_boundary_nodes
from saena_tpu.generators import band_matrix, laplacian3D

from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.amg import strength as tstrength
from saena_tpu_torch.config import Options
from saena_tpu_torch.core.coo import CooBuilder


def _poisson(m):
    A0 = laplacian3D(m, m, m)
    return remove_boundary_nodes(A0, np.ones(A0.shape[0]))[0]


VARIANTS = {
    "default": ("poisson", {}),
    "scale": ("poisson", {"scale": True}),
    "adaptive": ("poisson", {"adaptive_coarsening": True}),
    "spai": ("poisson", {"PSmoother": "SPAI"}),
    "sparsify": ("poisson", {"sample_sz_percent": 0.7}),
    "double": ("poisson", {"aggregation": "double"}),
    "no_dense_switch": ("band", {"switch_to_dense": False}),
    "no_dynamic_levels": ("poisson", {"dynamic_levels": False}),
    "no_reorder_coarse": ("poisson", {"reorder_coarse": False}),
    "filter": ("poisson", {"filter_start": 2, "filter_thre": 1e-2,
                           "filter_max": 1e-1}),
    "conn_strength": ("poisson", {"connStrength": 0.6}),
    "user_eig": ("poisson", {"eig": 12.0}),
}


def _same_csr(a, b, what):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=what)
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=what)
    np.testing.assert_allclose(a.data, b.data, rtol=1e-12,
                               atol=1e-12 * np.abs(b.data).max(), err_msg=what)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_setup_matches_saena_tpu(variant):
    kind, kw = VARIANTS[variant]
    A = _poisson(12) if kind == "poisson" else band_matrix(1500, 8)
    JH, Ji = jh.setup(A, JOptions(**kw), dtype=jnp.float64)
    TH, Ti = th.setup(A, Options(**kw), dtype=torch.float64, device="cpu")
    assert Ti.sizes == Ji.sizes
    assert Ti.formats == Ji.formats
    assert Ti.thetas == Ji.thetas and Ti.coarsen_kinds == Ji.coarsen_kinds
    for l, (a, b) in enumerate(zip(Ti.csr_levels, Ji.csr_levels)):
        _same_csr(a, b, f"A{l}")
    for l, (P, JP, R, JR) in enumerate(zip(Ti.Ps, Ji.Ps, Ti.Rs, Ji.Rs)):
        _same_csr(P, JP, f"P{l}")
        _same_csr(R, JR, f"R{l}")
    for l, (TL, JL) in enumerate(zip(TH.levels, JH.levels)):
        if JL.eig_max is None:
            assert TL.eig_max is None
        else:
            np.testing.assert_allclose(TL.eig_max, JL.eig_max, rtol=1e-9)
    if kw.get("scale"):
        np.testing.assert_allclose(TH.inv_sq_diag.numpy(),
                                   np.asarray(JH.inv_sq_diag), rtol=1e-15)
    assert "wall" in Ti.phases and Ti.upload_bytes > 0
    assert all(isinstance(v, float) for v in Ti.phases.values())


def test_mis1_fixpoint_matches_saena_tpu():
    """The numpy MIS(1) fixpoint the port carries, against saena_tpu's
    aggregation (native single pass or the same fixpoint)."""
    A = _poisson(10)
    S = tstrength.strength_graph(A, 0.3)
    _same_csr(S, jstrength.strength_graph(A, 0.3), "S")
    agg, roots = tstrength.aggregate_mis1(S)
    jagg, jroots = jstrength.aggregate_mis1(S)
    np.testing.assert_array_equal(agg, jagg)
    np.testing.assert_array_equal(roots, jroots)


@pytest.mark.parametrize("add_duplicates", [False, True])
def test_coo_builder_duplicate_semantics(add_duplicates):
    """set(): a later duplicate replaces; set2() (add_duplicates): summed."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 20, 300)
    cols = rng.integers(0, 20, 300)
    vals = rng.standard_normal(300)
    vals[:5] = 1e-16                        # dropped as almost zero
    out = []
    for cls in (CooBuilder, JCooBuilder):
        b = cls(shape=(20, 20), add_duplicates=add_duplicates)
        b.set(rows[:150], cols[:150], vals[:150])
        b.set(rows[150:], cols[150:], vals[150:])
        out.append(b.assemble())
    _same_csr(out[0], out[1], "assembled")
