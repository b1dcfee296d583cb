"""The plain reference: the frozen generator equals the port's, the
residual flags a perturbed solution, and the reference loads nothing of the
program."""
import ast
import os

import numpy as np
import pytest
import scipy.sparse.linalg as spla

from conftest import REPO

from amgbench.reference import laplacian3D as ref
from amgbench.reference.residual import relative_residuals


@pytest.mark.parametrize("m", [8, 13])
def test_frozen_generator_is_the_ports(m):
    from saena_tpu_torch import generators
    from saena_tpu_torch.core.coo import remove_boundary_nodes

    A, B = ref.laplacian3D(m), generators.laplacian3D(m, m, m)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(A, f), getattr(B, f))
    assert np.array_equal(ref.laplacian3D_set_rhs(m), generators.laplacian3D_set_rhs(m, m, m))
    Ai, *_ = remove_boundary_nodes(A)
    assert Ai.shape[0] == (m - 2) ** 3


def test_residual_flags_a_perturbed_solution():
    m = 10
    A = ref.laplacian3D(m)
    b = np.random.default_rng(1).uniform(-1, 1, A.shape[0])
    u = spla.spsolve(A.tocsc(), b)
    ok = relative_residuals(A, u, b)[0]
    assert ok < 1e-12
    for k in (0, 7, A.shape[0] // 2):
        v = u.copy()
        v[k] += 1e-5 * np.abs(u).max()
        assert relative_residuals(A, v, b)[0] > 1e-8
    assert relative_residuals(A, np.zeros_like(u), b)[0] == pytest.approx(1.0)


def test_reference_imports_nothing_of_the_program():
    folder = os.path.join(REPO, "amgbench", "reference")
    for f in os.listdir(folder):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(folder, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".", 1)[0] not in ("saena_tpu_torch", "saena_tpu", "jax",
                                                   "torch", "amgbench"), (f, n)
