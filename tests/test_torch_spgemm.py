"""The port's device products over a mesh (ops/spgemm.py, the ring half of
ops/bspgemm.py, AMG.matmat(mesh=)) against saena_tpu's, in f64 on the CPU.

Each test of tests/test_spgemm.py has a counterpart here of the same name,
problem and seed: saena_tpu's function on the conftest's 8-device JAX CPU
mesh and the port's on ``Mesh(8, "cpu")`` on the same scipy inputs. The
port's product must be within 1e-12 x max(1, max |C|) of saena_tpu's and
keep the JAX test's own bound against scipy. Beside them: ``_ring_plan``'s
arrays, keys and block values equal saena_tpu's bit for bit at D = 8 and
D = 3 (unequal splits); ``_use_dense_ring`` routes alike; the fixed-order
block sums (``_WindowSums``) match a plain reference on runs cut by
windows;
``eig_max_invdiag_device`` against scipy and saena_tpu. On the card (marker
``cuda``): two calls of matmat_sparse and two of spgemm_blocks give equal
bits.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu.ops import bspgemm as jb
from saena_tpu.ops import spgemm as js
from saena_tpu.parallel.sharded import make_mesh

from saena_tpu_torch import generators
from saena_tpu_torch.amg.prolongation import restriction, smoothed_prolongator
from saena_tpu_torch.amg.strength import find_aggregation
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.ops import bspgemm as tb
from saena_tpu_torch.ops import spgemm as ts
from saena_tpu_torch.parallel.comm import Mesh
from saena_tpu_torch.parallel.partition import equal_row_split, nnz_balanced_split

from test_goldens import REF    # saena_tpu's reference data directory

D = 8
F64 = torch.float64


@pytest.fixture(scope="module")
def mesh():
    return Mesh(D, "cpu")


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(D)


def _same(C, ref):
    """Within 1e-12 x max(1, max |C|) of saena_tpu's product."""
    C, ref = sp.csr_matrix(C), sp.csr_matrix(ref)
    assert C.shape == ref.shape
    assert abs(C - ref).max() <= 1e-12 * max(1.0, abs(ref).max())


def _galerkin(A):
    agg, n_c, _ = find_aggregation(A, 0.3)
    P_ = smoothed_prolongator(A, agg, n_c)
    return restriction(P_), P_


def test_matmat_random(mesh, jmesh):
    A = generators.random_symm_matrix(300, 0.05, seed=1)
    B = generators.random_symm_matrix(300, 0.05, seed=2)
    C = ts.matmat(A, B, mesh, dtype=F64)
    _same(C, js.matmat(A, B, jmesh, dtype=jnp.float64))
    assert np.abs(C - (A @ B).tocsr()).max() < 1e-10


def test_matmat_rectangular(mesh, jmesh):
    A = sp.random(220, 150, density=0.1, random_state=4, format="csr")
    B = sp.random(150, 90, density=0.1, random_state=5, format="csr")
    C = ts.matmat(A, B, mesh, dtype=F64)
    _same(C, js.matmat(A, B, jmesh, dtype=jnp.float64))
    assert np.abs(C - (A @ B).tocsr()).max() < 1e-10


def test_triple_product_vs_scipy(mesh, jmesh):
    """Galerkin RAP through the ring engine == scipy (config 3 oracle)."""
    A = generators.laplacian2D(24, 24)
    R, P_ = _galerkin(A)
    Ac = ts.triple_product(R, A, P_, mesh, dtype=F64, tol=1e-13)
    _same(Ac, js.triple_product(R, A, P_, jmesh, dtype=jnp.float64, tol=1e-13))
    ref = (R @ A @ P_).tocsr()
    ref.data[np.abs(ref.data) < 1e-13] = 0.0
    ref.eliminate_zeros()
    assert np.abs(Ac - ref).max() < 1e-9


def test_bsp_single_device_random():
    A = sp.random(500, 700, density=0.02, random_state=1, format="csr")
    B = sp.random(700, 300, density=0.03, random_state=2, format="csr")
    C = tb.spgemm_blocks(A, B, dtype=F64, device="cpu")
    _same(C, jb.spgemm_blocks(A, B, dtype=jnp.float64))
    assert np.abs(C - (A @ B).tocsr()).max() < 1e-12


def test_bsp_single_device_empty_and_bk128():
    Z = sp.csr_matrix((100, 80))
    B = sp.random(80, 60, density=0.05, random_state=3, format="csr")
    assert tb.spgemm_blocks(Z, B, dtype=F64, device="cpu").nnz == 0
    A = generators.random_symm_matrix(200, 0.2, seed=7)   # dense rows -> bk=128
    assert tb.pick_bk(A, A) == 128
    C = tb.spgemm_blocks(A, A, dtype=F64, device="cpu")
    _same(C, jb.spgemm_blocks(A, A, dtype=jnp.float64))
    assert np.abs(C - (A @ A).tocsr()).max() < 1e-10


def test_bsp_florida_sih4():
    """Irregular sparsity oracle (config 3): SiH4 @ SiH4 == scipy."""
    path = f"{REF}/FloridaCollection/SiH4.bin"
    if not os.path.exists(path):
        pytest.skip("reference data absent")
    from saena_tpu_torch import Matrix

    M = Matrix()
    M.read_file(path)
    M.assemble(dtype=F64, device="cpu")
    A = M.csr
    C = tb.spgemm_blocks(A, A, dtype=F64, device="cpu")
    _same(C, jb.spgemm_blocks(A, A, dtype=jnp.float64))
    ref = (A @ A).tocsr()
    assert np.abs(C - ref).max() < 1e-10 * max(1.0, abs(ref).max())


def test_bsp_ring_matches_scipy(mesh, jmesh):
    A = sp.random(500, 700, density=0.02, random_state=11, format="csr")
    B = sp.random(700, 300, density=0.03, random_state=12, format="csr")
    C = tb.matmat_sparse(A, B, mesh, dtype=F64)
    _same(C, jb.matmat_sparse(A, B, jmesh, dtype=jnp.float64))
    assert np.abs(C - (A @ B).tocsr()).max() < 1e-12


def test_bsp_ring_rap_memory_prop_nnz(mesh, jmesh):
    """Device RAP through the block-sparse ring on the 8-shard mesh: exact
    vs scipy, with peak block memory ∝ nonzero blocks (here >10x below the
    dense ring's O(n^2/D) footprint), the same ratio as saena_tpu's plan."""
    A, *_ = remove_boundary_nodes(generators.laplacian3D(32, 32, 32))
    R, P_ = _galerkin(A)
    RA = tb.matmat_sparse(R, A, mesh, dtype=F64)
    Ac = tb.matmat_sparse(RA, P_, mesh, dtype=F64)
    jRA = jb.matmat_sparse(R, A, jmesh, dtype=jnp.float64)
    _same(RA, jRA)
    _same(Ac, jb.matmat_sparse(jRA, P_, jmesh, dtype=jnp.float64))
    ref = (R @ A @ P_).tocsr()
    assert np.abs(Ac - ref).max() < 1e-11

    bk = tb.pick_bk(R, A)
    splits = equal_row_split(R.shape[0], 8), equal_row_split(A.shape[0], 8)
    plan = tb._ring_plan(R, A, 8, bk, *splits, F64)
    jplan = jb._ring_plan(R, A, 8, bk, *splits, np.float64)
    block_elems = plan.Ab.numel() + plan.Bb.numel() + 8 * (plan.nC_max + 1) * 1024
    dense_elems = (R.shape[0] * R.shape[1] + A.shape[0] * A.shape[1]
                   + R.shape[0] * A.shape[1])
    assert block_elems < dense_elems / 10
    assert block_elems == jplan.Ab.size + jplan.Bb.size + 8 * (jplan.nC_max + 1) * 1024


def test_matmat_auto_routes_sparse(mesh, jmesh):
    """matmat(mode="auto") must take the block-sparse ring for operands too
    sparse/big for dense blocks, and still match scipy."""
    A = sp.random(3000, 3000, density=0.001, random_state=21, format="csr")
    B = sp.random(3000, 3000, density=0.001, random_state=22, format="csr")
    assert not ts._use_dense_ring(A, B, D)
    C = ts.matmat(A, B, mesh, dtype=F64)
    _same(C, js.matmat(A, B, jmesh, dtype=jnp.float64))
    assert np.abs(C - (A @ B).tocsr()).max() < 1e-12


def test_api_matmat_device_routing(mesh, jmesh):
    """AMG.matmat(A, B, mesh=...) routes through the rings and matches
    scipy and saena_tpu's (ref saena::amg::matmat ->
    setup_matmat.cpp:1164-1487). The no-mesh call stays the host
    product."""
    import saena_tpu as J
    import saena_tpu_torch as T
    from saena_tpu_torch.io.readers import read_matrix

    path = f"{REF}/FloridaCollection/bcsstk16.mtx"
    if os.path.exists(path):
        A_csr = read_matrix(path).tocsr()
    else:
        A_csr = sp.random(2000, 2000, density=0.003, random_state=3,
                          format="csr")
    mats = []
    for pkg, kw in ((T, dict(dtype=F64, device="cpu")), (J, {})):
        A = pkg.Matrix(); A.set_csr(A_csr); A.assemble(**kw)
        B = pkg.Matrix(); B.set_csr(A_csr.T.tocsr()); B.assemble(**kw)
        mats.append((A, B))
    amg = T.AMG(dtype=F64, device="cpu")
    C_dev = amg.matmat(*mats[0], mesh=mesh, dtype=F64)
    C_host = amg.matmat(*mats[0])
    _same(C_dev.csr, J.AMG().matmat(*mats[1], mesh=jmesh, dtype=jnp.float64).csr)
    ref = (A_csr @ A_csr.T).tocsr()
    assert np.abs(C_dev.csr - ref).max() <= 1e-9 * max(1.0, abs(ref).max())
    assert np.abs(C_host.csr - ref).max() <= 1e-9 * max(1.0, abs(ref).max())


# ------------------------------------------------ the plan and the routing --


def _operands():
    A = sp.random(500, 700, density=0.02, random_state=11, format="csr")
    B = sp.random(700, 300, density=0.03, random_state=12, format="csr")
    L = generators.laplacian2D(24, 24)
    R, P_ = _galerkin(L)
    S = generators.random_symm_matrix(200, 0.2, seed=7)
    return {"random": (A, B), "R_A": (R, L), "RA_P": ((R @ L).tocsr(), P_),
            "bk128": (S, S), "empty_row_block": (sp.csr_matrix((40, 700)), B)}


OPERANDS = ("random", "R_A", "RA_P", "bk128", "empty_row_block")


@pytest.fixture(scope="module")
def operands():
    return _operands()


@pytest.mark.parametrize("split", ["equal", "nnz"])
@pytest.mark.parametrize("n_shards", [8, 3])
@pytest.mark.parametrize("name", OPERANDS)
def test_ring_plan_matches_saena_tpu(name, n_shards, split, operands):
    A, B = operands[name]
    bk = tb.pick_bk(A, B)
    if split == "equal":
        sa, sb = equal_row_split(A.shape[0], n_shards), equal_row_split(B.shape[0], n_shards)
    else:
        sa = nnz_balanced_split(A, n_shards, switch_repart=False)
        sb = nnz_balanced_split(B, n_shards, switch_repart=False)
    tp = tb._ring_plan(A, B, n_shards, bk, sa, sb, F64)
    jp = jb._ring_plan(A, B, n_shards, bk, sa, sb, jnp.float64)
    for f in ("Ab", "Bb", "AI", "BI"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    for f in ("CI", "NCK"):                     # host arrays
        np.testing.assert_array_equal(getattr(tp, f), np.asarray(getattr(jp, f)), err_msg=f)
        assert getattr(tp, f).dtype == np.int32
    assert len(tp.c_keys) == len(jp.c_keys) == n_shards
    for a, b in zip(tp.c_keys, jp.c_keys):
        np.testing.assert_array_equal(a, b)
    assert (tp.n_cb, tp.nC_max, tp.n_bc_C, tp.shape) == \
        (jp.n_cb, jp.nC_max, jp.n_bc_C, jp.shape)
    np.testing.assert_array_equal(tp.a_split, jp.a_split)
    assert tp.pairs == int((np.asarray(jp.CI) != jp.nC_max).sum())
    # and the product on those splits, one process against saena_tpu's
    if split == "nnz" and n_shards == D:
        C = tb.matmat_sparse(A, B, Mesh(D, "cpu"), a_split=sa, b_split=sb)
        _same(C, jb.matmat_sparse(A, B, make_mesh(D), dtype=jnp.float64,
                                  a_split=sa, b_split=sb))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_use_dense_ring_routes_alike(n_shards, operands):
    cases = list(operands.values()) + [
        (generators.random_symm_matrix(m, dens, seed=1),
         generators.random_symm_matrix(m, dens, seed=2))
        for m, dens in ((300, 0.05), (5000, 0.001), (5000, 0.005), (5000, 0.01))]
    got = [ts._use_dense_ring(A, B, n_shards) for A, B in cases]
    assert got == [js._use_dense_ring(A, B, n_shards) for A, B in cases]
    assert True in got or n_shards == 1


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_matmat_modes_and_unassembled_blocks(mode, mesh, jmesh, operands):
    A, B = operands["random"]
    C = ts.matmat(A, B, mesh, dtype=F64, mode=mode)
    _same(C, js.matmat(A, B, jmesh, dtype=jnp.float64, mode=mode))
    blocks, a_split = ts.matmat(A, B, mesh, dtype=F64, assemble=False, mode=mode)
    jblocks, ja_split = js.matmat(A, B, jmesh, dtype=jnp.float64, assemble=False,
                                  mode=mode)
    np.testing.assert_array_equal(a_split, ja_split)
    assert tuple(blocks.shape) == jblocks.shape
    np.testing.assert_allclose(blocks.numpy(), np.asarray(jblocks), rtol=0,
                               atol=1e-12 * max(1.0, abs(C).max()))
    with pytest.raises(ValueError):
        ts.matmat(A, B, mesh, mode="bogus")


def test_matmat_f32_rounds_as_f32(mesh, operands):
    """An f32 ring product is within f32 rounding of scipy's f64 product."""
    A, B = operands["random"]
    ref = (A @ B).tocsr()
    bound = 4 * np.finfo(np.float32).eps * abs(abs(A) @ abs(B)).max()
    for mode in ("dense", "sparse"):
        C = ts.matmat(A, B, mesh, dtype=torch.float32, mode=mode)
        assert abs(C - ref).max() <= bound, mode


def test_matmat_prepare_run_match_saena_tpu(mesh, jmesh):
    A = generators.random_symm_matrix(300, 0.05, seed=1)
    B = generators.random_symm_matrix(300, 0.05, seed=2)
    Ab, Bb, split = ts.matmat_prepare(A, B, mesh, dtype=F64)
    jAb, jBb, jsplit = js.matmat_prepare(A, B, jmesh, dtype=jnp.float64)
    np.testing.assert_array_equal(Ab.numpy(), np.asarray(jAb))
    np.testing.assert_array_equal(Bb.numpy(), np.asarray(jBb))
    np.testing.assert_array_equal(split, jsplit)
    C = ts.matmat_run(Ab, Bb, mesh)
    np.testing.assert_allclose(C.numpy(), np.asarray(js.matmat_run(jAb, jBb, jmesh)),
                               rtol=0, atol=1e-12 * max(1.0, abs(A @ B).max()))
    with pytest.raises(ValueError):
        ts.matmat_prepare(A, B[:200], mesh)


# ---------------------------------------------------- fixed-order block sums --


@pytest.mark.parametrize("window", [1, 8])
@pytest.mark.parametrize("chunk", [4, 8, 512])
def test_bsp_numeric_sums_cut_runs(chunk, window, monkeypatch):
    """Runs of one output block longer than a window and cut by window
    ends, blocks of one pair and padding: the fixed-order sums give the
    plain product, and two calls give equal bits."""
    monkeypatch.setattr(tb, "WINDOW", window)
    rng = np.random.default_rng(5)
    nA, nB, nC = 30, 20, 9
    Ab = rng.standard_normal((nA, 8, 16))
    Bb = rng.standard_normal((nB, 16, 128))
    c = np.sort(np.concatenate([np.full(23, 2), rng.integers(0, nC, 40), [nC - 1]]))
    a = rng.integers(0, nA, c.size)
    b = rng.integers(0, nB, c.size)
    ai, bi, ci = tb._pad_pairs(a, b, c, nC, chunk=chunk)
    ref = np.zeros((nC + 1, 8, 128))
    np.add.at(ref, c, np.einsum("pik,pkj->pij", Ab[a], Bb[b]))
    Ab_t, Bb_t = torch.from_numpy(Ab), torch.from_numpy(Bb)
    C = tb._bsp_numeric(Ab_t, Bb_t, ai, bi, ci, nC, chunk=chunk)
    np.testing.assert_allclose(C.numpy(), ref, rtol=0, atol=1e-12 * abs(ref).max())
    assert not C[nC].any()                           # padding adds nothing
    assert torch.equal(C, tb._bsp_numeric(Ab_t, Bb_t, ai, bi, ci, nC, chunk=chunk))


def test_pad_pairs_min_len_and_assemble_tol_match_saena_tpu(operands):
    A, B = operands["random"]
    bk = tb.pick_bk(A, B)
    l, r = tb._block_left(A, bk), tb._block_right(B, bk)
    pairs = tb._pairs(l[1], l[2], r[1], r[2], 3)
    n = 2 * tb.CHUNK * (-(-pairs[0].size // tb.CHUNK))
    for got, ref in zip(tb._pad_pairs(*pairs[:3], pairs[3].size, min_len=n),
                        jb._pad_pairs(*pairs[:3], pairs[3].size, min_len=n)):
        np.testing.assert_array_equal(got, ref)
        assert got.size == n
    C = tb._bsp_numeric(torch.from_numpy(l[0]), torch.from_numpy(r[0]),
                        *tb._pad_pairs(*pairs[:3], pairs[3].size), pairs[3].size).numpy()
    tol = float(np.quantile(np.abs(C[C != 0]), 0.3))
    got = tb._assemble_csr(C, pairs[3], 3, (500, 300), tol)
    ref = jb._assemble_csr(C, pairs[3], 3, (500, 300), tol)
    _same(got, ref)
    assert got.nnz == ref.nnz < tb._assemble_csr(C, pairs[3], 3, (500, 300)).nnz


def test_spgemm_blocks_bk_tol_and_dtype_match_saena_tpu(operands):
    A, B = operands["random"]
    for bk in (32, 128):
        C = tb.spgemm_blocks(A, B, dtype=F64, bk=bk, tol=1e-3, device="cpu")
        _same(C, jb.spgemm_blocks(A, B, dtype=jnp.float64, bk=bk, tol=1e-3))
        assert np.abs(C.data).min() > 1e-3
    C32 = tb.spgemm_blocks(A, B, dtype=torch.float32, device="cpu")
    assert C32.dtype == np.float32
    ref = (A @ B).tocsr()
    assert abs(C32 - ref).max() <= 4 * np.finfo(np.float32).eps * abs(abs(A) @ abs(B)).max()


# ------------------------------------------------------------- the eig --


def test_eig_max_invdiag_device_matches_scipy_and_saena_tpu():
    from saena_tpu.amg.eig import eig_max_invdiag_device as jeig
    from saena_tpu_torch.amg.eig import SAFETY, eig_max_invdiag_device
    from saena_tpu_torch.ops.formats import pad_to
    import scipy.linalg as sla

    S = generators.random_symm_matrix(150, 0.1, seed=3)
    A = (S @ S.T + sp.eye(150)).tocsr()
    n, n_pad = A.shape[0], pad_to(A.shape[0])
    d = A.diagonal()
    Ad = np.zeros((n_pad, n_pad))
    Ad[:n, :n] = A.toarray()
    inv = np.zeros(n_pad)
    inv[:n] = 1.0 / d
    lam = eig_max_invdiag_device(lambda v: torch.from_numpy(Ad) @ v,
                                 torch.from_numpy(inv), n_pad, F64, device="cpu")
    exact = sla.eigvalsh(A.toarray() / np.sqrt(np.outer(d, d)))[-1] * SAFETY
    jlam = float(jeig(lambda v: jnp.asarray(Ad) @ v, jnp.asarray(inv), n_pad,
                      jnp.float64))
    # a Rayleigh quotient from below: 60 steps on this spectrum reach 1e-8
    assert lam.dim() == 0 and float(lam) <= exact * (1 + 1e-12)
    assert abs(float(lam) - exact) <= 1e-8 * exact
    assert abs(float(lam) - jlam) <= 1e-8 * exact
    again = eig_max_invdiag_device(lambda v: torch.from_numpy(Ad) @ v,
                                   torch.from_numpy(inv), n_pad, F64, device="cpu")
    assert float(again) == float(lam)


# ------------------------------------------------------------- the card --


@pytest.mark.cuda
@pytest.mark.parametrize("name", OPERANDS)
def test_cuda_products_are_bit_equal(name, operands):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, B = operands[name]
    cuda_mesh = Mesh(4, "cuda")
    runs = [tb.matmat_sparse(A, B, cuda_mesh) for _ in range(2)]
    runs += [tb.spgemm_blocks(A, B, device="cuda") for _ in range(2)]
    for first, second in (runs[:2], runs[2:]):
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(first, f), getattr(second, f))
    _same(runs[0], tb.matmat_sparse(A, B, Mesh(4, "cpu")))
    _same(runs[2], (A @ B).tocsr())
