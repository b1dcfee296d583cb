"""The port's block-sparse SpGEMM (ops/bspgemm.py: host symbolic, the
numeric phase in torch) and Options(rap="device") against saena_tpu's, in
f64 on the CPU.

- spgemm_blocks equals saena_tpu's within 1e-12 relative to max |C| on
  random sparse operators (bk 32 and 128) and the Galerkin products of a
  Laplacian hierarchy, and scipy's product; the symbolic helpers give the
  same blocks and pairs; pick_bk picks alike; the empty product is empty.
- rap="device" at 14^3: the port's own setup against its rap="host" and
  against saena_tpu's rap="device": equal level sizes, every level within
  1e-11 (saena_tpu's test_device_rap_matches_host bound), equal pCG
  iterations; dist_setup takes the device engine for the levels it does
  not shard.

Card (marker ``cuda``, skipped without one): the numeric phase on the card
(its block sums in a fixed order, as on the CPU) against the CPU within
1e-12 relative.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch import Options, generators
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.amg import solvers as tsolvers
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.ops import bspgemm as tb
from saena_tpu_torch.parallel.dist_setup import dist_setup

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def jb():
    from saena_tpu.ops import bspgemm

    return bspgemm


def _interior(m):
    return remove_boundary_nodes(generators.laplacian3D(m, m, m))[0].tocsr()


NAMES = ("RA_P", "R_A", "dense_rows", "random")


@pytest.fixture(scope="module")
def products():
    A = sp.random(500, 700, density=0.02, random_state=1, format="csr")
    B = sp.random(700, 300, density=0.03, random_state=2, format="csr")
    D = generators.random_symm_matrix(200, 0.2, seed=7)      # bk 128
    _, info = th.setup(_interior(12), Options(setup_shards=0), **F64)
    L, P, R = info.csr_levels[0], info.Ps[0], info.Rs[0]
    return {"random": (A, B), "dense_rows": (D, D), "R_A": (R, L),
            "RA_P": ((R @ L).tocsr(), P)}


def _close(C, ref, rtol):
    assert C.shape == ref.shape
    assert abs(C - ref).max() <= rtol * max(1.0, abs(ref).max())


@pytest.mark.parametrize("name", NAMES)
def test_spgemm_blocks_matches_saena_tpu(name, products, jb):
    import jax.numpy as jnp

    A, B = products[name]
    C = tb.spgemm_blocks(A, B, device="cpu")
    ref = jb.spgemm_blocks(A, B, dtype=jnp.float64)
    assert isinstance(C, sp.csr_matrix) and C.has_sorted_indices
    _close(C, ref.tocsr(), 1e-12)
    _close(C, (A @ B).tocsr(), 1e-12)
    assert tb.pick_bk(A, B) == jb.pick_bk(A, B)


@pytest.mark.parametrize("name", NAMES)
def test_symbolic_phase_matches_saena_tpu(name, products, jb):
    A, B = products[name]
    bk = tb.pick_bk(A, B)
    left, right = tb._block_left(A, bk), tb._block_right(B, bk)
    for got, ref in zip(left + right, jb._block_left(A, bk) + jb._block_right(B, bk)):
        np.testing.assert_array_equal(got, ref)
    n_bc = -(-B.shape[1] // 128)
    pairs = tb._pairs(left[1], left[2], right[1], right[2], n_bc)
    ref = jb._pairs(left[1], left[2], right[1], right[2], n_bc)
    for got, r in zip(pairs, ref):
        np.testing.assert_array_equal(got, r)
    for got, r in zip(tb._pad_pairs(*pairs[:3], pairs[3].size),
                      jb._pad_pairs(*ref[:3], ref[3].size)):
        np.testing.assert_array_equal(got, r)


def test_empty_product_and_counter(products):
    Z = sp.csr_matrix((100, 80))
    B = sp.random(80, 60, density=0.05, random_state=3, format="csr")
    before = tb.pairs_total
    C = tb.spgemm_blocks(Z, B, device="cpu")
    assert C.shape == (100, 60) and C.nnz == 0
    assert tb.pairs_total == before
    A, B = products["random"]
    tb.spgemm_blocks(A, B, device="cpu")
    bk = tb.pick_bk(A, B)
    l, r = tb._block_left(A, bk), tb._block_right(B, bk)
    n_pairs = tb._pairs(l[1], l[2], r[1], r[2], 3)[0].size
    assert tb.pairs_total == before + n_pairs > before
    with pytest.raises(ValueError):
        tb.spgemm_blocks(A, A, device="cpu")


def test_device_rap_matches_host_and_saena_tpu():
    from saena_tpu.amg import hierarchy as jh
    from saena_tpu.amg import solvers as jsolvers
    from saena_tpu.config import Options as JOptions

    A = _interior(14)
    rhs = A @ np.ones(A.shape[0])
    Hh, ih = th.setup(A, Options(setup_shards=0), **F64)
    Hd, idv = th.setup(A, Options(setup_shards=0, rap="device"), **F64)
    Hj, ij = jh.setup(A, JOptions(rap="device"))
    assert ih.sizes == idv.sizes == ij.sizes
    for Ah, Ad, Aj in zip(ih.csr_levels, idv.csr_levels, ij.csr_levels):
        assert abs(Ah - Ad).max() < 1e-11
        assert abs(Aj - Ad).max() < 1e-11
    rp = np.pad(rhs, (0, Hh.n_pad - A.shape[0]))
    its = [tsolvers.solve_pCG(H, rp, tol=1e-8).iters for H in (Hh, Hd)]
    its.append(int(jsolvers.solve_pCG(Hj, rp, tol=1e-8).iters))
    assert its[0] == its[1] == its[2]


def test_dist_setup_takes_the_device_engine_on_serial_levels():
    """Sharded levels take the distributed host product, the levels below
    the shard threshold the device engine (block pairs counted)."""
    A = _interior(14)
    _, serial = th.setup(A, Options(setup_shards=0, rap="device"), **F64)
    before = tb.pairs_total
    _, dist = dist_setup(A, Options(rap="device"), n_shards=2, tail_rows=512,
                         **F64)
    assert dist.comm.dist_levels > 0 and tb.pairs_total > before
    assert dist.sizes == serial.sizes
    for a, b in zip(dist.csr_levels, serial.csr_levels):
        assert abs(a - b).max() < 1e-11


# ------------------------------------------------------------- the card --


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_numeric_phase_matches_cpu(name, products):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, B = products[name]
    C = tb.spgemm_blocks(A, B, device="cuda")
    _close(C, tb.spgemm_blocks(A, B, device="cpu"), 1e-12)
