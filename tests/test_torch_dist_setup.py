"""The port's shard-parallel setup (saena_tpu_torch/parallel/dist_setup.py)
on the CPU, in f64.

- It equals the port's serial setup bit for bit (indptr, indices, data of
  every level, P and R) at 2, 3 and 4 shards, on both aggregation paths
  and both wire codecs, and with the numpy MIS rounds of hosts without a
  toolchain.
- Its host levels, P and R equal saena_tpu's dist_setup bit for bit on the
  16^3 and 24^3 Poisson interiors and band_matrix(3000, 16), and its
  CommMeter records the same volumes, MIS rounds and distributed levels.
- AMG.set_matrix honours Options.setup_shards as saena_tpu's does: -1 runs
  the shard-parallel setup at its default shard count, a positive value
  forces the count, 0 runs the serial setup; all three give one hierarchy.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from saena_tpu.config import Options as JOptions
from saena_tpu.parallel.dist_setup import dist_setup as jdist_setup

from saena_tpu_torch import AMG, Matrix, generators
from saena_tpu_torch import _native as tn
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.config import Options
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.parallel import dist_setup as tds

F64 = dict(dtype=torch.float64, device="cpu")


def _poisson(m):
    return remove_boundary_nodes(generators.laplacian3D(m, m, m))[0].tocsr()


def assert_same_host_levels(i1, i2):
    """Every level, P and R of two SetupInfos equal bit for bit."""
    assert i1.sizes == i2.sizes
    for name, As, Bs in (("A", i1.csr_levels, i2.csr_levels),
                         ("P", i1.Ps, i2.Ps), ("R", i1.Rs, i2.Rs)):
        assert len(As) == len(Bs)
        for l, (X, Y) in enumerate(zip(As, Bs)):
            for attr in ("indptr", "indices", "data"):
                x, y = getattr(X, attr), getattr(Y, attr)
                assert x.shape == y.shape and np.array_equal(x, y), \
                    f"{name}{l} {attr} differs"
                if attr == "data":
                    assert np.array_equal(x.view(np.uint64), y.view(np.uint64))


_SERIAL: dict = {}


def _serial(agg):
    if agg not in _SERIAL:
        _SERIAL[agg] = th.setup(_poisson(16), Options(aggregation=agg), **F64)[1]
    return _SERIAL[agg]


@pytest.mark.parametrize("codec", ["gr", "none"])
@pytest.mark.parametrize("agg", ["dist1", "double"])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_dist_setup_equals_serial_setup(n_shards, agg, codec):
    _, info = tds.dist_setup(_poisson(16), Options(aggregation=agg),
                             n_shards=n_shards, tail_rows=32, wire_codec=codec,
                             **F64)
    assert_same_host_levels(_serial(agg), info)
    assert info.comm.dist_levels >= 1 and info.n_shards == n_shards
    assert info.native


def test_numpy_mis_rounds_equal_native(monkeypatch):
    monkeypatch.setattr(tn, "have_native", lambda: False)
    _, info = tds.dist_setup(_poisson(16), Options(), n_shards=3, tail_rows=32,
                             **F64)
    assert_same_host_levels(_serial("dist1"), info)


def test_more_shards_than_cores_under_fast_thread_switching():
    """Stress: 16 shard threads (more than the cores) and the setup
    executor, with the interpreter switching threads every microsecond;
    the meter's volumes and the hierarchy stay those of the serial setup
    and of a calm run."""
    import sys

    A = _poisson(16)
    _, calm = tds.dist_setup(A, Options(), n_shards=16, tail_rows=8, **F64)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, info = tds.dist_setup(A, Options(), n_shards=16, tail_rows=8, **F64)
    finally:
        sys.setswitchinterval(old)
    assert_same_host_levels(_serial("dist1"), info)
    assert info.comm.bytes_by_phase == calm.comm.bytes_by_phase
    assert info.comm.mis_rounds == calm.comm.mis_rounds


JAX_CASES = {
    "poisson16": (lambda: _poisson(16), 4, 32),
    "poisson24": (lambda: _poisson(24), 4, 64),
    "band3000": (lambda: generators.band_matrix(3000, 16).tocsr(), 3, 64),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_dist_setup_equals_saena_tpu(case):
    make, n_shards, tail = JAX_CASES[case]
    A = make()
    _, ji = jdist_setup(A, JOptions(), dtype=jnp.float64, n_shards=n_shards,
                        tail_rows=tail)
    _, ti = tds.dist_setup(A, Options(), n_shards=n_shards, tail_rows=tail,
                           **F64)
    assert_same_host_levels(ji, ti)
    jm, tm = ji.comm, ti.comm
    assert tm.bytes_by_phase == jm.bytes_by_phase
    assert tm.raw_by_phase == jm.raw_by_phase
    assert (tm.mis_rounds, tm.dist_levels) == (jm.mis_rounds, jm.dist_levels)
    assert tm.table() == jm.table()
    assert ti.shard_stats() == ji.shard_stats()


def test_comm_meter_halo_sized_and_gr_compresses():
    """Strength, prolongation and MIS exchanges are boundary-sized; the GR
    wire carries the SpGEMM windows under their raw size, losslessly."""
    A = _poisson(16)
    n, nnz = A.shape[0], A.nnz
    _, info = tds.dist_setup(A, Options(), n_shards=4, tail_rows=500, **F64)
    m = info.comm
    assert m.dist_levels == 1
    assert m.bytes_by_phase["strength"] < 8 * n
    assert m.bytes_by_phase["prolong"] < 8 * n
    assert m.bytes_by_phase["mis"] < 2 * nnz
    _, i_raw = tds.dist_setup(A, Options(), n_shards=4, tail_rows=64,
                              wire_codec="none", **F64)
    _, i_gr = tds.dist_setup(A, Options(), n_shards=4, tail_rows=64, **F64)
    assert_same_host_levels(i_raw, i_gr)
    raw = i_raw.comm.bytes_by_phase["spgemm"]
    assert i_gr.comm.raw_by_phase["spgemm"] == raw
    assert i_gr.comm.bytes_by_phase["spgemm"] < 0.8 * raw
    assert "x of raw" in i_gr.comm.table()


@pytest.mark.parametrize("shards", [-1, 3, 0])
def test_set_matrix_honours_setup_shards(shards):
    m = 16
    A = Matrix()
    A.set_csr(generators.laplacian3D(m, m, m))
    A.assemble(**F64)
    s = AMG(**F64).set_matrix(A, Options(remove_boundary=True,
                                         setup_shards=shards))
    assert_same_host_levels(_serial("dist1"), s.info)
    expect = {-1: tds.default_shards(), 3: 3, 0: 0}[shards]
    assert s.info.n_shards == expect
    assert (s.info.comm is None) == (shards == 0)
    if shards > 0:
        # 2744 rows > 3 shards x 512 tail rows: the fine level is sharded
        assert s.info.comm.dist_levels >= 1
    if shards:
        assert "M(min,avg,max)" in s.info.table()
    s.set_rhs(generators.laplacian3D_set_rhs(m, m, m))
    _, res = s.solve_pCG()
    assert float(res.rel_res) < 1e-8
