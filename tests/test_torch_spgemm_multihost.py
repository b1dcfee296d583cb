"""The port's ring products over two processes: two spawned ranks join a
gloo process group, each holds 4 of the 8 shards of one global mesh, and
run ``matmat_sparse`` (the block-sparse ring) and ``matmat(mode="dense")``
(the dense ring) on the operands of tests/test_spgemm.py's
test_bsp_ring_matches_scipy. B's blocks move between the ranks through
``Mesh.ppermute``'s ``batch_isend_irecv``, and each rank gathers the whole
product. Both ranks' products must equal the one-process 8-shard products
bit for bit (data, indices, indptr). Each rank has its own timeout and one
torch thread, as the reference run in this process has.

Run as a script, this file is one rank: ``python
test_torch_spgemm_multihost.py <rank> <port> <output directory>``.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANKS, SHARDS_PER_RANK = 2, 4
TIMEOUT_S = 240
KINDS = ("sparse", "dense")


def _operands():
    A = sp.random(500, 700, density=0.02, random_state=11, format="csr")
    B = sp.random(700, 300, density=0.03, random_state=12, format="csr")
    return A, B


def _product(mesh, kind):
    from saena_tpu_torch.ops.bspgemm import matmat_sparse
    from saena_tpu_torch.ops.spgemm import matmat

    A, B = _operands()
    if kind == "sparse":
        return matmat_sparse(A, B, mesh, dtype=torch.float64)
    return matmat(A, B, mesh, dtype=torch.float64, mode="dense")


def _rank_main(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from saena_tpu_torch.parallel.multihost import global_mesh, init_distributed

    init_distributed(f"tcp://127.0.0.1:{port}", world_size=RANKS, rank=rank,
                     backend="gloo")
    calls = {"batch_isend_irecv": 0}
    real = dist.batch_isend_irecv

    def counted(ops):
        calls["batch_isend_irecv"] += 1
        return real(ops)

    dist.batch_isend_irecv = counted
    try:
        mesh = global_mesh(SHARDS_PER_RANK, device="cpu")
        for kind in KINDS:
            calls["batch_isend_irecv"] = 0
            C = _product(mesh, kind)
            np.savez(os.path.join(out_dir, f"{kind}_{rank}.npz"), data=C.data,
                     indices=C.indices, indptr=C.indptr, shape=C.shape,
                     isend_irecv=calls["batch_isend_irecv"])
    finally:
        dist.destroy_process_group()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_rings_match_one_process(tmp_path, one_thread):
    from saena_tpu_torch.parallel.comm import Mesh

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(port), str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"

    one = Mesh(RANKS * SHARDS_PER_RANK, "cpu")
    ref = {kind: _product(one, kind) for kind in KINDS}
    A, B = _operands()
    for kind in KINDS:
        assert abs(ref[kind] - A @ B).max() < 1e-12, kind
        for r in range(RANKS):
            got = np.load(tmp_path / f"{kind}_{r}.npz")
            assert tuple(got["shape"]) == ref[kind].shape
            for f in ("data", "indices", "indptr"):
                np.testing.assert_array_equal(got[f], getattr(ref[kind], f),
                                              err_msg=f"{kind} rank {r} {f}")
            # the ring's rotations crossed ranks
            assert got["isend_irecv"] > 0, (kind, r)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
