"""The port's sharded solve over two processes (saena_tpu_torch/parallel/
multihost.py): two spawned ranks join a gloo process group, each holds 4 of
the 8 shards of one global mesh, and the mesh's collectives cross ranks
through torch.distributed. The counterpart of tests/test_multihost.py (two
jax.distributed processes of 4 virtual devices each), on the same 16^3
Poisson with replicate_threshold 500.

Three configurations, so that every collective crosses ranks:
``default`` (all_to_all halos, psum dots and restriction); ``ring`` (a
dense level's ppermute ring on an int8_block wire, allgather halos); and
``dia_f32`` (f32 ShardedDia levels, their slabs ppermuted on a bf16 wire).
In each, both ranks give the same iterations and level formats as the same
solve on 8 shards in one process, ||r0|| at rtol 1e-10 (f32: 1e-6), the
final residual within 1e-10 ||r0|| (f32: 1e-6 ||r0||) and u at rtol 1e-8
(f32: 1e-4; a sum over ranks has no fixed order), and a true relative
residual < 1e-7 (f32: 1e-5); each of the backend's four collectives was
called. A group of world size 1 holding 4 shards (the card's NCCL run in
chip_smoke.py, here on gloo) calls the backend for its all_to_all and psum
and gives the one-process 4-shard solve bit for bit. Each rank has its own
timeout, so a hung rank fails a test and not the suite, and one torch
thread, so that the ranks load the CPU little beside the suite's other
files.

Run as a script, this file is one rank: ``python test_torch_multihost.py
<rank> <port> <output directory> <world size>``.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
M = 16
RANKS, SHARDS_PER_RANK = 2, 4
TIMEOUT_S = 240
# the torch.distributed calls of comm.py, counted in each rank
BACKEND_CALLS = ("all_to_all_single", "all_gather", "all_gather_into_tensor",
                 "batch_isend_irecv", "all_reduce")


# name: (Options, dtype, sharded_format, the level formats it must have)
CONFIGS = {
    "default": (dict(replicate_threshold=500), "float64", "auto", "ShardedEll"),
    "ring": (dict(replicate_threshold=300, dense_thre=0.005, dense_sz_thre=3000,
                  halo_mode="allgather", compress_halo=True,
                  halo_dtype="int8_block"), "float64", "auto", "ShardedDense"),
    "dia_f32": (dict(replicate_threshold=500, compress_halo=True),
                "float32", "dia", "ShardedDia"),
}


def _solve(mesh, name):
    """(u, iters, r0, rfin, rel_true, formats, d_active) of the sharded pCG
    of configuration ``name`` on ``mesh``, from the port's own host setup."""
    from saena_tpu_torch.amg import hierarchy as H
    from saena_tpu_torch.config import Options
    from saena_tpu_torch.core.coo import remove_boundary_nodes
    from saena_tpu_torch.generators import laplacian3D, laplacian3D_set_rhs
    from saena_tpu_torch.parallel.sharded import shard_hierarchy, sharded_solve_pCG

    A, _, _, _, rhs = remove_boundary_nodes(laplacian3D(M, M, M),
                                            laplacian3D_set_rhs(M, M, M))
    kw, dt, fmt, _ = CONFIGS[name]
    opts, dt = Options(**kw), getattr(torch, dt)
    _, info = H.setup(A, opts, dtype=dt, device="cpu")
    sh, splits = shard_hierarchy(info, opts, mesh, dtype=dt, sharded_format=fmt)
    u, iters, r0, rfin, _ = sharded_solve_pCG(
        sh, splits, rhs, mesh, params=H.SolveParams.from_options(opts),
        tol=1e-8 if dt == torch.float64 else 1e-6, max_iter=100)
    rel = float(np.linalg.norm(rhs - A @ u) / np.linalg.norm(rhs))
    return u, iters, r0, rfin, rel, [type(lv.A).__name__ for lv in sh.sharded], \
        list(sh.d_active)


def _count_backend_calls() -> dict:
    """Wrap torch.distributed's collectives that comm.py calls; returns the
    counts, which the wrappers raise."""
    import torch.distributed as dist

    calls = dict.fromkeys(BACKEND_CALLS, 0)

    def wrap(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    for name in BACKEND_CALLS:
        setattr(dist, name, wrap(name, getattr(dist, name)))
    return calls


def _rank_main(rank: int, port: int, out_dir: str, world: int) -> None:
    import torch.distributed as dist

    from saena_tpu_torch.parallel.comm import Mesh
    from saena_tpu_torch.parallel.multihost import global_mesh, init_distributed

    init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                     backend="gloo")
    calls = _count_backend_calls()
    try:
        mesh = global_mesh(SHARDS_PER_RANK, device="cpu")
        assert (mesh.size, mesh.k, mesh.lo) == (world * SHARDS_PER_RANK,
                                                SHARDS_PER_RANK, rank * SHARDS_PER_RANK)
        # world 1: the group's solve, then the same on a mesh without one,
        # in this process, so that the two differ only in the group
        runs = [(name, mesh, name) for name in CONFIGS] if world > 1 else \
            [("default", mesh, "default"),
             ("no_group", Mesh(SHARDS_PER_RANK, "cpu"), "default")]
        for label, m, name in runs:
            u, iters, r0, rfin, rel, kinds, d_active = _solve(m, name)
            np.save(os.path.join(out_dir, f"{label}_u{rank}.npy"), u)
            print("RESULT " + json.dumps(dict(name=label, rank=rank, iters=iters,
                                              r0=r0, rfin=rfin, rel_true=rel,
                                              kinds=kinds, d_active=d_active,
                                              calls=calls)),
                  flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, tmp_path) -> dict:
    """{(configuration, rank): RESULT} of ``world`` spawned ranks."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(port), str(tmp_path), str(world)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"
        for ln in out.splitlines():
            if ln.startswith("RESULT "):
                res = json.loads(ln[len("RESULT "):])
                results[res["name"], res["rank"]] = res
    return results


@pytest.fixture
def one_thread():
    """The one-process reference solves on one torch thread, as the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_rank_gloo_pcg_matches_one_process(tmp_path, one_thread):
    from saena_tpu_torch.parallel.comm import Mesh

    results = _run_ranks(RANKS, tmp_path)
    assert len(results) == len(CONFIGS) * RANKS, f"missing RESULT lines: {results}"
    for r in range(RANKS):
        calls = results[list(CONFIGS)[-1], r]["calls"]
        assert min(calls["all_to_all_single"], calls["batch_isend_irecv"],
                   calls["all_reduce"], calls["all_gather"]) > 0, calls

    one = Mesh(RANKS * SHARDS_PER_RANK, "cpu")
    for name, (_, dt, _, kind) in CONFIGS.items():
        u, iters, r0, rfin, rel, kinds, d_active = _solve(one, name)
        tol = 1e-8 if dt == "float64" else 1e-4
        assert kind in kinds and rel < (1e-7 if dt == "float64" else 1e-5), name
        for r in range(RANKS):
            res = results[name, r]
            assert res["iters"] == iters, name
            assert (res["kinds"], res["d_active"]) == (kinds, d_active), name
            assert res["r0"] == pytest.approx(r0, rel=1e-10 if dt == "float64" else 1e-6)
            assert abs(res["rfin"] - rfin) <= tol * 1e-2 * r0, name
            assert res["rel_true"] < (1e-7 if dt == "float64" else 1e-5), name
            np.testing.assert_allclose(np.load(tmp_path / f"{name}_u{r}.npy"), u,
                                       rtol=tol, atol=tol * np.abs(u).max(), err_msg=name)


def test_one_rank_group_calls_the_backend(tmp_path):
    results = _run_ranks(1, tmp_path)
    res, ref = results["default", 0], results["no_group", 0]
    calls = res["calls"]
    assert calls["all_to_all_single"] > 0 and calls["all_reduce"] > 0, calls
    assert calls["batch_isend_irecv"] == 0, calls     # no pair crosses ranks
    assert ref["calls"] == calls                      # the mesh without a group calls none
    assert res["rel_true"] < 1e-7
    for k in ("iters", "r0", "rfin", "kinds", "d_active"):
        assert res[k] == ref[k], k
    np.testing.assert_array_equal(np.load(tmp_path / "default_u0.npy"),
                                  np.load(tmp_path / "no_group_u0.npy"))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
