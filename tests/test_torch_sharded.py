"""The port's sharded path (saena_tpu_torch/parallel/sharded.py) against
saena_tpu's on the conftest's 8-device CPU mesh, in f64 unless a case says
otherwise. One parametrised counterpart for each test of
tests/test_parallel.py (same names, same problems and options):

- partitions and splits equal saena_tpu's;
- SpMV: each sharded format the port builds, and the same format built by
  saena_tpu and carried across (``convert.load_sharded_operator``), against
  scipy at rtol 1e-12 (f32 DIA at the JAX test's 5e-5; the f64 ShardedDia,
  which only the card picks, built from the structural plan at 1e-12);
  where the layout is the same, the port's arrays equal saena_tpu's;
- pCG: the port's sharded solve, with the JAX test's assertions (the port's
  serial iterations and u within 1e-10 where it asks for serial parity,
  the true residual, iteration bounds against uncompressed or twin-free
  runs); the level formats and active shard counts equal saena_tpu's in
  every case (the measured shrink excepted: its pick is a timing);
- the acceptance case (20^3, replicate_threshold 500): the JAX sharded
  solve's iterations and history at rtol 1e-10, both on the port's own
  hierarchy and on saena_tpu's carried across
  (``convert.load_sharded_hierarchy``).

Beside them: the two reference faults the port repairs (measured shrinking
warns before its fallback; the sharded profile masks BSR padding), the
sharded profile's rows, and on the card (marker ``cuda``) the sharded graph
solve bit-equal to its uncaptured loop.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu.config import Options as JOptions
from saena_tpu.core.coo import remove_boundary_nodes
from saena_tpu.generators import (band_matrix, laplacian3D, laplacian3D_set_rhs,
                                  random_symm_matrix)
from saena_tpu.parallel import partition as jpart
from saena_tpu.parallel import sharded as JS

from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.amg import solvers as tsolvers
from saena_tpu_torch.config import Options
from saena_tpu_torch.convert import load_sharded_hierarchy, load_sharded_operator
from saena_tpu_torch.parallel import partition as tpart
from saena_tpu_torch.parallel import sharded as S
from saena_tpu_torch.parallel.comm import Mesh

D = 8
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs: the suite runs files side
    by side, and some of saena_tpu's tests time themselves."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= D, "conftest must provide 8 virtual devices"
    return JS.make_mesh(D)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(D, "cpu")


# ---------------------------------------------------------------------------
# carrying saena_tpu's sharded state across
# ---------------------------------------------------------------------------

_STATIC = {"ShardedStrip8": ("perrow", "mode", "n_cols_pad", "n_out"),
           "ShardedDia": ("offsets", "n_loc", "lo_pad", "hi_pad", "compress"),
           "ShardedDense": ("compress",),
           "ShardedEll": ("reduce_rows",)}
_ARRAYS = {"ShardedEll": ("cols", "vals", "spill_rows", "spill_cols", "spill_vals"),
           "ShardedBsr": ("blocks", "bcols"),
           "ShardedStrip8": ("idx", "vals", "strips", "gather_idx"),
           "ShardedDia": ("data",), "ShardedDense": ("data",)}


def flatten_operator(arrays, key, M):
    """Spec of a saena_tpu sharded operator, its arrays put in ``arrays``."""
    if M is None:
        return None
    kind = type(M).__name__
    spec = {"format": kind, "shape": list(M.shape), "nnz": int(M.nnz),
            **{k: getattr(M, k) for k in _STATIC.get(kind, ())}}
    for f in _ARRAYS[kind]:
        if getattr(M, f, None) is not None:
            arrays[f"{key}.{f}"] = np.asarray(getattr(M, f))
    plan = getattr(M, "plan", None)
    if plan is not None:
        spec["plan"] = {"n_local": plan.n_local, "max_send": plan.max_send,
                        "mode": plan.mode, "compress": plan.compress}
        arrays[f"{key}.send_idx"] = np.asarray(plan.send_idx)
    return spec


def flatten_sharded(jsh):
    """(arrays, meta) of a saena_tpu ShardedHierarchy, for
    convert.load_sharded_hierarchy."""
    from test_torch_solve import flatten_hierarchy

    arrays, levels = {}, []
    for l, lv in enumerate(jsh.sharded):
        arrays[f"S{l}.inv_diag"] = np.asarray(lv.inv_diag)
        spec = {"n": lv.n, "lvl": lv.lvl, "eig_max": lv.eig_max}
        for k in ("A", "R_next", "P_next", "A_smooth"):
            spec[k] = flatten_operator(arrays, f"S{l}.{k}", getattr(lv, k))
        if spec["A_smooth"] is not None:
            spec["A_smooth"]["dtype"] = str(lv.A_smooth.dtype)
        levels.append(spec)
    tail, tmeta = flatten_hierarchy(jsh.replicated)
    arrays.update({f"tail.{k}": v for k, v in tail.items()})
    return arrays, {"levels": levels,
                    "trans_R": flatten_operator(arrays, "trans_R", jsh.trans_R),
                    "trans_P": flatten_operator(arrays, "trans_P", jsh.trans_P),
                    "replicated": tmeta, "d_active": list(jsh.d_active)}


def carried(M, mesh, dtype=F64):
    arrays = {}
    return load_sharded_operator(arrays, "M", flatten_operator(arrays, "M", M),
                                 mesh, dtype)


def port_spmv(M, x, split, mesh, n_rows=None):
    """The port's sharded SpMV of a plain vector x under ``split``."""
    xb = torch.from_numpy(S.blocked_pad_vector(x, split))[mesh.local].to(
        M.dtype if M.dtype != torch.bfloat16 else torch.float32)
    return M.matvec(xb).to(F64).numpy()


# ---------------------------------------------------------------------------
# problems and setups, shared by the cases
# ---------------------------------------------------------------------------


def _interior(m):
    A, _, _, _, rhs = remove_boundary_nodes(laplacian3D(m, m, m),
                                            laplacian3D_set_rhs(m, m, m))
    return A, rhs


def _irregular():
    A = (random_symm_matrix(900, 0.01, seed=13) + 20.0 * sp.identity(900)).tocsr()
    return A, A @ np.ones(900)


PROBLEMS = {"p16": lambda: _interior(16), "p18": lambda: _interior(18),
            "p20": lambda: _interior(20), "rand900": _irregular}


@functools.lru_cache(maxsize=None)
def host_setup(problem):
    """(A, rhs, SetupInfo, eigs): the port's host levels, which are
    saena_tpu's bit for bit, and their eig estimates (both packages'
    shard_hierarchy take them instead of running Lanczos again)."""
    A, rhs = PROBLEMS[problem]()
    H, info = th.setup(A, Options(), dtype=F64, device="cpu")
    return A, rhs, info, [lv.eig_max for lv in H.levels]


@functools.lru_cache(maxsize=None)
def serial_solve(problem, opts_items, dtype=F64):
    """The port's serial pCG (tol 1e-8) on the same host levels."""
    A, rhs, info, _ = host_setup(problem)
    opts = Options(**dict(opts_items))
    H, _ = th.devicify(info.csr_levels, info.Ps, info.Rs, opts, dtype=dtype,
                       device="cpu")
    rp = np.pad(rhs, (0, H.n_pad - A.shape[0]))
    res = tsolvers.solve_pCG(H, rp, params=th.SolveParams.from_options(opts),
                             tol=1e-8, max_iter=100)
    return res.iters, res.u.numpy()[: A.shape[0]], res.history.numpy()


def kinds(sh):
    return [type(lv.A).__name__ for lv in sh.sharded]


def sharded_pair(problem, mesh, jmesh, opts_kw, dtype=F64, fmt="auto",
                 check_picks=True):
    """The port's sharded hierarchy of a case and, where the picks are
    compared, saena_tpu's: equal formats and active shard counts."""
    A, rhs, info, eigs = host_setup(problem)
    sh, splits = S.shard_hierarchy(info, Options(**opts_kw), mesh, dtype=dtype,
                                   eigs=eigs, sharded_format=fmt)
    jsh = None
    if check_picks:
        jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
        jsh, jsplits = JS.shard_hierarchy(info, JOptions(**opts_kw), jmesh,
                                          dtype=jdt, eigs=eigs, sharded_format=fmt)
        assert kinds(sh) == kinds(jsh)
        assert sh.d_active == tuple(jsh.d_active)
        for a, b in zip(splits, jsplits):
            np.testing.assert_array_equal(a, b)
    return A, rhs, sh, splits, jsh


def rel_true(A, rhs, u):
    return np.linalg.norm(rhs - A @ u) / np.linalg.norm(rhs)


def solve(sh, splits, rhs, mesh, opts_kw, tol=1e-8, max_iter=100):
    return S.sharded_solve_pCG(sh, splits, rhs, mesh,
                               params=th.SolveParams.from_options(Options(**opts_kw)),
                               tol=tol, max_iter=max_iter)


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------


def _skewed():
    rng = np.random.default_rng(7)
    n = 64
    Ad = np.diag(rng.uniform(1, 2, n))
    Ad[: n // 4] = rng.uniform(0.1, 1.0, (n // 4, n))
    return sp.csr_matrix(Ad + Ad.T)


@pytest.mark.parametrize("name", ["partition_balance", "equal_row_split",
                                  "repart_knobs_change_split", "subset_split_shape"])
def test_partitions(name):
    """test_partition_balance, test_equal_row_split,
    test_repart_knobs_change_split, test_subset_split_shape: the port's
    splits equal saena_tpu's and keep their properties."""
    if name == "partition_balance":
        A = laplacian3D(12, 12, 12)
        split = tpart.nnz_balanced_split(A, D)
        np.testing.assert_array_equal(split, jpart.nnz_balanced_split(A, D))
        nnz_per = [A[split[d]: split[d + 1]].nnz for d in range(D)]
        assert max(nnz_per) / (A.nnz / D) < 1.5
    elif name == "equal_row_split":
        np.testing.assert_array_equal(np.diff(tpart.equal_row_split(10, 4)), [3, 3, 2, 2])
    elif name == "repart_knobs_change_split":
        A = _skewed()
        dens = A.nnz / 64 ** 2
        for kw in (dict(repart_thre=0.1, switch_repart=True),
                   dict(repart_thre=0.1, switch_repart=False),
                   dict(repart_thre=dens + 0.05, switch_repart=True)):
            np.testing.assert_array_equal(tpart.nnz_balanced_split(A, 4, **kw),
                                          jpart.nnz_balanced_split(A, 4, **kw))
        s_on = tpart.nnz_balanced_split(A, 4, repart_thre=0.1, switch_repart=True)
        np.testing.assert_array_equal(s_on, tpart.equal_row_split(64, 4))
        assert not np.array_equal(
            tpart.nnz_balanced_split(A, 4, repart_thre=0.1, switch_repart=False), s_on)
        from saena_tpu_torch.api import AMG

        amg = AMG(device="cpu")
        amg.switch_repart(False)
        amg.set_repart_thre(0.42)
        assert amg.opts.switch_repart is False and amg.opts.repart_thre == 0.42
    else:
        A = laplacian3D(10, 10, 10)
        s = tpart.subset_split(A, 8, 3)
        np.testing.assert_array_equal(s, jpart.subset_split(A, 8, 3))
        assert len(s) == 9 and s[-1] == s[3] == A.shape[0]
        nnz_per = [A[s[d]: s[d + 1]].nnz for d in range(3)]
        assert max(nnz_per) / (A.nnz / 3) < 1.5


# ---------------------------------------------------------------------------
# SpMV of every sharded format
# ---------------------------------------------------------------------------


def _same_arrays(M, J, names):
    for n in names:
        a, b = getattr(M, n), getattr(J, n)
        if a is None or b is None:
            assert a is None and b is None, n
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[: a.shape[0]], err_msg=n)


def _dia_case(A, mesh, jmesh, atol):
    plan = S.sharded_dia_plan(A, D, D, torch.float32, "cpu")
    jplan = JS.sharded_dia_plan(A, D, D, jnp.float32)
    assert plan is not None and jplan is not None
    for a, b in zip(plan, jplan):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    M = S._build_sharded_dia(A, plan, torch.float32, mesh)
    J = JS._build_sharded_dia(A, jplan, jnp.float32, "d", D)
    np.testing.assert_array_equal(M.data.numpy(), np.asarray(J.data))
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    xb = np.zeros(D * plan[1], np.float32)
    xb[: A.shape[0]] = x
    for Mx in (M, carried(J, mesh, torch.float32)):
        y = Mx.matvec(torch.from_numpy(xb.reshape(D, -1)), exact=True).numpy()
        np.testing.assert_allclose(y.reshape(-1)[: A.shape[0]], A @ x,
                                   rtol=5e-5, atol=atol)
    return plan


SPMV = ("spmv_matches_scipy-exchange", "spmv_matches_scipy-allgather",
        "dense_ring_matvec", "bsr_spmv", "bsr_rectangular", "dia_matvec_exact",
        "ell_spill_skewed_row", "dia_multihop_wide_band", "sharded_strip8_spmv")


@pytest.mark.parametrize("name", SPMV)
def test_sharded_spmv(name, mesh):
    """test_sharded_spmv_matches_scipy[exchange / allgather],
    test_sharded_dense_ring_matvec, test_sharded_bsr_spmv,
    test_sharded_bsr_rectangular, test_sharded_dia_matvec_exact,
    test_sharded_ell_spill_skewed_row, test_sharded_dia_multihop_wide_band,
    test_sharded_strip8_spmv."""
    rng = np.random.default_rng(0)
    if name.startswith("spmv_matches_scipy"):
        mode = name.split("-")[1]
        A = random_symm_matrix(700, 0.01, seed=11)
        split = tpart.nnz_balanced_split(A, D)
        M = S._build_sharded_ell(A, split, split, F64, mode, mesh)
        J = JS._build_sharded_ell(A, split, split, jnp.float64, mode, "d")
        _same_arrays(M, J, ("cols", "vals"))
        _same_arrays(M.plan, J.plan, ("send_idx",))
        assert (M.plan.max_send, M.plan.n_local) == (J.plan.max_send, J.plan.n_local)
        cases = [(A, split, split, (M, carried(J, mesh)))]
    elif name == "dense_ring_matvec":
        A = random_symm_matrix(300, 0.3, seed=21)
        split = tpart.equal_row_split(300, D)
        J = JS._build_sharded_dense(A, split, jnp.float64, "d", D)
        cases = [(A, split, split, (S._build_sharded_dense(A, split, F64, mesh),
                                    carried(J, mesh)))]
    elif name == "bsr_spmv":
        A = random_symm_matrix(700, 0.01, seed=31)
        split = tpart.nnz_balanced_split(A, D)
        cases = []
        for mode in ("exchange", "allgather"):
            M = S._build_sharded_bsr(A, split, split, F64, mode, mesh)
            J = JS._build_sharded_bsr(A, split, split, jnp.float64, mode, "d")
            _same_arrays(M, J, ("blocks", "bcols"))
            _same_arrays(M.plan, J.plan, ("send_idx",))
            cases.append((A, split, split, (M, carried(J, mesh))))
    elif name == "bsr_rectangular":
        Rm = sp.random(260, 700, density=0.02, random_state=5, format="csr")
        row_split = tpart.equal_row_split(260, D)
        col_split = tpart.nnz_balanced_split(random_symm_matrix(700, 0.01, seed=31), D)
        M = S._build_sharded_bsr(Rm, row_split, col_split, F64, "exchange", mesh)
        J = JS._build_sharded_bsr(Rm, row_split, col_split, jnp.float64, "exchange", "d")
        _same_arrays(M, J, ("blocks", "bcols"))
        cases = [(Rm, row_split, col_split, (M, carried(J, mesh)))]
    elif name == "dia_matvec_exact":
        _dia_case(band_matrix(3000, 5).tocsr(), mesh, None, 5e-4)
        return
    elif name == "dia_multihop_wide_band":
        A = sp.diags([4.0] + [-1.0] * 4, [0, 1, -1, 900, -900], shape=(3000, 3000),
                     format="csr")
        _, n_loc, lo_pad, hi_pad, _ = _dia_case(A, mesh, None, 5e-4)
        assert lo_pad > n_loc and hi_pad > n_loc       # genuinely multi-hop
        return
    elif name == "ell_spill_skewed_row":
        n = 6000
        A = random_symm_matrix(n, 0.002, seed=13).tolil()
        A[7, :5000] = 1e-3
        A[:5000, 7] = 1e-3
        A = A.tocsr()
        A.setdiag(A.diagonal() + 10.0)
        split = tpart.nnz_balanced_split(A, D)
        M = S._build_sharded_ell(A, split, split, F64, "exchange", mesh)
        J = JS._build_sharded_ell(A, split, split, jnp.float64, "exchange", "d")
        assert M.vals.shape[1] < 100 and M.spill_rows is not None
        _same_arrays(M, J, ("cols", "vals", "spill_rows", "spill_cols", "spill_vals"))
        from saena_tpu_torch.ops.formats import ell_from_csr

        serial = ell_from_csr(A, F64, "cpu", width_quantile=0.98)
        assert (M.vals.numel() + M.spill_vals.numel()
                <= 2 * (serial.vals.numel() + serial.spill_vals.numel()))
        cases = [(A, split, split, (M, carried(J, mesh)))]
    else:   # sharded_strip8_spmv: the port's (perrow, mode) is its own pick
        A = random_symm_matrix(900, 0.02, seed=5)
        split = tpart.nnz_balanced_split(A, D)
        J = JS._build_sharded_strip8(A, split, split, jnp.float64, "exchange", "d")
        cases = [(A, split, split,
                  (S._build_sharded_strip8(A, split, split, F64, "exchange", mesh),
                   carried(J, mesh)))]
    for A, row_split, col_split, ops in cases:
        x = rng.standard_normal(A.shape[1])
        for M in ops:
            y = port_spmv(M, x, col_split, mesh)
            np.testing.assert_allclose(S.unblock_vector(y, row_split), A @ x,
                                       rtol=1e-12, atol=1e-12 if name != "dense_ring_matvec"
                                       else 1e-10)


DIA_F64 = {
    "banded": lambda: band_matrix(3000, 5).tocsr(),
    "multihop_wide_band": lambda: sp.diags(
        [4.0] + [-1.0] * 4, [0, 1, -1, 900, -900], shape=(3000, 3000), format="csr"),
}


@pytest.mark.parametrize("name", DIA_F64)
def test_sharded_dia_f64(name, mesh):
    """The f64 ShardedDia, the card's pick for the finest levels, which the
    CPU's picker never builds (it keeps saena_tpu's f32 / bf16 DIA): built
    here from the structural plan, its halo slabs (multi-hop on the wide
    band), K1's plain version over each shard's rectangular block and the
    fused update with x_row0 in every variant, against scipy at rtol 1e-12,
    the padding rows zero."""
    A = DIA_F64[name]()
    plan = S.sharded_dia_plan(A, D, D, torch.float32, "cpu")
    assert plan is not None and S.sharded_dia_plan(A, D, D, F64, "cpu") is None
    _, n_loc, lo_pad, hi_pad, _ = plan
    if name == "multihop_wide_band":
        assert lo_pad > n_loc and hi_pad > n_loc
    M = S._build_sharded_dia(A, plan, F64, mesh)
    assert M.dtype == F64 and (lo_pad, hi_pad) == (M.lo_pad, M.hi_pad)
    n = A.shape[0]
    rng = np.random.default_rng(17)
    x, rhs, dinv = (rng.standard_normal(n) for _ in range(3))
    Ax, c = A @ x, 0.7

    def blocked(v):
        return torch.from_numpy(np.pad(v, (0, D * n_loc - n)).reshape(D, n_loc))

    def check(y, ref):
        y = y.numpy().reshape(-1)
        np.testing.assert_array_equal(y[n:], 0.0)
        np.testing.assert_allclose(y[:n], ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())

    for exact in (True, False):
        check(M.matvec(blocked(x), exact=exact), Ax)
    xb, rb, db = blocked(x), blocked(rhs), blocked(dinv)
    check(M.fused_update(xb, rb, db, c=c), x + c * dinv * (rhs - Ax))
    check(M.fused_update(xb, rb, db, c=c, add_x=False), c * dinv * (rhs - Ax))
    check(M.fused_update(xb, rb, c=c, add_x=False), c * (rhs - Ax))


def test_strip8_xla_matches_kernel():
    """test_strip8_xla_matches_kernel: the port's plain strip8 (the
    version K3 is held to) gives saena_tpu's strip8_spmv_xla on saena_tpu's
    layout, the same products folded alike (the row-block sums add in
    another order: rtol 1e-12, as tests/test_torch_strip8.py)."""
    from saena_tpu.ops.pallas_strip8_spmv import strip8_from_csr, strip8_spmv_xla
    from saena_tpu_torch.ops.strip8_spmv import Strip8Matrix, strip8_spmv_plain

    rng = np.random.default_rng(7)
    A = sp.random(600, 900, density=0.02, random_state=rng, format="csr")
    A.sort_indices()
    J = strip8_from_csr(A, dtype=jnp.float64)
    t = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt))
    M = Strip8Matrix(t(J.idx, np.int8), t(J.vals, np.float64), t(J.strips, np.int32),
                     t(J.gather_idx, np.int32), J.shape, J.nnz, J.perrow, J.mode,
                     J.n_cols_pad, J.n_out)
    x = rng.standard_normal(J.n_cols_pad)
    ref = np.asarray(strip8_spmv_xla(J, jnp.asarray(x)))
    np.testing.assert_allclose(strip8_spmv_plain(M, torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_int8_block_codec_roundtrip():
    """test_int8_block_codec_roundtrip on the port's codec (bit-equality
    with saena_tpu's: tests/test_torch_halo.py)."""
    from saena_tpu_torch.parallel.halo import int8_block_decode, int8_block_encode

    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.standard_normal((4, 512))
                         * 10.0 ** rng.integers(-8, 8, size=(4, 512)))
    buf = int8_block_encode(v)
    assert buf.dtype == torch.int8 and buf.shape == (4, 4, 129)
    out = int8_block_decode(buf, v.dtype)
    ch = v.numpy().reshape(4, 4, 128)
    amax = np.abs(ch).max(axis=-1, keepdims=True)
    assert (np.abs(out.numpy().reshape(4, 4, 128) - ch) <= amax / 127.0 + 1e-300).all()
    assert torch.equal(int8_block_encode(out), buf)       # idempotent
    z = int8_block_decode(int8_block_encode(torch.zeros(2, 256, dtype=F64)), F64)
    assert not z.any()


# ---------------------------------------------------------------------------
# the sharded pCG
# ---------------------------------------------------------------------------

R500 = dict(replicate_threshold=500)
# name: (problem, Options, dtype, sharded_format, tol, max_iter, check)
# check: "serial" = the port's serial iterations and u within 1e-10 (bsr:
# 1e-9, as the JAX test); "iters" = serial iterations; "true" = the true
# residual alone; ("near", other case, k) = within k iterations of it
SOLVES = {
    "pcg_matches_serial": ("p20", R500, F64, "auto", 1e-8, 100, "serial"),
    "pcg_compressed_halo": ("p20", dict(R500, compress_halo=True), F64, "auto",
                            1e-8, 100, "true"),
    "pcg_float8_halo": ("p20", dict(R500, compress_halo=True,
                                    halo_dtype="float8_e4m3fn"), F64, "auto",
                        1e-8, 100, "true"),
    "jacobi": ("p16", dict(R500, smoother="jacobi", preSmooth=2, postSmooth=2),
               F64, "auto", 1e-8, 150, "true"),
    "irregular_matrix": ("rand900", dict(replicate_threshold=400), F64, "auto",
                         1e-8, 300, "true"),
    "pcg_with_dense_level": ("p18", dict(replicate_threshold=300, dense_thre=0.005,
                                         dense_sz_thre=3000), F64, "auto", 1e-8,
                             100, "true"),
    "pcg_manual_shrink": ("p20", dict(replicate_threshold=300, shrink_values=(0, 2, 2)),
                          F64, "auto", 1e-8, 100, "serial"),
    "pcg_auto_shrink": ("p20", dict(replicate_threshold=300, shrink_comm_ratio=0.03),
                        F64, "auto", 1e-8, 100, "iters"),
    "pcg_bsr_format": ("p20", R500, F64, "bsr", 1e-8, 100, "serial"),
    "dia_poisson": ("p20", R500, torch.float32, "dia", 1e-6, 100, "true"),
    "pcg_int8_block_halo": ("p20", dict(R500, compress_halo=True,
                                        halo_dtype="int8_block"), F64, "auto",
                            1e-8, 100, ("near", "pcg_matches_serial", 2)),
    "smooth_dtype": ("p20", dict(R500, smooth_dtype="float32"), F64, "auto",
                     1e-8, 100, ("near", "pcg_matches_serial", 1)),
    "pcg_strip8_format": ("p20", R500, F64, "strip8", 1e-8, 100, "iters"),
    "dia_bf16_smooth_twin": ("p20", dict(R500, smooth_dtype="bfloat16"),
                             torch.float32, "dia", 1e-6, 100,
                             ("near", "dia_poisson", 1)),
}


@functools.lru_cache(maxsize=None)
def _solved(name, mesh, jmesh):
    problem, kw, dt, fmt, tol, max_iter, _ = SOLVES[name]
    A, rhs, sh, splits, jsh = sharded_pair(problem, mesh, jmesh, kw, dt, fmt)
    return A, rhs, sh, splits, jsh, solve(sh, splits, rhs, mesh, kw, tol, max_iter)


@pytest.mark.parametrize("name", list(SOLVES))
def test_sharded_pcg(name, mesh, jmesh):
    """The pCG tests of tests/test_parallel.py, one case each (the JAX
    test's name without its prefix), with its assertions."""
    problem, kw, dt, fmt, tol, max_iter, check = SOLVES[name]
    A, rhs, sh, splits, jsh, (u, iters, r0, rfin, hist) = _solved(name, mesh, jmesh)
    assert rel_true(A, rhs, u) < (1e-6 if problem == "rand900" else
                                  1e-5 if dt == torch.float32 else 1e-7)
    if check in ("serial", "iters"):
        it_s, u_s, _ = serial_solve(problem, tuple(sorted(kw.items())))
        assert iters == it_s
        if check == "serial":
            assert np.abs(u - u_s).max() < (1e-9 if fmt == "bsr" else 1e-10)
    elif isinstance(check, tuple):
        assert abs(iters - _solved(check[1], mesh, jmesh)[5][1]) <= check[2]
    if name == "pcg_matches_serial":
        assert len(sh.sharded) >= 2       # sharded-to-sharded transfers
    if name == "pcg_with_dense_level":
        assert "ShardedDense" in kinds(sh)
    if name == "pcg_manual_shrink":
        assert sh.d_active[:2] == (D, D // 2) and splits[1][D // 2] == splits[1][-1]
    if name == "pcg_auto_shrink":
        assert any(d < D for d in sh.d_active[1:]), sh.d_active
    if name == "pcg_bsr_format":
        assert set(kinds(sh)) <= {"ShardedBsr", "ShardedDense"} and "ShardedBsr" in kinds(sh)
    if name == "pcg_strip8_format":
        assert "ShardedStrip8" in kinds(sh)
    if name in ("dia_poisson", "dia_bf16_smooth_twin"):
        assert isinstance(sh.sharded[0].A, S.ShardedDia)
    if name == "dia_bf16_smooth_twin":
        assert sh.sharded[0].A_smooth.dtype == torch.bfloat16
    if name == "smooth_dtype":
        assert any(lv.A_smooth is not None for lv in sh.sharded)


def test_sharded_pcg_matches_jax(mesh, jmesh):
    """The acceptance case, test_sharded_pcg_matches_serial's problem with
    float_level past the hierarchy (saena_tpu's transition at float_level
    is the fault test_transition_keeps_the_vector_dtype shows): saena_tpu's
    sharded solve's iterations and history at rtol 1e-10, and its u, from
    the port's own hierarchy and from saena_tpu's carried across."""
    kw = dict(R500, float_level=100)
    A, rhs, sh, splits, jsh = sharded_pair("p20", mesh, jmesh, kw)
    assert kinds(sh) == ["ShardedEll", "ShardedEll", "ShardedDense"]
    ju, jit_, jr0, jrfin, jhist = JS.sharded_solve_pCG(
        jsh, splits, rhs, jmesh, params=JS.SolveParams.from_options(JOptions(**kw)),
        tol=1e-8, max_iter=100)
    carried_sh = load_sharded_hierarchy(*flatten_sharded(jsh), mesh, F64)
    for h in (sh, carried_sh):
        u, iters, r0, rfin, hist = solve(h, splits, rhs, mesh, kw)
        assert iters == int(jit_)
        np.testing.assert_allclose(hist, np.asarray(jhist), rtol=1e-10, equal_nan=True)
        np.testing.assert_allclose(u, np.asarray(ju), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(ju)).max())


def test_transition_keeps_the_vector_dtype(mesh, jmesh):
    """saena_tpu/parallel/sharded.py:1363 stores the transition (trans_R,
    trans_P) at low_dtype whenever the last sharded level's next level is
    at or past float_level, without float_storage, which keeps every other
    operator at the hierarchy's dtype (its serial devicify, and its own
    sharded levels). At 20^3 with replicate_threshold 500 (three sharded
    levels) its transition is f32 in an f64 hierarchy. The port stores it
    at the level dtype, so its sharded history is the serial one's."""
    A, rhs, sh, splits, jsh = _solved("pcg_matches_serial", mesh, jmesh)[:5]
    assert len(sh.sharded) == 3 >= Options().float_level
    assert jsh.trans_R.dtype == jnp.float32 and jsh.trans_P.dtype == jnp.float32
    assert sh.trans_R.dtype == F64 and sh.trans_P.dtype == F64
    hist = _solved("pcg_matches_serial", mesh, jmesh)[5][4]
    it_s, _, hist_s = serial_solve("p20", tuple(sorted(R500.items())))
    np.testing.assert_allclose(hist[: it_s + 1], hist_s[: it_s + 1], rtol=1e-10)
    f32 = S.shard_hierarchy(host_setup("p20")[2], Options(**R500, float_storage=True),
                            mesh, dtype=F64, eigs=host_setup("p20")[3])[0]
    assert f32.trans_R.dtype == torch.float32      # float_storage still reduces it


def test_sharded_pcg_dense_level_compressed_ring(mesh, jmesh):
    """test_sharded_pcg_dense_level_compressed_ring: the dense level's ring
    on a bf16 wire takes the uncompressed iterations, on int8_block at most
    one more."""
    kw0 = dict(replicate_threshold=300, dense_thre=0.005, dense_sz_thre=3000)
    it = {}
    for wire in (None, "bfloat16", "int8_block"):
        kw = dict(kw0, compress_halo=wire is not None, halo_dtype=wire or "bfloat16")
        A, rhs, sh, splits, _ = sharded_pair("p18", mesh, jmesh, kw)
        dense = [lv.A for lv in sh.sharded if isinstance(lv.A, S.ShardedDense)]
        assert dense and dense[0].compress == (wire or "")
        u, it[wire], *_ = solve(sh, splits, rhs, mesh, kw)
        assert rel_true(A, rhs, u) < 1e-7, wire
    assert it["bfloat16"] == it[None] and it["int8_block"] <= it[None] + 1


def test_measured_shrink_mode(mesh):
    """test_measured_shrink_mode: shrink_measure times dummy sharded
    matvecs per candidate; every pick is a valid subset and the solve
    converges (the pick is a timing, so it is not held to saena_tpu's)."""
    kw = dict(replicate_threshold=300, shrink_measure=True)
    A, rhs, info, eigs = host_setup("p16")
    sh, splits = S.shard_hierarchy(info, Options(**kw), mesh, dtype=F64, eigs=eigs)
    assert all(1 <= d <= D for d in sh.d_active)
    u, *_ = solve(sh, splits, rhs, mesh, kw)
    assert rel_true(A, rhs, u) < 1e-7
    A1 = info.csr_levels[1]
    t = S.measured_shrink_time(A1, tpart.subset_split(A1, D, D), F64, "exchange", mesh)
    assert 0 < t < 1.0


def test_measured_shrink_failure_warns_then_falls_back(mesh, monkeypatch):
    """The reference's bare ``except Exception`` (sharded.py:1238) swallows a
    failed measurement silently; the port warns, then takes the static
    ratio: the same picks as shrink_measure=False."""
    A, rhs, info, eigs = host_setup("p20")
    kw = dict(replicate_threshold=300, shrink_comm_ratio=0.03)

    def broken(*a, **k):
        raise RuntimeError("no timer")

    monkeypatch.setattr(S, "measured_shrink_time", broken)
    with pytest.warns(RuntimeWarning, match="measured shrinking of level 1 failed"):
        sh, _ = S.shard_hierarchy(info, Options(**kw, shrink_measure=True), mesh,
                                  dtype=F64, eigs=eigs)
    ref, _ = S.shard_hierarchy(info, Options(**kw), mesh, dtype=F64, eigs=eigs)
    assert sh.d_active == ref.d_active and any(d < D for d in sh.d_active[1:])


def test_sharded_lazy_update(mesh):
    """test_sharded_lazy_update: update_sharded_values after the port's
    update2 keeps the eig estimates and solves the updated system."""
    from saena_tpu_torch import AMG, Matrix

    A0, _ = _interior(16)
    A = Matrix()
    A.set_csr(A0)
    A.assemble(device="cpu", dtype=F64)
    solver = AMG(device="cpu", dtype=F64)
    opts = Options(**R500)
    solver.set_matrix(A, opts)
    sh0, _ = S.shard_hierarchy(solver.info, opts, mesh, dtype=F64)
    A1 = A0.copy()
    A1.data = A1.data * 1.001
    M1 = Matrix()
    M1.set_csr(A1)
    M1.assemble(device="cpu", dtype=F64)
    solver.update2(M1)
    sh1, splits1 = S.update_sharded_values(sh0, solver.info, opts, mesh, dtype=F64)
    assert [lv.eig_max for lv in sh1.sharded] == [lv.eig_max for lv in sh0.sharded]
    rhs1 = A1 @ np.ones(A1.shape[0])
    u, *_ = S.sharded_solve_pCG(sh1, splits1, rhs1, mesh, params=solver.params)
    assert rel_true(A1, rhs1, u) < 1e-7


# ---------------------------------------------------------------------------
# the sharded profile
# ---------------------------------------------------------------------------


def test_sharded_profile_rows(mesh, jmesh):
    """profile_sharded_matvecs on the CPU: a row a sharded level with its
    phases; compressed plans carry the codec's legs."""
    from saena_tpu_torch.profiling import format_sharded_profile, profile_sharded_matvecs

    for name in ("pcg_matches_serial", "pcg_int8_block_halo"):
        sh = _solved(name, mesh, jmesh)[2]
        rows = profile_sharded_matvecs(sh, mesh, n_iter=2)
        assert [r["level"] for r in rows] == list(range(len(sh.sharded)))
        assert all(r["device"] == "cpu" and r["total_us"] > 0 for r in rows)
        ell = [r for r in rows if r["format"] == "ShardedEll"]
        assert ell and all("pack_us" in r and "remote_us" in r for r in ell)
        assert all(("compress_us" in r) == (name != "pcg_matches_serial") for r in ell)
        assert len(format_sharded_profile(rows).splitlines()) == len(rows) + 1


def test_profile_masks_bsr_padding(mesh):
    """saena_tpu/profiling.py:400 counts padding BSR slots (chunk 0, zero
    blocks) as local references; the port's remote fraction counts real
    blocks only."""
    from saena_tpu_torch.profiling import remote_fraction

    A = random_symm_matrix(700, 0.01, seed=31)
    split = tpart.nnz_balanced_split(A, D)
    M = S._build_sharded_bsr(A, split, split, F64, "exchange", mesh)
    real = M.blocks.abs().amax(dim=(-2, -1)) != 0
    assert not real.all()                          # there is padding
    remote = M.bcols >= M.plan.n_local // 128
    assert remote_fraction(M) == pytest.approx(
        float(remote[real].sum()) / float(real.sum()))
    assert remote_fraction(M) > float(remote.float().mean())   # the fault's count


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_sharded_graph_solve_matches_uncaptured_loop():
    """On the card: the sharded pCG (48^3's little sister, 20^3, 4 shards,
    the card's picks) as graph replays is bit-equal to the same loop run
    uncaptured, with equal launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from saena_tpu_torch.runtime import launches_of

    A, rhs = _interior(20)
    _, info = th.setup(A, Options(), dtype=F64, device="cuda")
    cmesh = Mesh(4, "cuda")
    sh, splits = S.shard_hierarchy(info, Options(**R500), cmesh, dtype=F64)
    runs = []
    for g in (False, True, True):
        runs.append(launches_of(
            lambda: S.sharded_solve_pCG(sh, splits, rhs, cmesh, graphs=g)))
        torch.cuda.synchronize()
    (u0, it0, *_, h0), l0 = runs[0]
    for (u, it, *_, h), l in runs[1:]:
        assert it == it0 and np.array_equal(u, u0)
        np.testing.assert_array_equal(h, h0)
        assert l == l0
