"""Options.smooth_dtype in the port against saena_tpu, on the CPU.

- Every format's twin (DIA, dense, ELL, BSR, strip, strip8) built at
  float32 beside an f64 operator equals saena_tpu's twin value for value,
  its index arrays are the operator's own, and the operator is unchanged.
  At bfloat16 the twins agree within one bf16 ulp, compared in f32 (the two
  frameworks round f64 to bf16 by different routes).
- Each package's own setup at 16^3 gives the same level formats and the
  same twins per level (none on the coarsest level, none at the level's
  own dtype); convert.load_hierarchy carries saena_tpu's twins across,
  f32 and bf16, value for value.
- pCG with smooth_dtype="float32" takes saena_tpu's iterations. Its
  histories agree at rtol 1e-5: the f32 twins' ELL and dense products sum
  in another order than XLA's (2e-7 relative a product), which moves the
  f64 history by up to 1.4e-6 (measured) on each package's own setup, as
  tests/test_torch_solve.py's float_storage case allows 1e-5 for f32
  operators.
- The plain bf16 strip / strip8 versions equal the f32 plain versions on
  the upcast values, bit for bit.

Card (marker ``cuda``, skipped without one): the bf16 strip / strip8
kernels on both paths against their plain versions (row-sum-scaled error
<= 1e-5: f32 accumulation in another order), two launches bit-equal.
"""
import copy
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.amg import solvers as tsolvers
from saena_tpu_torch.config import Options
from saena_tpu_torch.convert import load_hierarchy
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.generators import laplacian3D
from saena_tpu_torch.ops import formats as tf
from saena_tpu_torch.ops import strip8_spmv as t8
from saena_tpu_torch.ops import strip_spmv as t1

F64 = dict(dtype=torch.float64, device="cpu")
VALUES = {"DiaMatrix": ("data",), "DenseMatrix": ("data",),
          "EllMatrix": ("vals", "spill_vals"), "BsrMatrix": ("blocks",),
          "StripMatrix": ("vals",), "Strip8Matrix": ("vals",)}
INDICES = {"DiaMatrix": (), "DenseMatrix": (),
           "EllMatrix": ("cols", "spill_rows", "spill_cols"),
           "BsrMatrix": ("bcols",),
           "StripMatrix": ("idx", "strip_of", "rb_local", "sb_of"),
           "Strip8Matrix": ("idx", "strips", "gather_idx")}


@pytest.fixture(scope="module")
def jx():
    """saena_tpu's pieces, imported here so that the card's tests of this
    file also run where JAX is not installed."""
    import jax.numpy as jnp

    from saena_tpu import _native
    from saena_tpu.amg import hierarchy as jh
    from saena_tpu.amg import solvers as jsolvers
    from saena_tpu.config import Options as JOptions
    from saena_tpu.ops import formats as jf
    from saena_tpu.ops import pallas_strip8_spmv as js8
    from saena_tpu.ops import pallas_strip_spmv as js1
    from test_torch_solve import flatten_hierarchy

    return types.SimpleNamespace(jnp=jnp, native=_native, jh=jh,
                                 jsolvers=jsolvers, JOptions=JOptions, jf=jf,
                                 js1=js1, js8=js8, flatten=flatten_hierarchy)


def _interior(m):
    return remove_boundary_nodes(laplacian3D(m, m, m))[0].tocsr()


@pytest.fixture(scope="module")
def levels():
    """The host levels of the 16^3 Poisson interior."""
    return th.setup(_interior(16), Options(setup_shards=0), **F64)[1].csr_levels


def _builders(jx, A, monkeypatch):
    """{format: (saena_tpu builder, port builder)}, each fn(dtype,
    smooth_dtype) -> (M, twin); strip8 on the same general-mode plan in
    both packages (perrow 2)."""
    monkeypatch.setattr(jx.native, "strip8_plan_core", lambda *a, **k: None)
    B = A.copy()
    coo = B.tocoo()
    B._saena_strip8_plan = ((B.shape, B.nnz), (
        coo, jx.js8._plan8_one(coo, *A.shape, 2, "general")))
    return {
        "DiaMatrix": (lambda d, s: jx.jf.dia_from_csr(A, d, smooth_dtype=s),
                      lambda d, s: tf.dia_from_csr(A, d, "cpu", smooth_dtype=s)),
        "DenseMatrix": (lambda d, s: jx.jf.dense_from_csr(A, d, smooth_dtype=s),
                        lambda d, s: tf.dense_from_csr(A, d, "cpu",
                                                       smooth_dtype=s)),
        "EllMatrix": (lambda d, s: jx.jf.ell_from_csr(
                          A, d, width_quantile=0.98, smooth_dtype=s),
                      lambda d, s: tf.ell_from_csr(
                          A, d, "cpu", width_quantile=0.98, smooth_dtype=s)),
        "BsrMatrix": (lambda d, s: jx.jf.bsr_from_csr(A, d, smooth_dtype=s),
                      lambda d, s: tf.bsr_from_csr(A, d, "cpu", smooth_dtype=s)),
        "StripMatrix": (lambda d, s: jx.js1.strip_from_csr(
                            A, d, perrow=4, smooth_dtype=s),
                        lambda d, s: t1.strip_from_csr(
                            A, d, "cpu", perrow=4, smooth_dtype=s)),
        "Strip8Matrix": (lambda d, s: jx.js8.strip8_from_csr(
                             B, d, smooth_dtype=s),
                         lambda d, s: t8.strip8_from_csr(
                             A, d, "cpu", perrow=2, smooth_dtype=s)),
    }


def _bf16_within_one_ulp(got, ref):
    """|got - ref| <= one bf16 ulp of ref, in f32."""
    ulp = np.where(ref == 0, 0.0, 2.0 ** (np.floor(np.log2(
        np.abs(np.where(ref == 0, 1.0, ref)))) - 7))
    assert (np.abs(got - ref) <= ulp).all(), float(np.abs(got - ref).max())


# the fine level for DIA, the coarse level for dense, the first
# coarse level for the gather formats
LEVEL_OF = {"DiaMatrix": 0, "DenseMatrix": 2, "EllMatrix": 1, "BsrMatrix": 1,
            "StripMatrix": 1, "Strip8Matrix": 1}


@pytest.mark.parametrize("fmt", sorted(VALUES))
@pytest.mark.parametrize("twin", ["float32", "bfloat16"])
def test_twin_matches_saena_tpu(fmt, twin, levels, jx, monkeypatch):
    A = levels[LEVEL_OF[fmt]]
    jb, tb = _builders(jx, A, monkeypatch)[fmt]
    JM, JS = jb(jx.jnp.float64, getattr(jx.jnp, twin))
    TM, TS = tb(torch.float64, getattr(torch, twin))
    assert type(TM).__name__ == type(TS).__name__ == fmt
    assert TS.dtype == getattr(torch, twin) and TM.dtype == torch.float64
    assert TS.shape == TM.shape == tuple(JS.shape) and TS.nnz == TM.nnz
    for f in INDICES[fmt]:
        assert getattr(TS, f) is getattr(TM, f), f
        np.testing.assert_array_equal(getattr(TS, f).numpy(),
                                      np.asarray(getattr(JS, f)), err_msg=f)
    for f in VALUES[fmt]:
        np.testing.assert_array_equal(getattr(TM, f).numpy(),
                                      np.asarray(getattr(JM, f)), err_msg=f)
        got = getattr(TS, f).float().numpy()
        ref = np.asarray(getattr(JS, f)).astype(np.float32)
        if twin == "float32":
            np.testing.assert_array_equal(got, ref, err_msg=f)
        else:
            _bf16_within_one_ulp(got, ref)


def test_device_matrix_from_csr_returns_the_picked_format_and_its_twin(levels):
    """The twin follows M's format pick on both branches (prefer_bsr=True
    reaches the card's branch on the CPU)."""
    for A in levels:
        for prefer in (None, True):
            kw = dict(prefer_bsr=prefer)
            M = tf.device_matrix_from_csr(A, torch.float64, "cpu", **kw)
            M2, S = tf.device_matrix_from_csr(A, torch.float64, "cpu",
                                              smooth_dtype=torch.bfloat16, **kw)
            assert type(M) is type(M2) is type(S)
            assert S.dtype == torch.bfloat16


def _twins(hier):
    return [(type(L.A).__name__,
             None if L.A_smooth is None else str(L.A_smooth.dtype).split(".")[-1])
            for L in hier.levels]


@pytest.mark.parametrize("opts", [dict(smooth_dtype="float32"),
                                  dict(smooth_dtype="bfloat16"),
                                  dict(smooth_dtype="float32",
                                       aggregation="double")])
def test_levels_carry_saena_tpu_twins(opts, jx):
    A = _interior(16)
    JH, _ = jx.jh.setup(A, jx.JOptions(**opts), dtype=jx.jnp.float64)
    TH, _ = th.setup(A, Options(setup_shards=0, **opts), **F64)
    assert _twins(TH) == _twins(JH)
    assert _twins(TH)[-1][1] is None
    assert all(t == opts["smooth_dtype"] for _, t in _twins(TH)[:-1])
    # carried across: the same twins, value for value
    C = load_hierarchy(*jx.flatten(JH), **F64)
    assert _twins(C) == _twins(JH)
    for L, J in zip(C.levels, JH.levels):
        if L.A_smooth is not None:
            for f in VALUES[type(L.A_smooth).__name__]:
                np.testing.assert_array_equal(
                    getattr(L.A_smooth, f).float().numpy(),
                    np.asarray(getattr(J.A_smooth, f)).astype(np.float32))


def test_twin_at_the_level_dtype_is_not_built():
    A = _interior(12)
    TH, _ = th.setup(A, Options(setup_shards=0, smooth_dtype="float64"), **F64)
    assert all(L.A_smooth is None for L in TH.levels)


def test_pcg_with_f32_twins_matches_saena_tpu(jx):
    A = _interior(16)
    rhs = A @ np.ones(A.shape[0])
    JH, _ = jx.jh.setup(A, jx.JOptions(smooth_dtype="float32"),
                        dtype=jx.jnp.float64)
    TH, _ = th.setup(A, Options(setup_shards=0, smooth_dtype="float32"), **F64)
    rp = np.pad(rhs, (0, TH.n_pad - A.shape[0]))
    ref = jx.jsolvers.solve_pCG(JH, rp, tol=1e-8)
    res = tsolvers.solve_pCG(TH, rp, tol=1e-8)
    it = int(ref.iters)
    assert res.iters == it and float(res.rel_res) < 1e-8
    np.testing.assert_allclose(res.history[: it + 1].numpy(),
                               np.asarray(ref.history)[: it + 1], rtol=1e-5)
    # the twins sit in the V-cycle only: the outer method sees A
    base = tsolvers.solve_pCG(th.setup(A, Options(setup_shards=0), **F64)[0],
                              rp, tol=1e-8)
    assert abs(res.iters - base.iters) <= 1


def _strip_cases():
    rng = np.random.default_rng(5)
    A = sp.random(700, 900, density=0.03, random_state=rng, format="csr")
    A.sort_indices()
    out = {f"strip_pr{pr}": (t1, t1.strip_from_csr(A, torch.float32, "cpu",
                                                   perrow=pr))
           for pr in (1, 2, 4, 8, 16)}
    for pr in (1, 2, 4):
        for mode in ("general", "interval"):
            out[f"strip8_{mode}_pr{pr}"] = (t8, t8.strip8_from_csr(
                A, torch.float32, "cpu", perrow=pr, mode=mode))
    return A, out


def test_plain_bf16_equals_f32_plain_on_upcast_values():
    A, cases = _strip_cases()
    x = torch.from_numpy(np.pad(np.random.default_rng(6).standard_normal(900),
                                (0, 124))).float()
    for name, (mod, M) in cases.items():
        plain = getattr(mod, "strip_spmv_plain" if mod is t1 else "strip8_spmv_plain")
        Mb = M.with_vals(M.vals.to(torch.bfloat16))
        up = M.with_vals(Mb.vals.float())
        y = plain(Mb, x)
        assert y.dtype == torch.float32
        assert torch.equal(y, plain(up, x)), name
        assert torch.equal(Mb.matvec(x), up.matvec(x)), name


# ------------------------------------------------------------- the card --


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rows", "stream"])
def test_cuda_bf16_kernels_match_plain(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    A, cases = _strip_cases()
    x = torch.from_numpy(np.pad(np.random.default_rng(6).standard_normal(900),
                                (0, 124))).float().to(dev)
    for name, (mod, M) in cases.items():
        build = t1.strip_from_csr if mod is t1 else t8.strip8_from_csr
        kw = dict(perrow=M.perrow) if mod is t1 else dict(perrow=M.perrow,
                                                          mode=M.mode)
        _, Mb = build(A, torch.float32, dev, smooth_dtype=torch.bfloat16, **kw)
        Mb = copy.copy(Mb)
        if path == "stream":
            Mb.rechunk()
        else:
            Mb.chunks = None
        kern = mod.strip_spmv if mod is t1 else mod.strip8_spmv
        plain = mod.strip_spmv_plain if mod is t1 else mod.strip8_spmv_plain
        y = kern(Mb, x)
        assert torch.equal(y, kern(Mb, x)), name
        ref = plain(Mb, x)
        scale = plain(Mb.with_vals(Mb.vals.abs()), x.abs()).clamp_min(1e-30)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32
        assert float(((y - ref).abs() / scale).max()) <= 1e-5, name
