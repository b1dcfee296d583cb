"""The port's DIA SpMV / fused update against saena_tpu's.

- plain PyTorch version vs ``DiaMatrix.matvec_xla`` and ``_dia_rect_xla``
  in f64: rtol 1e-12 (same products, summed in another order);
- plain version vs the Pallas kernel in interpret mode in f32, as
  tests/test_dia_spmv.py runs it: rtol/atol 2e-5 (f32 rounding);
- the CUDA kernel vs the plain version on a card (skips without one):
  row-sum-scaled error 1e-5 in f32, 1e-12 in f64 (FMA contraction), in
  every configuration of its plan (ops/dia_spmv.dia_plan), two launches
  bit-equal, and x, rhs and dinv as views that are not 16-byte aligned
  bit-equal to the aligned call.
"""
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.generators import band_matrix, laplacian3D
from saena_tpu_torch.ops import dia_spmv as dmod
from saena_tpu_torch.ops import formats as tf
from saena_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
from saena_tpu_torch.runtime import launches_of
from test_torch_dia_plan import L1_OFFSETS


@pytest.fixture(scope="module")
def jx():
    """saena_tpu's DIA pieces. Imported here rather than at the top so the
    CUDA-only tests of this file also run where JAX is not installed."""
    import jax.numpy as jnp

    from saena_tpu.ops import formats
    from saena_tpu.ops import pallas_dia_spmv as pallas
    from saena_tpu.parallel.sharded import _dia_rect_xla

    return types.SimpleNamespace(jnp=jnp, formats=formats, pallas=pallas,
                                 dia_rect_xla=_dia_rect_xla)


def _poisson(m):
    return remove_boundary_nodes(laplacian3D(m, m, m))[0]


def _diags(n, offsets, seed):
    return sp.diags([np.random.default_rng(seed + k).standard_normal(n - abs(d))
                     for k, d in enumerate(offsets)], offsets, format="csr")


def _wide(n=2000):
    return _diags(n, [0, 1, -1, 300, -300, 1500, -1500], 0)


MATRICES = {
    "poisson10": lambda: _poisson(10),
    "band900": lambda: band_matrix(900, 3),
    "wide_offsets": _wide,
}

# (rhs, dinv, c, add_x): plain SpMV, Jacobi sweep, Chebyshev scaled
# residual, V-cycle residual
VARIANTS = {
    "spmv": (False, False, 1.0, False),
    "jacobi": (True, True, 2.0 / 3.0, True),
    "cheb": (True, True, 0.37, False),
    "residual": (True, False, -1.0, False),
}


def _vectors(n, n_pad, m_pad, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros(m_pad)
    x[: n if m_pad == n_pad else m_pad] = rng.standard_normal(
        n if m_pad == n_pad else m_pad)
    rhs = np.pad(rng.standard_normal(n), (0, n_pad - n))
    dinv = np.pad(rng.uniform(0.5, 1.5, n), (0, n_pad - n))
    return x, rhs, dinv


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plain_matches_matvec_xla_f64(name, jx):
    A = MATRICES[name]()
    D = jx.formats.dia_from_csr(A, dtype=jx.jnp.float64)
    x, _, _ = _vectors(A.shape[0], D.n_pad, D.n_pad, 0)
    ref = np.asarray(D.matvec_xla(jx.jnp.asarray(x)))
    y = dia_spmv_plain(torch.from_numpy(np.array(D.data)), torch.from_numpy(x),
                       D.offsets).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    assert (y[A.shape[0]:] == 0).all()


def test_plain_rectangular_matches_dia_rect_xla_f64(jx):
    rng = np.random.default_rng(3)
    n_loc, m_pad = 1024, 256 + 1024 + 128
    offs = (0, 255, 256, 257, 385)          # extended coordinates
    data = rng.standard_normal((len(offs), n_loc))
    x = rng.standard_normal(m_pad)
    ref = np.asarray(jx.dia_rect_xla(jx.jnp.asarray(data), jx.jnp.asarray(x), offs))
    y = dia_spmv_plain(torch.from_numpy(data), torch.from_numpy(x), offs).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", ["poisson10", "wide_offsets"])
def test_plain_matches_pallas_interpret_f32(name, variant, jx):
    has_rhs, has_dinv, c, add_x = VARIANTS[variant]
    A = MATRICES[name]()
    D = jx.formats.dia_from_csr(A)          # f32 data, as the kernel streams
    n = A.shape[0]
    x, rhs, dinv = (v.astype(np.float32) for v in _vectors(n, D.n_pad, D.n_pad, 1))
    if has_rhs:
        ref = jx.pallas.dia_fused_update(D.data, x, rhs, D.offsets,
                                         dinv=dinv if has_dinv else None, c=c,
                                         add_x=add_x, interpret=True)
    else:
        ref = jx.pallas.dia_spmv(D.data, x, D.offsets, interpret=True)
    ref = np.asarray(ref)
    t = torch.from_numpy
    y = dia_spmv_plain(t(np.array(D.data)), t(x), D.offsets,
                       rhs=t(rhs) if has_rhs else None,
                       dinv=t(dinv) if has_dinv else None, c=c, add_x=add_x)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert (y[n:] == 0).all()


@pytest.mark.parametrize("variant", ["spmv", "jacobi"])
def test_plain_rectangular_matches_pallas_interpret_f32(variant, jx):
    """Rectangular mode: a 1024-row block reading a halo-extended x, the
    x-add taking the block's own rows at x_row0 = 2 (256 elements in)."""
    has_rhs, has_dinv, c, add_x = VARIANTS[variant]
    rng = np.random.default_rng(4)
    n_loc, m_pad, x_row0 = 1024, 256 + 1024 + 128, 2
    offs = (-5, 255, 256, 257, 385)
    data = rng.standard_normal((len(offs), n_loc)).astype(np.float32)
    x = rng.standard_normal(m_pad).astype(np.float32)
    rhs = rng.standard_normal(n_loc).astype(np.float32)
    dinv = rng.uniform(0.5, 1.5, n_loc).astype(np.float32)
    j = jx.jnp.asarray
    if has_rhs:
        ref = jx.pallas.dia_fused_update(j(data), j(x), j(rhs), offs,
                                         dinv=j(dinv), c=c, add_x=add_x,
                                         x_row0=x_row0, interpret=True)
    else:
        ref = jx.pallas._dia_call(j(data), j(x), offs, interpret=True)
    t = torch.from_numpy
    y = dia_spmv_plain(t(data), t(x), offs, rhs=t(rhs) if has_rhs else None,
                       dinv=t(dinv) if has_dinv else None, c=c, add_x=add_x,
                       x_row0=x_row0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_bf16_data_plain_matches_pallas_interpret(jx):
    """bf16-stored diagonals: f32 x, accumulator and output on both sides,
    from the same bf16 values: rtol/atol 2e-5."""
    A = _poisson(9)
    D, Dsm = jx.formats.dia_from_csr(A, smooth_dtype=jx.jnp.bfloat16)
    n = A.shape[0]
    x, rhs, dinv = (v.astype(np.float32) for v in _vectors(n, D.n_pad, D.n_pad, 2))
    ref = np.asarray(jx.pallas.dia_fused_update(Dsm.data, x, rhs, Dsm.offsets,
                                                dinv=dinv, c=2 / 3, interpret=True))
    data_bf16 = torch.from_numpy(np.array(Dsm.data.astype(jx.jnp.float32))).to(
        torch.bfloat16)
    y = dia_spmv_plain(data_bf16, torch.from_numpy(x), Dsm.offsets,
                       rhs=torch.from_numpy(rhs), dinv=torch.from_numpy(dinv),
                       c=2 / 3, add_x=True)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_dia_matrix_uses_plain_on_cpu_without_counting():
    """On CPU tensors the wrapper runs the plain version, and
    runtime.launches counts kernel launches only."""
    A = _poisson(8)
    D = tf.dia_from_csr(A, torch.float64, "cpu")
    x, rhs, dinv = (torch.from_numpy(v) for v in
                    _vectors(A.shape[0], D.n_pad, D.n_pad, 5))
    (y, yv), made = launches_of(
        lambda: (D.fused_update(x, rhs, dinv=dinv, c=0.5), D.matvec(x)))
    ref = dia_spmv_plain(D.data, x, D.offsets, rhs=rhs, dinv=dinv, c=0.5,
                         add_x=True)
    assert torch.equal(y, ref)
    assert torch.equal(yv, dia_spmv_plain(D.data, x, D.offsets))
    assert not made


def test_wrapper_raises_on_other_devices():
    data = torch.zeros((1, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dia_spmv(data, torch.zeros(128, device="meta"), (0,))


CUDA_CASES = {
    "wide_offsets": _wide,
    "clustered101": lambda: _diags(9000, L1_OFFSETS, 20),
    "band300": lambda: _diags(3000, tuple(range(-150, 150)), 40),
}


def _unaligned(t):
    """The same values as a view whose storage starts one element in."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    store[1:] = t
    return store[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["auto", "l1", "l1_groups3", "smem", "rows"])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("dname", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cuda_kernel_matches_plain(variant, dname, case, config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    has_rhs, has_dinv, c, add_x = VARIANTS[variant]
    A = CUDA_CASES[case]()
    ddt = getattr(torch, dname)
    D = tf.dia_from_csr(A, ddt, "cuda")
    if len(D.offsets) > dmod.MAX_DIAGS and config not in ("auto", "rows"):
        pytest.skip(f"{len(D.offsets)} diagonals take the row kernel only")
    if config == "auto":
        plan = D.plan
    else:
        cfg, _, g = config.partition("_groups")
        plan = dmod.dia_plan(D.offsets, D.n_pad, ddt, dmod.sm_count("cuda"),
                             config=cfg, groups=int(g) if g else None)
    cdt = torch.promote_types(ddt, torch.float32)
    n = A.shape[0]
    x, rhs, dinv = (torch.from_numpy(v).to("cuda", cdt) for v in
                    _vectors(n, D.n_pad, D.n_pad, 6))
    kw = dict(rhs=rhs if has_rhs else None, dinv=dinv if has_dinv else None,
              c=c, add_x=add_x)
    yk, made = launches_of(lambda: dia_spmv(D.data, x, D.offsets, plan=plan, **kw))
    torch.cuda.synchronize()
    assert made["dia"] == 1
    assert torch.equal(yk, dia_spmv(D.data, x, D.offsets, plan=plan, **kw))
    kw_u = dict(kw, rhs=_unaligned(rhs) if has_rhs else None,
                dinv=_unaligned(dinv) if has_dinv else None)
    assert torch.equal(yk, dia_spmv(D.data, _unaligned(x), D.offsets, plan=plan,
                                    **kw_u))
    yp = dia_spmv_plain(D.data, x, D.offsets, **kw)
    scale = dia_spmv_plain(D.data.abs().double(), x.abs().double(), D.offsets)
    if has_rhs:
        scale = abs(c) * (rhs.abs().double() + scale)
        if has_dinv:
            scale = scale * dinv.abs().double()
        if add_x:
            scale = scale + x.abs().double()
    err = ((yk.double() - yp.double()).abs() / scale.clamp_min(1e-300)).max()
    assert float(err) <= (1e-12 if dname == "float64" else 1e-5)
    assert (yk[n:] == 0).all()
