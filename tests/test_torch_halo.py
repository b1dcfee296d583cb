"""The port's halo plans and wire codec (saena_tpu_torch/parallel/halo.py)
against saena_tpu/parallel/halo.py on the same numpy inputs, made from a
seed:

- the int8_block codec: the wire buffer bit-equal to saena_tpu's, f32 and
  f64, zero chunks and values across 16 decades; the port decodes exactly
  (q * 2^e), where saena_tpu's decode is within 64 ulps of it (XLA's exp2
  on the CPU is not exact at integer exponents: up to about 30 ulps in
  f32);
- build_halo_plan in the exchange, allgather and direct modes, with and
  without the int8_block padding of max_send: equal send_idx, n_local,
  max_send, and equal remaps of every column each shard references (the
  port's remap is a vectorised lookup where saena_tpu's loops per element);
- the plan's exchange on the stacked shards: the extended vector of every
  shard is [own block | what each other shard packed for it].
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saena_tpu.generators import random_symm_matrix
from saena_tpu.parallel import halo as jhalo
from saena_tpu.parallel.partition import nnz_balanced_split

from saena_tpu_torch.parallel import halo as thalo
from saena_tpu_torch.parallel.comm import Mesh

D = 8


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_int8_block_codec_matches_saena_tpu(dtype):
    rng = np.random.default_rng(11)
    v = (rng.standard_normal((3, 5, 384))
         * 10.0 ** rng.integers(-8, 8, size=(3, 5, 384))).astype(dtype)
    v[1, 2, 128:256] = 0.0                       # a zero chunk
    ref = np.asarray(jhalo.int8_block_encode(jnp.asarray(v)))
    buf = thalo.int8_block_encode(torch.from_numpy(v))
    np.testing.assert_array_equal(buf.numpy(), ref)
    exact = np.ldexp(ref[..., :128].astype(dtype),
                     ref[..., 128:].astype(np.int32)).reshape(v.shape)
    out = thalo.int8_block_decode(buf, getattr(torch, np.dtype(dtype).name)).numpy()
    np.testing.assert_array_equal(out, exact)
    jout = np.asarray(jhalo.int8_block_decode(jnp.asarray(ref), dtype))
    np.testing.assert_allclose(jout, exact, rtol=64 * np.finfo(dtype).eps, atol=0)


def _rowcols(A, split):
    return [np.unique(A[split[d]: split[d + 1]].indices) for d in range(D)]


@pytest.mark.parametrize("mode,compress", [("exchange", ""),
                                           ("exchange", "int8_block"),
                                           ("allgather", ""), ("direct", "")])
def test_build_halo_plan_matches_saena_tpu(mode, compress):
    A = random_symm_matrix(700, 0.01, seed=11)
    split = nnz_balanced_split(A, D)
    rowcols = _rowcols(A, split)
    jplan, jremap = jhalo.build_halo_plan(rowcols, split, mode=mode,
                                          compress=compress)
    send_idx, n_local, max_send, remap = thalo.build_halo_plan(
        rowcols, split, mode=mode, compress=compress)
    np.testing.assert_array_equal(send_idx, np.asarray(jplan.send_idx))
    assert (n_local, max_send) == (jplan.n_local, jplan.max_send)
    for d in range(D):
        np.testing.assert_array_equal(remap(d, rowcols[d]), jremap(d, rowcols[d]))
    if mode == "exchange":
        with pytest.raises(KeyError):       # a column outside the plan
            outside = np.setdiff1d(np.arange(700), rowcols[0])
            remap(0, outside[(outside < split[0]) | (outside >= split[1])][:1])


@pytest.mark.parametrize("compress", ["", "bfloat16", "int8_block"])
def test_extend_gives_every_shard_its_halo(compress):
    A = random_symm_matrix(700, 0.01, seed=11)
    split = nnz_balanced_split(A, D)
    rowcols = _rowcols(A, split)
    send_idx, n_local, max_send, remap = thalo.build_halo_plan(
        rowcols, split, compress=compress)
    plan = thalo.plan_on(Mesh(D, "cpu"), send_idx, n_local, max_send, "exchange",
                         compress)
    x = np.random.default_rng(2).standard_normal(700)
    xb = np.zeros((D, n_local))
    for d in range(D):
        xb[d, : split[d + 1] - split[d]] = x[split[d]: split[d + 1]]
    ext = plan.extend(torch.from_numpy(xb)).numpy()
    exact = plan.extend(torch.from_numpy(xb), exact=True).numpy()
    assert ext.shape == (D, n_local + D * max_send)
    for d in range(D):
        got = ext[d][remap(d, rowcols[d])]
        np.testing.assert_array_equal(exact[d][remap(d, rowcols[d])], x[rowcols[d]])
        if compress:
            np.testing.assert_allclose(got, x[rowcols[d]], rtol=2 ** -7,
                                       atol=np.abs(x).max() / 127)
        else:
            np.testing.assert_array_equal(got, x[rowcols[d]])
