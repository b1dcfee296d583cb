"""The DIA kernel's launch plan (ops/dia_spmv.dia_plan), on the CPU.

The plan is a pure function of (offsets, n_pad, dtype, SM count); the
kernel (csrc/dia_spmv.cu) follows it without checks of its own, so these
tests hold the plan to what the kernel needs: every row computed exactly
once, the diagonal groups a partition of the diagonals, the grid within
the card's limits, and every staged x window covering what its diagonals
read. The 48^3 Poisson solve's two DIA shapes (levels 0 and 1) must get
the intended diagonal groups.
"""
import numpy as np
import pytest
import torch

from saena_tpu_torch.ops import dia_spmv as dmod
from saena_tpu_torch.ops.dia_spmv import dia_plan

L0_OFFSETS = (-2116, -46, -1, 0, 1, 46, 2116)
L0_N_PAD = 97408
# the 101 diagonals of the 48^3 hierarchy's level 1: 9 clusters of at most
# +-92 around 0, +-1058, +-2116, +-3174, +-4232
L1_OFFSETS = (
    -4232, -3197, -3175, -3174, -3173, -3151, -2162, -2140, -2139, -2138,
    -2117, -2116, -2115, -2094, -2093, -2092, -2070, -1127, -1105, -1104,
    -1103, -1082, -1081, -1080, -1060, -1059, -1058, -1057, -1056, -1036,
    -1035, -1034, -1013, -1012, -1011, -989, -92, -70, -69, -68, -47, -46,
    -45, -25, -24, -23, -22, -21, -2, -1, 0, 1, 2, 21, 22, 23, 24, 25, 45,
    46, 47, 68, 69, 70, 92, 989, 1011, 1012, 1013, 1034, 1035, 1036, 1056,
    1057, 1058, 1059, 1060, 1080, 1081, 1082, 1103, 1104, 1105, 1127, 2070,
    2092, 2093, 2094, 2115, 2116, 2117, 2138, 2139, 2140, 2162, 3151, 3173,
    3174, 3175, 3197, 4232)
L1_N_PAD = 48768
DTYPES = [torch.float32, torch.float64, torch.bfloat16]
GRID_MAX = 2**31 - 1


def _check(plan, offsets, n_pad):
    """The plan's invariants; returns nothing, asserts."""
    nd = len(offsets)
    assert plan.offsets == tuple(offsets) and plan.n_pad == n_pad
    # every row exactly once
    V = plan.rows_per_lane
    starts = plan.lane_rows()
    rows = (starts[:, None] + np.arange(V)).reshape(-1)
    assert rows.size == n_pad
    assert np.array_equal(np.sort(rows), np.arange(n_pad))
    # the groups partition the diagonals, none empty
    gp = plan.group_ptr
    assert len(gp) == plan.groups + 1 and gp[0] == 0 and gp[-1] == nd
    assert all(a < b for a, b in zip(gp, gp[1:]))
    # the card's limits
    assert 1 <= plan.grid <= GRID_MAX
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    if plan.config == "rows":
        return
    assert plan.threads <= dmod.MAX_THREADS
    assert 1 <= plan.groups <= dmod.MAX_GROUPS and nd <= dmod.MAX_DIAGS
    assert plan.smem_bytes <= dmod.SMEM_BLOCK
    assert len(plan.windows) <= dmod.MAX_WINDOWS
    # the packed form the kernel reads
    head = [dmod._CONFIG_CODE[plan.config], plan.groups, plan.row_warps, plan.grid,
            plan.units, nd, len(plan.windows), plan.smem_bytes]
    tail = list(plan.woff) + [v for w in plan.windows for v in w]
    assert plan.packed.dtype == np.int32
    assert plan.packed.tolist() == head + list(gp) + list(offsets) + tail
    assert plan.packed_ptr == plan.packed.ctypes.data


@pytest.mark.parametrize("dtype", DTYPES)
def test_level0_plan(dtype):
    """7 diagonals, one group: the row kernel; forced onto the tiled kernel,
    one group, one round and a 16-byte row run per lane."""
    plan = dia_plan(L0_OFFSETS, L0_N_PAD, dtype)
    _check(plan, L0_OFFSETS, L0_N_PAD)
    assert plan.config == "rows" and plan.groups == 1
    tiled = dia_plan(L0_OFFSETS, L0_N_PAD, dtype, config="l1")
    _check(tiled, L0_OFFSETS, L0_N_PAD)
    assert tiled.groups == 1 and tiled.rounds == 1
    assert tiled.rows_per_lane * torch.empty(0, dtype=dtype).element_size() == 16


@pytest.mark.parametrize("dtype", DTYPES)
def test_level1_plan(dtype):
    """101 diagonals: 4 to 8 groups, one round, and no SM holding more than
    one unit over the even share."""
    plan = dia_plan(L1_OFFSETS, L1_N_PAD, dtype)
    _check(plan, L1_OFFSETS, L1_N_PAD)
    assert plan.config == ("l1" if dtype == torch.float64 else "smem")
    assert 4 <= plan.groups <= 8
    assert plan.rounds == 1
    per_sm = -(-plan.grid // dmod.H100_SMS) * plan.row_warps
    assert per_sm <= -(-plan.units // dmod.H100_SMS) + plan.row_warps


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_ndiag_gets_a_valid_plan(dtype):
    """ndiag 1..300 (up to CHUNK and over MAX_DIAGS the row kernel takes
    it), random offsets, odd n_pad multiples of 128; each forced
    configuration too."""
    rng = np.random.default_rng(0)
    for nd in range(1, 301):
        n_pad = 128 * int(rng.integers(1, 60))
        offs = tuple(sorted(rng.choice(np.arange(-3 * n_pad, 3 * n_pad), nd,
                                       replace=False).tolist()))
        plan = dia_plan(offs, n_pad, dtype)
        _check(plan, offs, n_pad)
        assert (plan.config == "rows") == (nd <= dmod.CHUNK or nd > dmod.MAX_DIAGS)
        for cfg in ("l1", "smem", "rows"):
            try:
                forced = dia_plan(offs, n_pad, dtype, config=cfg)
            except ValueError:          # windows too large to stage
                assert cfg == "smem"
                continue
            _check(forced, offs, n_pad)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forced_groups_and_row_warps(dtype):
    for G in range(1, dmod.MAX_GROUPS + 1):
        for W in (1, 2, 4, 8):
            if 32 * G * W > dmod.MAX_THREADS:
                with pytest.raises(ValueError):
                    dia_plan(L1_OFFSETS, L1_N_PAD, dtype, groups=G, row_warps=W)
                continue
            plan = dia_plan(L1_OFFSETS, L1_N_PAD, dtype, groups=G, row_warps=W)
            _check(plan, L1_OFFSETS, L1_N_PAD)
            assert (plan.groups, plan.row_warps) == (G, W)
    with pytest.raises(ValueError):
        dia_plan(L0_OFFSETS, L0_N_PAD, dtype, groups=8)       # 8 groups, 7 diagonals
    with pytest.raises(ValueError):
        dia_plan(L0_OFFSETS, L0_N_PAD, dtype, config="tma")


def _emulate_staged_reads(plan, offsets, x, xv):
    """For every block, round, active lane and diagonal: the V values the
    kernel reads from its staged windows, and what it should read
    (x[i + off + r], 0 outside x). The windows are filled as the kernel's
    cp.async loop fills them."""
    V, W = plan.rows_per_lane, plan.row_warps
    m_pad = x.size
    total = sum(w[1] for w in plan.windows)
    woff = np.asarray(plan.woff)
    offs = np.asarray(offsets)
    nv = V // xv + 1
    for b in range(plan.grid):
        ulo, uhi = plan.unit_range(b)
        for rd in range(-(-(uhi - ulo) // W)):
            row0 = (ulo + rd * W) * 32 * V
            xs = np.full(total, np.nan)
            for lo, length, base in plan.windows:
                a = row0 + lo + np.arange(length)
                inside = (a >= 0) & (a < m_pad)
                xs[base:base + length] = np.where(inside, x[np.clip(a, 0, m_pad - 1)], 0.0)
            u = ulo + rd * W + np.arange(W)
            i = (u[:, None] * 32 * V + np.arange(32) * V).reshape(-1)
            i = i[(np.repeat(u, 32) < uhi) & (i < plan.n_pad)]
            local = i - row0
            j0 = local[:, None] + woff[None, :]                     # (lanes, ndiag)
            a0 = (j0 // xv) * xv
            # the vectors read must lie in the staged array
            assert a0.min() >= 0 and (a0 + nv * xv).max() <= total
            got = xs[j0[..., None] + np.arange(V)]
            j = i[:, None, None] + offs[None, :, None] + np.arange(V)
            want = np.where((j >= 0) & (j < m_pad), x[np.clip(j, 0, m_pad - 1)], 0.0)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["level1", "rect", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_staged_windows_hold_what_each_diagonal_reads(case, dtype):
    rng = np.random.default_rng(3)
    if case == "level1":
        offs, n_pad, m_pad = L1_OFFSETS, 9216, 9216
    elif case == "rect":          # halo-extended x, as the sharded DIA reads it
        offs, n_pad, m_pad = (-5, 255, 256, 257, 385), 4096, 256 + 4096 + 128
    else:
        n_pad = m_pad = 2560
        offs = tuple(sorted(rng.choice(np.arange(-2 * n_pad, 2 * n_pad), 40,
                                       replace=False).tolist()))
    plan = dia_plan(offs, n_pad, dtype, config="smem")
    _check(plan, offs, n_pad)
    x = rng.standard_normal(m_pad)
    _emulate_staged_reads(plan, offs, x, 16 // torch.empty(0, dtype=dtype).element_size())


def test_wrapper_runs_the_plain_version_on_cpu_with_any_plan():
    """A plan changes how the card launches, never what the CPU computes."""
    rng = np.random.default_rng(1)
    data = torch.from_numpy(rng.standard_normal((len(L0_OFFSETS), 4096)))
    x = torch.from_numpy(rng.standard_normal(4096))
    ref = dmod.dia_spmv_plain(data, x, L0_OFFSETS)
    for cfg in dmod.CONFIGS:
        plan = dia_plan(L0_OFFSETS, 4096, torch.float64, config=cfg)
        assert torch.equal(dmod.dia_spmv(data, x, L0_OFFSETS, plan=plan), ref)


@pytest.mark.parametrize("wrong", ["offsets", "n_pad", "dtype"])
def test_wrapper_raises_on_a_plan_for_another_operator(wrong):
    """The tiled kernel reads its offsets from the plan: a plan made for other
    offsets (same count), other rows or another data dtype must raise, on
    the CPU as on the card."""
    rng = np.random.default_rng(2)
    data = torch.from_numpy(rng.standard_normal((len(L0_OFFSETS), 4096)))
    x = torch.from_numpy(rng.standard_normal(4096))
    offs, n_pad, dtype = L0_OFFSETS, 4096, torch.float64
    if wrong == "offsets":
        offs = tuple(o + 1 for o in L0_OFFSETS)
    elif wrong == "n_pad":
        n_pad = 8192
    else:
        dtype = torch.float32
    plan = dia_plan(offs, n_pad, dtype, config="l1")
    with pytest.raises(ValueError, match="plan is for another"):
        dmod.dia_spmv(data, x, L0_OFFSETS, plan=plan)
    # the plan of the operator itself passes, as a tuple of its own or a list
    ref = dmod.dia_spmv_plain(data, x, L0_OFFSETS)
    for cfg in dmod.CONFIGS:
        good = dia_plan(L0_OFFSETS, 4096, torch.float64, config=cfg)
        assert torch.equal(dmod.dia_spmv(data, x, list(L0_OFFSETS), plan=good), ref)
