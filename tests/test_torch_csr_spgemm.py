"""The row-wise SpGEMM "K5" (ops/csr_spgemm.py, csrc/csr_spgemm.cu) and the
route of the setup's Galerkin products (amg/galerkin.py).

On the CPU:
- the plain version equals the host kernel ``_native.spgemm_csr`` bit for
  bit (indptr, indices, values as uint64) on canonical operands with
  explicit and signed zeros, empty rows, a Y row ending at column m - 1,
  rows past the host's dense thresholds and a dense Y: the arithmetic the
  kernel repeats;
- the route is a pure function of the device, the multiply-adds and the
  canonical form, so a CPU setup takes the host kernel for every product,
  and records each with its level, engine and multiply-adds;
- the wrapper refuses operands on the CPU, of another dtype, and host
  matrices that are not canonical.

On a card (marker ``cuda``; skips without one): K5 against the host kernel
as uint64 on the same operands, at the widest window, across windows and on
a product shaped like the 96^3 level-3 A P at fewer rows; two launches
bit-equal; and a card-routed 48^3 ``set_matrix`` and ``update2`` whose
levels, P and R equal the host-routed ones bit for bit, its launches
counted in runtime.launches.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from saena_tpu_torch import _native, generators
from saena_tpu_torch.amg import galerkin as gal
from saena_tpu_torch.amg import hierarchy as th
from saena_tpu_torch.config import Options
from saena_tpu_torch.core.coo import remove_boundary_nodes
from saena_tpu_torch.ops import csr_spgemm as K
from saena_tpu_torch.ops.csr_spgemm import DeviceCsr
from saena_tpu_torch.runtime import launches_of


def _rand(n, m, d, seed, zeros=0.0, neg_zeros=0.0, empty_rows=0):
    """A canonical float64 CSR with some stored zeros (+0.0 and -0.0) and
    some empty rows."""
    rng = np.random.default_rng(seed)
    M = sp.random(n, m, density=d, random_state=rng, format="csr")
    M.data = rng.standard_normal(M.nnz)
    if zeros:
        M.data[rng.random(M.nnz) < zeros] = 0.0
    if neg_zeros:
        M.data[rng.random(M.nnz) < neg_zeros] = -0.0
    if empty_rows:
        M = M.tolil()
        for r in rng.choice(n, empty_rows, replace=False):
            M.rows[r], M.data[r] = [], []
        M = M.tocsr()
    M.sort_indices()
    return M


def _last_column(n, m, seed):
    """Every row holds column m - 1."""
    M = _rand(n, m, 0.05, seed).tolil()
    for r in range(n):
        M[r, m - 1] = 1.0 + r
    M = M.tocsr()
    M.sort_indices()
    return M


def _poisson(m):
    return remove_boundary_nodes(generators.laplacian3D(m, m, m))[0].tocsr()


def _galerkin_ap():
    A = _poisson(10)
    info = th.setup(A, Options(), dtype=torch.float64, device="cpu")[1]
    return info.csr_levels[1], info.Ps[1]


CASES = {
    "sparse": lambda: (_rand(120, 90, 0.05, 1), _rand(90, 300, 0.04, 2)),
    "signed_zeros": lambda: (_rand(150, 80, 0.06, 3, neg_zeros=0.2, zeros=0.1),
                             _rand(80, 400, 0.02, 4, neg_zeros=0.3, zeros=0.1)),
    "empty_rows": lambda: (_rand(100, 60, 0.08, 5, empty_rows=20),
                           _rand(60, 70, 0.1, 6, empty_rows=15)),
    "last_column": lambda: (_rand(80, 50, 0.1, 7), _last_column(50, 333, 8)),
    # rows of at least m and m / 4 multiply-adds: the host's dense paths
    "dense_rows": lambda: (_rand(60, 200, 0.3, 9, neg_zeros=0.2),
                           _rand(200, 64, 0.2, 10, neg_zeros=0.3)),
    # Y over 65% full: the host's dense-Y panel, with explicit -0.0 in it
    "dense_y": lambda: (_rand(70, 40, 0.15, 11, neg_zeros=0.3),
                        _rand(40, 50, 0.8, 12, neg_zeros=0.2, zeros=0.1)),
    "galerkin_ap": _galerkin_ap,
}


def assert_bit_equal(C, Z):
    """Two scipy CSRs with equal indptr, indices and values as uint64."""
    assert C.shape == Z.shape
    np.testing.assert_array_equal(C.indptr.astype(np.int64), Z.indptr.astype(np.int64))
    np.testing.assert_array_equal(C.indices, Z.indices)
    assert C.data.dtype == Z.data.dtype == np.float64
    np.testing.assert_array_equal(C.data.view(np.uint64), Z.data.view(np.uint64))


# ------------------------------------------------------------------ CPU --

@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_is_the_host_kernel_bit_for_bit(name):
    X, Y = CASES[name]()
    Z = _native.spgemm_csr(X, Y)
    C = K.csr_spgemm_plain(DeviceCsr.from_host(X, "cpu"), DeviceCsr.from_host(Y, "cpu"))
    assert_bit_equal(C.to_host(), Z)


def test_the_cases_reach_each_accumulator_start():
    """The cases hold signed zero results on both kinds of rows, so an
    accumulator started at the wrong zero would show."""
    seen = set()
    for name in ("signed_zeros", "dense_rows", "dense_y"):
        X, Y = CASES[name]()
        Z = _native.spgemm_csr(X, Y)
        bits = Z.data.view(np.uint64)
        seen |= {int(b) for b in bits[Z.data == 0.0]}
    assert seen == {0, 1 << 63}


@pytest.mark.parametrize("k_rows,y_held,m,want", [
    (0, 0, 10, 10),                    # X holds nothing: no dense panel
    (40, 1040, 40, 10),                # 65% full: the panel, m // 4
    (40, 1039, 40, 40),                # just under 65%
    (8000, 8000 * 4001, 6000, 6000),   # full, but the panel past 3.2e7 doubles
    (5, 25, 5, 1),
    (3, 0, 0, 0),
])
def test_zero_min_flops_mirrors_the_host_thresholds(k_rows, y_held, m, want):
    assert K.zero_min_flops(k_rows, y_held, m) == want


@pytest.mark.parametrize("m,nwin,win", [(1, 1, 32), (6057, 1, 6080), (20835, 1, 20864),
                                        (25600, 1, 25600), (25601, 2, 12832),
                                        (88553, 4, 22144)])
def test_windows_cover_the_output(m, nwin, win):
    assert K.windows(m) == (nwin, win)
    assert win % 32 == 0 and win <= K.MAX_WINDOW and nwin * win >= m


@pytest.mark.parametrize("device,macs,canonical,card", [
    ("cuda", gal.CARD_MIN_MACS, True, True),
    (torch.device("cuda", 0), 10 * gal.CARD_MIN_MACS, True, True),
    ("cuda", gal.CARD_MIN_MACS - 1, True, False),
    ("cuda", 10 * gal.CARD_MIN_MACS, False, False),
    ("cpu", 10 * gal.CARD_MIN_MACS, True, False),
    (None, 10 * gal.CARD_MIN_MACS, True, False),
])
def test_route_is_a_function_of_device_macs_and_form(device, macs, canonical, card):
    assert gal.takes_card(device, macs, canonical) is card


def test_canonical_form():
    X = _rand(30, 30, 0.2, 13)
    assert K.is_canonical(X)
    assert not K.is_canonical(X.astype(np.float32))
    assert not K.is_canonical(X.tocoo())
    U = sp.csr_matrix((X.data[::-1].copy(), X.indices[::-1].copy(), X.indptr), shape=X.shape)
    assert not K.is_canonical(U)       # columns not sorted
    D = sp.csr_matrix((np.ones(2), np.array([1, 1]), np.array([0, 2])), shape=(1, 3))
    assert not K.is_canonical(D)       # a duplicate
    with pytest.raises(ValueError):
        DeviceCsr.from_host(D, "cpu")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    X, Y = CASES["sparse"]()
    Xc, Yc = DeviceCsr.from_host(X, "cpu"), DeviceCsr.from_host(Y, "cpu")
    Y32 = DeviceCsr(Yc.indptr, Yc.indices, Yc.values.float(), Yc.shape)

    def refused():
        with pytest.raises(ValueError, match="CUDA"):
            K.csr_spgemm(Xc, Yc)
        with pytest.raises(TypeError):
            K.csr_spgemm(X, Y)
        with pytest.raises(ValueError, match="float64"):
            K.csr_spgemm(Xc, Y32)

    assert not launches_of(refused)[1]


def test_the_order_within_a_y_row_does_not_change_the_bits():
    """The host kernel gives the same bits for Y with its rows unsorted (a
    column permutation, as coarsen_tail's reordering leaves P) as for Y
    sorted, which the card route relies on when it sorts such a Y."""
    X, Y = CASES["dense_rows"]()
    perm = np.random.default_rng(14).permutation(Y.shape[1])
    Yp = Y[:, perm].tocsr()
    Yp.sort_indices()
    # each row's entries in reverse
    idx = np.concatenate([np.arange(a, b)[::-1]
                          for a, b in zip(Yp.indptr[:-1], Yp.indptr[1:])])
    Yu = sp.csr_matrix((Yp.data[idx], Yp.indices[idx], Yp.indptr.copy()), shape=Yp.shape)
    assert not Yu.has_sorted_indices and (Yu != Yp).nnz == 0
    Z = _native.spgemm_csr(X, Yp)
    assert_bit_equal(_native.spgemm_csr(X, Yu), Z)
    C = K.csr_spgemm_plain(DeviceCsr.from_host(X, "cpu"),
                           DeviceCsr.from_host(Yu.sorted_indices(), "cpu"))
    assert_bit_equal(C.to_host(), Z)


def test_spgemm_macs_counts_the_y_rows_reached():
    X, Y = CASES["empty_rows"]()
    want = sum(int(Y.indptr[c + 1] - Y.indptr[c]) for c in X.indices)
    assert gal.spgemm_macs(X, Y) == want
    assert gal.spgemm_macs(X, DeviceCsr.from_host(Y, "cpu")) == want


@pytest.mark.parametrize("shards", [0, 2])
def test_cpu_setup_takes_the_host_for_every_product(shards):
    """A CPU setup records every Galerkin product, each on the host, with
    its level and multiply-adds, and its levels are the host kernel's."""
    from saena_tpu_torch.parallel.dist_setup import dist_setup

    A = _poisson(14)
    if shards:
        info, made = launches_of(lambda: dist_setup(
            A, Options(), dtype=torch.float64, device="cpu", n_shards=2, tail_rows=64)[1])
    else:
        info, made = launches_of(
            lambda: th.setup(A, Options(), dtype=torch.float64, device="cpu")[1])
    levels = {p.level for p in info.products}
    assert levels == set(range(len(info.sizes) - 1))
    assert all(p.engine == "host" and p.macs > 0 and p.seconds >= 0 for p in info.products)
    assert info.card_mac_share() == 0.0
    assert "0.00% of their multiply-adds on the card" in info.table()
    # the serial setup's products: A P then R W a level
    if not shards:
        assert len(info.products) == 2 * (len(info.sizes) - 1)
        A0, P0, R0 = info.csr_levels[0], info.Ps[0], info.Rs[0]
        W = _native.spgemm_csr(A0, P0)
        assert [p.macs for p in info.products[:2]] == [gal.spgemm_macs(A0, P0),
                                                       gal.spgemm_macs(R0, W)]
    assert not made


def test_share_is_none_without_products():
    info = th.SetupInfo([], [], [], [], [], [], [])
    assert info.card_mac_share() is None
    assert "galerkin" not in info.table()


# ---------------------------------------------------------------- card --

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _on_card(X, Y, dev):
    return K.csr_spgemm(DeviceCsr.from_host(X, dev), DeviceCsr.from_host(Y, dev))


def level3_ap_like(n=2000, seed=5):
    """A P shaped like the 96^3 level 3 (A: rows of 499-4,699 entries over
    20,835 columns; P: 20,835 x 6,057, some 940 entries a row) at fewer rows."""
    rng = np.random.default_rng(seed)
    k, m = 20835, 6057
    lens = rng.integers(499, 4700, n)
    rows = [np.sort(rng.choice(k, ln, replace=False)) for ln in lens]
    A = sp.csr_matrix((rng.standard_normal(lens.sum()), np.concatenate(rows),
                       np.concatenate([[0], np.cumsum(lens)])), shape=(n, k))
    plen = rng.integers(600, 1300, k)
    start = rng.integers(0, m - 1300, k)
    cols = np.concatenate([s + np.sort(rng.choice(1300, ln, replace=False))
                           for s, ln in zip(start, plen)])
    P = sp.csr_matrix((rng.standard_normal(plen.sum()), cols,
                       np.concatenate([[0], np.cumsum(plen)])), shape=(k, m))
    return A, P


CARD_CASES = dict(CASES)
CARD_CASES.update({
    # the widest window K5 takes, then two and four windows
    "widest_window": lambda: (_rand(300, 200, 0.05, 21), _last_column(200, K.MAX_WINDOW, 22)),
    "two_windows": lambda: (_rand(300, 200, 0.05, 23), _last_column(200, K.MAX_WINDOW + 1, 24)),
    "four_windows": lambda: (_rand(500, 400, 0.02, 25, neg_zeros=0.1),
                             _last_column(400, 88553, 26)),
    "level3_ap_like": level3_ap_like,
})


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_cuda_k5_is_the_host_kernel_bit_for_bit(name):
    dev = _card()
    X, Y = CARD_CASES[name]()
    Z = _native.spgemm_csr(X, Y)
    (C1, C2), made = launches_of(lambda: (_on_card(X, Y, dev), _on_card(X, Y, dev)))
    torch.cuda.synchronize(dev)
    assert made["csr_spgemm"] == 4
    assert_bit_equal(C1.to_host(), Z)
    for a, b in zip((C1.indptr, C1.indices, C1.values), (C2.indptr, C2.indices, C2.values)):
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.float64 else a,
                           b.view(torch.int64) if b.dtype == torch.float64 else b)


@pytest.mark.cuda
def test_cuda_chained_product_keeps_w_on_the_card(monkeypatch):
    """galerkin_product keeps A P on the card for R (A P): the result equals
    the host route's bit for bit."""
    dev = _card()
    A = _poisson(16)
    info = th.setup(A, Options(), dtype=torch.float64, device="cpu")[1]
    A1, P1, R1 = info.csr_levels[1], info.Ps[1], info.Rs[1]
    host = gal.galerkin_product(R1, A1, P1)
    monkeypatch.setattr(gal, "CARD_MIN_MACS", 0)
    timer = th.PhaseTimer()
    card = gal.galerkin_product(R1, A1, P1, device=dev, timer=timer, level=1)
    assert [p.engine for p in timer.products] == ["card", "card"]
    assert_bit_equal(card, host)


def _assert_same_levels(i1, i2):
    assert i1.sizes == i2.sizes
    for Xs, Ys in ((i1.csr_levels, i2.csr_levels), (i1.Ps, i2.Ps), (i1.Rs, i2.Rs)):
        assert len(Xs) == len(Ys)
        for X, Y in zip(Xs, Ys):
            assert_bit_equal(X.tocsr(), Y.tocsr())


@pytest.mark.cuda
def test_cuda_card_routed_setup_and_update2_equal_the_host_routed(monkeypatch):
    """The 48^3 set_matrix (shard-parallel and serial) and an update2 on the
    card, with the products routed to K5 (the crossover at 0, so every
    product goes), against the same with every product on the host."""
    from saena_tpu_torch import AMG, Matrix

    dev = _card()
    csr = generators.laplacian3D(48, 48, 48)

    def run(min_macs, shards):
        monkeypatch.setattr(gal, "CARD_MIN_MACS", min_macs)
        M = Matrix()
        M.set_csr(csr)
        M.assemble(device=dev, dtype=torch.float64)
        amg = AMG(device=dev, dtype=torch.float64)
        amg.set_matrix(M, Options(remove_boundary=True, setup_shards=shards))
        first = amg.info
        M2 = Matrix()
        M2.set_csr(csr * 1.3)
        M2.assemble(device=dev, dtype=torch.float64)
        amg.update2(M2)
        return first, amg.info

    for shards in (-1, 0):
        (card_set, card_upd), made = launches_of(lambda: run(0, shards))
        launched = made["csr_spgemm"]
        (host_set, host_upd), made = launches_of(lambda: run(2**62, shards))
        assert made["csr_spgemm"] == 0
        n_card = sum(p.engine == "card" for p in card_set.products + card_upd.products)
        assert launched == 2 * n_card and n_card > 0
        assert card_set.card_mac_share() == 100.0
        # update2's finest A is the caller's CSR without its boundary rows,
        # whose columns need not be sorted: its product may stay on the host
        assert {p.level for p in card_upd.products if p.engine == "host"} <= {0}
        assert card_upd.card_mac_share() > 90.0
        assert host_set.card_mac_share() == 0.0
        _assert_same_levels(card_set, host_set)
        _assert_same_levels(card_upd, host_upd)
