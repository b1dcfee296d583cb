"""The gather kernels' work tables (saena_tpu_torch/ops/chunks.py) and the
build digest of their shared header (ops/cuda_build.py), on the CPU.

- `balance` cuts a row-block-ordered unit list at given chunk boundaries
  (equal shares, or the packed boundaries of a small operator) into
  segments that cover every unit once, in order; a row block lies in one
  direct segment or, when chunk boundaries cut it, in consecutive pieces
  listed in `cuts`; empty row blocks, a single row block, a list smaller
  than one chunk and an uneven split are all covered;
- the head records repeat each chunk's bounds and first segment;
- the packed boundaries keep short row blocks whole and cut long ones into
  at most max_pieces pieces; equal shares stop at the resident warps;
- the library path of a kernel changes when a shared header under csrc/
  changes (no nvcc needed).
"""
import os
import shutil

import numpy as np
import pytest

from saena_tpu_torch.ops import chunks, cuda_build

CASES = {
    "empty_row_blocks": ([0, 0, 4, 4, 4, 9, 20, 20, 31, 31], 4),
    "single_row_block": ([0, 100], 7),
    "smaller_than_one_chunk": ([0, 3, 3, 5], 1),
    "uneven_split": ([0, 10, 13, 40, 41, 77, 103], 10),
    "no_units": ([0, 0, 0, 0], 1),
    "one_row_block_over_many_chunks": ([0, 2, 90, 91], 9),
    "more_chunks_than_row_blocks": ([0, 64, 128], 16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_balance_covers_every_unit_once_in_row_block_order(name):
    ptr, n_chunks = CASES[name]
    ptr = np.asarray(ptr)
    n_rb, n = ptr.size - 1, int(ptr[-1])
    chunk_ptr, seg_ptr, segs, cuts = chunks.balance(ptr, chunks.equal_bounds(n, n_chunks))
    assert chunk_ptr[0] == 0 and chunk_ptr[-1] == n
    assert np.ptp(np.diff(chunk_ptr)) <= 1                     # equal shares
    heads = chunks.head_records(chunk_ptr, seg_ptr, segs)
    np.testing.assert_array_equal(heads[:, :4].T, [chunk_ptr[:-1], chunk_ptr[1:],
                                                   seg_ptr[:-1], seg_ptr[1:]])
    has = seg_ptr[1:] > seg_ptr[:-1]
    np.testing.assert_array_equal(heads[has, 4:], segs[seg_ptr[:-1][has]])
    assert seg_ptr[0] == 0 and seg_ptr[-1] == segs.shape[0]
    covered = []
    written = np.zeros(n_rb, dtype=int)
    for c in range(n_chunks):
        k = chunk_ptr[c]
        for g in range(seg_ptr[c], seg_ptr[c + 1]):
            rb, lo, hi, cut = segs[g]
            assert lo == k and ptr[rb] <= lo <= hi <= ptr[rb + 1]
            covered.extend(range(lo, hi))
            k = hi
            if cut < 0:
                assert (lo, hi) == (ptr[rb], ptr[rb + 1])
                written[rb] += 1
        assert k == chunk_ptr[c + 1]
    assert covered == list(range(n))
    rb_order = segs[:, 0]
    assert (np.diff(rb_order) >= 0).all()
    for cut, (g0, cnt) in enumerate(cuts):
        piece = segs[g0:g0 + cnt]
        rb = piece[0, 0]
        assert (piece[:, 0] == rb).all() and (piece[:, 3] == cut).all() and cnt > 1
        assert piece[0, 1] == ptr[rb] and piece[-1, 2] == ptr[rb + 1]
        written[rb] += 1
    assert (written == 1).all()                                # every row block once
    assert (segs[:, 3] >= 0).sum() == cuts[:, 1].sum()


def test_balance_marks_exactly_the_row_blocks_that_chunks_split():
    ptr = np.array([0, 5, 5, 30, 31, 60])
    chunk_ptr, _, segs, cuts = chunks.balance(ptr, chunks.equal_bounds(60, 4))  # shares of 15
    np.testing.assert_array_equal(chunk_ptr, [0, 15, 30, 45, 60])
    np.testing.assert_array_equal(segs[cuts[:, 0], 0], [2, 4])
    np.testing.assert_array_equal(cuts[:, 1], [2, 2])
    # the empty row block 1 sits at position 5, inside chunk 0
    assert [tuple(s) for s in segs if s[0] == 1] == [(1, 5, 5, -1)]


@pytest.mark.parametrize("n_units,cap,expect", [
    (0, 2112, 1), (1, 2112, 1), (64, 2112, 32), (65, 2112, 33),
    (13056, 2112, 2112), (10 ** 6, 2112, 2112), (960, 100, 100)])
def test_n_chunks_follows_the_units_up_to_the_card(n_units, cap, expect):
    assert chunks.n_chunks_for(n_units, cap, 2) == expect


@pytest.mark.parametrize("ptr,chunk_min,whole_max,pieces,expect", [
    # short row blocks packed up to chunk_min units, a long one cut
    ([0, 1, 2, 3, 40, 41], 2, 8, 100, [0, 2, 3] + list(range(4, 41, 2)) + [41]),
    # the long row block cut into at most 4 pieces
    ([0, 1, 2, 3, 40, 41], 2, 8, 4, [0, 2, 3, 12, 21, 30, 40, 41]),
    # every row block whole, packed
    ([0, 3, 6, 9, 12], 6, 8, 100, [0, 6, 12]),
    ([0, 0, 0], 1, 8, 100, [0, 0]),
])
def test_packed_bounds_keep_short_row_blocks_whole(ptr, chunk_min, whole_max, pieces, expect):
    b = chunks.packed_bounds(np.array(ptr), chunk_min, whole_max, pieces)
    np.testing.assert_array_equal(b, expect)
    _, _, segs, cuts = chunks.balance(np.array(ptr), b)
    lens = np.diff(ptr)
    cut = segs[cuts[:, 0], 0] if cuts.size else np.zeros(0, int)
    assert (lens[cut] > whole_max).all() and (cuts[:, 1] <= pieces).all()


def test_chunk_bounds_switch_from_packed_to_equal_shares_at_the_card():
    """Below the resident warps the boundaries follow the row blocks; above
    them the shares are equal and their count stops at the card, or lower
    when a long row block would be cut into more than max_pieces pieces."""
    ptr = np.arange(0, 4001, 4)                               # 1000 row blocks of 4
    small = chunks.chunk_bounds(ptr, 128, 2112, 2, 8)
    assert np.isin(small, ptr).all() and small.size - 1 == 1000
    big = chunks.chunk_bounds(ptr, 128, 100, 2, 8)
    assert big.size - 1 == 100 and np.ptp(np.diff(big)) <= 1
    long = np.array([0, 100000, 100004])
    b = chunks.chunk_bounds(long, 1024, 2112, 1, 8)
    assert b.size - 1 <= 100004 * (chunks.max_pieces(1024) - 1) // 100000
    _, _, _, cuts = chunks.balance(long, b)
    assert cuts[:, 1].max() <= chunks.max_pieces(1024)


def test_library_path_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a header under csrc/ gives every kernel a new library path,
    so a stale library is never reused; an unchanged tree keeps its path."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, src)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    headers = sorted(f for f in os.listdir(src) if f.endswith(".cuh"))
    assert headers
    before = {n: cuda_build.library_path(n) for n in cuda_build.KERNEL_SOURCES}
    assert before == {n: cuda_build.library_path(n) for n in cuda_build.KERNEL_SOURCES}
    with open(src / headers[0], "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.KERNEL_SOURCES}
    assert all(after[n] != before[n] for n in before)
