"""Matrix file I/O.

The reference reads Matrix Market ``.mtx`` files and its own ``.bin`` format
(packed little-endian (int32 row, int32 col, float64 val) triples with both
triangles stored — saena_matrix.cpp:17-401 does the .mtx→.bin conversion and
a parallel binary read). Here both land in scipy CSR on the host; sharding
happens later at setup.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.io
import scipy.sparse as sp

_BIN_DTYPE = np.dtype([("row", "<i4"), ("col", "<i4"), ("val", "<f8")])
_BIN_DTYPE64 = np.dtype([("row", "<i8"), ("col", "<i8"), ("val", "<f8")])


def _layout_score(raw) -> float:
    """Plausibility of a decoded triple array: sane indices + normal values."""
    if raw.size == 0:
        return -1.0
    r, c, v = raw["row"], raw["col"], raw["val"]
    idx_ok = np.mean((r >= 0) & (c >= 0) & (r < 10**8) & (c < 10**8))
    av = np.abs(v)
    val_ok = np.mean(np.isfinite(v) & ((av == 0) | ((av > 1e-250) & (av < 1e250))))
    return float(idx_ok + val_ok)


def _read_bin_raw(path: str):
    """Saena .bin files appear with 16-byte (int32 idx — FloridaCollection)
    and 24-byte (int64 idx — Helmholtz2D) triples; auto-detect by decoding
    both ways and scoring plausibility."""
    sz = os.path.getsize(path)
    cands = []
    if sz % _BIN_DTYPE.itemsize == 0:
        cands.append(np.fromfile(path, dtype=_BIN_DTYPE))
    if sz % _BIN_DTYPE64.itemsize == 0:
        cands.append(np.fromfile(path, dtype=_BIN_DTYPE64))
    if not cands:
        raise ValueError(f"{path}: size {sz} matches no known triple layout")
    return max(cands, key=_layout_score)


def read_bin(path: str, shape=None) -> sp.csr_matrix:
    """Read Saena .bin COO triples (0-based, both triangles present)."""
    raw = _read_bin_raw(path)
    rows = raw["row"].astype(np.int64)
    cols = raw["col"].astype(np.int64)
    if shape is None:
        n = int(max(rows.max(), cols.max())) + 1 if rows.size else 0
        shape = (n, n)
    a = sp.csr_matrix((raw["val"], (rows, cols)), shape=shape)
    a.sum_duplicates()
    return a


def write_bin(path: str, A: sp.spmatrix) -> None:
    coo = A.tocoo()
    order = np.lexsort((coo.row, coo.col))  # column-major like the reference
    out = np.empty(coo.nnz, dtype=_BIN_DTYPE)
    out["row"] = coo.row[order]
    out["col"] = coo.col[order]
    out["val"] = coo.data[order]
    out.tofile(path)


def read_mtx(path: str) -> sp.csr_matrix:
    try:
        a = scipy.io.mmread(path).tocsr()
    except ValueError:
        # the reference's Helmholtz2D .mtx files carry no MatrixMarket
        # banner: plain "n m nnz" header then 1-based triples
        dat = np.loadtxt(path)
        n, m = int(dat[0, 0]), int(dat[0, 1])
        a = sp.csr_matrix(
            (dat[1:, 2], (dat[1:, 0].astype(np.int64) - 1,
                          dat[1:, 1].astype(np.int64) - 1)),
            shape=(n, m))
    a.sum_duplicates()
    return a


def write_mtx(path: str, A: sp.spmatrix) -> None:
    scipy.io.mmwrite(path, A.tocoo())


_SBIN_MAGIC = b"SAENATPU"


def write_sbin(path: str, A: sp.spmatrix) -> None:
    """Compressed matrix format: CSR with delta + Golomb-Rice coded index
    streams (the GR_encoder applied to persistence; the reference applies it
    to SpGEMM wire streams). Typically 2-4x smaller than .bin on stencil
    matrices; values stored raw f64."""
    from saena_tpu_torch import native

    A = A.tocsr()
    A.sort_indices()
    cols = A.indices.astype(np.uint32)
    seg = A.indptr[:-1].astype(np.int64)
    payload, k = native.gr_compress(native.delta_encode(cols, seg))
    with open(path, "wb") as f:
        f.write(_SBIN_MAGIC)
        np.asarray([A.shape[0], A.shape[1], A.nnz, k, len(payload)],
                   dtype="<i8").tofile(f)
        A.indptr.astype("<i8").tofile(f)
        f.write(payload)
        A.data.astype("<f8").tofile(f)


def read_sbin(path: str) -> sp.csr_matrix:
    from saena_tpu_torch import native

    with open(path, "rb") as f:
        if f.read(8) != _SBIN_MAGIC:
            raise ValueError(f"{path}: not a saena_tpu .sbin file")
        n, m, nnz, k, plen = np.fromfile(f, dtype="<i8", count=5)
        indptr = np.fromfile(f, dtype="<i8", count=n + 1)
        payload = f.read(int(plen))
        data = np.fromfile(f, dtype="<f8", count=nnz)
    seg = indptr[:-1]
    cols = native.delta_decode(
        native.gr_decompress(payload, int(nnz), int(k)), seg)
    return sp.csr_matrix((data, cols.astype(np.int64), indptr), shape=(int(n), int(m)))


def read_matrix(path: str) -> sp.csr_matrix:
    """Dispatch on extension, like the reference's read_file auto-detect."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bin":
        return read_bin(path)
    if ext == ".sbin":
        return read_sbin(path)
    if ext in (".mtx", ".mm"):
        return read_mtx(path)
    raise ValueError(f"unsupported matrix file extension: {ext!r}")
