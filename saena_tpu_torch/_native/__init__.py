"""Native (C++) host kernels, built with g++ at first use and loaded with
ctypes.

Six sources beside this file: the Golomb-Rice index-stream codec
(gr_codec.cpp, the reference's GR_encoder), the single-pass MIS(1)
aggregation and its per-shard sweep (mis1.cpp), the Gustavson SpGEMM of
the Galerkin product (spgemm.cpp), the strip and strip8 planners
(stripplan.cpp, strip8plan.cpp), and the strength keep mask with an OpenMP
CSR SpMV (strength.cpp). They compile together into
``saena_tpu_torch/_build/libsaena_native-<digest>.so``; the digest covers
the sources, the flags and the host CPU as ``-march=native`` resolves it,
so an edited source, other flags or another CPU give a new build, and a
library built for another host is never loaded.

Every function returns None when no ``g++`` is on PATH; its caller then
takes the numpy version of the same computation. When ``g++`` exists and
the build or the load fails, the first call raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("gr_codec.cpp", "mis1.cpp", "spgemm.cpp", "stripplan.cpp",
           "strip8plan.cpp", "strength.cpp")
# -ffp-contract=off: no silent FMA fusion. The SpGEMM and SpMV must give the
# floating-point results of the scipy products they replace, bit for bit.
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
             "-shared", "-fPIC", "-std=c++17")

_LIB = None
_TRIED = False
_LOCK = threading.Lock()


def _host_target(cxx: str) -> bytes:
    """The target options ``-march=native`` resolves to on this host."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, check=True, timeout=60)
    return out.stdout


def library_path(cxx: str) -> str:
    """Where the library of these sources, flags and host CPU lives."""
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode() + b"\0")
    digest.update(_host_target(cxx))
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libsaena_native-{digest.hexdigest()[:12]}.so")


def _build(cxx: str) -> str:
    so = library_path(cxx)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, *(os.path.join(_HERE, s) for s in SOURCES),
           "-o", tmp]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(
            f"native host kernels: g++ exit {out.returncode}:\n{out.stderr}")
    os.replace(tmp, so)
    return so


def _declare(lib) -> None:
    c_i64, c_int, c_p, c_d = (ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_double)
    sigs = {
        "gr_compress": (c_i64, [c_p, c_i64, c_int, c_p, c_i64]),
        "gr_decompress": (c_i64, [c_p, c_i64, c_int, c_p, c_i64]),
        "gr_pick_k": (c_int, [c_p, c_i64]),
        "delta_encode": (None, [c_p, c_i64, c_p, c_i64, c_p]),
        "delta_decode": (None, [c_p, c_i64, c_p, c_i64, c_p]),
        "mis1_aggregate": (None, [c_i64, c_p, c_p, c_p, c_p]),
        "mis1_sweep": (c_i64, [c_i64, c_i64, c_p, c_p, c_p, c_p, c_p, c_p, c_p]),
        "spgemm_csr_start": (c_p, [c_i64, c_i64, c_p, c_p, c_p, c_p, c_p, c_p,
                                   c_p, c_p, ctypes.c_int32]),
        "spgemm_csr_finish": (None, [c_p, c_p, c_p, c_p]),
        "strip_plan_core": (c_i64, [c_i64, c_p, c_p, c_i64, c_i64, c_i64,
                                    c_p, c_p, c_p, c_p]),
        "strip8_plan_core": (c_i64, [c_i64, c_p, c_p, c_i64, c_i64, c_i64,
                                     c_p, c_p, c_p, c_p, c_p, c_i64]),
        "strip8i_plan_core": (c_i64, [c_i64, c_p, c_p, c_i64, c_i64, c_i64,
                                      c_p, c_p, c_p, c_p, c_p, c_i64]),
        "strength_keep": (c_i64, [c_i64, c_p, c_p, c_p, c_d, c_p, c_p]),
        "csr_matvec": (None, [c_i64, c_p, c_p, c_p, c_p, c_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _build_and_load():
    """The loaded library, or None without g++ on PATH."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        # libgomp's default wait policy spin-waits after every parallel
        # region and takes a core from the numpy work between kernel calls;
        # it must be set before libgomp initializes
        os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
        cxx = shutil.which("g++")
        if cxx is not None:
            lib = ctypes.CDLL(_build(cxx))
            _declare(lib)
            _LIB = lib
        _TRIED = True
        return _LIB


def have_native() -> bool:
    return _build_and_load() is not None


QMAX = 48


def gr_pick_k(values: np.ndarray) -> int:
    """Best k among {0, 7, 15} (ref CSCMat::compress_prep picks per-rank k)."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    lib = _build_and_load()
    if lib is not None:
        return int(lib.gr_pick_k(values.ctypes.data, values.size))
    best_k, best_bits = 7, np.inf
    for k in (0, 7, 15):
        q = values >> k
        bits = np.where(q < QMAX, q + 1 + k, QMAX + 32).sum()
        if bits < best_bits:
            best_bits, best_k = bits, k
    return best_k


def gr_compress(values: np.ndarray, k: int | None = None) -> tuple[bytes, int]:
    """Golomb-Rice compress a uint32 stream; returns (payload, k)."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    if k is None:
        k = gr_pick_k(values)
    lib = _build_and_load()
    if lib is not None:
        cap = int(values.size * 12 + 64)
        out = np.zeros(cap, dtype=np.uint8)
        n = lib.gr_compress(values.ctypes.data, values.size, k,
                            out.ctypes.data, cap)
        if n < 0:
            raise RuntimeError(f"gr_compress failed ({n})")
        return bytes(out[:n].tobytes()), k
    return _py_gr_compress(values, k), k


def gr_decompress(payload: bytes, n_vals: int, k: int) -> np.ndarray:
    lib = _build_and_load()
    buf = np.frombuffer(payload, dtype=np.uint8)
    out = np.zeros(n_vals, dtype=np.uint32)
    if lib is not None:
        r = lib.gr_decompress(buf.ctypes.data, buf.size, k,
                              out.ctypes.data, n_vals)
        if r < 0:
            raise RuntimeError("gr_decompress: malformed stream")
        return out
    return _py_gr_decompress(buf, n_vals, k)


def delta_encode(values: np.ndarray, seg_starts: np.ndarray) -> np.ndarray:
    values = np.ascontiguousarray(values, dtype=np.uint32)
    seg = np.ascontiguousarray(seg_starts, dtype=np.int64)
    lib = _build_and_load()
    out = np.zeros_like(values)
    if lib is not None and values.size:
        lib.delta_encode(values.ctypes.data, values.size,
                         seg.ctypes.data, seg.size, out.ctypes.data)
        return out
    prev = np.concatenate([[0], values[:-1]]) if values.size else values
    out = values - prev
    out[seg[seg < values.size]] = values[seg[seg < values.size]]
    return out


def delta_decode(deltas: np.ndarray, seg_starts: np.ndarray) -> np.ndarray:
    deltas = np.ascontiguousarray(deltas, dtype=np.uint32)
    seg = np.ascontiguousarray(seg_starts, dtype=np.int64)
    lib = _build_and_load()
    out = np.zeros_like(deltas)
    if lib is not None and deltas.size:
        lib.delta_decode(deltas.ctypes.data, deltas.size,
                         seg.ctypes.data, seg.size, out.ctypes.data)
        return out
    starts = seg[seg < deltas.size]
    grp = np.zeros(deltas.size, dtype=np.int64)
    grp[starts] = 1
    grp = np.cumsum(grp)
    csum = np.cumsum(deltas.astype(np.uint64))
    base = np.zeros(deltas.size, dtype=np.uint64)
    if starts.size:
        base_vals = csum[starts] - deltas[starts]
        base = base_vals[grp - 1]
    return (csum - base).astype(np.uint32)


def mis1_aggregate(indptr: np.ndarray, indices: np.ndarray):
    """Single-pass lexicographic-first MIS(1) aggregation (mis1.cpp).

    Returns (agg, is_root) with agg[i] = fine index of i's root, the
    aggregation of the min-index fixpoint in amg/strength.py in one O(nnz)
    sweep; None without a toolchain or for graphs past int32 indexing."""
    lib = _build_and_load()
    if lib is None:
        return None
    n = indptr.size - 1
    # mis1.cpp walks int32 column indices: wider graphs take the fixpoint
    if n >= 2**31 or (indices.size and int(indices.max()) >= 2**31):
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    agg = np.empty(n, dtype=np.int64)
    is_root = np.empty(n, dtype=np.uint8)
    lib.mis1_aggregate(n, indptr.ctypes.data, indices.ctypes.data,
                       agg.ctypes.data, is_root.ctypes.data)
    return agg, is_root


def mis1_sweep(row0: int, indptr, indices, dec_snap, root_snap,
               decided, is_root, agg) -> int | None:
    """One per-shard round of the distributed MIS fixpoint (mis1.cpp): an
    ascending-index local sweep over fresh local state and the snapshot of
    remote state. Mutates decided/is_root/agg in the shard's global slice;
    returns the number of still undecided local rows, or None without a
    toolchain. The arrays must be contiguous, of the declared dtypes (int64
    indptr and agg, int32 indices, uint8 flags) and sizes; others raise."""
    lib = _build_and_load()
    if lib is None:
        return None
    n_loc = indptr.size - 1
    n = decided.size
    for arr, dt, size in ((indptr, np.int64, n_loc + 1), (indices, np.int32, indptr[-1]),
                          (dec_snap, np.uint8, n), (root_snap, np.uint8, n),
                          (decided, np.uint8, n), (is_root, np.uint8, n),
                          (agg, np.int64, n)):
        if arr.dtype != dt or not arr.flags.c_contiguous or arr.size < size:
            raise TypeError(f"mis1_sweep: needs contiguous {np.dtype(dt)} arrays "
                            f"of {size} entries, got {arr.dtype} {arr.shape}")
    if row0 < 0 or row0 + n_loc > n:
        raise ValueError(f"mis1_sweep: rows {row0}..{row0 + n_loc} outside 0..{n}")
    return int(lib.mis1_sweep(
        n_loc, row0, indptr.ctypes.data, indices.ctypes.data,
        dec_snap.ctypes.data, root_snap.ctypes.data,
        decided.ctypes.data, is_root.ctypes.data, agg.ctypes.data))


def strip_plan_core(row, col, rpt: int, n_strips: int, perrow: int):
    """Slot and pair assignment of the strip planner (stripplan.cpp).
    Entries must be sorted by (row, col). Returns (slot int8, inv int32,
    pair_rb int32, pair_strip int32), the pair arrays cut to the unique
    pair count; None without a toolchain, or for unsorted or too wide
    input (the numpy planner takes those)."""
    lib = _build_and_load()
    if lib is None:
        return None
    nnz = row.size
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    slot = np.empty(nnz, dtype=np.int8)
    inv = np.empty(nnz, dtype=np.int32)
    pair_rb = np.empty(nnz, dtype=np.int32)
    pair_strip = np.empty(nnz, dtype=np.int32)
    n_pairs = lib.strip_plan_core(
        nnz, row.ctypes.data, col.ctypes.data, rpt, n_strips, perrow,
        slot.ctypes.data, inv.ctypes.data, pair_rb.ctypes.data,
        pair_strip.ctypes.data)
    if n_pairs < 0:
        return None
    return slot, inv, pair_rb[:n_pairs].copy(), pair_strip[:n_pairs].copy()


def strip8_plan_core(row, col, n_rb: int, n_strips: int, perrow: int = 1):
    """General-mode tile assignment of the strip8 planner (strip8plan.cpp).
    Entries must be sorted by (row, col). Returns (e_tile int32, e_sub
    int8, e_krem int8, tile_strips (n_tiles, 8) int32, rb_tiles int32), or
    None without a toolchain or for unsorted input."""
    lib = _build_and_load()
    if lib is None:
        return None
    nnz = row.size
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    cap = nnz // 8 + n_rb + 2
    e_tile = np.empty(nnz, dtype=np.int32)
    e_sub = np.empty(nnz, dtype=np.int8)
    e_krem = np.empty(nnz, dtype=np.int8)
    t_strip = np.empty(cap * 8, dtype=np.int32)
    rb_tiles = np.zeros(n_rb, dtype=np.int32)
    n_tiles = lib.strip8_plan_core(
        nnz, row.ctypes.data, col.ctypes.data, n_rb, n_strips, perrow,
        e_tile.ctypes.data, e_sub.ctypes.data, e_krem.ctypes.data,
        t_strip.ctypes.data, rb_tiles.ctypes.data, cap)
    if n_tiles < 0:
        return None
    return (e_tile, e_sub, e_krem,
            t_strip[:n_tiles * 8].reshape(n_tiles, 8).copy(), rb_tiles)


def strip8i_plan_core(row, col, n_rb: int, n_strips: int, perrow: int = 1):
    """Interval-mode tile assignment (strip8plan.cpp): a tile's 8 sublanes
    read the consecutive strips from t_base[tile]. Returns (e_tile, e_sub,
    e_krem, t_base (n_tiles,) int32, rb_tiles) or None."""
    lib = _build_and_load()
    if lib is None:
        return None
    nnz = row.size
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    # tiles <= nnz (sum over strips of max-per-row counts) + 1 per interval
    cap = nnz + 8 * n_rb + 16
    e_tile = np.empty(nnz, dtype=np.int32)
    e_sub = np.empty(nnz, dtype=np.int8)
    e_krem = np.empty(nnz, dtype=np.int8)
    t_base = np.empty(cap, dtype=np.int32)
    rb_tiles = np.zeros(n_rb, dtype=np.int32)
    n_tiles = lib.strip8i_plan_core(
        nnz, row.ctypes.data, col.ctypes.data, n_rb, n_strips, perrow,
        e_tile.ctypes.data, e_sub.ctypes.data, e_krem.ctypes.data,
        t_base.ctypes.data, rb_tiles.ctypes.data, cap)
    if n_tiles < 0:
        return None
    return e_tile, e_sub, e_krem, t_base[:n_tiles].copy(), rb_tiles


def strength_keep(indptr, indices, data, theta: float):
    """Strength-graph keep mask (strength.cpp): the per-row max of -offdiag
    and the union-symmetrized threshold test, bit-identical to the numpy
    mask of amg/strength.py. Returns (keep bool, kept count) or None."""
    lib = _build_and_load()
    if lib is None:
        return None
    n = indptr.size - 1
    if n >= 2**31 or (indices.size and indices.dtype.itemsize > 4
                      and indices.max() >= 2**31):
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float64)
    keep = np.empty(indices.size, dtype=np.uint8)
    safe = np.empty(n, dtype=np.float64)
    kept = lib.strength_keep(n, indptr.ctypes.data, indices.ctypes.data,
                             data.ctypes.data, float(theta),
                             keep.ctypes.data, safe.ctypes.data)
    return keep.view(bool), int(kept)


def csr_matvec(indptr, indices, data, x, out=None):
    """y = A x with scipy's per-row sequential accumulation (strength.cpp),
    on OpenMP threads over rows; None without a toolchain."""
    lib = _build_and_load()
    if lib is None:
        return None
    n = indptr.size - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = out if out is not None else np.empty(n, dtype=np.float64)
    lib.csr_matvec(n, indptr.ctypes.data, indices.ctypes.data,
                   data.ctypes.data, x.ctypes.data, y.ctypes.data)
    return y


def spgemm_csr(A, B, nt: int = 0):
    """CSR x CSR product (spgemm.cpp): Gustavson with a stamped dense
    accumulator, OpenMP threads over FLOP-balanced contiguous row blocks.
    Returns a canonical scipy CSR (sorted indices, no duplicates), or None
    without a toolchain or past int32 column indexing. ``nt``: thread count
    (0 = OpenMP's default); callers that already run shard tasks in
    parallel pass 1. The host stand-in for the reference's
    mkl_dcsrmultcsr base case (saena_object_setup_matmat.cpp:214)."""
    import scipy.sparse as sp

    lib = _build_and_load()
    if lib is None:
        return None
    n, k = A.shape
    k2, m = B.shape
    if k != k2:
        raise ValueError(f"spgemm_csr: shapes {A.shape} and {B.shape}")
    if max(n, m, k) >= 2**31:
        return None
    a_indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    a_indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    a_values = np.ascontiguousarray(A.data, dtype=np.float64)
    b_indptr = np.ascontiguousarray(B.indptr, dtype=np.int64)
    b_indices = np.ascontiguousarray(B.indices, dtype=np.int32)
    b_values = np.ascontiguousarray(B.data, dtype=np.float64)
    rownnz = np.zeros(n, dtype=np.int64)
    nnz_out = ctypes.c_int64(0)
    ctx = lib.spgemm_csr_start(
        n, m,
        a_indptr.ctypes.data, a_indices.ctypes.data, a_values.ctypes.data,
        b_indptr.ctypes.data, b_indices.ctypes.data, b_values.ctypes.data,
        rownnz.ctypes.data, ctypes.byref(nnz_out), int(nt))
    nnz = int(nnz_out.value)
    c_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rownnz, out=c_indptr[1:])
    c_indices = np.empty(nnz, dtype=np.int32)
    c_values = np.empty(nnz, dtype=np.float64)
    lib.spgemm_csr_finish(ctx, c_indptr.ctypes.data,
                          c_indices.ctypes.data, c_values.ctypes.data)
    out = sp.csr_matrix((c_values, c_indices, c_indptr), shape=(n, m))
    out.has_sorted_indices = True
    out.has_canonical_format = True
    return out


# ---- bitstream versions in Python (slow; taken only without g++) ----

def _py_gr_compress(values: np.ndarray, k: int) -> bytes:
    bits = []
    for v in values.tolist():
        q = v >> k
        if q < QMAX:
            bits.extend([1] * q)
            bits.append(0)
            for i in range(k):
                bits.append((v >> i) & 1)
        else:
            bits.extend([1] * QMAX)
            for i in range(32):
                bits.append((v >> i) & 1)
    arr = np.asarray(bits + [0] * ((-len(bits)) % 8), dtype=np.uint8)
    return np.packbits(arr.reshape(-1, 8)[:, ::-1], axis=1).tobytes()


def _py_gr_decompress(buf: np.ndarray, n_vals: int, k: int) -> np.ndarray:
    bits = np.unpackbits(buf)[: buf.size * 8]
    bits = bits.reshape(-1, 8)[:, ::-1].ravel()
    out = np.zeros(n_vals, dtype=np.uint32)
    pos = 0
    for i in range(n_vals):
        q = 0
        while q < QMAX and bits[pos]:
            q += 1
            pos += 1
        if q == QMAX:
            v = 0
            for j in range(32):
                v |= int(bits[pos + j]) << j
            pos += 32
        else:
            pos += 1  # the 0 terminator
            v = 0
            for j in range(k):
                v |= int(bits[pos + j]) << j
            pos += k
            v |= q << k
        out[i] = v
    return out
