"""Row-wise CSR SpGEMM ("K5"): the kernel wrapper, the CSR operands on a
device, and the plain PyTorch version.

    C = X @ Y, bit for bit ``_native.spgemm_csr(X, Y)``

for canonical float64 CSR operands (sorted columns, no duplicates). The
setup's Galerkin products take it on the card (amg/galerkin.py routes them);
it replaces no Pallas kernel: the JAX package takes those products on the
host.

The host kernel's arithmetic, which both versions here repeat: row i's
pattern is the union of the Y rows its X entries reach (explicit zeros
kept, columns ascending); C[i, j] adds the products X[i, k] * Y[k, j] in
the stored order of X's row, each product rounded and the add rounded, no
fused multiply-add. Its stamped rows store the first product and add the
others; its dense paths (a row of at least ``zero_min_flops`` multiply-adds)
add every product to a zeroed array. Both agree but for the sign of a zero
result, so the versions here start each accumulator at -0.0 (-0.0 + p == p
for every p) or, on those dense rows, at +0.0.

`csr_spgemm` launches the CUDA kernel (csrc/csr_spgemm.cu) for operands on
the card and raises for any other; `csr_spgemm_plain` is the same function
in torch ops on the CPU, for the CPU tests. Launches are recorded in
`runtime.launches` ("csr_spgemm": two a product, the count and the fill pass).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch.ops import cuda_build
from saena_tpu_torch.runtime import launched

MAX_WINDOW = 25_600   # output columns a block holds (shared with csrc/csr_spgemm.cu)

# one product at a time on the card: the shard-parallel setup calls in from
# several pool threads
_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class DeviceCsr:
    """A canonical float64 CSR matrix as tensors on one device: ``indptr``
    int64 (n + 1), ``indices`` int32 and ``values`` float64 (nnz)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    shape: tuple

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> int:
        return self.values.numel()

    @classmethod
    def from_host(cls, M: sp.csr_matrix, device) -> "DeviceCsr":
        """M's arrays on ``device``; M must be canonical float64 CSR."""
        if not is_canonical(M):
            raise ValueError("DeviceCsr: the matrix must be float64 CSR with sorted "
                             "columns and no duplicates")
        if max(M.shape) >= 2**31:
            raise ValueError(f"DeviceCsr: shape {M.shape} past int32 indexing")
        put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)
        return cls(put(M.indptr, np.int64), put(M.indices, np.int32),
                   put(M.data, np.float64), tuple(M.shape))

    def to_host(self) -> sp.csr_matrix:
        """The scipy CSR, flagged canonical."""
        out = sp.csr_matrix((self.values.cpu().numpy(), self.indices.cpu().numpy(),
                             self.indptr.cpu().numpy()), shape=self.shape)
        out.has_sorted_indices = True
        out.has_canonical_format = True
        return out

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr.cpu().numpy())


def is_canonical(M) -> bool:
    """Whether M is a product operand K5 takes: a DeviceCsr, or a float64
    scipy CSR with sorted columns and no duplicates."""
    if isinstance(M, DeviceCsr):
        return True
    return (sp.issparse(M) and M.format == "csr" and M.dtype == np.float64
            and bool(M.has_canonical_format))


def zero_min_flops(k_rows: int, y_held: int, m: int) -> int:
    """The multiply-adds from which the host kernel accumulates a row from a
    zeroed array: ``m`` (its "flops >= m" rows), or ``m // 4`` when it takes
    its dense-Y panel (Y's first ``k_rows`` rows, the ones X's columns can
    reach, hold ``y_held`` entries: at least 65% of them, and the panel at
    most 3.2e7 doubles). Mirrors _native/spgemm.cpp."""
    if m == 0:
        return 0
    dense_y = (k_rows > 0 and float(y_held) / (float(k_rows) * float(m)) >= 0.65
               and float(k_rows) * float(m) <= 3.2e7)
    return m // 4 if dense_y else m


def _zero_min_flops(X: DeviceCsr, Y: DeviceCsr) -> int:
    k_rows = int(X.indices.max()) + 1 if X.nnz else 0
    return zero_min_flops(k_rows, int(Y.indptr[k_rows]), Y.shape[1])


def windows(m: int) -> tuple[int, int]:
    """(windows, columns a window) of an output m columns wide: the fewest
    windows of at most MAX_WINDOW columns, each a multiple of 32."""
    nwin = max(1, -(-m // MAX_WINDOW))
    win = -(-max(1, -(-m // nwin)) // 32) * 32
    return nwin, win


def csr_spgemm_plain(X: DeviceCsr, Y: DeviceCsr) -> DeviceCsr:
    """X @ Y in torch ops on the CPU, with the kernel's arithmetic: every
    product in (X entry, Y entry) order, grouped by output entry in that
    order, and added one rank at a time onto -0.0 or +0.0."""
    n, k = X.shape
    k2, m = Y.shape
    if k != k2:
        raise ValueError(f"csr_spgemm_plain: shapes {X.shape} and {Y.shape}")
    i64 = torch.int64
    xi = X.indices.to(i64)
    ylen = Y.indptr.diff()[xi]                           # a Y row per X entry
    erow = torch.repeat_interleave(torch.arange(n), X.indptr.diff())
    flops = torch.zeros(n, dtype=i64).index_add_(0, erow, ylen)
    ent = torch.repeat_interleave(torch.arange(xi.numel()), ylen)
    first = torch.cumsum(ylen, 0) - ylen
    pb = Y.indptr[xi][ent] + torch.arange(ent.numel()) - first[ent]
    key = erow[ent] * m + Y.indices[pb].to(i64)
    prod = X.values[ent] * Y.values[pb]
    key, order = torch.sort(key, stable=True)
    prod = prod[order]
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    rank = torch.arange(key.numel()) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    group = torch.repeat_interleave(torch.arange(uniq.numel()), counts)
    urow = uniq // max(m, 1)
    acc = torch.full((uniq.numel(),), -0.0, dtype=torch.float64)
    acc[flops[urow] >= _zero_min_flops(X, Y)] = 0.0
    rank, by_rank = torch.sort(rank, stable=True)
    bounds = torch.searchsorted(rank, torch.arange(int(counts.max()) + 1 if counts.numel() else 1))
    for r0, r1 in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        sel = by_rank[r0:r1]
        g = group[sel]
        acc[g] = acc[g] + prod[sel]
    indptr = torch.zeros(n + 1, dtype=i64)
    indptr[1:] = torch.cumsum(torch.bincount(urow, minlength=n), 0)
    return DeviceCsr(indptr, (uniq % max(m, 1)).to(torch.int32), acc, (n, m))


@functools.cache
def _library():
    lib = cuda_build.load("csr_spgemm")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.saena_csr_spgemm_count.argtypes = [i64, i, i, p, p, p, p, p, p, p]
    lib.saena_csr_spgemm_count.restype = ctypes.c_int
    lib.saena_csr_spgemm_fill.argtypes = [i64, i, i, p, p, p, p, p, p, p, p, i64, p, p, p]
    lib.saena_csr_spgemm_fill.restype = ctypes.c_int
    return lib


def _check(X: DeviceCsr, Y: DeviceCsr) -> torch.device:
    if not (isinstance(X, DeviceCsr) and isinstance(Y, DeviceCsr)):
        raise TypeError("csr_spgemm: operands must be DeviceCsr (canonical float64 CSR)")
    if X.shape[1] != Y.shape[0]:
        raise ValueError(f"csr_spgemm: shapes {X.shape} and {Y.shape}")
    arrays = [(name, t, dt, size) for M in (X, Y) for name, t, dt, size in (
        ("indptr", M.indptr, torch.int64, M.shape[0] + 1),
        ("indices", M.indices, torch.int32, M.nnz),
        ("values", M.values, torch.float64, M.nnz))]
    for name, t, dt, size in arrays:
        if t.dtype != dt or not t.is_contiguous() or t.dim() != 1 or t.numel() != size:
            raise ValueError(f"csr_spgemm: {name} must be contiguous {dt} ({size},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    dev = X.device
    for name, t, *_ in arrays:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"csr_spgemm: {name} on {t.device}; the kernel takes "
                             "operands on one CUDA device")
    return dev


def csr_spgemm(X: DeviceCsr, Y: DeviceCsr) -> DeviceCsr:
    """X @ Y on the card through K5, bit for bit the host kernel's product."""
    dev = _check(X, Y)
    n, m = X.shape[0], Y.shape[1]
    nwin, win = windows(m)
    lib = _library()
    with _LOCK, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        zmin = _zero_min_flops(X, Y)
        win_nnz = torch.empty(n * nwin, dtype=torch.int64, device=dev)
        row_flops = torch.empty(n, dtype=torch.int64, device=dev)
        rc = lib.saena_csr_spgemm_count(
            n, win, nwin, X.indptr.data_ptr(), X.indices.data_ptr(), Y.indptr.data_ptr(),
            Y.indices.data_ptr(), win_nnz.data_ptr(), row_flops.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"csr_spgemm: count launch failed with CUDA error {rc}")
        launched("csr_spgemm")
        offs = torch.zeros(n * nwin + 1, dtype=torch.int64, device=dev)
        offs[1:] = torch.cumsum(win_nnz, 0)
        nnz = int(offs[-1])
        indices = torch.empty(nnz, dtype=torch.int32, device=dev)
        values = torch.empty(nnz, dtype=torch.float64, device=dev)
        rc = lib.saena_csr_spgemm_fill(
            n, win, nwin, X.indptr.data_ptr(), X.indices.data_ptr(), X.values.data_ptr(),
            Y.indptr.data_ptr(), Y.indices.data_ptr(), Y.values.data_ptr(), offs.data_ptr(),
            row_flops.data_ptr(), zmin, indices.data_ptr(), values.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"csr_spgemm: fill launch failed with CUDA error {rc}")
        launched("csr_spgemm")
        return DeviceCsr(offs[::nwin].contiguous(), indices, values, (n, m))
