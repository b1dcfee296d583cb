"""Distributed SpGEMM: ring-pipelined C = A @ B over the mesh.

The port of saena_tpu/ops/spgemm.py, the replacement of the reference's
matmat engine (saena_object_setup_matmat.cpp:1710-2470): there, B's CSC
blocks rotate around an MPI ring, each step overlapping the transfer with a
recursive fast_mm local multiply whose base case is MKL's CSR SpGEMM with
a bounded dense accumulator (matmat_thre1 = 2e7 caps row_sz*col_sz).

Here the ring is ``Mesh.ppermute`` (a copy along the stacked shard axis in
one process, ``batch_isend_irecv`` across ranks) and the local multiply
takes one of two forms:

- "dense" (``_ring_spgemm_dense``): blocks are densified and each ring step
  is one batched matrix product over this process's shards
  (``torch.baddbmm``; the JAX package's ``jnp.dot`` at HIGHEST precision,
  outside any Pallas kernel). ``runtime.resolve_device`` keeps TF32 off, so
  an f32 product rounds as f32 does. Dense blocks win once the operands
  are a few percent dense (the dense accumulator the reference bounds with
  matmat_thre1, promoted to the whole strategy).
- "sparse" (``ops/bspgemm.matmat_sparse``): the block-sparse ring, memory
  ∝ nonzero blocks.

``matmat`` picks one by operand density and size (``_use_dense_ring``).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from saena_tpu_torch.ops.formats import pad_to
from saena_tpu_torch.parallel.partition import equal_row_split


def _dense_blocks(A: sp.spmatrix, split: np.ndarray, n_cols_pad: int, dtype,
                  mesh):
    """This process's dense row blocks (k, n_loc_pad, n_cols_pad) on the
    mesh's device, and n_loc_pad (over all D blocks)."""
    n_loc_pad = pad_to(int(np.max(np.diff(split))))
    A = A.tocsr()
    out = torch.zeros((mesh.k, n_loc_pad, n_cols_pad), dtype=dtype)
    for j, d in enumerate(mesh.shard_ids()):
        blk = A[split[d]: split[d + 1]]
        out[j, : blk.shape[0], : blk.shape[1]] = torch.from_numpy(blk.toarray())
    return out.to(mesh.device), n_loc_pad


def _ring_spgemm_dense(A_blocks: torch.Tensor, B_blocks: torch.Tensor,
                       mesh) -> torch.Tensor:
    """A_blocks: (k, n_loc_pad, m_pad), A's row blocks with columns in the
    blocked-padded layout of B's row space (m_pad = D * m_loc_pad).
    B_blocks: (k, m_loc_pad, k_pad). Returns this process's C blocks (k,
    n_loc_pad, k_pad). At step s shard d multiplies its column slice e =
    (d + s) mod D by the B block it holds, B_e, then B moves one shard down
    the ring; the last step's rotation, which would bring B home, is left
    out."""
    D = mesh.size
    k, n_loc, _ = A_blocks.shape
    m_loc = B_blocks.shape[1]
    A4 = A_blocks.view(k, n_loc, D, m_loc)
    own = torch.arange(k, device=A_blocks.device)
    C = torch.zeros((k, n_loc, B_blocks.shape[2]), dtype=A_blocks.dtype,
                    device=A_blocks.device)
    perm = [(j, (j - 1) % D) for j in range(D)]
    B_cur = B_blocks
    for s in range(D):
        e = (own + mesh.lo + s) % D
        C.baddbmm_(A4[own, :, e, :], B_cur)
        if s < D - 1:
            B_cur = mesh.ppermute(B_cur, perm)
    return C


def matmat_prepare(A: sp.spmatrix, B: sp.spmatrix, mesh, dtype=torch.float32):
    """Host -> device distribution, once: the counterpart of the reference's
    assemble + CSC conversion + compress_prep before its timed matmat loop
    (setup_matmat.cpp:1164-1360). Returns (A_blocks, B_blocks, a_split),
    device-resident operands for repeated matmat_run calls."""
    if A.shape[1] != B.shape[0]:
        raise ValueError("inner dimensions must match")
    D = mesh.size
    a_split = equal_row_split(A.shape[0], D)
    b_split = equal_row_split(B.shape[0], D)
    m_loc_pad = pad_to(int(np.max(np.diff(b_split))))
    k_pad = pad_to(B.shape[1])

    # A's columns must address the blocked-padded layout of B's rows
    A_perm = _blocked_pad_cols(A.tocsc(), b_split, m_loc_pad)
    A_blocks, _ = _dense_blocks(A_perm, a_split, D * m_loc_pad, dtype, mesh)
    B_blocks, _ = _dense_blocks(B, b_split, k_pad, dtype, mesh)
    return A_blocks, B_blocks, a_split


def matmat_run(A_blocks, B_blocks, mesh) -> torch.Tensor:
    """The ring product on device-resident operands (the timed region of
    the reference's matmat benchmark)."""
    return _ring_spgemm_dense(A_blocks, B_blocks, mesh)


# density/size switch between the dense ring and the block-sparse ring (the
# role matmat_thre1/matmat_thre2 play in the reference's fast_mm,
# saena_object.h:75-85): dense blocks win once operands are a few percent
# dense AND the O(n*m/D) block memory is affordable
MATMAT_DENSE_THRE = 0.01        # min operand density for the dense ring
MATMAT_DENSE_ELEMS = 5e7        # max per-shard dense-block elements


def _use_dense_ring(A: sp.spmatrix, B: sp.spmatrix, D: int) -> bool:
    dens_a = A.nnz / max(1, A.shape[0] * A.shape[1])
    dens_b = B.nnz / max(1, B.shape[0] * B.shape[1])
    elems = (A.shape[0] * A.shape[1] + B.shape[0] * B.shape[1]
             + A.shape[0] * B.shape[1]) / max(1, D)
    return min(dens_a, dens_b) >= MATMAT_DENSE_THRE and \
        elems <= MATMAT_DENSE_ELEMS


def matmat(A: sp.spmatrix, B: sp.spmatrix, mesh, dtype=torch.float32,
           assemble: bool = True, tol: float = 0.0, mode: str = "auto"):
    """Distributed C = A @ B on the mesh (ref saena::amg::matmat,
    setup_matmat.cpp:1164-1487). mode: "auto" picks the dense ring or the
    block-sparse ring by operand density (the matmat_thre1 counterpart);
    "dense" / "sparse" force one. Returns scipy CSR (on every rank) when
    ``assemble``, else the dense ring's C blocks of this process (k,
    n_loc_pad, k_pad) and the row split."""
    if mode not in ("auto", "dense", "sparse"):
        raise ValueError(f"mode must be 'auto', 'dense' or 'sparse', not {mode!r}")
    D = mesh.size
    use_dense = (mode == "dense") or (mode == "auto" and
                                      _use_dense_ring(A, B, D))
    if not use_dense and assemble:
        from saena_tpu_torch.ops.bspgemm import matmat_sparse
        return matmat_sparse(A, B, mesh, dtype=dtype, tol=tol)

    A_blocks, B_blocks, a_split = matmat_prepare(A, B, mesh, dtype)
    C_blocks = _ring_spgemm_dense(A_blocks, B_blocks, mesh)
    if not assemble:
        return C_blocks, a_split

    C = np.zeros((A.shape[0], B.shape[1]))
    cb = mesh.all_gather(C_blocks).cpu().numpy()
    for d in range(D):
        rows = a_split[d + 1] - a_split[d]
        C[a_split[d]: a_split[d + 1]] = cb[d, :rows, : B.shape[1]]
    Cs = sp.csr_matrix(C)
    if tol > 0:
        Cs.data[np.abs(Cs.data) < tol] = 0.0
    Cs.eliminate_zeros()
    return Cs


def _blocked_pad_cols(A_csc: sp.csc_matrix, col_split: np.ndarray,
                      n_loc_pad: int) -> sp.csr_matrix:
    """Re-index A's columns into the blocked-padded layout of col_split."""
    coo = A_csc.tocoo()
    own = np.searchsorted(col_split, coo.col, side="right") - 1
    new_col = own * n_loc_pad + (coo.col - col_split[own])
    D = len(col_split) - 1
    return sp.csr_matrix(
        (coo.data, (coo.row, new_col)), shape=(A_csc.shape[0], D * n_loc_pad))


def triple_product(R: sp.spmatrix, A: sp.spmatrix, P_: sp.spmatrix, mesh,
                   dtype=torch.float32, tol: float = 1e-14,
                   mode: str = "auto") -> sp.csr_matrix:
    """Distributed Galerkin Ac = R*A*P as two ring SpGEMMs (ref
    triple_mat_mult, saena_object_setup2.cpp:361-849). Sparse fine
    operators route through the block-sparse ring (memory ∝ nonzero
    blocks), so device RAP scales with nnz instead of O(n^2/D)."""
    RA = matmat(R, A, mesh, dtype=dtype, tol=tol, mode=mode)
    return matmat(RA, P_, mesh, dtype=dtype, tol=tol, mode=mode)
