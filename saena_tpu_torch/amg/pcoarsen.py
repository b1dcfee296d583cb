"""p-coarsening for high-order (Nektar++-style) modal FEM discretizations.

A numpy module, the port's copy of saena_tpu/amg/pcoarsen.py (the same
functions and results; detect_modal_blocks counts the block pattern with a
sparse product instead of a dense copy of A, so it takes operators of any
size).

Re-design of saena_object_pcoarsen_modal.cpp: for modal bases, coarsening
order p -> p' SELECTS the subset of modal DOFs with mode index <= p' inside
each element, so the prolongation is a binary injection matrix (the
reference comment "modal basis no need for interpolation", :470).
Element-local selection formulas per element type follow
next_p_level_random (:221-341); coarse element maps are rebuilt per level
like mesh_info (:499-612); the level loop drops the order by
order_dif[level] until 1 (pcoarsen :12-218), after which h-coarsening
(smoothed aggregation) takes over: create_prolongation dispatches on p_order
(saena_object.cpp:541-551). ``hierarchy.setup(p_levels=)`` applies the
injections first.

Inputs mirror amg::set_matrix's Nektar overload (saena.hpp:202): per-element
node maps (1-based), bdydof (boundary nodes are numbered first), optional
g2u (local->universal matrix index, identity when running standalone), and
order_dif per level.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

TRI, QUAD, TET, HEX, PRISM, SEG = 0, 1, 2, 3, 4, 5


def element_type(n_dof: int, order: int) -> int:
    """Infer element type from the modal DOF count (ref :241-257; SEG added
    here for 1-D modal units — the layout of the bundled Helmholtz2D
    matrices, see io/nektar.py)."""
    op1 = order + 1
    if order >= 1 and n_dof == op1:
        return SEG
    if n_dof == op1 * op1:
        return QUAD
    if n_dof == op1 * op1 * op1:
        return HEX
    if n_dof == op1 * (order + 2) // 2:
        return TRI
    if n_dof == (order**3 + 11 * order) // 6 + order**2 + 1:
        return TET
    if n_dof == 6 + 9 * (order - 1) + 3 * (order - 1) ** 2 + \
            (order - 1) * (order - 2) + (order - 1) ** 2 * (order - 2) // 2:
        return PRISM
    raise ValueError(f"cannot infer element type: {n_dof} dofs at order {order}")


def coarse_dof_positions(order: int, next_order: int, etype: int) -> np.ndarray:
    """Element-local positions (0-based) of the DOFs that survive at
    next_order (ref next_p_level_random :221-341)."""
    op1 = order + 1
    pos = []
    if etype == SEG:
        pos = list(range(next_order + 1))
    elif etype == QUAD:
        for i in range(next_order + 1):
            for j in range(next_order + 1):
                pos.append(op1 * i + j)
    elif etype == HEX:
        for i in range(next_order + 1):
            for j in range(next_order + 1):
                for k in range(next_order + 1):
                    pos.append(op1 * op1 * i + op1 * j + k)
    elif etype == TRI:
        for i in range(next_order + 1):
            for j in range(next_order + 1 - i):
                pos.append((2 * order + 3 - i) * i // 2 + j)
    elif etype == TET:
        counter = 0
        for i in range(order + 1):
            for j in range(order + 1 - i):
                for k in range(order + 1 - i - j):
                    if i <= next_order and j <= next_order - i and \
                            k <= next_order - i - j:
                        pos.append(counter)
                    counter += 1
    elif etype == PRISM:
        counter = 0
        for i in range(order + 1):
            for j in range(order + 1):
                for k in range(order + 1 - i):
                    if i <= next_order and j <= next_order and \
                            k <= next_order - i:
                        pos.append(counter)
                    counter += 1
    else:
        raise ValueError(f"unknown element type {etype}")
    return np.asarray(pos, dtype=np.int64)


@dataclasses.dataclass
class PLevel:
    P: sp.csr_matrix          # fine-matrix-space -> coarse-matrix-space injection
    order: int                # fine order
    next_order: int
    elem_maps: list           # coarse per-element maps (1-based node ids)
    bdydof: int               # coarse boundary-node count


def _coarsen_maps(elem_maps, order: int, next_order: int):
    """One selection step: returns (coarse_node_ind sorted fine ids,
    coarse_elem_maps with 1-based coarse ids) — ref mesh_info :499-612."""
    selected = []
    per_elem = []
    for nodes in elem_maps:
        nodes = np.asarray(nodes, dtype=np.int64)
        etype = element_type(nodes.size, order)
        pos = coarse_dof_positions(order, next_order, etype)
        sel = nodes[pos]
        per_elem.append(sel)
        selected.append(sel)
    coarse_node_ind = np.unique(np.concatenate(selected))
    renum = {int(g): i + 1 for i, g in enumerate(coarse_node_ind)}  # 1-based
    coarse_maps = [np.asarray([renum[int(g)] for g in sel], dtype=np.int64)
                   for sel in per_elem]
    return coarse_node_ind, coarse_maps


def pcoarsen_step(elem_maps, order: int, next_order: int, bdydof: int,
                  g2u_f=None):
    """Build one injection P and the coarse-level mesh metadata.

    Node ids are 1-based; ids <= bdydof are boundary and excluded from the
    matrix space (ref set_P_from_mesh :357-497). g2u_f maps (node-1-bdydof)
    -> universal fine matrix row; identity if None."""
    coarse_node_ind, coarse_maps = _coarsen_maps(elem_maps, order, next_order)
    next_bdydof = int(np.sum(coarse_node_ind - 1 < bdydof))

    # coarse matrix space: interior coarse nodes, renumbered after boundary
    n_coarse = coarse_node_ind.size - next_bdydof

    rows, cols = [], []
    fine_of_coarse = {int(g): i + 1 for i, g in enumerate(coarse_node_ind)}
    for ei, nodes in enumerate(elem_maps):
        nodes = np.asarray(nodes, dtype=np.int64)
        etype = element_type(nodes.size, order)
        pos = coarse_dof_positions(order, next_order, etype)
        sel = nodes[pos]                       # fine 1-based ids that survive
        cmap = coarse_maps[ei]                 # coarse 1-based ids
        for fid, cid in zip(sel, cmap):
            if fid - 1 < bdydof:               # skip boundary nodes
                continue
            frow = int(fid - 1 - bdydof)
            if g2u_f is not None:
                frow = int(g2u_f[frow])
            ccol = int(cid - 1 - next_bdydof)
            rows.append(frow)
            cols.append(ccol)

    rc = np.unique(np.stack([rows, cols], axis=1), axis=0) if rows else \
        np.zeros((0, 2), dtype=np.int64)
    n_fine_rows = int(rc[:, 0].max()) + 1 if rc.size else 0
    P = sp.csr_matrix(
        (np.ones(rc.shape[0]), (rc[:, 0], rc[:, 1])),
        shape=(n_fine_rows, n_coarse),
    )
    return PLevel(P=P, order=order, next_order=next_order,
                  elem_maps=coarse_maps, bdydof=next_bdydof)


def pcoarsen_plevels(elem_maps, order: int, order_dif, bdydof: int = 0,
                     n_fine: int | None = None):
    """Full p-hierarchy: list of injection P matrices (matrix space), one per
    p-level, until order 1 (ref pcoarsen level loop + create_prolongation
    dispatch). order_dif[l] = order decrement at level l."""
    Ps = []
    maps = [np.asarray(m, dtype=np.int64) for m in elem_maps]
    cur_order = order
    cur_bdy = bdydof
    lvl = 0
    n_rows = n_fine
    while cur_order > 1:
        dif = order_dif[lvl] if lvl < len(order_dif) else order_dif[-1]
        next_order = max(1, cur_order - dif)
        step = pcoarsen_step(maps, cur_order, next_order, cur_bdy)
        P = step.P
        if n_rows is not None and P.shape[0] < n_rows:
            P = sp.csr_matrix(
                (P.data, P.indices, np.concatenate(
                    [P.indptr,
                     np.full(n_rows - P.shape[0], P.indptr[-1])])),
                shape=(n_rows, P.shape[1]))
        Ps.append(P)
        maps = step.elem_maps
        cur_bdy = step.bdydof
        cur_order = next_order
        n_rows = P.shape[1]
        lvl += 1
    return Ps


def detect_modal_blocks(A, nummodes: int) -> int:
    """Verify A has the per-unit modal block layout (n_units consecutive
    groups of ``nummodes`` rows, every coupled unit pair a fully dense
    nummodes x nummodes block) and return n_units. Raises if the layout
    does not hold; callers should fall back to plain h-coarsening then.
    The stored nonzeros of each unit pair's block are counted by a sparse
    product B^T pat B with B the row-to-unit map."""
    n = A.shape[0]
    if nummodes < 2 or n % nummodes:
        raise ValueError(f"n={n} not a multiple of nummodes={nummodes}")
    n_units = n // nummodes
    pat = (abs(A.tocsr()) > 0).astype(np.int64)
    B = sp.csr_matrix((np.ones(n, dtype=np.int64),
                       (np.arange(n), np.arange(n) // nummodes)),
                      shape=(n, n_units))
    blk = (B.T @ pat @ B).tocsr()
    blk.eliminate_zeros()
    if not (blk.data == nummodes * nummodes).all():
        raise ValueError("matrix blocks are not dense per modal unit")
    return int(n_units)


def modal_block_plevels(n_units: int, nummodes: int, order_dif=None):
    """p-level injections for the per-unit modal layout: unit u owns rows
    [u*nummodes, (u+1)*nummodes) ordered low->high mode, and order p -> p'
    keeps each unit's first p'+1 modes. This is the 1-D SEG specialization
    of next_p_level_random (ref :221-341) expressed directly; equivalent to
    pcoarsen_plevels over SEG element maps but without the python per-element
    loop. order_dif defaults to [1, 1, ...] (drop one order per level, ref
    pcoarsen loop :12-218); the chain stops at order 1 (two modes), after
    which h-coarsening takes over."""
    order = nummodes - 1
    if order_dif is None:
        order_dif = [1] * (order - 1)
    Ps = []
    cur = order
    lvl = 0
    while cur > 1:
        dif = order_dif[lvl] if lvl < len(order_dif) else order_dif[-1]
        nxt = max(1, cur - dif)
        pf, pc = cur + 1, nxt + 1
        rows = (np.arange(n_units)[:, None] * pf + np.arange(pc)).ravel()
        P = sp.csr_matrix(
            (np.ones(rows.size), (rows, np.arange(rows.size))),
            shape=(n_units * pf, n_units * pc))
        Ps.append(P)
        cur = nxt
        lvl += 1
    return Ps
