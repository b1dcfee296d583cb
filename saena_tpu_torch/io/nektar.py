"""Nektar++ session-file reader (mesh + expansion metadata).

The reference receives its p-coarsening inputs (per-element dof maps, g2u,
bdydof, order_dif) at runtime from an embedding Nektar++ application
(amg::set_matrix Nektar overload, saena.hpp:202); the bundled
Helmholtz2D_CG_curved_tri data ships the Nektar session XMLs next to the
matrices. This module decodes those sessions standalone so the same
workloads can be driven without Nektar: the compressed GEOMETRY blocks
(``COMPRESSED="B64Z-LittleEndian"`` = base64 of zlib of packed little-endian
structs, Nektar's CompressData format: vertex = uint64 id + 3 f64, edge =
3x uint64, tri = 4x uint64, quad = 5x uint64), the COMPOSITE id lists, the
BOUNDARYREGIONS -> composite mapping, and the EXPANSIONS NUMMODES/TYPE.

For the bundled matrices the derived facts that matter downstream are
``n_units = interior edge count`` and ``nummodes``: each matrix is exactly
(n_units * nummodes) square with a dense nummodes x nummodes modal block per
coupled edge pair, i.e. the modal "segment" layout that saena_tpu's
p-coarsening (amg/pcoarsen.py, not yet in the port) coarsens. The module
is a copy of saena_tpu/io/nektar.py.
"""
from __future__ import annotations

import base64
import dataclasses
import re
import zlib

import numpy as np


@dataclasses.dataclass
class NektarMesh:
    dim: int
    vert_ids: np.ndarray        # (V,) uint64
    verts: np.ndarray           # (V, 3) float64
    edge_ids: np.ndarray        # (E,)
    edges: np.ndarray           # (E, 2) vertex ids
    tri_ids: np.ndarray         # (T,)
    tris: np.ndarray            # (T, 3) edge ids
    quad_ids: np.ndarray        # (Q,)
    quads: np.ndarray           # (Q, 4) edge ids
    composites: dict            # id -> (kind char, np.ndarray of ids)
    boundary_composites: list   # composite ids referenced by BOUNDARYREGIONS
    nummodes: int               # EXPANSIONS NUMMODES (modal order + 1)
    basis_type: str             # EXPANSIONS TYPE (e.g. MODIFIED)

    @property
    def boundary_edges(self) -> np.ndarray:
        """Edge ids belonging to boundary composites."""
        out = [ids for cid in self.boundary_composites
               for kind, ids in [self.composites[cid]] if kind == "E"]
        return (np.unique(np.concatenate(out)) if out
                else np.zeros(0, dtype=np.int64))

    @property
    def interior_edges(self) -> np.ndarray:
        """Edge ids NOT on the boundary — the dof-carrying units of the
        bundled modal matrices."""
        return np.setdiff1d(self.edge_ids.astype(np.int64),
                            self.boundary_edges)


def _inflate(payload: str) -> bytes:
    return zlib.decompress(base64.b64decode(payload.strip()))


def _block(txt: str, pattern: str) -> bytes | None:
    m = re.search(pattern, txt, re.S)
    return _inflate(m.group(1)) if m else None


def _ranges(spec: str) -> np.ndarray:
    """Parse a Nektar id list like ``0,4,11-13`` into an int array."""
    ids = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            ids.extend(range(int(lo), int(hi) + 1))
        else:
            ids.append(int(part))
    return np.asarray(ids, dtype=np.int64)


def read_nektar(path: str) -> NektarMesh:
    """Parse a Nektar++ session XML (compressed-geometry variant)."""
    txt = open(path).read()

    m = re.search(r"<GEOMETRY\s+DIM=\"(\d+)\"", txt)
    dim = int(m.group(1)) if m else 2

    def records(tag_pat, n_ints, has_coords=False):
        raw = _block(txt, tag_pat)
        if raw is None:
            z = np.zeros(0, dtype=np.uint64)
            return z, (np.zeros((0, 3)) if has_coords
                       else z.reshape(0, max(1, n_ints - 1)))
        if has_coords:          # uint64 id + 3 float64
            rec = np.frombuffer(raw, dtype=np.dtype(
                [("id", "<u8"), ("xyz", "<f8", (3,))]))
            return rec["id"].copy(), rec["xyz"].copy()
        arr = np.frombuffer(raw, dtype="<u8").reshape(-1, n_ints)
        return arr[:, 0].copy(), arr[:, 1:].copy()

    vert_ids, verts = records(
        r"<VERTEX[^>]*COMPRESSED[^>]*>(.*?)</VERTEX>", 4, has_coords=True)
    edge_ids, edges = records(r"<EDGE[^>]*COMPRESSED[^>]*>(.*?)</EDGE>", 3)
    tri_ids, tris = records(r"<T\s+COMPRESSED[^>]*>(.*?)</T>", 4)
    quad_ids, quads = records(r"<Q\s+COMPRESSED[^>]*>(.*?)</Q>", 5)

    composites = {}
    comp_block = re.search(r"<COMPOSITE>(.*?)</COMPOSITE>", txt, re.S)
    if comp_block:
        for cm in re.finditer(
                r"<C\s+ID=\"(\d+)\">\s*([A-Z])\[([^\]]*)\]\s*</C>",
                comp_block.group(1)):
            composites[int(cm.group(1))] = (cm.group(2), _ranges(cm.group(3)))

    boundary = []
    breg = re.search(r"<BOUNDARYREGIONS>(.*?)</BOUNDARYREGIONS>", txt, re.S)
    if breg:
        for bm in re.finditer(r"<B\s+ID=\"\d+\">\s*C\[([^\]]*)\]\s*</B>",
                              breg.group(1)):
            boundary.extend(int(x) for x in _ranges(bm.group(1)))

    nummodes, btype = 0, ""
    em = re.search(r"<E\s[^>]*NUMMODES=\"(\d+)\"[^>]*TYPE=\"(\w+)\"", txt)
    if em:
        nummodes, btype = int(em.group(1)), em.group(2)

    return NektarMesh(dim=dim, vert_ids=vert_ids, verts=verts,
                      edge_ids=edge_ids, edges=edges,
                      tri_ids=tri_ids, tris=tris,
                      quad_ids=quad_ids, quads=quads,
                      composites=composites, boundary_composites=boundary,
                      nummodes=nummodes, basis_type=btype)
