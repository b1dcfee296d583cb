"""Static halo-exchange plans (the reference's vIndex / vdispls analog,
saena_matrix_setup.cpp:793-1098), ported from saena_tpu/parallel/halo.py.

A row-sharded operator's halo pattern is fixed at setup as an index array
``send_idx`` (k, D, max_send): the local slots each shard packs for each
other shard. The exchange is

    send = x_loc[send_idx]            # (k, D, max_send) gather: the pack
    recv = mesh.all_to_all(send)      # the Isend/Irecv
    x_ext = cat([x_loc, recv])        # [own block | what shard 0 sent | ...]

and the operator's column ids are remapped into this extended local space
at setup, so the remote accumulation disappears into the local gather.
Per-pair counts are padded to the largest, so every shape is static.

Compressed halos (the ZFP analog, saena_matrix_zfp.cpp): the send buffer is
cast to a narrower float for the wire, or coded by ``int8_block``, a
fixed-rate codec: 128 lanes quantized to int8 under one power-of-2 exponent
byte per chunk (129 wire bytes per 128 values). Power-of-2 scales make
re-encoding idempotent, so multi-hop halo chains do not compound the error.

Vectors are "blocked-padded": shard d's rows sit at [d * n_loc_pad,
d * n_loc_pad + rows_d), so the all-gathered stacked blocks are the
blocked-padded global vector.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from saena_tpu_torch.ops.formats import pad_to
from saena_tpu_torch.parallel.comm import Mesh


# ---------------------------------------------------------------------------
# block-scaled int8 fixed-rate codec
# ---------------------------------------------------------------------------


def int8_block_encode(v: torch.Tensor) -> torch.Tensor:
    """(..., c * 128) float -> (..., c, 129) int8 wire buffer: 128 quantized
    lanes and a shared power-of-2 exponent byte per chunk; |q| <= 127 by
    the choice e = ceil(log2(amax / 127))."""
    ch = v.reshape(*v.shape[:-1], -1, 128)
    amax = ch.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    e = torch.clamp(torch.ceil(torch.log2(safe / 127.0)), -126, 126)
    q = torch.round(ch * torch.exp2(-e)).to(torch.int8)
    q = torch.where(amax > 0, q, torch.zeros_like(q))
    return torch.cat([q, e.to(torch.int8)], dim=-1)


def int8_block_decode(buf: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of int8_block_encode: (..., c, 129) int8 -> (..., c * 128)."""
    q = buf[..., :128].to(dtype)
    e = buf[..., 128:].to(dtype)
    out = q * torch.exp2(e)
    return out.reshape(*out.shape[:-2], -1)


def wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a halo wire name ("bfloat16", "float16",
    "float8_e4m3fn", "float32", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown halo wire dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True, eq=False)
class HaloPlan:
    """A sharded operator's halo exchange over ``mesh``: send_idx[d, e] =
    the local slots shard d packs for shard e (this process's shards d)."""

    send_idx: torch.Tensor         # (k, D, max_send) int64
    n_local: int                   # n_loc_pad of the COLUMN space
    max_send: int
    mesh: Mesh
    mode: str = "exchange"         # exchange | allgather | direct | none
    compress: str = ""             # "", a float wire dtype name, "int8_block"

    def _recv(self, send: torch.Tensor, exact: bool) -> torch.Tensor:
        """The all_to_all of ``send`` on the plan's wire (int8_block codes
        the last axis, a multiple of 128), back at send's dtype."""
        move = self.mesh.all_to_all
        if exact or not self.compress:
            return move(send)
        if self.compress == "int8_block":
            return int8_block_decode(move(int8_block_encode(send)), send.dtype)
        return move(send.to(wire_dtype(self.compress))).to(send.dtype)

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """The send block (k, D, max_send): x[d][send_idx[d, e]]."""
        k = x.shape[0]
        return torch.gather(x, 1, self.send_idx.reshape(k, -1)).reshape(
            self.send_idx.shape)

    def pack_chunks(self, x: torch.Tensor) -> torch.Tensor:
        """The chunk send block (k, D, max_send * 128): send_idx as chunk ids
        of x viewed as 128-wide chunks."""
        k = x.shape[0]
        idx = self.send_idx.reshape(k, -1, 1).expand(-1, -1, 128)
        return torch.gather(x.reshape(k, -1, 128), 1, idx).reshape(
            *self.send_idx.shape[:2], -1)

    def extend(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        """The extended local vector the SpMV gathers from: x (k, n_local)
        -> (k, n_local + D * max_send) in exchange mode; x itself in direct
        mode; the blocked-padded global vector (D * n_local,), one for
        every shard, in allgather mode. ``exact`` skips the compression
        (the outer Krylov matvecs see the exact operator; only the
        preconditioner's ride the lossy wire)."""
        if self.mode in ("direct", "none"):
            return x
        if self.mode == "allgather":
            return self.mesh.all_gather(x).reshape(-1)
        recv = self._recv(self.pack(x), exact)
        return torch.cat([x, recv.reshape(x.shape[0], -1)], dim=1)

    def extend_chunks(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        """Chunk-granular halo: x (k, n_local) as 128-wide chunks, send_idx
        holding chunk ids. Returns (k, n_chunks_ext, 128), or the shared
        (D * n_local / 128, 128) in allgather mode."""
        k = x.shape[0]
        xb = x.reshape(k, -1, 128)
        if self.mode in ("direct", "none"):
            return xb
        if self.mode == "allgather":
            return self.mesh.all_gather(x).reshape(-1, 128)
        recv = self._recv(self.pack_chunks(x), exact)
        return torch.cat([xb, recv.reshape(k, -1, 128)], dim=1)


def owner_of(cols: np.ndarray, split: np.ndarray) -> np.ndarray:
    """Owning shard of each global column id (ref lower_bound2 over split)."""
    return np.searchsorted(split, cols, side="right") - 1


def build_halo_plan(row_cols_per_dev: list, col_split: np.ndarray,
                    mode: str = "exchange", compress: str = ""):
    """(send_idx, n_local, max_send, remap) of a row-sharded matrix whose
    column ids live in the space that ``col_split`` partitions, all host
    numpy: send_idx is (D, D, max_send) int32 over every shard (a
    ``HaloPlan`` takes this process's rows of it, ``plan_on``).

    row_cols_per_dev[d]: global column ids appearing in shard d's rows.
    ``remap(d, g)`` maps global column ids of shard d to its extended-local
    indices."""
    D = len(col_split) - 1
    n_loc = [int(col_split[e + 1] - col_split[e]) for e in range(D)]
    n_loc_pad = pad_to(max(n_loc) if n_loc else 1)

    if mode == "direct":
        # x is fully addressable on every shard (a replicated input):
        # column ids map straight into its plain padded indexing
        def remap(d, g):
            return np.asarray(g, dtype=np.int32)

        return np.zeros((max(D, 1), max(D, 1), 1), np.int32), n_loc_pad, 0, remap

    if mode == "allgather":
        # the extended vector is the blocked-padded global vector
        def remap(d, g):
            own = owner_of(g, col_split)
            return (own * n_loc_pad + (g - col_split[own])).astype(np.int32)

        return np.zeros((D, D, 1), np.int32), n_loc_pad, 0, remap

    # needed[d][e]: sorted unique global ids shard d needs from e (e != d)
    needed = [[None] * D for _ in range(D)]
    for d in range(D):
        g = np.unique(np.asarray(row_cols_per_dev[d], dtype=np.int64))
        own = owner_of(g, col_split)
        for e in range(D):
            if e != d:
                needed[d][e] = g[own == e]
    max_send = max([1] + [len(needed[d][e]) for d in range(D)
                          for e in range(D) if e != d])
    if compress == "int8_block":
        # the codec chunks the send buffer into 128-lane blocks
        max_send = pad_to(max_send)

    # send_idx[e, d] = local slots e packs for d (= what d needs from e)
    send_idx = np.zeros((D, D, max_send), dtype=np.int32)
    for e in range(D):
        for d in range(D):
            need = needed[d][e]
            if e != d and len(need):
                send_idx[e, d, : len(need)] = (need - col_split[e]).astype(np.int32)

    # extended layout of shard d: [own n_loc_pad | e0's max_send | e1's ...];
    # lookup[d] holds its halo ids sorted, with their extended slots
    lookup = []
    for d in range(D):
        ids = [needed[d][e] for e in range(D) if e != d]
        slots = [n_loc_pad + e * max_send + np.arange(len(needed[d][e]))
                 for e in range(D) if e != d]
        ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        slots = np.concatenate(slots) if slots else np.zeros(0, np.int64)
        order = np.argsort(ids, kind="stable")
        lookup.append((ids[order], slots[order]))

    def remap(d, g):
        g = np.asarray(g, dtype=np.int64)
        own = owner_of(g, col_split)
        out = np.empty(g.shape, dtype=np.int32)
        local = own == d
        out[local] = (g[local] - col_split[d]).astype(np.int32)
        ids, slots = lookup[d]
        rem = g[~local]
        pos = np.searchsorted(ids, rem)
        if rem.size and (pos.max() >= ids.size or (ids[pos] != rem).any()):
            raise KeyError(f"shard {d}: a column outside its halo plan")
        out[~local] = slots[pos]
        return out

    return send_idx, n_loc_pad, max_send, remap


def plan_on(mesh: Mesh, send_idx: np.ndarray, n_local: int, max_send: int,
            mode: str, compress: str = "") -> HaloPlan:
    """The HaloPlan of this process's shards, on the mesh's device."""
    D = mesh.size
    if send_idx.shape[0] != D:
        # keep the leading axis that of the mesh
        send_idx = np.zeros((D, D, 1), np.int32)
    return HaloPlan(
        send_idx=torch.from_numpy(np.ascontiguousarray(
            send_idx[mesh.local], dtype=np.int64)).to(mesh.device),
        n_local=int(n_local), max_send=int(max_send), mesh=mesh, mode=mode,
        compress=compress)
