"""The mesh and its collectives: the port's counterpart of a 1-D
``jax.sharding.Mesh`` and of the four ``jax.lax`` collectives the JAX
package's sharded path uses inside ``shard_map`` (``all_to_all``,
``all_gather``, ``ppermute``, ``psum``).

A ``Mesh`` has D shards. One process drives all of its shards at once:
every sharded tensor is stacked, ``(k, ...)`` for the k shards this process
holds, which in a single process is k = D, exactly the JAX pytree before
``shard_map`` splits it. On one card the D shard slots share the card (the
counterpart of XLA's virtual devices). In one process the collectives are
tensor ops on the stacked tensors:

- ``all_to_all``: a transpose of the ``(D, D, ...)`` send block;
- ``all_gather``: the stacked tensor itself, read as one;
- ``ppermute``: a copy along axis 0, zero where the permutation gives a
  shard no source, as ``lax.ppermute`` does;
- ``psum``: a sum over axis 0 (a fixed order, so equal inputs give equal
  bits).

With a ``torch.distributed`` group of W ranks (gloo for CPU tensors, NCCL
for the card) each rank holds k = D / W consecutive shards, and each
collective does its local part as above and its cross-rank part with
``all_to_all_single``, ``all_gather_into_tensor`` (``all_gather`` on
gloo), ``batch_isend_irecv`` and ``all_reduce``. A mesh with a group runs
``all_to_all``, ``all_gather`` and ``psum`` through it at every world
size, W = 1 too; a ``ppermute`` calls the backend only for the pairs that
cross ranks, which at W = 1 are none. Payloads cross ranks as bytes, so a
bf16, float8 or int8 wire needs no support of its dtype in the backend. A
sum over ranks has no fixed order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from saena_tpu_torch.runtime import resolve_device


class Mesh:
    """``n_shards`` shards on ``device`` (the card unless named), over the
    ranks of ``group`` (None: this process holds every shard).

    ``size`` is D, ``k`` the shards of this process, ``lo`` the global index
    of its first; ``local`` slices a host array of all D shards down to this
    process's."""

    def __init__(self, n_shards: int, device=None, group=None):
        if n_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, not {n_shards}")
        self.size = int(n_shards)
        self.device = resolve_device(device)
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        if self.size % self.world:
            raise ValueError(f"{self.size} shards do not split over "
                             f"{self.world} ranks")
        self.k = self.size // self.world
        self.lo = self.rank * self.k
        self.local = slice(self.lo, self.lo + self.k)
        self._perms: dict = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.size} shards, {self.device}, {self.world} "
                f"rank{'s' if self.world > 1 else ''})")

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def shard_ids(self) -> range:
        """Global indices of this process's shards."""
        return range(self.lo, self.lo + self.k)

    # ---- collectives -------------------------------------------------------

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """send (k, D, ...): send[d, e] goes from shard d to shard e.
        Returns recv (k, D, ...) with recv[d, e] = what shard e sent to d."""
        if self.group is None:
            return send.transpose(0, 1).contiguous()
        k, W = self.k, self.world
        rest = send.shape[2:]
        # (dest rank, dest shard, source shard, ...): chunk q goes to rank q
        inp = send.reshape(k, W, k, *rest).permute(1, 2, 0, *range(3, 3 + len(rest)))
        out = _from_bytes(_exchange_bytes(
            _bytes(inp), lambda o, i: dist.all_to_all_single(o, i, group=self.group)),
            inp.shape, send.dtype)
        # out[p, d, s] = from shard p*k + s to this rank's shard d
        return out.permute(1, 0, 2, *range(3, 3 + len(rest))).reshape(
            k, self.size, *rest)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x (k, ...) -> (D, ...): every shard's block, on every rank."""
        if self.group is None:
            return x
        b = _bytes(x)
        out = torch.empty((self.world,) + tuple(b.shape), dtype=torch.uint8,
                          device=b.device)
        if self.backend == "gloo":
            dist.all_gather(list(out.unbind(0)), b, group=self.group)
        else:
            dist.all_gather_into_tensor(out, b, group=self.group)
        return _from_bytes(out, (self.size,) + tuple(x.shape[1:]), x.dtype)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """x (k, ...); ``perm`` pairs (source shard, destination shard) of
        global indices. Shard d of the result holds the source's block, or
        zeros where no pair ends at d."""
        src, dst, sends, recvs = self._perm(tuple(perm))
        out = torch.zeros_like(x)
        if src is not None:
            out[dst] = x[src]
        if sends or recvs:
            ops = []
            bufs = []
            for s, d, peer in sends:
                ops.append(dist.P2POp(dist.isend, _bytes(x[s - self.lo]), peer,
                                      self.group, tag=s * self.size + d))
            for s, d, peer in recvs:
                buf = torch.empty_like(_bytes(x[0]))
                bufs.append((d - self.lo, buf))
                ops.append(dist.P2POp(dist.irecv, buf, peer, self.group,
                                      tag=s * self.size + d))
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            for d, buf in bufs:
                out[d] = _from_bytes(buf, x.shape[1:], x.dtype)
        return out

    def _perm(self, perm):
        """(local source index tensor, local destination index tensor, sends,
        receives) of a permutation, cached by its pairs; sends and receives
        cross ranks, in one order on both sides."""
        hit = self._perms.get(perm)
        if hit is None:
            mine = set(self.shard_ids())
            pairs = sorted(perm)
            loc = [(s - self.lo, d - self.lo) for s, d in pairs
                   if s in mine and d in mine]
            src = dst = None
            if loc:
                src = torch.tensor([s for s, _ in loc], device=self.device)
                dst = torch.tensor([d for _, d in loc], device=self.device)
            sends = [(s, d, d // self.k) for s, d in pairs
                     if s in mine and d not in mine]
            recvs = [(s, d, s // self.k) for s, d in pairs
                     if d in mine and s not in mine]
            hit = self._perms[perm] = (src, dst, sends, recvs)
        return hit

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """x (k, ...) -> (...): the sum over every shard, on every rank."""
        y = x.sum(0)
        if self.group is not None:
            dist.all_reduce(y, group=self.group)
        return y

    def pmax_host(self, v: float) -> float:
        """The largest of a host value over the ranks (every rank must call
        it)."""
        if self.group is None:
            return v
        t = torch.tensor([v], dtype=torch.float64,
                         device=self.device if self.backend == "nccl" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t.item())


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as its bytes: (..., last * itemsize) uint8."""
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8).reshape(*t.shape[:-1], -1) \
        if t.dim() else t.reshape(1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, shape, dtype) -> torch.Tensor:
    return b.contiguous().reshape(-1).view(dtype).reshape(shape)


def _exchange_bytes(b: torch.Tensor, fn) -> torch.Tensor:
    out = torch.empty_like(b)
    fn(out, b)
    return out


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards in this process (the JAX package's
    ``make_mesh``): by default one shard per CUDA card on the card, else one."""
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh(n_devices, dev)
