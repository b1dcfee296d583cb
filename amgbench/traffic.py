"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and the seed give the inputs, and a closed loop with one caller drives the
program with them, one record a request.

Parameters of a mix:

- ``rhs_pool``: right-hand sides made in set-up; the first
  ``manufactured_rhs`` of them (0 or 1) are the configuration's
  manufactured rhs, the rest uniform(-1, 1). Request ``i`` takes
  ``pool[order[i % rhs_pool]]``, ``order`` a permutation drawn from the seed.
- ``solver``: the ``AMG`` method each request calls after ``set_rhs``.
- ``update`` (optional): the ``AMG`` lazy update each request calls first,
  with a matrix of new values on the same pattern: request ``k`` uses
  ``A * (1 + amp * s_k)``, ``s_k = 1 + ((k + k0) mod period)``, ``k0``
  drawn from the seed, from ``value_scale: {"amp", "period"}``. The
  ``period`` scaled matrices are made in set-up; a request builds its
  ``Matrix`` (``set_csr`` + ``assemble``) and updates.
- ``check_share``: the share of the window's requests whose answers are
  kept for the check, drawn from the seed (the first is always kept).
- ``traced_records``: the requests that a ``--trace 1`` run traces.

Every seed gets the same sizes and the same work, in another order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import traceback

import numpy as np

SOLVERS = ("solve_pCG", "solve_pGMRES", "solve", "solve_CG", "solve_GMRES",
           "solve_smoother")
UPDATES = ("update1", "update2", "update3")


@dataclasses.dataclass
class Record:
    """One request: its inputs, its host-clock times and what it returned."""
    index: int
    rhs: int                      # index into the rhs pool
    scale: int                    # index of the scaled matrix, -1 without
    start: float = 0.0
    end: float = 0.0
    iters: int = -1
    phases: dict = dataclasses.field(default_factory=dict)   # host seconds by call
    u: np.ndarray | None = None   # kept for the check
    error: str = ""


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), stream])


def rhs_pool(traffic: dict, n: int, manufactured: np.ndarray, seed: int) -> list:
    rng = _rng(seed, 0)
    k = int(traffic.get("manufactured_rhs", 0))
    pool = [manufactured.copy() for _ in range(k)]
    pool += [rng.uniform(-1.0, 1.0, n) for _ in range(int(traffic["rhs_pool"]) - k)]
    return pool


def rhs_order(traffic: dict, seed: int) -> np.ndarray:
    return _rng(seed, 1).permutation(int(traffic["rhs_pool"]))


def scales(traffic: dict, seed: int) -> tuple:
    """(factors of the scaled matrices, offset k0); ((), 0) without an update."""
    vs = traffic.get("value_scale")
    if not traffic.get("update") or not vs:
        return (), 0
    period = int(vs["period"])
    k0 = int(_rng(seed, 2).integers(period))
    return tuple(1.0 + float(vs["amp"]) * (1 + s) for s in range(period)), k0


def scaled(A, factor: float):
    B = A.copy()
    B.data *= factor
    return B


class ClosedLoop:
    """The closed loop over one ``AMG`` and its inputs."""

    def __init__(self, traffic: dict, amg, A, pool: list, seed: int, *,
                 matrix_cls, device, dtype):
        solver = traffic["solver"]
        update = traffic.get("update")
        if solver not in SOLVERS or (update and update not in UPDATES):
            raise ValueError(f"unknown solver {solver!r} or update {update!r}")
        self.amg, self.pool = amg, pool
        self.solve = getattr(amg, solver)
        self.update = getattr(amg, update) if update else None
        self.order = rhs_order(traffic, seed)
        factors, self.k0 = scales(traffic, seed)
        self.mats = [scaled(A, f) for f in factors]
        self.matrix_cls, self.device, self.dtype = matrix_cls, device, dtype
        self.keep = _rng(seed, 3)
        self.share = float(traffic.get("check_share", 1.0))
        # spans around the calls into the program; a traced run sets
        # torch.profiler.record_function here
        self.span = lambda name: contextlib.nullcontext()

    def request(self, i: int, keep: bool) -> Record:
        """Request ``i``: [the update,] set_rhs and the solve, on the host
        clock. An exception is the request's answer: it is recorded and the
        loop goes on."""
        rec = Record(i, int(self.order[i % len(self.order)]),
                     (i + self.k0) % len(self.mats) if self.mats else -1)
        rec.start = time.perf_counter()
        try:
            if self.update is not None:
                with self.span("amgbench.assemble"):
                    M = self.matrix_cls()
                    M.set_csr(self.mats[rec.scale])
                    M.assemble(device=self.device, dtype=self.dtype)
                t = time.perf_counter()
                with self.span("amgbench.update"):
                    self.update(M)
                rec.phases["update"] = time.perf_counter() - t
            with self.span("amgbench.solve"):
                self.amg.set_rhs(self.pool[rec.rhs])
                u, res = self.solve()
            rec.end = time.perf_counter()
            rec.iters = int(res.iters)
            if keep:
                rec.u = u
        except Exception:   # a request that fails is counted, not fatal
            rec.end = time.perf_counter()
            rec.error = traceback.format_exc(limit=4)
        return rec

    def window(self, seconds: float, first: int) -> tuple:
        """Requests from ``first`` on until ``seconds`` have passed; returns
        (records, wall seconds from the first start to the last end)."""
        recs = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = first
        while True:
            keep = i == first or self.keep.random() < self.share
            recs.append(self.request(i, keep))
            i += 1
            if recs[-1].end >= deadline:
                break
        return recs, recs[-1].end - t0

    def run(self, n: int, first: int) -> list:
        """``n`` requests from ``first`` on, every answer kept."""
        return [self.request(i, True) for i in range(first, first + n)]
