"""The comparison that decides ``correct``: every kept answer of the run
against the plain reference (``amgbench/reference/<problem>.py``, found by
the configuration's ``problem``).

The reference makes the configuration's matrix and the mix's inputs again
from the seed, so nothing the program did to them can reach the judge, and
recomputes each answer's residual in float64: ||A_k u - b|| / ||b|| over the
full system (boundary rows included, which the program merges back). The
configuration states the limit: ``limits.rel_res``, the solver's tolerance.
A request that raised, or whose residual is not a finite number at most the
limit, failed.
"""
from __future__ import annotations

import numpy as np

from amgbench import spec
from amgbench import traffic as tr
from amgbench.reference.residual import relative_residuals

BLOCK = 16    # answers a sparse product


def inputs(root: str, config: dict, traffic: dict, seed: int):
    """(A, rhs pool): the configuration's matrix and the mix's right-hand
    sides, made by the reference from the seed."""
    ref = spec.reference(root, config["problem"])
    A = ref.matrix(config)
    return A, tr.rhs_pool(traffic, A.shape[0], ref.manufactured_rhs(config), seed)


def judge(root: str, config: dict, traffic: dict, seed: int, records: list) -> dict:
    """The numbers compared, each with its limit, and the failed requests."""
    A, pool = inputs(root, config, traffic, seed)
    factors, _ = tr.scales(traffic, seed)
    limit = float(config["limits"]["rel_res"])
    kept = [r for r in records if r.u is not None and not r.error]
    worst, failed = 0.0, sum(1 for r in records if r.error)
    groups: dict = {}
    for r in kept:
        groups.setdefault(r.scale, []).append(r)
    for scale, recs in groups.items():
        As = tr.scaled(A, factors[scale]) if scale >= 0 else A
        for i in range(0, len(recs), BLOCK):
            blk = recs[i:i + BLOCK]
            rel = relative_residuals(
                As, np.stack([r.u for r in blk], axis=1),
                np.stack([pool[r.rhs] for r in blk], axis=1))
            bad = ~(rel <= limit)
            failed += int(bad.sum())
            worst = max(worst, float(np.where(np.isfinite(rel), rel, np.inf).max()))
    return {"checks": {"rel_res_worst": {"value": worst, "limit": limit},
                       "failed": {"value": failed, "limit": 0},
                       "answers_checked": {"value": len(kept), "min": 1}},
            "failed": failed,
            "correct": failed == 0 and len(kept) >= 1}
