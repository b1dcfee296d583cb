"""Distributed-RHS analog: arbitrary-order ingest + solution return mapping.

Mirrors ``saena_vector`` (saena_vector.{h,cpp}): values can be set in any
order with add/replace duplicate semantics; ``assemble`` produces the
index-ordered dense vector the solver consumes; ``return_vec`` maps the
solution back to the ORIGINAL input ordering (ref return_vec,
saena_vector.cpp:238-489, which builds a reverse exchange from orig_order).
"""
from __future__ import annotations

import numpy as np


class SaenaVector:
    def __init__(self, add_duplicates: bool = False):
        self.add_duplicates = add_duplicates
        self._idx: list[np.ndarray] = []
        self._val: list[np.ndarray] = []
        self._idx_offset = 0
        self._assembled: np.ndarray | None = None
        self._orig_idx: np.ndarray | None = None

    def set_dup_flag(self, add: bool) -> None:
        self.add_duplicates = add

    def set_idx_offset(self, offset: int) -> None:
        self._idx_offset = offset

    def set(self, idx, val) -> None:
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64)).ravel() + self._idx_offset
        val = np.atleast_1d(np.asarray(val, dtype=np.float64)).ravel()
        if idx.shape != val.shape:
            raise ValueError("idx and val must have the same shape")
        self._idx.append(idx)
        self._val.append(val)

    def assemble(self, size: int | None = None) -> np.ndarray:
        if not self._idx:
            raise ValueError("no entries set")
        idx = np.concatenate(self._idx)
        val = np.concatenate(self._val)
        self._orig_idx = idx.copy()
        n = size if size is not None else int(idx.max()) + 1
        out = np.zeros(n)
        if self.add_duplicates:
            np.add.at(out, idx, val)
        else:
            out[idx] = val  # later entries overwrite earlier ones
        self._assembled = out
        return out

    def get_vec(self) -> np.ndarray:
        if self._assembled is None:
            raise ValueError("assemble() first")
        return self._assembled

    def return_vec(self, u: np.ndarray) -> np.ndarray:
        """Scatter the solution back to the original input ordering."""
        if self._orig_idx is None:
            raise ValueError("assemble() first")
        u = np.asarray(u)
        return u[self._orig_idx]
