"""The residual that judges an answer, in float64 with NumPy and SciPy."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def relative_residuals(A: sp.csr_matrix, U: np.ndarray, B: np.ndarray) -> np.ndarray:
    """||A u - b|| / ||b|| in float64 for each column pair of U and B
    (n x k), one block of columns at a time."""
    A = A.tocsr().astype(np.float64)
    U = np.asarray(U, dtype=np.float64).reshape(A.shape[0], -1)
    B = np.asarray(B, dtype=np.float64).reshape(A.shape[0], -1)
    R = A @ U - B
    return np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)
