// Strength-of-connection graph pass (amg/strength.py::strength_graph) and
// a plain CSR SpMV used by the host Lanczos loop (amg/eig.py).
//
// strength_csr: S_ij = -a_ij / max_{k != i}(-a_ik); keep entries where
// S_ij > theta or S_ji > theta (union symmetrization, the reference's
// strength_matrix.cpp:233-271 semantics). The numpy version makes ~6
// full-nnz passes (repeat/where/reduceat/divide/cumsum); this is two.
// Row scaling uses the same arithmetic (-a_ij / maxrow) so the kept set is
// bit-identical to the numpy path.
//
// csr_matvec: y = A x with each row accumulated SEQUENTIALLY in index
// order — bitwise identical to scipy's csr_matvec regardless of the OpenMP
// row partition, so swapping it into the Lanczos loop cannot move a single
// Ritz value (convergence goldens pin iteration counts).
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Pass 1 of strength_graph: per-row max of -a_ik over off-diagonal entries
// and the keep mask. keep[e] in {0,1}; safe[i] = the row scaling
// denominator (1.0 where the row max is non-finite or zero).
// Returns the number of kept entries.
int64_t strength_keep(int64_t n, const int64_t *indptr,
                      const int32_t *indices, const double *data,
                      double theta, uint8_t *keep, double *safe) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        double mx = -1.0 / 0.0;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            if (indices[p] != i && -data[p] > mx) mx = -data[p];
        }
        safe[i] = (mx == mx && mx != 1.0 / 0.0 && mx != -1.0 / 0.0 &&
                   mx != 0.0)
                      ? mx
                      : 1.0;
    }
    int64_t kept = 0;
#pragma omp parallel for schedule(static) reduction(+ : kept)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int32_t j = indices[p];
            const double negv = -data[p];
            const bool k = (j != i) && (negv / safe[i] > theta ||
                                        negv / safe[j] > theta);
            keep[p] = k ? 1 : 0;
            kept += k ? 1 : 0;
        }
    }
    return kept;
}

// y = A x, scipy-identical per-row sequential accumulation.
void csr_matvec(int64_t n, const int64_t *indptr, const int32_t *indices,
                const double *data, const double *x, double *y) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        double acc = 0.0;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            acc += data[p] * x[indices[p]];
        y[i] = acc;
    }
}

}  // extern "C"
