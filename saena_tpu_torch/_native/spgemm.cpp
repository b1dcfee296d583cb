// Host CSR x CSR SpGEMM (Gustavson with a dense sparse-accumulator).
//
// Native-code counterpart of the reference's local SpGEMM base case
// (mkl_dcsrmultcsr inside fast_mm, saena_object_setup_matmat.cpp:177-244):
// hierarchy setup runs on the host, so the Galerkin products R*(A*P) go
// through this kernel (amg/galerkin.py picks it over torch/scipy when
// available).
//
// Design: single numeric pass — scatter partial products into a dense value
// accumulator `acc` with a generation-stamped occupancy array `stamp`
// (no per-row clearing), collect the touched column list, sort it so the
// output is canonical CSR, gather values. Threads own CONTIGUOUS row blocks
// cut by a balanced FLOP estimate (sum of B-row lengths over each row's
// A-entries) and append to private buffers; the blocks are then memcpy'd
// into the caller's arrays in row order, so no second (symbolic) product
// pass is needed.
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Phase 1: C = A(n x k) * B(k x m). Returns nnz(C) and leaves the result in
// thread-private buffers held in a heap context; caller then sizes its
// output arrays and calls spgemm_csr_finish to copy them out and free the
// context. c_rownnz (size n) receives per-row output counts.
// nt_req: requested thread count; 0 = OpenMP default. Callers that are
// THEMSELVES parallel (the shard-parallel setup pool) pass 1 so shard
// tasks x OpenMP teams never oversubscribe the host cores.
void *spgemm_csr_start(int64_t n, int64_t m,
                       const int64_t *a_indptr, const int32_t *a_indices,
                       const double *a_values,
                       const int64_t *b_indptr, const int32_t *b_indices,
                       const double *b_values,
                       int64_t *c_rownnz, int64_t *nnz_out,
                       int32_t nt_req);
void spgemm_csr_finish(void *ctx, const int64_t *c_indptr,
                       int32_t *c_indices, double *c_values);

}  // extern "C"

namespace {

struct Block {
    int64_t row_lo = 0, row_hi = 0;
    std::vector<int32_t> idx;
    std::vector<double> val;
};

struct Ctx {
    int64_t n = 0;
    std::vector<Block> blocks;
};

}  // namespace

void *spgemm_csr_start(int64_t n, int64_t m,
                       const int64_t *a_indptr, const int32_t *a_indices,
                       const double *a_values,
                       const int64_t *b_indptr, const int32_t *b_indices,
                       const double *b_values,
                       int64_t *c_rownnz, int64_t *nnz_out,
                       int32_t nt_req) {
#ifdef _OPENMP
    const int nt = nt_req > 0 ? (int)nt_req
                              : std::max(1, omp_get_max_threads());
#else
    const int nt = 1;
#endif
    // balanced contiguous row blocks by FLOP estimate
    std::vector<int64_t> cut(nt + 1, n);
    cut[0] = 0;
    {
        double total = 0.0;
        std::vector<double> rowflops(n);
        for (int64_t i = 0; i < n; ++i) {
            double f = 1.0;  // floor so empty rows still advance the cursor
            for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
                const int64_t kk = a_indices[p];
                f += (double)(b_indptr[kk + 1] - b_indptr[kk]);
            }
            rowflops[i] = f;
            total += f;
        }
        double acc = 0.0;
        int nextcut = 1;
        for (int64_t i = 0; i < n && nextcut < nt; ++i) {
            acc += rowflops[i];
            if (acc >= total * nextcut / nt) cut[nextcut++] = i + 1;
        }
    }

    // dense-B fast path: when B is dense-ish, scatter it once into a
    // row-major panel; dense-ish output rows then accumulate with
    // CONTIGUOUS axpy streams (acc[j] += av * Brow[j]) instead of the
    // random acc/stamp read-modify-write — the stamped pattern pass keeps
    // the EXACT Gustavson output pattern (explicit zeros included), and
    // the accumulation order per output element is unchanged, so values
    // are bit-identical (the one exception: a -0.0 first contribution
    // lands as +0.0; arithmetically inert).
    // rows of B that can ever be read = 1 + max column index of A (the ABI
    // does not pass k; rows beyond this bound never participate)
    int64_t k_rows = 0;
    for (int64_t i = 0; i < n; ++i)
        for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p)
            if (a_indices[p] >= k_rows) k_rows = a_indices[p] + 1;
    const double b_fill = k_rows ? (double)b_indptr[k_rows] /
                                       ((double)k_rows * (double)m)
                                 : 0.0;
    std::vector<double> Bd;
    // >= 0.65 fill: the axpy streams do 1/fill x more flops than the
    // sparse scatter, so the contiguous-access win only nets out once B
    // is well past half full (measured: no gain at 38-52%, ~1.5-2x at
    // ~90% — the near-dense coarse AMG levels)
    // panel cap: 3.2e7 doubles = 256 MB — a 2-core setup host cannot
    // afford the previous 1.2e8-element (~1 GB) temporary (ADVICE r4:
    // swap/OOM risk mid-setup); near-dense coarse AMG operands are far
    // smaller than this anyway
    const bool dense_b = k_rows > 0 && b_fill >= 0.65 &&
                         (double)k_rows * (double)m <= 3.2e7;
    if (dense_b) {
        Bd.assign((size_t)k_rows * (size_t)m, 0.0);
#pragma omp parallel for schedule(static)
        for (int64_t kk = 0; kk < k_rows; ++kk) {
            double *row = Bd.data() + (size_t)kk * (size_t)m;
            // += so non-canonical CSR input (duplicate column entries)
            // keeps the Gustavson path's duplicate-summing semantics
            for (int64_t pb = b_indptr[kk]; pb < b_indptr[kk + 1]; ++pb)
                row[b_indices[pb]] += b_values[pb];
        }
    }

    Ctx *ctx = new Ctx;
    ctx->n = n;
    ctx->blocks.resize(nt);

#pragma omp parallel num_threads(nt)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        Block &blk = ctx->blocks[t];
        blk.row_lo = cut[t];
        blk.row_hi = cut[t + 1];
        std::vector<double> acc(m, 0.0);
        std::vector<int64_t> stamp(m, -1);
        std::vector<int32_t> touched;
        touched.reserve(1024);
        int64_t gen = 0;
        for (int64_t i = blk.row_lo; i < blk.row_hi; ++i) {
            ++gen;
            int64_t flops = 0;
            for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
                const int64_t kk = a_indices[pa];
                flops += b_indptr[kk + 1] - b_indptr[kk];
            }
            if (dense_b && flops >= m / 4) {
                // pattern pass (stamps only, 4 B writes)
                for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
                    const int64_t kk = a_indices[pa];
                    for (int64_t pb = b_indptr[kk]; pb < b_indptr[kk + 1];
                         ++pb)
                        stamp[b_indices[pb]] = gen;
                }
                // value pass: contiguous axpy over the dense panel
                std::fill(acc.begin(), acc.end(), 0.0);
                for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
                    const double av = a_values[pa];
                    const double *brow =
                        Bd.data() + (size_t)a_indices[pa] * (size_t)m;
                    for (int64_t j = 0; j < m; ++j) acc[j] += av * brow[j];
                }
                int64_t cnt = 0;
                for (int64_t j = 0; j < m; ++j) {
                    if (stamp[j] == gen) {
                        blk.idx.push_back((int32_t)j);
                        blk.val.push_back(acc[j]);
                        ++cnt;
                    }
                }
                c_rownnz[i] = cnt;
                continue;
            }
            if (flops >= m) {
                // very dense row (>= one MAC per output column): TWO
                // branch-free passes beat the stamped single pass — a
                // pattern pass of pure 8 B stamp writes, then a value pass
                // with no per-MAC stamp compare/branch (acc zero-filled:
                // 0.0 + a*b == a*b exactly, so values keep the Gustavson
                // accumulation order bit-for-bit; same -0.0-first-
                // contribution caveat as the dense-B path). Measured 1.4x
                // on the 48^3 level-2 A@P (the setup's hottest product).
                for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
                    const int64_t kk = a_indices[pa];
                    for (int64_t pb = b_indptr[kk]; pb < b_indptr[kk + 1];
                         ++pb)
                        stamp[b_indices[pb]] = gen;
                }
                std::fill(acc.begin(), acc.end(), 0.0);
                for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
                    const int64_t kk = a_indices[pa];
                    const double av = a_values[pa];
                    for (int64_t pb = b_indptr[kk]; pb < b_indptr[kk + 1];
                         ++pb)
                        acc[b_indices[pb]] += av * b_values[pb];
                }
                int64_t cnt = 0;
                for (int64_t j = 0; j < m; ++j) {
                    if (stamp[j] == gen) {
                        blk.idx.push_back((int32_t)j);
                        blk.val.push_back(acc[j]);
                        ++cnt;
                    }
                }
                c_rownnz[i] = cnt;
                continue;
            }
            if (flops >= m / 4) {
                // dense-ish row: no touched list / sort — scatter with the
                // stamp only, then emit by an ordered accumulator scan
                for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
                    const int64_t kk = a_indices[pa];
                    const double av = a_values[pa];
                    for (int64_t pb = b_indptr[kk]; pb < b_indptr[kk + 1];
                         ++pb) {
                        const int32_t j = b_indices[pb];
                        if (stamp[j] != gen) {
                            stamp[j] = gen;
                            acc[j] = av * b_values[pb];
                        } else {
                            acc[j] += av * b_values[pb];
                        }
                    }
                }
                int64_t cnt = 0;
                for (int64_t j = 0; j < m; ++j) {
                    if (stamp[j] == gen) {
                        blk.idx.push_back((int32_t)j);
                        blk.val.push_back(acc[j]);
                        ++cnt;
                    }
                }
                c_rownnz[i] = cnt;
                continue;
            }
            touched.clear();
            for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
                const int64_t kk = a_indices[pa];
                const double av = a_values[pa];
                for (int64_t pb = b_indptr[kk]; pb < b_indptr[kk + 1]; ++pb) {
                    const int32_t j = b_indices[pb];
                    if (stamp[j] != gen) {
                        stamp[j] = gen;
                        acc[j] = av * b_values[pb];
                        touched.push_back(j);
                    } else {
                        acc[j] += av * b_values[pb];
                    }
                }
            }
            std::sort(touched.begin(), touched.end());
            c_rownnz[i] = (int64_t)touched.size();
            for (const int32_t j : touched) {
                blk.idx.push_back(j);
                blk.val.push_back(acc[j]);
            }
        }
    }

    int64_t nnz = 0;
    for (const auto &b : ctx->blocks) nnz += (int64_t)b.idx.size();
    *nnz_out = nnz;
    return ctx;
}

void spgemm_csr_finish(void *vctx, const int64_t *c_indptr,
                       int32_t *c_indices, double *c_values) {
    Ctx *ctx = static_cast<Ctx *>(vctx);
#pragma omp parallel for schedule(static)
    for (size_t t = 0; t < ctx->blocks.size(); ++t) {
        const Block &b = ctx->blocks[t];
        if (b.idx.empty()) continue;
        const int64_t off = c_indptr[b.row_lo];
        std::memcpy(c_indices + off, b.idx.data(),
                    b.idx.size() * sizeof(int32_t));
        std::memcpy(c_values + off, b.val.data(),
                    b.val.size() * sizeof(double));
    }
    delete ctx;
}
