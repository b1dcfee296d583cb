// Sequential lexicographic MIS(1) aggregation pass.
//
// Native-code counterpart of the reference's aggregation_1_dist
// (saena_object_setup1.cpp:724-995): the reference iterates a min-index
// propagation fixpoint (undecided nodes watch their minimum eligible
// strength-neighbor; roots stay eligible forever, joined nodes drop out)
// until global convergence. That fixpoint has a closed form — it is the
// LEXICOGRAPHICALLY FIRST maximal independent set:
//
//   root(i)  <=>  no strength-neighbor j < i is a root
//   agg(i)   =   min{ j < i : j neighbor of i, root(j) }, else i
//
// because a node's decision only ever depends on strictly smaller indices
// (jm < i is required for both waiting and joining), so resolving nodes in
// ascending index order reproduces the parallel fixpoint exactly. The
// vectorized host fixpoint in amg/strength.py needs O(wavefront-depth)
// rounds of O(nnz) work (~140x nnz on a 96^3 Poisson grid); this pass is a
// single O(nnz) sweep. Equivalence with the fixpoint is asserted by
// tests/test_amg.py::test_mis1_native_matches_fixpoint.
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <cstdint>

extern "C" {

// indptr: n+1 int64 row offsets; indices: int32 column indices (the strength
// graph is < 2^31 wide by construction — device formats are int32 too).
// Outputs: agg[i] = fine index of i's root, is_root[i] in {0,1}.
void mis1_aggregate(int64_t n, const int64_t *indptr, const int32_t *indices,
                    int64_t *agg, uint8_t *is_root) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t best = -1;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t j = indices[p];
            if (j < i && is_root[j] && (best < 0 || j < best)) best = j;
        }
        if (best >= 0) {
            agg[i] = best;
            is_root[i] = 0;
        } else {
            agg[i] = i;
            is_root[i] = 1;
        }
    }
}

// Per-shard sweep round for the DISTRIBUTED MIS fixpoint
// (parallel/dist_setup.py). Resolves the shard's rows in ascending index
// order using FRESH state for local neighbors and the round-start SNAPSHOT
// for remote neighbors — exactly the reference's structure of a full local
// pass between boolean halo exchanges (aggregation_1_dist,
// saena_object_setup1.cpp:724-995). The fixpoint is schedule-independent
// (a node's root/join outcome depends only on which smaller neighbors are
// MIS members), so any snapshot staleness costs extra rounds, never a
// different aggregation; convergence needs one round per cross-shard hop
// of the longest dependency chain instead of one per fixpoint wavefront.
//
// indptr/indices: the shard's LOCAL rows with GLOBAL column ids;
// decided/is_root/agg are global arrays — writes stay in [row0, row0+n_loc)
// so concurrent shard sweeps never collide. Returns #still-undecided.
int64_t mis1_sweep(int64_t n_loc, int64_t row0, const int64_t *indptr,
                   const int32_t *indices, const uint8_t *dec_snap,
                   const uint8_t *root_snap, uint8_t *decided,
                   uint8_t *is_root, int64_t *agg) {
    const int64_t r1 = row0 + n_loc;
    int64_t und = 0;
    for (int64_t i = 0; i < n_loc; ++i) {
        const int64_t gi = row0 + i;
        if (decided[gi]) continue;
        int64_t jm = -1;  // min eligible (undecided-or-root) smaller neighbor
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t j = indices[p];
            if (j >= gi) continue;
            const bool local = j >= row0 && j < r1;
            const uint8_t dec = local ? decided[j] : dec_snap[j];
            const uint8_t rt = local ? is_root[j] : root_snap[j];
            if (!dec || rt) {
                if (jm < 0 || j < jm) jm = j;
            }
        }
        if (jm < 0) {  // no eligible smaller neighbor -> root
            is_root[gi] = 1;
            decided[gi] = 1;
            agg[gi] = gi;
        } else {
            const bool local = jm >= row0 && jm < r1;
            const uint8_t dec = local ? decided[jm] : dec_snap[jm];
            if (dec) {  // eligible + decided => a root: join it
                agg[gi] = jm;
                decided[gi] = 1;
            } else {
                ++und;  // waits on an undecided smaller neighbor
            }
        }
    }
    return und;
}

}  // extern "C"
