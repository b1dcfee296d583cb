// Strip-planner core for the Pallas strip-gather SpMV layout
// (ops/pallas_strip_spmv.py::_plan).
//
// Computes, for entries sorted by (row, col):
//   - slot of each entry within its (row-block, strip, row, replica) group
//   - the sorted unique (row-block, strip, replica) PAIR list and each
//     entry's pair id (inv)
//
// The numpy version needs two O(nnz log nnz) comparison sorts (argsort of
// the (rb, strip, row) key + np.unique of the pair key). Here everything
// is block-local: a row-block's entries are CONTIGUOUS in canonical-CSR
// order, so the group running index k falls out of run-length detection,
// and the pair dedup uses a generation-stamped per-strip table plus a
// small sort of the block's touched strips — O(nnz + pairs log strips) and
// no big scatter traffic.
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Inputs: entries (row, col) sorted by (row, col) — canonical-CSR order —
// with row < n. Layout parameters rpt (rows per tile), n_strips, perrow.
// Outputs (preallocated by caller, nnz-sized):
//   slot[nnz]  int8   — entry slot within its pair's row
//   inv[nnz]   int32  — entry's pair id (into the sorted unique pair list)
//   pair_rb / pair_strip [nnz] int32 — only the first n_pairs filled
// Returns n_pairs, or -1 if the entries are found unsorted (caller falls
// back to the numpy planner).
int64_t strip_plan_core(int64_t nnz, const int64_t *row, const int64_t *col,
                        int64_t rpt, int64_t n_strips, int64_t perrow,
                        int8_t *slot, int32_t *inv, int32_t *pair_rb,
                        int32_t *pair_strip) {
    const int64_t cap = 128 / perrow;
    // per-strip stamped scratch: generation, max replica seen, pair base id
    std::vector<int64_t> gen(n_strips, -1);
    std::vector<int32_t> maxrep(n_strips, 0);
    std::vector<int32_t> base(n_strips, 0);
    std::vector<int32_t> touched;
    touched.reserve(256);

    int64_t n_pairs = 0;
    int64_t blk_gen = 0;
    int64_t i = 0;
    while (i < nnz) {
        const int64_t rb = row[i] / rpt;
        // find the block's entry range [i, j) and assign slots/replicas;
        // stash each entry's replica in inv temporarily
        ++blk_gen;
        touched.clear();
        int64_t j = i;
        int64_t prev_row = -1, prev_strip = -1, k = 0;
        for (; j < nnz && row[j] / rpt == rb; ++j) {
            const int64_t r = row[j];
            const int64_t s = col[j] >> 7;  // col / 128
            if (r == prev_row) {
                if (s < prev_strip) return -1;  // unsorted input
                k = (s == prev_strip) ? k + 1 : 0;
            } else {
                if (r < prev_row) return -1;
                k = 0;
            }
            prev_row = r;
            prev_strip = s;
            int64_t rep = k / perrow;
            if (rep >= cap) rep = cap - 1;
            slot[j] = (int8_t)(k % perrow);
            inv[j] = (int32_t)rep;
            if (gen[s] != blk_gen) {
                gen[s] = blk_gen;
                maxrep[s] = (int32_t)rep;
                touched.push_back((int32_t)s);
            } else if ((int32_t)rep > maxrep[s]) {
                maxrep[s] = (int32_t)rep;
            }
        }
        // pairs of this block in (strip, replica) order = global
        // (rb, strip, replica) order since blocks arrive ascending
        std::sort(touched.begin(), touched.end());
        for (const int32_t s : touched) {
            base[s] = (int32_t)n_pairs;
            for (int32_t rep = 0; rep <= maxrep[s]; ++rep) {
                pair_rb[n_pairs] = (int32_t)rb;
                pair_strip[n_pairs] = s;
                ++n_pairs;
            }
        }
        for (int64_t t = i; t < j; ++t)
            inv[t] += base[col[t] >> 7];
        i = j;
    }
    return n_pairs;
}

}  // extern "C"
