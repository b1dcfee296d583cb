// Planner core for the multi-strip ("strip8") Pallas SpMV layout
// (ops/pallas_strip8_spmv.py).
//
// A strip8 tile covers 128 consecutive rows (one row per LANE) and holds
// 8 independent strip slots (one per SUBLANE): slot (i, j) of tile t is an
// entry of row rb*128 + j gathered from x strip strips[t, i]. Within one
// row-block, a strip s needs max_r count(r, s) sublane-slots; the slots of
// all touched strips are packed 8-per-tile. This lifts the single-strip
// tile's fill ceiling for operators whose rows scatter across many strips
// (SA-coarsened mid-level A, aggregation transposes Pt^T: a strip of 128
// columns holds at most 128 one-entry-per-column entries, capping the
// classic layout at 12.5% fill; here up to 8 strips share the tile).
//
// Entries must arrive sorted by (row, col) — canonical-CSR order — so each
// row-block's entries are contiguous and (row, strip) runs are detected
// without sorting; per-strip state uses a generation-stamped table.
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Inputs: nnz entries (row, col), rows < n; a row block covers
// Q = 128/perrow consecutive rows (each row owns perrow lanes per strip
// slot, smoothing lumpy per-(row, strip) counts); n_rb = ceil(n / Q);
// n_strips strips.
// Outputs (preallocated by the caller):
//   e_tile[nnz]    int32 — GLOBAL tile id of each entry
//   e_sub[nnz]     int8  — sublane (strip slot) of each entry
//   e_krem[nnz]    int8  — lane group of the entry within its slot
//     (lane = e_krem * Q + row % Q)
//   t_strip[cap*8] int32 — strip id per (tile, sublane); unused slots 0
//   rb_tiles[n_rb] int32 — tile count per row block (tiles are consecutive
//     and ordered by row block)
// cap = capacity of t_strip/8 (max tiles). Returns the total tile count,
// -1 if entries are unsorted, or -2 if cap is too small.
int64_t strip8_plan_core(int64_t nnz, const int64_t *row, const int64_t *col,
                         int64_t n_rb, int64_t n_strips, int64_t perrow,
                         int32_t *e_tile, int8_t *e_sub, int8_t *e_krem,
                         int32_t *t_strip, int32_t *rb_tiles, int64_t cap) {
    const int64_t Q = 128 / perrow;
    // per-strip stamped scratch
    std::vector<int64_t> gen(n_strips, -1);
    std::vector<int32_t> maxrep(n_strips, 0);
    std::vector<int32_t> base(n_strips, 0);
    std::vector<int32_t> touched;
    touched.reserve(256);

    for (int64_t b = 0; b < n_rb; ++b) rb_tiles[b] = 0;

    int64_t n_tiles = 0;
    int64_t blk_gen = 0;
    int64_t i = 0;
    while (i < nnz) {
        const int64_t rb = row[i] / Q;
        ++blk_gen;
        touched.clear();
        // pass A over the block: per-(row, strip) running count k -> stash
        // k in e_tile; track the max column index (k / perrow) per strip
        int64_t j = i;
        int64_t prev_row = -1, prev_strip = -1, k = 0;
        for (; j < nnz && row[j] / Q == rb; ++j) {
            const int64_t r = row[j];
            const int64_t s = col[j] >> 7;
            if (r == prev_row) {
                if (s < prev_strip) return -1;  // unsorted input
                k = (s == prev_strip) ? k + 1 : 0;
            } else {
                if (r < prev_row) return -1;
                k = 0;
            }
            prev_row = r;
            prev_strip = s;
            e_tile[j] = (int32_t)k;  // temporary: replica within (row, strip)
            const int32_t kcol = (int32_t)(k / perrow);
            if (gen[s] != blk_gen) {
                gen[s] = blk_gen;
                maxrep[s] = kcol;
                touched.push_back((int32_t)s);
            } else if (kcol > maxrep[s]) {
                maxrep[s] = kcol;
            }
        }
        // assign column bases (strips sorted for a deterministic layout)
        std::sort(touched.begin(), touched.end());
        int32_t ncols = 0;
        for (const int32_t s : touched) {
            base[s] = ncols;
            ncols += maxrep[s] + 1;
        }
        const int64_t t_rb = (ncols + 7) / 8;
        if (n_tiles + t_rb > cap) return -2;
        rb_tiles[rb] = (int32_t)t_rb;
        // strip id per slot
        for (int64_t c = 0; c < t_rb * 8; ++c)
            t_strip[(n_tiles + c / 8) * 8 + (c % 8)] = 0;
        for (const int32_t s : touched) {
            for (int32_t r = 0; r <= maxrep[s]; ++r) {
                const int64_t c = base[s] + r;
                t_strip[(n_tiles + c / 8) * 8 + (c % 8)] = s;
            }
        }
        // pass B: entry -> (global tile, sublane, lane group)
        for (int64_t t = i; t < j; ++t) {
            const int64_t k_e = e_tile[t];
            const int64_t c = base[col[t] >> 7] + k_e / perrow;
            e_tile[t] = (int32_t)(n_tiles + c / 8);
            e_sub[t] = (int8_t)(c % 8);
            e_krem[t] = (int8_t)(k_e % perrow);
        }
        n_tiles += t_rb;
        i = j;
    }
    return n_tiles;
}

// INTERVAL variant: each tile's 8 strip slots are a CONSECUTIVE strip
// range [base, base+8) (sublane i = strip base+i), so the kernel builds
// its gather source with ONE dynamic 8-row slice instead of 8 scalar row
// loads (~2.5x less per-tile op cost). A row block's touched strips are
// covered greedily by length-8 intervals; each interval spawns replica
// tiles up to the max per-(row, strip) column count among its strips.
// Outputs as above, except t_base[cap] holds ONE strip base per tile.
int64_t strip8i_plan_core(int64_t nnz, const int64_t *row, const int64_t *col,
                          int64_t n_rb, int64_t n_strips, int64_t perrow,
                          int32_t *e_tile, int8_t *e_sub, int8_t *e_krem,
                          int32_t *t_base, int32_t *rb_tiles, int64_t cap) {
    const int64_t Q = 128 / perrow;
    std::vector<int64_t> gen(n_strips, -1);
    std::vector<int32_t> maxrep(n_strips, 0);
    std::vector<int32_t> tile0(n_strips, 0);  // first tile of strip's interval
    std::vector<int32_t> sub(n_strips, 0);    // sublane of strip
    std::vector<int32_t> touched;
    touched.reserve(256);

    for (int64_t b = 0; b < n_rb; ++b) rb_tiles[b] = 0;

    int64_t n_tiles = 0;
    int64_t blk_gen = 0;
    int64_t i = 0;
    while (i < nnz) {
        const int64_t rb = row[i] / Q;
        ++blk_gen;
        touched.clear();
        int64_t j = i;
        int64_t prev_row = -1, prev_strip = -1, k = 0;
        for (; j < nnz && row[j] / Q == rb; ++j) {
            const int64_t r = row[j];
            const int64_t s = col[j] >> 7;
            if (r == prev_row) {
                if (s < prev_strip) return -1;  // unsorted input
                k = (s == prev_strip) ? k + 1 : 0;
            } else {
                if (r < prev_row) return -1;
                k = 0;
            }
            prev_row = r;
            prev_strip = s;
            e_tile[j] = (int32_t)k;
            const int32_t kcol = (int32_t)(k / perrow);
            if (gen[s] != blk_gen) {
                gen[s] = blk_gen;
                maxrep[s] = kcol;
                touched.push_back((int32_t)s);
            } else if (kcol > maxrep[s]) {
                maxrep[s] = kcol;
            }
        }
        // greedy interval cover of the touched strips (sorted)
        std::sort(touched.begin(), touched.end());
        int64_t t_rb = 0;
        size_t a = 0;
        while (a < touched.size()) {
            // clamp so the kernel's 8-row x slice stays in bounds (extending
            // the interval DOWN only spans already-covered strips)
            const int64_t hi_base = n_strips > 8 ? n_strips - 8 : 0;
            const int32_t base_s =
                touched[a] > hi_base ? (int32_t)hi_base : touched[a];
            int32_t depth = 0;
            size_t b2 = a;
            while (b2 < touched.size() && touched[b2] < base_s + 8) {
                const int32_t s = touched[b2];
                if (maxrep[s] + 1 > depth) depth = maxrep[s] + 1;
                ++b2;
            }
            if (n_tiles + t_rb + depth > cap) return -2;
            for (int32_t d = 0; d < depth; ++d)
                t_base[n_tiles + t_rb + d] = base_s;
            for (size_t u = a; u < b2; ++u) {
                tile0[touched[u]] = (int32_t)(n_tiles + t_rb);
                sub[touched[u]] = (int32_t)(touched[u] - base_s);
            }
            t_rb += depth;
            a = b2;
        }
        rb_tiles[rb] = (int32_t)t_rb;
        for (int64_t t = i; t < j; ++t) {
            const int64_t s = col[t] >> 7;
            const int64_t k_e = e_tile[t];
            e_tile[t] = tile0[s] + (int32_t)(k_e / perrow);
            e_sub[t] = (int8_t)sub[s];
            e_krem[t] = (int8_t)(k_e % perrow);
        }
        n_tiles += t_rb;
        i = j;
    }
    return n_tiles;
}

}  // extern "C"
