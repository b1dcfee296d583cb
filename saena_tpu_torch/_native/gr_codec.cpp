// Golomb-Rice codec for sparse-matrix index streams.
//
// Native-code counterpart of the reference's GR_encoder (GR_encoder.{h,cpp}):
// Saena compresses the row/col_scan streams of CSC blocks before sending
// them around the SpGEMM ring, choosing k in {0 (memcpy), 7 (1-byte
// remainder), 15 (2-byte)} per rank with quotient overflows in an escape
// list. This implementation keeps the same role (setup-time/host-side
// compression of integer index streams, typically delta-encoded sorted
// columns) with a clean bitstream layout:
//
//   per value v >= 0:  q = v >> k, r = v & ((1<<k)-1)
//   q < QMAX : q unary '1'*q + '0', then r in k bits (LSB-first)
//   q >= QMAX: QMAX '1' bits (escape), then the full 32-bit value
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
    uint8_t *buf;
    int64_t cap;
    int64_t bitpos = 0;
    bool overflow = false;

    inline void put(int bit) {
        int64_t byte = bitpos >> 3;
        if (byte >= cap) { overflow = true; return; }
        if (bit) buf[byte] |= (uint8_t)(1u << (bitpos & 7));
        ++bitpos;
    }
    inline void put_bits(uint32_t v, int n) {
        for (int i = 0; i < n; ++i) put((v >> i) & 1u);
    }
};

struct BitReader {
    const uint8_t *buf;
    int64_t nbits;
    int64_t bitpos = 0;
    bool error = false;

    inline int get() {
        if (bitpos >= nbits) { error = true; return 0; }
        int64_t byte = bitpos >> 3;
        int bit = (buf[byte] >> (bitpos & 7)) & 1;
        ++bitpos;
        return bit;
    }
    inline uint32_t get_bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i) v |= (uint32_t)get() << i;
        return v;
    }
};

constexpr int QMAX = 48;  // escape threshold for pathological quotients

}  // namespace

extern "C" {

// Returns compressed size in BYTES, or -1 if out_cap is too small.
int64_t gr_compress(const uint32_t *in, int64_t n, int k,
                    uint8_t *out, int64_t out_cap) {
    if (k < 0 || k > 31) return -2;
    std::memset(out, 0, (size_t)out_cap);
    BitWriter w{out, out_cap};
    const uint32_t mask = (k == 31) ? 0x7fffffffu : ((1u << k) - 1u);
    for (int64_t i = 0; i < n; ++i) {
        uint32_t v = in[i];
        uint32_t q = v >> k;
        if (q < (uint32_t)QMAX) {
            for (uint32_t j = 0; j < q; ++j) w.put(1);
            w.put(0);
            w.put_bits(v & mask, k);
        } else {
            for (int j = 0; j < QMAX; ++j) w.put(1);
            w.put_bits(v, 32);
        }
        if (w.overflow) return -1;
    }
    return (w.bitpos + 7) >> 3;
}

// Returns number of values decoded, or -1 on malformed stream.
int64_t gr_decompress(const uint8_t *in, int64_t n_bytes, int k,
                      uint32_t *out, int64_t n_vals) {
    BitReader r{in, n_bytes * 8};
    for (int64_t i = 0; i < n_vals; ++i) {
        int q = 0;
        while (q < QMAX && r.get()) ++q;
        uint32_t v;
        if (q == QMAX) {
            v = r.get_bits(32);
        } else {
            v = ((uint32_t)q << k) | r.get_bits(k);
        }
        if (r.error) return -1;
        out[i] = v;
    }
    return n_vals;
}

// Pick k like the reference's CSCMat::compress_prep: smallest expected size
// among k in {0, 7, 15} using the mean magnitude of the stream.
int gr_pick_k(const uint32_t *in, int64_t n) {
    if (n == 0) return 0;
    double best_bits = 1e300;
    int best_k = 7;
    const int ks[3] = {0, 7, 15};
    for (int kk : ks) {
        double bits = 0;
        for (int64_t i = 0; i < n; ++i) {
            uint32_t q = in[i] >> kk;
            bits += (q < (uint32_t)QMAX) ? (double)(q + 1 + kk)
                                         : (double)(QMAX + 32);
        }
        if (bits < best_bits) { best_bits = bits; best_k = kk; }
    }
    return best_k;
}

// Delta-encode a (sorted-per-segment) stream in place: out[i] = in[i]-in[i-1]
// within each segment; segment starts reset the predictor.
void delta_encode(const uint32_t *in, int64_t n, const int64_t *seg_starts,
                  int64_t n_segs, uint32_t *out) {
    int64_t s = 0;
    uint32_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        while (s < n_segs && seg_starts[s] == i) { prev = 0; ++s; }
        out[i] = in[i] - prev;
        prev = in[i];
    }
}

void delta_decode(const uint32_t *in, int64_t n, const int64_t *seg_starts,
                  int64_t n_segs, uint32_t *out) {
    int64_t s = 0;
    uint32_t acc = 0;
    for (int64_t i = 0; i < n; ++i) {
        while (s < n_segs && seg_starts[s] == i) { acc = 0; ++s; }
        acc += in[i];
        out[i] = acc;
    }
}

}  // extern "C"
