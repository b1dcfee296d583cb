// Row-wise CSR x CSR SpGEMM ("K5") for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's default setup takes its
// Galerkin products R (A P) on the host (the native Gustavson kernel,
// saena_tpu_torch/_native/spgemm.cpp), and so did the port. On the coarse
// levels of a large problem those products carry most of the setup (the
// 96^3 Poisson, levels 2-4: some 175 G multiply-adds), and the host streams
// them at its memory rate. This kernel computes the same C = X Y on the card,
// bit for bit the host kernel's C:
//
//   - the pattern of row i is the union of the Y rows that X's row i
//     reaches, explicit zeros kept, columns ascending;
//   - C[i, j] takes its contributions X[i, k] * Y[k, j] in the stored order
//     of X's row i, each product rounded (__dmul_rn), then added to the
//     accumulator (__dadd_rn), never fused. The accumulator starts at -0.0,
//     so the first add returns the first product exactly, as the host's
//     stamped rows store it; on the rows the host accumulates from a zeroed
//     array (its dense paths: flops >= zero_min_flops) it starts at +0.0;
//   - no atomics on values; two launches give the same bits.
//
// Two passes, one block per (row, column window) in each:
//   count: a bitmap of the window's columns in shared memory (atomicOr on
//          pattern words), its popcount the row's entries in that window,
//          and the row's multiply-adds (window 0). The wrapper scans the
//          counts into the output offsets.
//   fill:  a dense accumulator and a byte flag per column of the window in
//          shared memory (9 bytes a column: a window of 25,600 columns takes
//          225 KB), the row's X entries in order, a barrier after each, the
//          block's threads striding the Y row (its columns are distinct, so
//          no two threads of one step meet). The next X entry's (column,
//          value, Y row bounds) are loaded while the current one is added.
//          Then each warp compacts its segment of the window by ballots, in
//          column order, to the offset the scan gave.
// An output wider than one window takes several: each block reads the whole
// Y rows and keeps its own columns, so a row's bytes are read once per
// window; the wrapper picks the fewest windows (ops/csr_spgemm.py).
//
// Bound: the Y stream. Each multiply-add reads a Y entry (a 4-byte column
// and an 8-byte value) that the L2 may or may not hold; the count pass reads
// the columns once more. At 3.35 TB/s the 96^3 level-3 product A P (47.7 G
// multiply-adds) needs at least 0.17 s with no reuse at all (PERF.md).
//
// Launches on the caller's stream, allocates nothing, and returns the CUDA
// error code so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // Y entries whose loads a thread starts together
constexpr int kMaxWindow = 25600;   // columns of a window (shared with ops/csr_spgemm.py)

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum
}

__global__ void __launch_bounds__(kThreads)
count_kernel(int win, int nwin, const int64_t* __restrict__ xp, const int32_t* __restrict__ xi,
             const int64_t* __restrict__ yp, const int32_t* __restrict__ yi,
             int64_t* __restrict__ win_nnz, int64_t* __restrict__ row_flops) {
  extern __shared__ uint32_t bits[];  // win / 32 words
  __shared__ int64_t red[2 * kWarps];
  const int64_t i = blockIdx.x;
  const int w = blockIdx.y;
  const int c0 = w * win;
  const int words = win >> 5;
  for (int k = threadIdx.x; k < words; k += kThreads) bits[k] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t a0 = __ldg(xp + i), a1 = __ldg(xp + i + 1);
  int64_t flops = 0;
  for (int64_t pa = a0 + warp; pa < a1; pa += kWarps) {
    const int kk = __ldg(xi + pa);
    const int64_t b0 = __ldg(yp + kk), b1 = __ldg(yp + kk + 1);
    if (lane == 0) flops += b1 - b0;
    for (int64_t pb = b0 + lane; pb < b1; pb += 32) {
      const unsigned c = static_cast<unsigned>(__ldg(yi + pb) - c0);
      if (c < static_cast<unsigned>(win)) atomicOr(bits + (c >> 5), 1u << (c & 31));
    }
  }
  __syncthreads();
  int64_t cnt = 0;
  for (int k = threadIdx.x; k < words; k += kThreads) cnt += __popc(bits[k]);
  cnt = warp_sum(cnt);
  flops = warp_sum(flops);
  if (lane == 0) {
    red[warp] = cnt;
    red[kWarps + warp] = flops;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t c = 0, f = 0;
    for (int q = 0; q < kWarps; ++q) {
      c += red[q];
      f += red[kWarps + q];
    }
    win_nnz[i * nwin + w] = c;
    if (w == 0) row_flops[i] = f;
  }
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(int win, int nwin, const int64_t* __restrict__ xp, const int32_t* __restrict__ xi,
            const double* __restrict__ xv, const int64_t* __restrict__ yp,
            const int32_t* __restrict__ yi, const double* __restrict__ yv,
            const int64_t* __restrict__ offs, const int64_t* __restrict__ row_flops,
            int64_t zero_min_flops, int32_t* __restrict__ ci, double* __restrict__ cv) {
  extern __shared__ double acc[];  // win accumulators, then win flag bytes
  unsigned char* flag = reinterpret_cast<unsigned char*>(acc + win);
  __shared__ int64_t seg_cnt[kWarps];
  const int64_t i = blockIdx.x;
  const int w = blockIdx.y;
  const int64_t base = __ldg(offs + i * nwin + w);
  if (__ldg(offs + i * nwin + w + 1) == base) return;  // nothing in this window
  const int c0 = w * win;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double init = __ldg(row_flops + i) >= zero_min_flops ? 0.0 : -0.0;
  for (int k = tid; k < win; k += kThreads) {
    acc[k] = init;
    flag[k] = 0;
  }
  __syncthreads();

  const int64_t a0 = __ldg(xp + i), a1 = __ldg(xp + i + 1);
  // the next X entry: its value and its Y row's bounds, loaded a step ahead
  double nav = 0.0;
  int64_t nb0 = 0, nb1 = 0;
  if (a0 < a1) {
    const int kk = __ldg(xi + a0);
    nav = __ldg(xv + a0);
    nb0 = __ldg(yp + kk);
    nb1 = __ldg(yp + kk + 1);
  }
  for (int64_t pa = a0; pa < a1; ++pa) {
    const double av = nav;
    const int64_t b0 = nb0, b1 = nb1;
    if (pa + 1 < a1) {
      const int kk = __ldg(xi + pa + 1);
      nav = __ldg(xv + pa + 1);
      nb0 = __ldg(yp + kk);
      nb1 = __ldg(yp + kk + 1);
    }
    for (int64_t p = b0 + tid; p < b1; p += kUnroll * kThreads) {
      unsigned c[kUnroll];
      double v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t pb = p + u * kThreads;
        const bool in = pb < b1;
        c[u] = in ? static_cast<unsigned>(__ldg(yi + pb) - c0) : 0xffffffffu;
        v[u] = in ? __ldg(yv + pb) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c[u] < static_cast<unsigned>(win)) {
          acc[c[u]] = __dadd_rn(acc[c[u]], __dmul_rn(av, v[u]));
          flag[c[u]] = 1;
        }
      }
    }
    __syncthreads();  // the next X entry adds after this one, column by column
  }

  // warp q compacts the columns [s0, s1) of the window (multiples of 32)
  const int seg = ((win >> 5) + kWarps - 1) / kWarps * 32;
  const int s0 = min(win, warp * seg), s1 = min(win, s0 + seg);
  int64_t n = 0;
  for (int k = s0 + lane; k < s1; k += 32) n += flag[k] != 0;
  n = warp_sum(n);
  if (lane == 0) seg_cnt[warp] = n;
  __syncthreads();
  int64_t pos = base;
  for (int q = 0; q < warp; ++q) pos += seg_cnt[q];
  for (int k = s0 + lane; k < s1; k += 32) {
    const bool held = flag[k] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, held);
    if (held) {
      const int64_t at = pos + __popc(mask & ((1u << lane) - 1u));
      ci[at] = c0 + k;
      cv[at] = acc[k];
    }
    pos += __popc(mask);
  }
}

bool bad_window(int64_t n, int win, int nwin) {
  return n < 0 || n > 0x7fffffffLL || win <= 0 || win % 32 != 0 || win > kMaxWindow ||
         nwin <= 0 || nwin > 65535;
}

}  // namespace

// count: X (n rows; xp int64 n + 1, xi int32) times Y (yp int64, yi int32),
// the output's columns cut into nwin windows of win columns (win a multiple
// of 32, at most 25,600). Writes win_nnz (n * nwin, row-major: row i's
// entries in window w at i * nwin + w) and row_flops (n), int64.
extern "C" int saena_csr_spgemm_count(int64_t n, int win, int nwin, const void* xp,
                                      const void* xi, const void* yp, const void* yi,
                                      void* win_nnz, void* row_flops, void* stream) {
  if (bad_window(n, win, nwin)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    count_kernel<<<dim3(static_cast<unsigned>(n), nwin), kThreads, (win >> 5) * 4,
                   static_cast<cudaStream_t>(stream)>>>(
        win, nwin, static_cast<const int64_t*>(xp), static_cast<const int32_t*>(xi),
        static_cast<const int64_t*>(yp), static_cast<const int32_t*>(yi),
        static_cast<int64_t*>(win_nnz), static_cast<int64_t*>(row_flops));
  return static_cast<int>(cudaGetLastError());
}

// fill: the same operands with their values (f64), offs (n * nwin + 1) the
// exclusive scan of win_nnz, row_flops from the count; a row of at least
// zero_min_flops multiply-adds accumulates from +0.0, the others from -0.0.
// Writes ci (int32) and cv (f64), offs[n * nwin] entries.
extern "C" int saena_csr_spgemm_fill(int64_t n, int win, int nwin, const void* xp,
                                     const void* xi, const void* xv, const void* yp,
                                     const void* yi, const void* yv, const void* offs,
                                     const void* row_flops, int64_t zero_min_flops, void* ci,
                                     void* cv, void* stream) {
  if (bad_window(n, win, nwin)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = win * 9;
  cudaError_t err = cudaFuncSetAttribute(fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0)
    fill_kernel<<<dim3(static_cast<unsigned>(n), nwin), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        win, nwin, static_cast<const int64_t*>(xp), static_cast<const int32_t*>(xi),
        static_cast<const double*>(xv), static_cast<const int64_t*>(yp),
        static_cast<const int32_t*>(yi), static_cast<const double*>(yv),
        static_cast<const int64_t*>(offs), static_cast<const int64_t*>(row_flops),
        zero_min_flops, static_cast<int32_t*>(ci), static_cast<double*>(cv));
  return static_cast<int>(cudaGetLastError());
}
