// Hybrid ELL SpMV ("K4") for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its EllMatrix to XLA (a
// gather, a product and a sum), and the port ran the same three torch ops.
// It was added for the operators the gather picker cannot place in strip,
// strip8 or BSR within their byte caps, such as the 96^3 Poisson level 3
// (20,835 rows, 50.7 M nonzeros, 499 to 4,699 a row), where the torch ops
// moved every stored slot through device memory about five times. It
// computes, at the compute type T of the values V,
//
//   y[r] = sum over slots k < bound[r / 32] of vals[k, r] * x[cols[k, r]]
//          (+ the sum of row r's spill triples, when it has any)
//
// over the slot-major arrays cols / vals (width, n_pad): slot k of row r at
// k * n_pad + r. bound[t] is the longest row of the 32-row tile t (its last
// slot holding a nonzero value, plus one), so the padding past it is never
// read; a stored zero adds nothing, so skipping one changes no sum.
//
// Bound: memory traffic. One pass over the stored slots below each tile's
// bound (a value and a 4-byte column each), the spill triples, x and y
// once. What the design does about it:
//   (a) x through the read-only path. A warp's 32 gathers at one slot fall
//       on nearby columns, and x stays in the L1 / L2 while the slots
//       stream past. Staging x in shared memory where it fits gained
//       nothing in f64 (the 96^3 level 3, L2 flushed: 284.4 µs staged,
//       285.2 through the L2; 3% in f32; PERF.md), and was taken out.
//   (b) One block of 32 warps per SM, each block a fixed list of whole
//       tiles, balanced by their slot counts on the host (ops/ell_spmv.py).
//       Lane l of a warp holds row 32 t + l, so one slot of a tile is 256
//       coalesced bytes of f64 values and 128 of columns; the 32 warps split
//       the tile's slots into contiguous chunks, and each lane issues the
//       loads of kUnroll slots together through the read-only path, so a
//       block keeps some 144 KB in flight. (NVIDIA H100 80GB HBM3, an
//       operator of 20,835 rows reading 95.1 M slots, f64, L2 flushed: 12
//       slots 389 µs, 16 387, 8 393, 4 421; evict-first streaming loads 413
//       at 8 slots, loads that skip the L1 with a 256-byte L2 prefetch 462;
//       PERF.md.)
//   (c) A fixed summation order and no atomics: each lane sums its chunk in
//       slot order; after one barrier, warp w finishes row 32 t + w, folding
//       the 32 chunk sums by a fixed shuffle tree, then the row's spill
//       triples (lanes stride them in the order of spill_segments, the same
//       tree) added once. Two launches on one input give equal bits; the
//       order differs from the torch version's, so the two agree to
//       rounding. The partial sums are double-buffered, so one barrier a
//       tile suffices.
//
// Types (values V, compute T): f32 and f64 throughout; bf16 values with an
// f32 x, accumulator and y (a smoothers' twin, Options.smooth_dtype). The
// compiler contracts the multiply-add to FMA.
//
// Launches on the caller's stream, allocates nothing, and returns the CUDA
// error code so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;              // rows of a tile: the lanes of a warp
constexpr int kWarps = 32;             // warps of a block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 12;            // slots whose loads a lane issues together
constexpr int kPartStride = kTile + 1;  // a warp's partial sums, padded against bank conflicts

template <typename V>
struct Load;
template <>
struct Load<float> {
  __device__ static float get(const float* p) { return __ldg(p); }
};
template <>
struct Load<double> {
  __device__ static double get(const double* p) { return __ldg(p); }
};
template <>
struct Load<__nv_bfloat16> {
  __device__ static float get(const __nv_bfloat16* p) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
};

template <typename T>
__device__ __forceinline__ T tree_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum
}

template <typename V, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ell_kernel(const int32_t* __restrict__ cols, const V* __restrict__ vals, int n_pad,
           const int32_t* __restrict__ bound, const int32_t* __restrict__ order,
           const int32_t* __restrict__ block_ptr, const int32_t* __restrict__ spill_ptr,
           const int32_t* __restrict__ spill_cols, const V* __restrict__ spill_vals,
           const T* __restrict__ x, T* __restrict__ y) {
  __shared__ T part[2 * kWarps * kPartStride];
  const int k0 = __ldg(block_ptr + blockIdx.x), k1 = __ldg(block_ptr + blockIdx.x + 1);
  if (k0 >= k1) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t stride = n_pad;
  for (int k = k0; k < k1; ++k) {
    const int t = __ldg(order + k);
    const int b = __ldg(bound + t);
    const int s0 = static_cast<int>(static_cast<int64_t>(b) * warp / kWarps);
    const int s1 = static_cast<int>(static_cast<int64_t>(b) * (warp + 1) / kWarps);
    const int64_t row = static_cast<int64_t>(t) * kTile + lane;
    const int32_t* cp = cols + s0 * stride + row;
    const V* vp = vals + s0 * stride + row;
    T acc = T(0);
    for (int s = s0; s < s1; s += kUnroll) {
      int c[kUnroll];
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = s + u < s1;
        c[u] = in ? __ldg(cp + u * stride) : 0;
        v[u] = in ? static_cast<T>(Load<V>::get(vp + u * stride)) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (s + u < s1) acc += v[u] * __ldg(x + c[u]);
      cp += kUnroll * stride;
      vp += kUnroll * stride;
    }
    T* pb = part + (k & 1) * kWarps * kPartStride;
    pb[warp * kPartStride + lane] = acc;
    __syncthreads();
    // warp w finishes row 32 t + w: its 32 chunk sums, then its spill
    const int r = t * kTile + warp;
    const T sum = tree_sum(pb[lane * kPartStride + warp]);
    const int p0 = spill_ptr ? __ldg(spill_ptr + r) : 0;
    const int p1 = spill_ptr ? __ldg(spill_ptr + r + 1) : 0;
    if (p1 > p0) {
      T sv = T(0);
      for (int p = p0 + lane; p < p1; p += 32)
        sv += static_cast<T>(Load<V>::get(spill_vals + p)) *
              __ldg(x + __ldg(spill_cols + p));
      sv = tree_sum(sv);
      if (lane == 0) y[r] = sum + sv;
    } else if (lane == 0) {
      y[r] = sum;
    }
  }
}

template <typename V, typename T>
cudaError_t launch(const void* cols, const void* vals, int n_pad, const void* bound,
                   const void* order, const void* block_ptr, int n_blocks,
                   const void* spill_ptr, const void* spill_cols, const void* spill_vals,
                   const void* x, void* y, cudaStream_t stream) {
  if (n_blocks > 0)
    ell_kernel<V, T><<<n_blocks, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(cols), static_cast<const V*>(vals), n_pad,
        static_cast<const int32_t*>(bound), static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(block_ptr), static_cast<const int32_t*>(spill_ptr),
        static_cast<const int32_t*>(spill_cols), static_cast<const V*>(spill_vals),
        static_cast<const T*>(x), static_cast<T*>(y));
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = f32 values and vectors, 1 = bf16 values with f32 x and y,
// 2 = f64. cols / vals (width, n_pad) slot-major, n_pad a multiple of 32;
// bound (n_pad / 32) the slots read of each tile; order the tiles grouped by
// block, block_ptr (n_blocks + 1) where each block's start; spill_ptr
// (n_pad + 1) where each row's spill triples start in spill_cols /
// spill_vals, or null without spill; x holds every column cols and
// spill_cols name.
extern "C" int saena_ell_spmv(int dtype_code, const void* cols, const void* vals, int n_pad,
                              const void* bound, const void* order, const void* block_ptr,
                              int n_blocks, const void* spill_ptr, const void* spill_cols,
                              const void* spill_vals, const void* x, void* y, void* stream) {
  if (n_pad % kTile != 0 || n_blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch<float, float>(cols, vals, n_pad, bound, order, block_ptr, n_blocks,
                                  spill_ptr, spill_cols, spill_vals, x, y, s);
    case 1:
      return launch<__nv_bfloat16, float>(cols, vals, n_pad, bound, order, block_ptr, n_blocks,
                                          spill_ptr, spill_cols, spill_vals, x, y, s);
    case 2:
      return launch<double, double>(cols, vals, n_pad, bound, order, block_ptr, n_blocks,
                                    spill_ptr, spill_cols, spill_vals, x, y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
