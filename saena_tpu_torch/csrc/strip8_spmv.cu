// Multi-strip ("strip8") gather SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel saena_tpu/ops/pallas_strip8_spmv.py:_kernel
// (launched by strip8_spmv there) together with its epilogue
// _reduce_scratch. A tile is (8, 128) int8 lane indices and values covering
// the Q = 128 / perrow rows of one row block; sublane i of tile t gathers
// from strip strips[t * 8 + i] (general mode) or strips[t] + i (interval
// mode). It computes
//
//   y[rb * Q + q] = sum over s < perrow of
//                   sum over the tiles t of gather_idx[rb] of
//                   sum over sublanes i of vals[t, i, s Q + q] * x[strip(t, i) * 128 + idx[t, i, s Q + q]]
//
// gather_idx entries equal to n_tiles are padding and are skipped; interval
// strips at or past n_strips read zeros (the JAX code pads x by 8 strips).
//
// Bound: memory traffic. Each tile streams 1024 index bytes and 1024 values
// once, x once; one multiply-add per slot. The TPU kernel wrote one folded
// 512-byte scratch row per tile and left the per-row-block sum and the
// perrow fold to two more passes outside the kernel. Here a block of 128
// threads takes a share of one row block's tiles, lane j in thread j: for
// each tile a warp reads 32 neighbouring slots of each sublane (coalesced),
// the gathers of one sublane fall in one strip of x (L1/L2), the 8 products
// are folded in the JAX order ((0+4)+(2+6))+((1+5)+(3+7)) and summed over
// the tiles in a register. A row block's gather_idx entries are split over
// n_split blocks (grid n_rb x n_split), so long rows of tiles do not leave
// the card idle behind one chain of dependent loads. Each block folds the
// perrow lane groups through shared memory; with n_split == 1 it writes y,
// otherwise it writes its Q rows to part[rb][split], and the last block of
// the row block to finish (a ticket in counter[rb], which it resets to 0)
// sums the splits in split order and writes y. One launch, no atomics on
// values, the same result on every run.
//
// Types: f32 values with f32 x/accumulator, f64 throughout. The compiler
// contracts the multiply-add to FMA, so results differ from the plain
// PyTorch version by rounding only.
//
// Launches on the caller's stream, allocates nothing (the wrapper passes the
// scratch part and the zeroed counter), and returns cudaGetLastError() so
// the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, bool INTERVAL>
__global__ void __launch_bounds__(128)
strip8_kernel(const int8_t* __restrict__ idx, const T* __restrict__ vals,
              const int32_t* __restrict__ strips, const int32_t* __restrict__ gather_idx,
              int t_max, int n_tiles, int n_strips, const T* __restrict__ x, int perrow,
              T* __restrict__ part, int32_t* __restrict__ counter, T* __restrict__ y) {
  __shared__ T fold[128];
  __shared__ bool last;
  const int rb = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int j = threadIdx.x;
  const int chunk = (t_max + n_split - 1) / n_split;
  const int k0 = min(t_max, split * chunk);
  const int k1 = min(t_max, k0 + chunk);
  T acc = T(0);
  for (int k = k0; k < k1; ++k) {
    const int t = __ldg(gather_idx + static_cast<int64_t>(rb) * t_max + k);
    if (t >= n_tiles) continue;                 // padding entry
    const int base = INTERVAL ? __ldg(strips + t) : 0;
    T c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = INTERVAL ? base + i : __ldg(strips + static_cast<int64_t>(t) * 8 + i);
      const int64_t off = (static_cast<int64_t>(t) * 8 + i) * 128 + j;
      const int lane = static_cast<int>(__ldg(idx + off));
      const T xv = (s >= 0 && s < n_strips)
                       ? __ldg(x + static_cast<int64_t>(s) * 128 + lane) : T(0);
      c[i] = __ldg(vals + off) * xv;
    }
    acc += ((c[0] + c[4]) + (c[2] + c[6])) + ((c[1] + c[5]) + (c[3] + c[7]));
  }
  fold[j] = acc;
  __syncthreads();
  const int Q = 128 / perrow;
  T v = T(0);
  if (j < Q)
    for (int s = 0; s < perrow; ++s) v += fold[s * Q + j];
  const int64_t row = static_cast<int64_t>(rb) * Q + j;
  if (n_split == 1) {
    if (j < Q) y[row] = v;
    return;
  }
  if (j < Q) part[(static_cast<int64_t>(rb) * n_split + split) * Q + j] = v;
  __threadfence();
  __syncthreads();
  if (j == 0) last = atomicAdd(counter + rb, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  if (j < Q) {
    const T* rows = part + static_cast<int64_t>(rb) * n_split * Q + j;
    T sum = T(0);
    for (int s = 0; s < n_split; ++s) sum += __ldcg(rows + static_cast<int64_t>(s) * Q);
    y[row] = sum;
  }
  if (j == 0) counter[rb] = 0;
}

template <typename T>
cudaError_t launch(int interval, const void* idx, const void* vals, const void* strips,
                   const void* gather_idx, int n_rb, int t_max, int n_tiles, int n_strips,
                   const void* x, int perrow, int n_split, void* part, void* counter,
                   void* y, cudaStream_t stream) {
  const int8_t* ix = static_cast<const int8_t*>(idx);
  const T* v = static_cast<const T*>(vals);
  const int32_t* st = static_cast<const int32_t*>(strips);
  const int32_t* gi = static_cast<const int32_t*>(gather_idx);
  const T* xv = static_cast<const T*>(x);
  T* pt = static_cast<T*>(part);
  int32_t* ct = static_cast<int32_t*>(counter);
  T* out = static_cast<T*>(y);
  const dim3 grid(n_rb, n_split);
  if (n_rb > 0) {
    if (interval)
      strip8_kernel<T, true><<<grid, 128, 0, stream>>>(ix, v, st, gi, t_max, n_tiles,
                                                      n_strips, xv, perrow, pt, ct, out);
    else
      strip8_kernel<T, false><<<grid, 128, 0, stream>>>(ix, v, st, gi, t_max, n_tiles,
                                                       n_strips, xv, perrow, pt, ct, out);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = f32 values and vectors, 2 = f64. interval: 0 general mode,
// 1 interval mode. perrow in {1, 2, 4}; n_tiles = the padded tile count.
// n_split >= 1 blocks per row block; with n_split > 1, part holds
// n_rb * n_split * Q values and counter n_rb zeros (left zero on return).
extern "C" int saena_strip8_apply(int dtype_code, int interval, const void* idx,
                                  const void* vals, const void* strips,
                                  const void* gather_idx, int n_rb, int t_max,
                                  int n_tiles, int n_strips, const void* x, int perrow,
                                  int n_split, void* part, void* counter, void* y,
                                  void* stream) {
  if ((perrow != 1 && perrow != 2 && perrow != 4) || n_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch<float>(interval, idx, vals, strips, gather_idx, n_rb, t_max, n_tiles,
                           n_strips, x, perrow, n_split, part, counter, y, s);
    case 2:
      return launch<double>(interval, idx, vals, strips, gather_idx, n_rb, t_max, n_tiles,
                            n_strips, x, perrow, n_split, part, counter, y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
