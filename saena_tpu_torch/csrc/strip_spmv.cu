// Strip-gather SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel saena_tpu/ops/pallas_strip_spmv.py:_kernel
// (launched by strip_spmv there). A is a list of PAIRS, each an (8, 128)
// tile of int8 lane indices and values keyed by (row block, 128-column strip
// of x). Slot (i, j) of a tile belongs to row i + 8 * (j % Q) of its row
// block, Q = 128 / perrow, and reads x[strip * 128 + idx]. It computes
//
//   y[rb * rpt + 8 q + i] = sum over the row block's pairs p and the row's
//                           perrow slot groups s of
//                           vals[p, i, s Q + q] * x[strip_of[p] * 128 + idx[p, i, s Q + q]]
//
// with rpt = 8 Q rows per row block. rb_ptr (n_rb + 1) gives each row
// block's pairs as one range of the superblock-major pair list.
//
// Bound: memory traffic. Each pair streams 1024 index bytes and 1024 values
// once (5 or 9 bytes a slot) and x once; the arithmetic is one multiply-add
// per slot. The TPU kernel kept x resident in VMEM, gathered within a vreg
// and routed each pair's (8, Q) result into a superblock accumulator with an
// iota mask, walking the pairs in one sequential grid. Here a block of 1024
// threads takes a share of one row block's pairs and each thread one slot
// (i, j) of the tile: a warp reads 32 neighbouring slots (coalesced), its x
// gathers fall inside one 128-value strip, which stays in L1/L2, and each
// thread keeps its slot's sum in a register. A row block's pairs are split
// over n_split blocks (grid n_rb x n_split), so a row block with many pairs
// does not leave the card idle behind one long chain of dependent loads.
// Each block folds the perrow slot groups of its rows through shared memory
// (1024 values, 8 KB in f64). With n_split == 1 it writes y; otherwise it
// writes its rows to part[rb][split], and the last block of the row block
// to finish (a ticket in counter[rb], which it resets to 0) sums the splits
// in split order and writes y. No atomics touch values, so the result is
// the same on every run. Zero padding pairs (strip 0, values 0) read
// x[0 .. 127], always in range.
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

constexpr int kSlots = 8 * 128;

template <typename T>
__global__ void __launch_bounds__(kSlots)
strip_kernel(const int8_t* __restrict__ idx, const T* __restrict__ vals,
             const int32_t* __restrict__ strip_of, const int32_t* __restrict__ rb_ptr,
             const T* __restrict__ x, int perrow, T* __restrict__ part,
             int32_t* __restrict__ counter, T* __restrict__ y) {
  __shared__ T fold[kSlots];
  __shared__ bool last;
  const int rb = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int t = threadIdx.x;          // slot (i, j) = (t / 128, t % 128)
  const int r0 = __ldg(rb_ptr + rb);
  const int r1 = __ldg(rb_ptr + rb + 1);
  const int chunk = (r1 - r0 + n_split - 1) / n_split;
  const int p0 = min(r1, r0 + split * chunk);
  const int p1 = min(r1, p0 + chunk);
  T acc = T(0);
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const int64_t off = static_cast<int64_t>(p) * kSlots + t;
    const int64_t base = static_cast<int64_t>(__ldg(strip_of + p)) * 128;
    const int lane = static_cast<int>(__ldg(idx + off));
    acc += __ldg(vals + off) * __ldg(x + base + lane);
  }
  fold[t] = acc;
  __syncthreads();
  const int Q = 128 / perrow;
  const int rpt = 8 * Q;
  T v = T(0);
  if (t < rpt) {
    // thread t owns row 8 q + i of the row block: y is written in order
    const int q = t >> 3;
    const int i = t & 7;
    for (int s = 0; s < perrow; ++s) v += fold[i * 128 + s * Q + q];
  }
  const int64_t row = static_cast<int64_t>(rb) * rpt + t;
  if (n_split == 1) {
    if (t < rpt) y[row] = v;
    return;
  }
  T* mine = part + (static_cast<int64_t>(rb) * n_split + split) * rpt;
  if (t < rpt) mine[t] = v;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(counter + rb, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  if (t < rpt) {
    const T* rows = part + static_cast<int64_t>(rb) * n_split * rpt + t;
    T sum = T(0);
    for (int s = 0; s < n_split; ++s) sum += __ldcg(rows + static_cast<int64_t>(s) * rpt);
    y[row] = sum;
  }
  if (t == 0) counter[rb] = 0;
}

template <typename T>
cudaError_t launch(const void* idx, const void* vals, const void* strip_of,
                   const void* rb_ptr, const void* x, int n_rb, int n_split, int perrow,
                   void* part, void* counter, void* y, cudaStream_t stream) {
  if (n_rb > 0) {
    strip_kernel<T><<<dim3(n_rb, n_split), kSlots, 0, stream>>>(
        static_cast<const int8_t*>(idx), static_cast<const T*>(vals),
        static_cast<const int32_t*>(strip_of), static_cast<const int32_t*>(rb_ptr),
        static_cast<const T*>(x), perrow, static_cast<T*>(part),
        static_cast<int32_t*>(counter), static_cast<T*>(y));
  }
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = f32 values and vectors, 2 = f64. perrow in {1, 2, 4, 8, 16}.
// n_split >= 1 blocks per row block; with n_split > 1, part holds
// n_rb * n_split * rpt values and counter n_rb zeros (left zero on return).
extern "C" int saena_strip_apply(int dtype_code, const void* idx, const void* vals,
                                 const void* strip_of, const void* rb_ptr,
                                 const void* x, int n_rb, int n_split, int perrow,
                                 void* part, void* counter, void* y, void* stream) {
  if (perrow < 1 || perrow > 16 || (perrow & (perrow - 1)) != 0 || n_split < 1 ||
      n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch<float>(idx, vals, strip_of, rb_ptr, x, n_rb, n_split, perrow, part,
                           counter, y, s);
    case 2:
      return launch<double>(idx, vals, strip_of, rb_ptr, x, n_rb, n_split, perrow, part,
                            counter, y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
