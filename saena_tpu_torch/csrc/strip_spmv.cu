// Strip-gather SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel saena_tpu/ops/pallas_strip_spmv.py:116
// _kernel (launched at :198 by strip_spmv there). A is a list of PAIRS, each
// an (8, 128) tile of int8 lane indices and values keyed by (row block,
// 128-column strip of x). Slot (i, j) of a tile belongs to row i + 8 * (j % Q)
// of its row block, Q = 128 / perrow, and reads x[strip * 128 + idx]. It
// computes
//
//   y[rb * rpt + 8 q + i] = sum over the row block's pairs p and the row's
//                           perrow slot groups s of
//                           vals[p, i, s Q + q] * x[strip_of[p] * 128 + idx[p, i, s Q + q]]
//
// with rpt = 8 Q rows per row block; the pairs come in row-block order.
//
// Bound: memory traffic. Each pair streams its 1024 index bytes and 1024
// values once (5 or 9 bytes a slot) and reads one 128-value strip of x; the
// arithmetic is one multiply-add per slot. The TPU kernel kept x resident in
// VMEM and walked the pairs in one sequential grid. On this card a pair's
// slots are gathered by threads that wait on dependent loads (the pair's
// strip, its index byte, then x), and a row block that one block walks
// alone is a chain of such round trips; small operators are bound by that
// latency and by the launch, large ones by the bytes.
//
// Two paths, one function (the wrapper picks per layout, ops/strip_spmv.py):
//
// rows: the first CUDA design. Block (rb, split) of 1024 threads takes an
//   equal share of row block rb's pairs, one slot per thread, the split
//   sized by the longest row block (about SPLIT_PAIRS pairs a block). Its
//   chain is short on small layouts and on the 1024-row row blocks of
//   perrow 1, where it stays the faster path.
// stream (gather_pipeline.cuh), for layouts with more pairs than the card
//   keeps warps resident, at perrow > 1:
//   (a) No global load waits on another: each lane copies its slots of a
//       pair's vals and idx tiles (16-byte and 4-byte cp.async, lane 0 also
//       the 16 bytes of strip_of that hold the pair's strip) into a ring of
//       kStages shared-memory stages, kStages pairs ahead of the compute.
//       x is gathered through the L1, where the strip stays resident. (A
//       version that copied each pair with cp.async.bulk and an mbarrier
//       per stage was slower on every layout timed.)
//   (b) Vector loads, no block barrier: lane l reads slots 4l .. 4l + 3 of
//       every sublane (8 float4, or 16 double2, and 8 index words) and keeps
//       its 32 row sums in registers; at a row block's end the perrow slot
//       groups fold with shuffles and the lanes write 32 consecutive rows.
//   (c) Work balanced over pairs: each warp takes an equal, contiguous share
//       of the pair list (row blocks kept whole on layouts too small to fill
//       the card); only row blocks that a share boundary cuts go through
//       part and a ticket.
//   On the 48^3 level-2 A at perrow 2-16 it runs 1.06-1.43x faster than
//   the rows path (PERF.md, PR 3).
//
// Types (values V, compute T): f32 values with f32 x/accumulator, f64
// throughout, and bf16 values with f32 x/accumulator/y (the smoothers' twin
// of an operator, Options.smooth_dtype): a pair then streams 3 bytes a slot
// instead of 5, and each lane copies its 8 bytes of a sublane's values with
// one 8-byte cp.async. The compiler contracts the multiply-add to FMA, so
// results differ from the plain PyTorch version by rounding only, in the
// same way on every run.
//
// Launches on the caller's stream, allocates nothing (the wrapper passes the
// scratch part and the zeroed counters), and returns the CUDA error code so
// the wrapper can raise on a refused launch.

#include "gather_pipeline.cuh"

namespace {

constexpr int kStages = 2;  // pairs in flight per warp

template <typename V>
struct Stage {
  static constexpr int kVals = 1024 * sizeof(V);
  static constexpr int kIdx = 1024;
  static constexpr int kStrip = 16;  // strip_of[4 (k / 4) ..][k % 4]
  static constexpr int kBytes = kVals + kIdx + kStrip;
};

template <typename V>
using RingOf = gather::Ring<Stage<V>::kBytes, kStages>;

template <typename V, typename T>
__global__ void __launch_bounds__(gather::kThreads)
stream_kernel(const int8_t* __restrict__ idx, const V* __restrict__ vals,
             const int32_t* __restrict__ strip_of, const int4* __restrict__ heads,
             const int4* __restrict__ segs, const int2* __restrict__ cuts,
             const T* __restrict__ x, int n_chunks, int perrow, T* part,
             int32_t* __restrict__ counter, T* __restrict__ y) {
  using S = Stage<V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * gather::kWarps + warp;
  if (w >= n_chunks) return;
  RingOf<V> ring(smem, warp);
  const int4 head = __ldg(heads + 2 * w);       // {k0, k1, g0, g1}
  const int k0 = head.x, k1 = head.y;

  // all lanes: the copies of pair k into its stage
  auto issue = [&](int k) {
    unsigned char* st = ring.stage(k - k0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int slot = i * 128 + 4 * lane;
      gather::cp_async_vals4<V>(
          st + slot * sizeof(V),
          reinterpret_cast<const unsigned char*>(vals + static_cast<int64_t>(k) * 1024 + slot));
      gather::cp_async4(st + S::kVals + slot, idx + static_cast<int64_t>(k) * 1024 + slot);
    }
    if (lane == 0) gather::cp_async16(st + S::kVals + S::kIdx, strip_of + (k & ~3));
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (k0 + s < k1) issue(k0 + s);
    gather::cp_async_commit();
  }
  gather::SegWalk sw(segs, head, __ldg(heads + 2 * w + 1), lane);

  const int Q = 128 / perrow;
  const int rpt = 8 * Q;
  T acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = T(0);
  // write every segment that ends at pair p (warp-uniform)
  auto flush = [&](int p) {
    while (sw.g < sw.g1) {
      const int4 sg = sw.current(lane);       // {rb, lo, hi, cut}
      if (sg.z != p) break;
      T v[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[i][e] = acc[i][e];
          acc[i][e] = T(0);
        }
      // slot j of a sublane is row group j % Q: fold the perrow slot groups
      for (int m = 16; m > 16 / perrow; m >>= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[i][e] += __shfl_xor_sync(gather::kFull, v[i][e], m);
      // lane l < Q / 4 holds rows 32 l + 8 e + i
      T* out = sg.w < 0 ? y + static_cast<int64_t>(sg.x) * rpt
                        : part + static_cast<int64_t>(sw.g) * rpt;
      if (4 * lane < Q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T lo[4] = {v[0][e], v[1][e], v[2][e], v[3][e]};
          const T hi[4] = {v[4][e], v[5][e], v[6][e], v[7][e]};
          gather::Vec4<T>::store(out + 32 * lane + 8 * e, lo);
          gather::Vec4<T>::store(out + 32 * lane + 8 * e + 4, hi);
        }
      }
      if (sg.w >= 0) gather::finish_piece<T, 8>(sg.w, sg.x, rpt, lane, cuts, part, counter, y);
      ++sw.g;
    }
  };

  flush(k0);
  for (int k = k0; k < k1; ++k) {
    RingOf<V>::wait();
    const unsigned char* st = ring.stage(k - k0);
    const int strip = reinterpret_cast<const int32_t*>(st + S::kVals + S::kIdx)[k & 3];
    uint32_t lanes[8];
    T v[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lanes[i] = reinterpret_cast<const uint32_t*>(st + S::kVals)[i * 32 + lane];
      gather::load_vals4<V, T>(reinterpret_cast<const V*>(st) + i * 128 + 4 * lane, v[i]);
    }
    __syncwarp();
    if (k + kStages < k1) issue(k + kStages);  // refill the stage just read
    gather::cp_async_commit();
    const T* xs = x + static_cast<int64_t>(strip) * 128;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += v[i][e] * __ldg(xs + ((lanes[i] >> (8 * e)) & 0xff));
    flush(k + 1);
  }
}

template <typename V, typename T>
cudaError_t launch_stream(const void* idx, const void* vals, const void* strip_of, const void* heads,
                   const void* segs, const void* cuts, const void* x, int n_chunks, int perrow,
                   void* part, void* counter, void* y, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr int kSmem = RingOf<V>::kSmem;
  cudaError_t e = gather::allow_smem(stream_kernel<V, T>, kSmem, smem_ok);
  if (e != cudaSuccess) return e;
  if (n_chunks > 0) {
    const int blocks = (n_chunks + gather::kWarps - 1) / gather::kWarps;
    stream_kernel<V, T><<<blocks, gather::kThreads, kSmem, stream>>>(
        static_cast<const int8_t*>(idx), static_cast<const V*>(vals),
        static_cast<const int32_t*>(strip_of), static_cast<const int4*>(heads),
        static_cast<const int4*>(segs), static_cast<const int2*>(cuts),
        static_cast<const T*>(x), n_chunks, perrow, static_cast<T*>(part),
        static_cast<int32_t*>(counter), static_cast<T*>(y));
  }
  return cudaGetLastError();
}

// The rows path: block (rb, split) of a grid n_rb x n_split takes an equal
// share of row block rb's pairs, one thread per slot (i, j) = (t / 128,
// t % 128), and keeps its slot's sum in a register; it folds the perrow slot
// groups of its rows through shared memory and writes y (n_split == 1) or
// its rows to part[rb][split], the last block of the row block to arrive (a
// ticket in counter[rb], reset to 0) summing the splits in split order.
constexpr int kSlots = 8 * 128;

template <typename V, typename T>
__global__ void __launch_bounds__(kSlots)
rows_kernel(const int8_t* __restrict__ idx, const V* __restrict__ vals,
            const int32_t* __restrict__ strip_of, const int32_t* __restrict__ rb_ptr,
            const T* __restrict__ x, int perrow, T* __restrict__ part,
            int32_t* __restrict__ counter, T* __restrict__ y) {
  __shared__ T fold[kSlots];
  __shared__ bool last;
  const int rb = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int t = threadIdx.x;
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
    acc += gather::load_val<V, T>(vals + off) * __ldg(x + base + lane);
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

template <typename V, typename T>
cudaError_t launch_rows(const void* idx, const void* vals, const void* strip_of,
                        const void* rb_ptr, const void* x, int n_rb, int n_split, int perrow,
                        void* part, void* counter, void* y, cudaStream_t stream) {
  if (n_rb > 0) {
    rows_kernel<V, T><<<dim3(n_rb, n_split), kSlots, 0, stream>>>(
        static_cast<const int8_t*>(idx), static_cast<const V*>(vals),
        static_cast<const int32_t*>(strip_of), static_cast<const int32_t*>(rb_ptr),
        static_cast<const T*>(x), perrow, static_cast<T*>(part),
        static_cast<int32_t*>(counter), static_cast<T*>(y));
  }
  return cudaGetLastError();
}

// Warps of the stream kernel that one SM keeps resident.
template <typename V, typename T>
int stream_warps_per_sm() {
  static bool smem_ok = false;
  constexpr int kSmem = RingOf<V>::kSmem;
  if (gather::allow_smem(stream_kernel<V, T>, kSmem, smem_ok) != cudaSuccess) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, stream_kernel<V, T>, gather::kThreads,
                                                    kSmem) != cudaSuccess)
    return 0;
  return blocks * gather::kWarps;
}

}  // namespace

// dtype_code: 0 = f32 values and vectors, 1 = bf16 values with f32 x, part
// and y, 2 = f64. perrow in {1, 2, 4, 8, 16}.

// The stream path. idx, vals, strip_of, heads, part and y 16-byte aligned;
// the pair count a multiple of 4 (the strip of pair k is copied with the 16
// bytes around it). n_chunks warps, heads holding two int4 for each; part
// holds one rpt-row piece per segment of a cut row block (it may be empty
// when no row block is cut) and counter one zero per cut row block (left
// zero on return).
extern "C" int saena_strip_stream(int dtype_code, const void* idx, const void* vals,
                                  const void* strip_of, const void* heads, const void* segs,
                                  const void* cuts, const void* x, int n_chunks, int perrow,
                                  void* part, void* counter, void* y, void* stream) {
  if (perrow < 1 || perrow > 16 || (perrow & (perrow - 1)) != 0 || n_chunks < 0 ||
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(vals) |
        reinterpret_cast<uintptr_t>(strip_of) | reinterpret_cast<uintptr_t>(heads) |
        reinterpret_cast<uintptr_t>(part) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch_stream<float, float>(idx, vals, strip_of, heads, segs, cuts, x, n_chunks,
                                         perrow, part, counter, y, s);
    case 1:
      return launch_stream<__nv_bfloat16, float>(idx, vals, strip_of, heads, segs, cuts, x,
                                                 n_chunks, perrow, part, counter, y, s);
    case 2:
      return launch_stream<double, double>(idx, vals, strip_of, heads, segs, cuts, x, n_chunks,
                                           perrow, part, counter, y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The rows path. n_split >= 1 blocks per row block; with n_split > 1, part
// holds n_rb * n_split * rpt values and counter n_rb zeros (left zero on
// return).
extern "C" int saena_strip_rows(int dtype_code, const void* idx, const void* vals,
                                const void* strip_of, const void* rb_ptr, const void* x,
                                int n_rb, int n_split, int perrow, void* part, void* counter,
                                void* y, void* stream) {
  if (perrow < 1 || perrow > 16 || (perrow & (perrow - 1)) != 0 || n_split < 1 ||
      n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch_rows<float, float>(idx, vals, strip_of, rb_ptr, x, n_rb, n_split, perrow,
                                       part, counter, y, s);
    case 1:
      return launch_rows<__nv_bfloat16, float>(idx, vals, strip_of, rb_ptr, x, n_rb, n_split,
                                               perrow, part, counter, y, s);
    case 2:
      return launch_rows<double, double>(idx, vals, strip_of, rb_ptr, x, n_rb, n_split, perrow,
                                         part, counter, y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Warps of the stream path one SM keeps resident (0 on an error).
extern "C" int saena_strip_stream_warps_per_sm(int dtype_code) {
  switch (dtype_code) {
    case 0: return stream_warps_per_sm<float, float>();
    case 1: return stream_warps_per_sm<__nv_bfloat16, float>();
    case 2: return stream_warps_per_sm<double, double>();
    default: return 0;
  }
}
