// Multi-strip ("strip8") gather SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel saena_tpu/ops/pallas_strip8_spmv.py:96
// _kernel (launched at :152 by strip8_spmv there) together with its epilogue
// _reduce_scratch (:161). A tile is (8, 128) int8 lane indices and values
// covering the Q = 128 / perrow rows of one row block; sublane i of tile t
// gathers from strip strips[t * 8 + i] (general mode) or strips[t] + i
// (interval mode); the host resolves both into unit_strips. It computes
//
//   y[rb * Q + q] = sum over s < perrow of
//                   sum over the tiles t of row block rb of
//                   sum over sublanes i of vals[t, i, s Q + q] * x[strip(t, i) * 128 + idx[t, i, s Q + q]]
//
// Strips outside [0, n_strips) read zeros (the JAX code pads x by 8 strips).
//
// Bound: memory traffic. Each tile streams its 1024 index bytes and 1024
// values once and reads 8 strips of x; one multiply-add per slot. The TPU
// kernel wrote one folded 512-byte scratch row per tile and left the
// per-row-block sum and the perrow fold to two passes outside the kernel
// (fused here). On this card a tile's slots are gathered by threads that
// wait on dependent loads (the gather_idx entry, the index bytes and
// strips, then x); a block that walks a long row block alone is a chain of
// such round trips, and small operators are bound by that latency and the
// launch.
//
// Two paths, one function (the wrapper picks per layout, ops/strip8_spmv.py):
//
// rows: the first CUDA design. Block (rb, split) of 128 threads, thread j
//   holding lane j of every sublane, takes an equal share of row block rb's
//   gather_idx row (padding entries skipped), the split sized by the
//   longest row (about SPLIT_TILES entries a block). It stays the faster
//   path on short row blocks and on layouts larger than the card's resident
//   warps (the 48^3 level-2 A among them).
// stream (gather_pipeline.cuh), for layouts whose row blocks are longer
//   than SPLIT_TILES and whose tiles fit the resident warps:
//   (a) No global load waits on another: each lane copies its slots of a
//       tile's vals and idx tiles (16-byte and 4-byte cp.async, lanes 0-1
//       also the tile's 8 strips from unit_strips) into a ring of kStages
//       shared-memory stages, kStages tiles ahead of the compute. The tile
//       ids come from tile_list (or are the list positions, when the tiles
//       already lie in row-block order), its strips from unit_strips, so no
//       copy waits on a load. x is gathered through the L1; a sublane whose
//       strip lies outside x reads zeros, so no copy ever reads past x. (A
//       version that copied each tile with cp.async.bulk and an mbarrier
//       per stage was slower on every layout timed.)
//   (b) Vector loads, no block barrier: lane l reads slots 4l .. 4l + 3 of
//       every sublane (8 float4, or 16 double2, and 8 index words), folds
//       the sublanes in registers in the JAX order
//       ((0+4)+(2+6))+((1+5)+(3+7)) and the perrow lane groups with
//       shuffles.
//   (c) Work balanced over the real tiles (padding of gather_idx dropped):
//       each warp takes an equal, contiguous share (row blocks kept whole on
//       layouts too small to fill the card); only row blocks that a share
//       boundary cuts go through part and a ticket.
//   On the 48^3 level 3-5 transfers it runs 1.1-1.4x faster than the rows
//   path (PERF.md, PR 3).
// The sums follow another order than the plain version's: equal to rounding.
//
// Types (values V, compute T): f32 values with f32 x/accumulator, f64
// throughout, and bf16 values with f32 x/accumulator/y (the smoothers' twin
// of an operator, Options.smooth_dtype): a tile then streams 3 bytes a slot
// instead of 5, and each lane copies its 8 bytes of a sublane's values with
// one 8-byte cp.async. The compiler contracts the multiply-add to FMA. The
// result is the same on every run.
//
// Launches on the caller's stream, allocates nothing (the wrapper passes the
// scratch part and the zeroed counters), and returns the CUDA error code so
// the wrapper can raise on a refused launch.

#include "gather_pipeline.cuh"

namespace {

constexpr int kStages = 2;  // tiles in flight per warp

template <typename V>
struct Stage {
  static constexpr int kVals = 1024 * sizeof(V);
  static constexpr int kIdx = 1024;
  static constexpr int kStrips = 32;  // 8 int32 strips
  static constexpr int kBytes = kVals + kIdx + kStrips;
};

template <typename V>
using RingOf = gather::Ring<Stage<V>::kBytes, kStages>;

template <typename V, typename T>
__global__ void __launch_bounds__(gather::kThreads)
stream_kernel(const int8_t* __restrict__ idx, const V* __restrict__ vals,
              const int32_t* __restrict__ tile_list, const int32_t* __restrict__ unit_strips,
              const int4* __restrict__ heads, const int4* __restrict__ segs,
              const int2* __restrict__ cuts, const T* __restrict__ x, int n_chunks, int perrow,
              T* part, int32_t* __restrict__ counter, T* __restrict__ y) {
  using S = Stage<V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * gather::kWarps + warp;
  if (w >= n_chunks) return;
  RingOf<V> ring(smem, warp);
  const int4 head = __ldg(heads + 2 * w);       // {k0, k1, g0, g1}
  const int k0 = head.x, k1 = head.y;

  // all lanes: the copies of list position k (tile t) into its stage
  auto tile_of = [&](int k) { return tile_list ? __ldg(tile_list + k) : k; };
  auto issue = [&](int k, int t) {
    unsigned char* st = ring.stage(k - k0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int slot = i * 128 + 4 * lane;
      gather::cp_async_vals4<V>(
          st + slot * sizeof(V),
          reinterpret_cast<const unsigned char*>(vals + static_cast<int64_t>(t) * 1024 + slot));
      gather::cp_async4(st + S::kVals + slot, idx + static_cast<int64_t>(t) * 1024 + slot);
    }
    if (lane < 2)
      gather::cp_async16(st + S::kVals + S::kIdx + 16 * lane,
                         unit_strips + static_cast<int64_t>(k) * 8 + 4 * lane);
  };
  int t[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) t[s] = k0 + s < k1 ? tile_of(k0 + s) : 0;
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (k0 + s < k1) issue(k0 + s, t[s]);
    gather::cp_async_commit();
  }
  int kn = min(k1, k0 + kStages);   // next position to copy
  int t_next = kn < k1 ? tile_of(kn) : 0;
  gather::SegWalk sw(segs, head, __ldg(heads + 2 * w + 1), lane);

  const int Q = 128 / perrow;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  // write every segment that ends at list position p (warp-uniform)
  auto flush = [&](int p) {
    while (sw.g < sw.g1) {
      const int4 sg = sw.current(lane);       // {rb, lo, hi, cut}
      if (sg.z != p) break;
      T v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[e];
        acc[e] = T(0);
        // lane j of the tile is row j % Q: fold the perrow lane groups
        if (perrow >= 2) v[e] += __shfl_xor_sync(gather::kFull, v[e], 16);
        if (perrow >= 4) v[e] += __shfl_xor_sync(gather::kFull, v[e], 8);
      }
      T* out = sg.w < 0 ? y + static_cast<int64_t>(sg.x) * Q : part + static_cast<int64_t>(sw.g) * Q;
      if (4 * lane < Q) gather::Vec4<T>::store(out + 4 * lane, v);
      if (sg.w >= 0) gather::finish_piece<T, 1>(sg.w, sg.x, Q, lane, cuts, part, counter, y);
      ++sw.g;
    }
  };

  flush(k0);
  for (int k = k0; k < k1; ++k) {
    RingOf<V>::wait();
    const unsigned char* st = ring.stage(k - k0);
    const int4 sa = *reinterpret_cast<const int4*>(st + S::kVals + S::kIdx);
    const int4 sb = *reinterpret_cast<const int4*>(st + S::kVals + S::kIdx + 16);
    const int sid[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    uint32_t lanes[8];
    T v[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lanes[i] = reinterpret_cast<const uint32_t*>(st + S::kVals)[i * 32 + lane];
      gather::load_vals4<V, T>(reinterpret_cast<const V*>(st) + i * 128 + 4 * lane, v[i]);
    }
    __syncwarp();
    if (kn < k1) {                             // refill the stage just read
      issue(kn, t_next);
      ++kn;
      if (kn < k1) t_next = tile_of(kn);
    }
    gather::cp_async_commit();
    T c[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const T* xs = x + static_cast<int64_t>(max(sid[i], 0)) * 128;
#pragma unroll
      for (int e = 0; e < 4; ++e)   // a strip outside x reads zeros
        c[i][e] = sid[i] >= 0 ? v[i][e] * __ldg(xs + ((lanes[i] >> (8 * e)) & 0xff)) : T(0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e] += ((c[0][e] + c[4][e]) + (c[2][e] + c[6][e])) +
                ((c[1][e] + c[5][e]) + (c[3][e] + c[7][e]));
    flush(k + 1);
  }
}

template <typename V, typename T>
cudaError_t launch_stream(const void* idx, const void* vals, const void* tile_list,
                   const void* unit_strips, const void* heads, const void* segs,
                   const void* cuts, const void* x, int n_chunks, int perrow, void* part,
                   void* counter, void* y, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr int kSmem = RingOf<V>::kSmem;
  cudaError_t e = gather::allow_smem(stream_kernel<V, T>, kSmem, smem_ok);
  if (e != cudaSuccess) return e;
  if (n_chunks > 0) {
    const int blocks = (n_chunks + gather::kWarps - 1) / gather::kWarps;
    stream_kernel<V, T><<<blocks, gather::kThreads, kSmem, stream>>>(
        static_cast<const int8_t*>(idx), static_cast<const V*>(vals),
        static_cast<const int32_t*>(tile_list), static_cast<const int32_t*>(unit_strips),
        static_cast<const int4*>(heads), static_cast<const int4*>(segs),
        static_cast<const int2*>(cuts), static_cast<const T*>(x), n_chunks, perrow,
        static_cast<T*>(part), static_cast<int32_t*>(counter), static_cast<T*>(y));
  }
  return cudaGetLastError();
}

// The rows path: block (rb, split) of a grid n_rb x n_split walks an equal
// share of row block rb's entries of gather_idx (padding entries skipped),
// thread j holding lane j of every sublane; it folds the sublanes in
// registers and the perrow lane groups through shared memory and writes y
// (n_split == 1) or its rows to part[rb][split], the last block of the row
// block to arrive (a ticket in counter[rb], reset to 0) summing the splits
// in split order.
template <typename V, typename T, bool INTERVAL>
__global__ void __launch_bounds__(128)
rows_kernel(const int8_t* __restrict__ idx, const V* __restrict__ vals,
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
      c[i] = gather::load_val<V, T>(vals + off) * xv;
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

template <typename V, typename T>
cudaError_t launch_rows(int interval, const void* idx, const void* vals, const void* strips,
                        const void* gather_idx, int n_rb, int t_max, int n_tiles, int n_strips,
                        const void* x, int perrow, int n_split, void* part, void* counter,
                        void* y, cudaStream_t stream) {
  const int8_t* ix = static_cast<const int8_t*>(idx);
  const V* v = static_cast<const V*>(vals);
  const int32_t* st = static_cast<const int32_t*>(strips);
  const int32_t* gi = static_cast<const int32_t*>(gather_idx);
  const T* xv = static_cast<const T*>(x);
  T* pt = static_cast<T*>(part);
  int32_t* ct = static_cast<int32_t*>(counter);
  T* out = static_cast<T*>(y);
  const dim3 grid(n_rb, n_split);
  if (n_rb > 0) {
    if (interval)
      rows_kernel<V, T, true><<<grid, 128, 0, stream>>>(ix, v, st, gi, t_max, n_tiles, n_strips,
                                                     xv, perrow, pt, ct, out);
    else
      rows_kernel<V, T, false><<<grid, 128, 0, stream>>>(ix, v, st, gi, t_max, n_tiles, n_strips,
                                                      xv, perrow, pt, ct, out);
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
// and y, 2 = f64. perrow in {1, 2, 4}.

// The stream path. tile_list: the real tiles in row-block order, or null
// when list position k is tile k; unit_strips: 8 strips per list position,
// -1 where the strip lies outside x. idx, vals, unit_strips, heads, part and
// y 16-byte aligned. n_chunks warps, heads holding two int4 for each; part
// holds one Q-row piece per segment of a cut row block (it may be empty when
// no row block is cut) and counter one zero per cut row block (left zero on
// return).
extern "C" int saena_strip8_stream(int dtype_code, const void* idx, const void* vals,
                                   const void* tile_list, const void* unit_strips,
                                   const void* heads, const void* segs, const void* cuts,
                                   const void* x, int n_chunks, int perrow, void* part,
                                   void* counter, void* y, void* stream) {
  if ((perrow != 1 && perrow != 2 && perrow != 4) || n_chunks < 0 ||
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(vals) |
        reinterpret_cast<uintptr_t>(unit_strips) | reinterpret_cast<uintptr_t>(heads) |
        reinterpret_cast<uintptr_t>(part) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch_stream<float, float>(idx, vals, tile_list, unit_strips, heads, segs, cuts,
                                         x, n_chunks, perrow, part, counter, y, s);
    case 1:
      return launch_stream<__nv_bfloat16, float>(idx, vals, tile_list, unit_strips, heads, segs,
                                                 cuts, x, n_chunks, perrow, part, counter, y, s);
    case 2:
      return launch_stream<double, double>(idx, vals, tile_list, unit_strips, heads, segs, cuts,
                                           x, n_chunks, perrow, part, counter, y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The rows path. interval: 0 general mode, 1 interval mode; n_tiles = the
// padded tile count. n_split >= 1 blocks per row block; with n_split > 1,
// part holds n_rb * n_split * Q values and counter n_rb zeros (left zero on
// return).
extern "C" int saena_strip8_rows(int dtype_code, int interval, const void* idx,
                                 const void* vals, const void* strips, const void* gather_idx,
                                 int n_rb, int t_max, int n_tiles, int n_strips, const void* x,
                                 int perrow, int n_split, void* part, void* counter, void* y,
                                 void* stream) {
  if ((perrow != 1 && perrow != 2 && perrow != 4) || n_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch_rows<float, float>(interval, idx, vals, strips, gather_idx, n_rb, t_max,
                                       n_tiles, n_strips, x, perrow, n_split, part, counter, y,
                                       s);
    case 1:
      return launch_rows<__nv_bfloat16, float>(interval, idx, vals, strips, gather_idx, n_rb,
                                               t_max, n_tiles, n_strips, x, perrow, n_split, part,
                                               counter, y, s);
    case 2:
      return launch_rows<double, double>(interval, idx, vals, strips, gather_idx, n_rb, t_max,
                                         n_tiles, n_strips, x, perrow, n_split, part, counter, y,
                                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Warps of the stream path one SM keeps resident (0 on an error).
extern "C" int saena_strip8_stream_warps_per_sm(int dtype_code) {
  switch (dtype_code) {
    case 0: return stream_warps_per_sm<float, float>();
    case 1: return stream_warps_per_sm<__nv_bfloat16, float>();
    case 2: return stream_warps_per_sm<double, double>();
    default: return 0;
  }
}
