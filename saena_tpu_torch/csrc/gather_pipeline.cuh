// Pieces shared by the stream paths of the strip (strip_spmv.cu) and strip8
// (strip8_spmv.cu) gather kernels for Hopper (sm_90a).
//
// 1. One warp per chunk of work. A block is kWarps independent warps; warp
//    w = blockIdx.x * kWarps + (threadIdx.x / 32) owns a contiguous chunk
//    [k0, k1) of a row-block-ordered list of units (pairs or tiles) and
//    never waits on another warp of its block. Its head record, two int4 at
//    heads[2 w], holds {k0, k1, g0, g1} and its first segment, so one load
//    starts the warp.
// 2. Asynchronous copies into a ring of stages in shared memory, one ring
//    per warp (Ring below): 16-byte cp.async of the values, 4-byte cp.async
//    of the index words, a ring's length ahead of the compute. No copy waits
//    on a load, and no register holds data in flight.
// 3. Segments and cut row blocks. Warp w walks the segments segs[g0 .. g1),
//    each {rb, lo, hi, cut}: the units [lo, hi) of row block rb. A row block
//    that lies inside one chunk has one segment with cut = -1, and the warp
//    writes its rows to y (an empty row block gets a segment with lo == hi
//    and is written as zeros). A row block that chunk boundaries cut has one
//    segment in each chunk it touches, consecutive in segs, and cuts[cut] =
//    {first segment, count}: each writes its rows to part[segment] and draws
//    a ticket in counter[cut] (an acq_rel atomic, which also publishes the
//    piece), and the warp that draws the last ticket sums the pieces in
//    segment order into y and resets the ticket. No value atomics: the
//    result is the same on every run. The tables are built on the host
//    (ops/chunks.py).
// 4. Values of type V, computed in T: f32 values in f32, f64 in f64, bf16
//    values in f32 (x, the sums and y stay f32). A lane's four values of a
//    sublane are 16 bytes at f32 (one cp.async), 32 at f64 (two) and 8 at
//    bf16 (one 8-byte cp.async); bf16 values become f32 as they are read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gather {

constexpr int kWarps = 4;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of one thread into shared memory (LDGSTS), issued in
// commit groups: 16 bytes through the L2 only, or 4 through the L1. Both
// addresses aligned to the size.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// The copies of one lane's four consecutive values of type V: 16-byte
// copies for f32 and f64, one 8-byte copy for bf16. Both addresses aligned
// to 4 sizeof(V) (16 at f64).
template <typename V>
__device__ __forceinline__ void cp_async_vals4(unsigned char* dst, const unsigned char* src) {
  if constexpr (4 * sizeof(V) >= 16) {
#pragma unroll
    for (int o = 0; o < 4 * static_cast<int>(sizeof(V)); o += 16) cp_async16(dst + o, src + o);
  } else {
    static_assert(4 * sizeof(V) == 8, "values of 2 bytes");
    cp_async8(dst, src);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring of one warp: kStages stages of kStage bytes (a multiple of 16).
// Unit u of the warp's chunk (u = 0, 1, ...) uses stage u % kStages. Each
// lane copies into a stage the bytes it reads back (its slots of the tile
// and its index words) in one commit group per unit, so a lane waits for its
// own copies only; a value the whole warp reads (a strip) is copied by one
// lane and read by all after the __syncwarp in wait().
template <int kStage, int kStages>
struct Ring {
  static constexpr int kSmem = kWarps * kStages * kStage;  // bytes per block
  unsigned char* base;

  __device__ __forceinline__ Ring(unsigned char* smem, int warp)
      : base(smem + warp * kStages * kStage) {}
  __device__ __forceinline__ unsigned char* stage(int u) const { return base + (u % kStages) * kStage; }
  // all lanes, before reading the next unit, one commit group having been
  // issued for each unit, kStages ahead: its copies have landed
  __device__ __forceinline__ static void wait() {
    cp_async_wait<kStages - 1>();
    __syncwarp();
  }
};

// The segments g0 .. g1 - 1 of one warp: the first from the warp's head
// record, the others 32 at a time in its lanes' registers, loaded while the
// first is in use.
struct SegWalk {
  const int4* __restrict__ segs;
  int g, g0, g1, gw;
  int4 first, win;  // segs[g0]; segs[gw + lane]

  __device__ __forceinline__ SegWalk(const int4* __restrict__ s, int4 head, int4 lead, int lane)
      : segs(s), g(head.z), g0(head.z), g1(head.w), first(lead) {
    fill(g0 + 1, lane);
  }
  __device__ __forceinline__ void fill(int from, int lane) {
    gw = from;
    win = gw + lane < g1 ? __ldg(segs + gw + lane) : make_int4(0, 0, 0, 0);
  }
  // segment g, for every lane (warp-uniform g < g1)
  __device__ __forceinline__ int4 current(int lane) {
    if (g == g0) return first;
    if (g - gw >= 32) fill(g, lane);
    const int src = g - gw;
    return make_int4(__shfl_sync(kFull, win.x, src), __shfl_sync(kFull, win.y, src),
                     __shfl_sync(kFull, win.z, src), __shfl_sync(kFull, win.w, src));
  }
};

// Four consecutive values: shared or device memory, 16-byte aligned.
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void load_cg(const float* p, float (&v)[4]) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec4<double> {
  __device__ __forceinline__ static void load(const double* p, double (&v)[4]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  __device__ __forceinline__ static void load_cg(const double* p, double (&v)[4]) {
    const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  __device__ __forceinline__ static void store(double* p, const double (&v)[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
};

// Four consecutive values of type V in shared memory (4 sizeof(V) bytes,
// aligned to that or to 16), as the compute type T.
template <typename V, typename T>
__device__ __forceinline__ void load_vals4(const V* p, T (&v)[4]) {
  if constexpr (std::is_same<V, T>::value) {
    Vec4<T>::load(p, v);
  } else {
    static_assert(std::is_same<V, __nv_bfloat16>::value && std::is_same<T, float>::value,
                  "bf16 values are computed in f32");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a, b;
    *reinterpret_cast<uint32_t*>(&a) = u.x;
    *reinterpret_cast<uint32_t*>(&b) = u.y;
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
  }
}

// One value of type V from device memory (read-only path), as T.
template <typename V, typename T>
__device__ __forceinline__ T load_val(const V* p) {
  if constexpr (std::is_same<V, T>::value) {
    return __ldg(p);
  } else {
    static_assert(std::is_same<V, __nv_bfloat16>::value && std::is_same<T, float>::value,
                  "bf16 values are computed in f32");
    return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
}

// Draws a ticket: returns the old count. acq_rel at the scope of the card:
// the writes that the lanes of this warp made before a __syncwarp are
// visible to whoever draws a later ticket, and this lane sees the writes of
// those who drew earlier ones.
__device__ __forceinline__ int ticket(int32_t* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// All lanes of a warp that has written its piece of the cut row block
// `cut` (row block rb, `rows` rows: a multiple of 4, at most 128 kSlots):
// the ticket. The warp that draws the last ticket sums the pieces in
// segment order into y, with 8 / kSlots pieces' loads in flight at once,
// and resets the ticket.
template <typename T, int kSlots>
__device__ __forceinline__ void finish_piece(int cut, int rb, int rows, int lane,
                                             const int2* __restrict__ cuts, const T* part,
                                             int32_t* __restrict__ counter, T* __restrict__ y) {
  const int2 c = __ldg(cuts + cut);
  __syncwarp();
  int last = 0;
  if (lane == 0) last = ticket(counter + cut) == c.y - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __syncwarp();  // the lanes' loads below come after lane 0's acquire
  const T* src = part + static_cast<int64_t>(c.x) * rows;
  T s[kSlots][4];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = T(0);
#pragma unroll(8 / kSlots)
  for (int p = 0; p < c.y; ++p) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int r = 4 * lane + 128 * j;
      if (r < rows) {
        T v[4];
        Vec4<T>::load_cg(src + static_cast<int64_t>(p) * rows + r, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += v[e];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (4 * lane + 128 * j < rows)
      Vec4<T>::store(y + static_cast<int64_t>(rb) * rows + 4 * lane + 128 * j, s[j]);
  if (lane == 0) counter[cut] = 0;
}

// Lets a kernel take `bytes` of dynamic shared memory (above the default
// 48 KB); once per kernel instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace gather
