// DIA (diagonal-storage) SpMV and fused smoother update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel saena_tpu/ops/pallas_dia_spmv.py:_kernel
// (launched by _dia_call via dia_spmv / dia_fused_update). It computes
//
//   acc[i] = sum_k data[k, i] * x[i + off_k]     (x reads as 0 outside [0, m_pad))
//   y[i]   = acc[i]                                       (no rhs)
//   y[i]   = [x[i + x0] +] c * [dinv[i] *] (rhs[i] - acc[i])   (with rhs)
//
// for i in [0, n_pad). With m_pad != n_pad the operator is a rectangular row
// block reading a halo-extended x (x0 places the block's own rows in x).
// The epilogue covers the Jacobi sweep (add_x, dinv, c = omega), the
// Chebyshev scaled residual (dinv, c = d2) and the plain residual (c = -1).
//
// Bound: memory traffic. Per row it must read ndiag data values, x once and
// (for the update) rhs and dinv, and write y; it does 2 * ndiag flops per
// row, far under the card's rate. On the 48^3 solve's shapes the time is
// set by how many bytes are in flight (the 101-diagonal level 1) and by the
// length of the dependent load chain (the 7-diagonal level 0, a few µs
// from the launch floor). The TPU kernel kept x resident in VMEM behind a
// halo scratch and rotated lanes to form each shifted view; none of that is
// carried over.
//
// Design ("tiled" kernel, one instantiation per data type and x access; the
// wrapper's plan, ops/dia_spmv.py:dia_plan, picks it):
// - a lane owns V consecutive rows, V = 16 bytes / sizeof(data): every
//   data, rhs, dinv and y access is one 16-byte load or store. A warp owns
//   a unit of 32 V rows; a block is W row warps x G diagonal groups. Group
//   g sums the diagonals [gk[g], gk[g + 1]) of its rows; groups 1..G-1 park
//   their sums in shared memory and group 0 adds them in group order and
//   applies the epilogue, so two launches give the same bits (no atomics).
// - offsets (or, with x staged, shared-memory window offsets) travel by
//   value in a __grid_constant__ parameter block, so no x address waits on
//   a load; the diagonal loop is unrolled by CHUNK (every load of a chunk is
//   issued before its first FMA; the tail of a group re-reads its last
//   diagonal and drops it with a select).
// - x: a lane's V shifted values come from aligned 16-byte vectors and a
//   select by off mod (16 / sizeof(x)), read through L1 ("l1"), or from
//   per-cluster windows of x copied into shared memory with cp.async
//   ("smem", one window per run of offsets no wider than the plan's span).
//   The plan stages x for wide f32 stencils (the 101-diagonal level 1,
//   where it measured faster) and reads it through L1 elsewhere. A view of
//   x, rhs or dinv that is not 16-byte aligned takes scalar, bounds-checked
//   loads of the same values in the same order.
// - the grid is sized by the plan so that the busiest SM holds as few
//   units as the unit count allows, in one wave where the card holds it.
// The first port's kernel (one thread per row, offsets read from memory)
// stays as the "rows" configuration: the plan takes it for up to CHUNK
// diagonals, for more than MAX_DIAGS, for data that is not 16-byte
// aligned, and it is the reference of the redesign's times. With one
// diagonal group there is nothing to split: on the 7-diagonal level 0 the
// tiled kernel measured 11-26% slower than the row kernel, which takes
// 2.5 µs (f32) against a 0.8 µs launch floor of an empty kernel (PERF.md);
// the time there is launch and one round trip.
//
// Types: f32 data with f32 accumulator; bf16 data with f32 x/accumulator/
// output; f64 throughout (the card has native FP64). The compiler contracts
// the multiply-add to FMA, so results differ from the plain PyTorch version
// by rounding only.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------------- row kernel --

template <typename TD, typename TC>
__device__ __forceinline__ TC load_data(const TD* p) { return static_cast<TC>(__ldg(p)); }

template <>
__device__ __forceinline__ float load_data<__nv_bfloat16, float>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename TD, typename TC, bool HAS_RHS, bool HAS_DINV, bool ADD_X>
__global__ void dia_kernel(const TD* __restrict__ data, const TC* __restrict__ x,
                           const int64_t* __restrict__ offsets, int ndiag,
                           int64_t n_pad, int64_t m_pad,
                           const TC* __restrict__ rhs, const TC* __restrict__ dinv,
                           TC c, int64_t x0, TC* __restrict__ y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  TC acc = TC(0);
  for (int k = 0; k < ndiag; ++k) {
    const int64_t j = i + __ldg(offsets + k);
    // bounds check, never data == 0: an out-of-range x must add nothing
    // even where the stored coefficient is not finite
    const TC xv = (j >= 0 && j < m_pad) ? __ldg(x + j) : TC(0);
    acc += load_data<TD, TC>(data + static_cast<int64_t>(k) * n_pad + i) * xv;
  }
  if (HAS_RHS) {
    TC z = __ldg(rhs + i) - acc;
    if (HAS_DINV) z = z * __ldg(dinv + i);
    z = z * c;
    if (ADD_X) z = z + __ldg(x + x0 + i);
    y[i] = z;
  } else {
    y[i] = acc;
  }
}

template <typename TD, typename TC>
cudaError_t launch_rows(const void* data, const void* x, const void* offsets, int ndiag,
                        int64_t n_pad, int64_t m_pad, const void* rhs, const void* dinv,
                        double c, int add_x, int64_t x0, void* y, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((n_pad + kThreads - 1) / kThreads);
  const TD* d = static_cast<const TD*>(data);
  const TC* xv = static_cast<const TC*>(x);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const TC* r = static_cast<const TC*>(rhs);
  const TC* dv = static_cast<const TC*>(dinv);
  TC* out = static_cast<TC*>(y);
  const TC cc = static_cast<TC>(c);
  if (blocks == 0) return cudaGetLastError();
  if (rhs == nullptr) {
    dia_kernel<TD, TC, false, false, false><<<blocks, kThreads, 0, stream>>>(
        d, xv, off, ndiag, n_pad, m_pad, r, dv, cc, x0, out);
  } else if (dinv == nullptr) {
    if (add_x)
      dia_kernel<TD, TC, true, false, true><<<blocks, kThreads, 0, stream>>>(
          d, xv, off, ndiag, n_pad, m_pad, r, dv, cc, x0, out);
    else
      dia_kernel<TD, TC, true, false, false><<<blocks, kThreads, 0, stream>>>(
          d, xv, off, ndiag, n_pad, m_pad, r, dv, cc, x0, out);
  } else {
    if (add_x)
      dia_kernel<TD, TC, true, true, true><<<blocks, kThreads, 0, stream>>>(
          d, xv, off, ndiag, n_pad, m_pad, r, dv, cc, x0, out);
    else
      dia_kernel<TD, TC, true, true, false><<<blocks, kThreads, 0, stream>>>(
          d, xv, off, ndiag, n_pad, m_pad, r, dv, cc, x0, out);
  }
  return cudaGetLastError();
}

// ----------------------------------------------------------- tiled path --

// limits shared with ops/dia_spmv.py
constexpr int MAX_DIAGS = 256;
constexpr int MAX_GROUPS = 8;
constexpr int MAX_WINDOWS = 32;
constexpr int MAX_THREADS = 256;
constexpr int MIN_BLOCKS = 4;      // blocks of MAX_THREADS an SM keeps resident
constexpr int CHUNK = 8;           // diagonals whose loads are issued together

enum Flags { HAS_RHS = 1, HAS_DINV = 2, ADD_X = 4, ALIGNED = 8 };
enum Config { CFG_ROWS = 0, CFG_L1 = 1, CFG_SMEM = 2 };

struct DiaParams {
  const void* data;
  const void* x;
  const void* rhs;
  const void* dinv;
  void* y;
  long long n_pad, m_pad, x0;
  double c;
  int units_q, units_r;                 // block b: units_q + (b < units_r) units
  int flags, groups, row_warps, nwin;
  int gk[MAX_GROUPS + 1];               // group g sums diagonals [gk[g], gk[g+1])
  int win_lo[MAX_WINDOWS];              // window w: x[row0 + lo, row0 + lo + len)
  int win_len[MAX_WINDOWS];             //   at shared index base (all in x elements,
  int win_base[MAX_WINDOWS];            //   multiples of 16 bytes)
  int doff[MAX_DIAGS];                  // the diagonals' offsets
  int woff[MAX_DIAGS];                  // their shared index less the row (smem)
};

// The data's 16-byte loads. Normal caching (__ldg), not evict-first
// (__ldcs): a smoother applies one operator several times in a row, and the
// 48^3 level 1 (19.7 MB f32, 39.4 MB f64) fits in the card's 50 MB L2, so
// the next launch finds much of it there. tools/dia_load_hints.py builds the
// kernel with other hints (-DSAENA_DIA_DATA_LOAD=__ldcs, __ldcg) and times
// them in turns, back to back and with the data rotated over copies larger
// than L2.
#ifndef SAENA_DIA_DATA_LOAD
#define SAENA_DIA_DATA_LOAD __ldg
#endif

template <typename T>
struct Vec16;                           // 16 bytes of T
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// V values of TD from 16 aligned bytes, as TC
template <typename TD, typename TC, int V>
__device__ __forceinline__ void load_data16(const TD* p, TC (&out)[V]) {
  if constexpr (sizeof(TD) == 2) {
    const uint4 u = SAENA_DIA_DATA_LOAD(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __nv_bfloat162 h;
      *reinterpret_cast<unsigned*>(&h) = w[q];
      const float2 f = __bfloat1622float2(h);
      out[2 * q] = f.x;
      out[2 * q + 1] = f.y;
    }
  } else {
    using VT = typename Vec16<TD>::type;
    const VT v = SAENA_DIA_DATA_LOAD(reinterpret_cast<const VT*>(p));
    const TD* e = reinterpret_cast<const TD*>(&v);
#pragma unroll
    for (int q = 0; q < V; ++q) out[q] = static_cast<TC>(e[q]);
  }
}

// N values of T from aligned 16-byte vectors (global, through L1)
template <typename T, int N>
__device__ __forceinline__ void load_vecs(const T* p, T (&out)[N]) {
  using VT = typename Vec16<T>::type;
  constexpr int XV = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < N / XV; ++q) {
    const VT v = __ldg(reinterpret_cast<const VT*>(p) + q);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int t = 0; t < XV; ++t) out[q * XV + t] = e[t];
  }
}

// N values of T, aligned vectors where the wrapper said so, else scalars
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, bool aligned, T (&out)[N]) {
  if (aligned) {
    load_vecs<T, N>(p, out);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) out[q] = __ldg(p + q);
  }
}

// the V values x[j0 .. j0 + V) of one diagonal, zero outside [0, m_pad)
template <typename TC, int V, bool ALIGNED_X, bool XS>
__device__ __forceinline__ void load_x(const TC* __restrict__ x, const TC* xs, long long j0,
                                       long long m_pad, TC (&out)[V]) {
  constexpr int XV = 16 / sizeof(TC);
  constexpr int NV = V / XV + 1;        // aligned vectors that cover V shifted values
  if constexpr (!ALIGNED_X) {
#pragma unroll
    for (int r = 0; r < V; ++r) {
      const long long j = j0 + r;
      out[r] = (j >= 0 && j < m_pad) ? __ldg(x + j) : TC(0);
    }
  } else {
    using VT = typename Vec16<TC>::type;
    const long long a0 = j0 & ~static_cast<long long>(XV - 1);   // floor to a vector
    const int s = static_cast<int>(j0 - a0);                      // uniform per diagonal
    TC win[NV * XV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const long long a = a0 + q * XV;
      VT v{};
      if constexpr (XS) {
        v = *reinterpret_cast<const VT*>(xs + a);
      } else if (a >= 0 && a < m_pad) {
        // m_pad is a multiple of XV here: a vector is wholly in or out of x
        v = __ldg(reinterpret_cast<const VT*>(x + a));
      }
      const TC* e = reinterpret_cast<const TC*>(&v);
#pragma unroll
      for (int t = 0; t < XV; ++t) win[q * XV + t] = e[t];
    }
#pragma unroll
    for (int r = 0; r < V; ++r) {
      TC v = win[r];
#pragma unroll
      for (int q = 1; q < XV; ++q) v = (s == q) ? win[r + q] : v;
      out[r] = v;
    }
  }
}

// acc[r] += data[k, i + r] * x[i + r + off_k] for the diagonal k
template <typename TD, typename TC, int V, bool ALIGNED_X, bool XS>
__device__ __forceinline__ void diag_term(const DiaParams& p, int k, long long i, long long local,
                                          const TC* xs, bool use, TC (&acc)[V]) {
  TC d[V], xv[V];
  load_data16<TD, TC, V>(static_cast<const TD*>(p.data) + static_cast<long long>(k) * p.n_pad + i, d);
  const long long j0 = XS ? local + p.woff[k] : i + p.doff[k];
  load_x<TC, V, ALIGNED_X, XS>(static_cast<const TC*>(p.x), xs, j0, p.m_pad, xv);
#pragma unroll
  for (int r = 0; r < V; ++r) acc[r] = use ? acc[r] + d[r] * xv[r] : acc[r];
}

template <typename TD, typename TC, bool ALIGNED_X, bool XS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
dia_tiled(const __grid_constant__ DiaParams p) {
  constexpr int V = 16 / sizeof(TD);    // rows per lane
  constexpr int XV = 16 / sizeof(TC);
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = p.row_warps, G = p.groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = warp % W, g = warp / W;
  // units [ulo, uhi): the first units_r blocks take one more (no division)
  const int b = blockIdx.x;
  const long long ulo = static_cast<long long>(b) * p.units_q + min(b, p.units_r);
  const long long uhi = ulo + p.units_q + (b < p.units_r);
  const int rounds = static_cast<int>((uhi - ulo + W - 1) / W);
  // shared memory: [group partial sums (G-1) x W*32 lanes x V][x windows]
  TC* red = reinterpret_cast<TC*>(smem);
  const int red_len = ((G - 1) * W * 32 * V + XV - 1) / XV * XV;
  TC* xs = red + red_len;
  const TC* x = static_cast<const TC*>(p.x);
  const bool aligned = p.flags & ALIGNED;
  const bool has_rhs = p.flags & HAS_RHS;

  for (int rd = 0; rd < rounds; ++rd) {
    const long long u = ulo + static_cast<long long>(rd) * W + w;
    const long long row0 = (ulo + static_cast<long long>(rd) * W) * 32 * V;
    const long long i = u * 32 * V + lane * V;
    // n_pad is a multiple of V: a lane's rows are all in or all out
    const bool active = u < uhi && i < p.n_pad;
    const long long local = i - row0;
    if constexpr (XS) {
      // copy each window x[row0 + lo, row0 + lo + len) to xs[base, base + len),
      // 16 bytes a thread, zero-filled outside [0, m_pad)
      for (int wi = 0; wi < p.nwin; ++wi) {
        const int nvec = p.win_len[wi] / XV;
        for (int t = threadIdx.x; t < nvec; t += blockDim.x) {
          const long long a = row0 + p.win_lo[wi] + static_cast<long long>(t) * XV;
          const bool in = a >= 0 && a < p.m_pad;
          const TC* src = in ? x + a : x;
          const unsigned dst = static_cast<unsigned>(
              __cvta_generic_to_shared(xs + p.win_base[wi] + t * XV));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                       "l"(src), "r"(in ? 16 : 0));
        }
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    // the epilogue's operands, loaded before the diagonals so that they
    // share the diagonals' round trip
    TC rv[V], dv[V], xa[V];
    if (g == 0 && active && has_rhs) {
      load_vals<TC, V>(static_cast<const TC*>(p.rhs) + i, aligned, rv);
      if (p.flags & HAS_DINV) load_vals<TC, V>(static_cast<const TC*>(p.dinv) + i, aligned, dv);
      if (p.flags & ADD_X) load_vals<TC, V>(x + p.x0 + i, aligned, xa);
    }
    TC acc[V];
#pragma unroll
    for (int r = 0; r < V; ++r) acc[r] = TC(0);
    if (active) {
      const int k1 = p.gk[g + 1];
      for (int k = p.gk[g]; k < k1; k += CHUNK) {
#pragma unroll
        for (int t = 0; t < CHUNK; ++t) {
          const bool use = k + t < k1;
          diag_term<TD, TC, V, ALIGNED_X, XS>(p, use ? k + t : k1 - 1, i, local, xs, use, acc);
        }
      }
    }
    if (G > 1) {
      const int slot = w * 32 + lane;
      if (g > 0) {
#pragma unroll
        for (int r = 0; r < V; ++r) red[((g - 1) * W * 32 + slot) * V + r] = acc[r];
      }
      __syncthreads();
      if (g == 0) {
        for (int h = 1; h < G; ++h) {
#pragma unroll
          for (int r = 0; r < V; ++r) acc[r] += red[((h - 1) * W * 32 + slot) * V + r];
        }
      }
    }
    if (g == 0 && active) {
      TC out[V];
#pragma unroll
      for (int r = 0; r < V; ++r) {
        TC z = acc[r];
        if (has_rhs) {
          z = rv[r] - z;
          if (p.flags & HAS_DINV) z = z * dv[r];
          z = z * static_cast<TC>(p.c);
          if (p.flags & ADD_X) z = z + xa[r];
        }
        out[r] = z;
      }
      using VT = typename Vec16<TC>::type;
      VT* dst = reinterpret_cast<VT*>(static_cast<TC*>(p.y) + i);
#pragma unroll
      for (int q = 0; q < V / XV; ++q) {
        VT v;
        TC* e = reinterpret_cast<TC*>(&v);
#pragma unroll
        for (int t = 0; t < XV; ++t) e[t] = out[q * XV + t];
        dst[q] = v;
      }
    }
    if (rd + 1 < rounds && (G > 1 || XS)) __syncthreads();   // shared memory reused
  }
}

// plan (int32, written by ops/dia_spmv.py:DiaPlan.packed):
// [config, groups, row_warps, grid, units, ndiag, nwin, smem_bytes,
//  gk[groups + 1], doff[ndiag], and with nwin > 0: woff[ndiag], (lo, len, base) x nwin]
enum PlanHead { P_CONFIG, P_GROUPS, P_ROW_WARPS, P_GRID, P_UNITS, P_NDIAG, P_NWIN,
                P_SMEM, P_HEAD };

template <typename TD, typename TC>
cudaError_t launch_tiled(const int32_t* plan, int flags, const void* data, const void* x,
                         int64_t n_pad, int64_t m_pad, const void* rhs, const void* dinv,
                         double c, int64_t x0, void* y, cudaStream_t stream) {
  const int G = plan[P_GROUPS], W = plan[P_ROW_WARPS], grid = plan[P_GRID];
  const int ndiag = plan[P_NDIAG], nwin = plan[P_NWIN], smem = plan[P_SMEM];
  const bool xs = plan[P_CONFIG] == CFG_SMEM;
  if (G < 1 || G > MAX_GROUPS || W < 1 || 32 * W * G > MAX_THREADS || ndiag < 1 ||
      ndiag > MAX_DIAGS || nwin < 0 || nwin > MAX_WINDOWS || grid < 1 || (xs && nwin < 1))
    return cudaErrorInvalidValue;
  DiaParams p;
  p.data = data;
  p.x = x;
  p.rhs = rhs;
  p.dinv = dinv;
  p.y = y;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.x0 = x0;
  p.units_q = plan[P_UNITS] / grid;
  p.units_r = plan[P_UNITS] % grid;
  p.c = c;
  p.flags = flags;
  p.groups = G;
  p.row_warps = W;
  p.nwin = nwin;
  const int32_t* q = plan + P_HEAD;
  for (int h = 0; h <= G; ++h) p.gk[h] = *q++;
  for (int k = 0; k < ndiag; ++k) p.doff[k] = *q++;
  if (nwin > 0)
    for (int k = 0; k < ndiag; ++k) p.woff[k] = *q++;
  for (int h = 0; h < nwin; ++h) {
    p.win_lo[h] = *q++;
    p.win_len[h] = *q++;
    p.win_base[h] = *q++;
  }
  const dim3 blocks(grid), threads(32 * W * G);
  const bool al = flags & ALIGNED;
  // an unaligned x cannot be copied 16 bytes at a time: the staged plan
  // then reads x through L1 with scalar loads (doff), like "l1"
  if (xs && al)
    dia_tiled<TD, TC, true, true><<<blocks, threads, smem, stream>>>(p);
  else if (al)
    dia_tiled<TD, TC, true, false><<<blocks, threads, smem, stream>>>(p);
  else
    dia_tiled<TD, TC, false, false><<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// dtype_code: 0 = f32 data, 1 = bf16 data (f32 compute), 2 = f64.
// rhs == NULL selects the plain SpMV; dinv == NULL drops the dinv factor.
// The row kernel: one thread per row, offsets from the int64 device array
// ``offsets``.
extern "C" int saena_dia_apply(int dtype_code, const void* data, const void* x,
                               const void* offsets, int ndiag, int64_t n_pad,
                               int64_t m_pad, const void* rhs, const void* dinv,
                               double c, int add_x, int64_t x0, void* y,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch_rows<float, float>(data, x, offsets, ndiag, n_pad, m_pad, rhs, dinv, c,
                                       add_x, x0, y, s);
    case 1:
      return launch_rows<__nv_bfloat16, float>(data, x, offsets, ndiag, n_pad, m_pad, rhs,
                                               dinv, c, add_x, x0, y, s);
    case 2:
      return launch_rows<double, double>(data, x, offsets, ndiag, n_pad, m_pad, rhs, dinv,
                                         c, add_x, x0, y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tiled kernel under ``plan`` (see PlanHead). flags: ADD_X (4) and
// ALIGNED (8: x, rhs and dinv 16-byte aligned, m_pad a multiple of 16
// bytes); HAS_RHS / HAS_DINV follow from rhs / dinv being non-NULL.
extern "C" int saena_dia_tiled(int dtype_code, const int32_t* plan, int flags,
                               const void* data, const void* x, int64_t n_pad,
                               int64_t m_pad, const void* rhs, const void* dinv,
                               double c, int64_t x0, void* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flags &= ADD_X | ALIGNED;
  if (rhs != nullptr) flags |= HAS_RHS;
  if (dinv != nullptr) flags |= HAS_DINV;
  switch (dtype_code) {
    case 0:
      return launch_tiled<float, float>(plan, flags, data, x, n_pad, m_pad, rhs, dinv, c, x0,
                                        y, s);
    case 1:
      return launch_tiled<__nv_bfloat16, float>(plan, flags, data, x, n_pad, m_pad, rhs, dinv,
                                                c, x0, y, s);
    case 2:
      return launch_tiled<double, double>(plan, flags, data, x, n_pad, m_pad, rhs, dinv, c,
                                          x0, y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// An empty kernel: the launch floor of graph-replayed launches.
extern "C" int saena_dia_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
