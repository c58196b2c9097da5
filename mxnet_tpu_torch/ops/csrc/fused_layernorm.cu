// Fused LayerNorm (+ residual) for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernels mxnet_tpu/ops/fused_layernorm.py
// _forward_kernel (:79, pallas_call at :140) and _backward_kernel (:97,
// pallas_call at :159): y = LayerNorm(x [+ res]) * gamma + beta over the
// last axis, with f32 row statistics and the two-pass variance
// mean((h - mean)^2); the backward recomputes the statistics from the
// saved inputs and gives dx, dgamma and dbeta.
//
// Bound on the H100: memory.  The forward moves x, res and y (3 rows of
// D elements per row) against about 10 FLOPs per element; the backward
// x, res, dy and dx (4 rows).  Each row is read from memory once; the
// statistics never leave the SM.
//
// Both directions give a row to a group of WPR warps (the caller's plan,
// ops.fused_layernorm.fwd_plan / bwd_plan: one warp up to D = 1024, all 8
// warps of the CTA at D = 8192), held in registers: each lane loads its
// columns of x and res (and dy) as 16-byte vectors (8 bf16 or 4 f32,
// neighbouring lanes on neighbouring addresses; scalar loads in the same
// layout where a row is not a multiple of 16 bytes or a pointer is not
// aligned to 16: the caller's `vector`).  The mean and the centred sum of
// squares are warp butterflies, plus for WPR > 1 one exchange through
// shared memory in warp order behind a named barrier of the group: no
// __syncthreads per row and no copy of the row in shared memory.
//
// Forward (ln_fwd_rows).  A CTA of 256 threads a row, with 2-byte loads,
// the row copied through shared memory, two CTA-wide reductions behind
// four __syncthreads and gamma and beta read from L2 for every row, runs
// at about a third of the bound.  Instead:
//  - a row to a warp in registers, as above; bf16 stays packed two to a
//    register from the 16-byte load to the F2FP that packs y (Raw, widen,
//    pack), and columns past D load as zeros, so the widening is branch
//    free: 80 registers a thread at D <= 1024 in bf16 (bounded to 3 CTAs
//    a SM without a spill), 128 in f32;
//  - each CTA widens gamma and beta to f32 in shared memory once (8 KB at
//    D = 1024), its lanes read them as float4 (lds), and a group's first
//    row is in flight before the CTA fetches them;
//  - a plain grid, a CTA per 8 / WPR rows.  tools/layernorm_sweep.cu
//    builds this kernel's other layouts from the same pieces, and
//    tools/port_layernorm_pairs.py --variants times them on the H100
//    (PERF.md): a persistent grid of fixed strides, a persistent grid
//    whose groups draw rows in order from a counter, gamma and beta in
//    registers (about 170 registers, one CTA a SM), the next row's loads
//    before the current row's reductions, other register bounds.  None
//    ran faster.
//
// Backward, two grids, because CTAs run in no order on Hopper (the TPU
// kernel carried dgamma/dbeta across its sequential grid steps):
//  1. ln_bwd_rows: the row layout above; mean, variance and c1/c2 from
//     the registers.  The grid is persistent (as many CTAs as are
//     resident on the card: two a SM); each thread sums dy * xhat and dy
//     for its columns over its rows in its group's row of shared memory
//     (held in registers, the sums took 168 registers a thread and one
//     CTA a SM, and ran no faster), and a CTA writes one partial row of
//     an f32 workspace (2, G, D).  gamma (in f32) and those sums are read
//     and written in shared memory as float4: scalar accesses at the
//     lanes' 16- or 32-byte stride meet 4- to 8-way bank conflicts,
//     which cost a third of the time;
//  2. ln_bwd_cols: a CTA per 32 columns, a lane per column (128-byte
//     rows); each warp sums a fixed slice of the G partial rows in order,
//     then the warps' sums add in warp order.
// No float atomics: both directions are bitwise the same from run to run
// (a row's sums run in one order whichever group takes it).

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int ROW_THREADS = 256;  // both row kernels: 8 warps a CTA
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int LANE_COLS = 32;  // columns a lane holds: a warp takes D <= 1024

// the WPR warps of row group rg meet (named barrier rg + 1; 0 is
// __syncthreads); one warp needs none
template <int WPR>
__device__ __forceinline__ void group_sync(int rg) {
  if constexpr (WPR > 1)
    asm volatile("bar.sync %0, %1;" ::"r"(rg + 1), "r"(WPR * 32) : "memory");
}

// the row group's sums of a[0..N): a butterfly in each warp (every lane
// gets the same bits), then, for WPR > 1, the warps' sums in warp order
// through red (N * WPR floats of this row group's)
template <int WPR, int N>
__device__ __forceinline__ void group_sum(float (&a)[N], float* red, int rg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
  if constexpr (WPR > 1) {
    const int w = (threadIdx.x / 32) % WPR;
    if (threadIdx.x % 32 == 0)
#pragma unroll
      for (int i = 0; i < N; ++i) red[i * WPR + w] = a[i];
    group_sync<WPR>(rg);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = 0.f;
#pragma unroll
      for (int v = 0; v < WPR; ++v) t += red[i * WPR + v];
      a[i] = t;
    }
  }
}

// V floats of shared memory as float4 accesses where V % 4 == 0 (p then
// 16-byte aligned): a warp's V-column slices sit 16 or 32 bytes apart,
// where scalar accesses would meet 4- or 8-way bank conflicts
template <int V>
__device__ __forceinline__ void lds(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void sts(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------

// What a thread loads of a row at once: V elements of T, as one 16-byte
// word (uint4) where V fills 16 bytes, else one T.  Packed bf16 stays two
// to a register; widen() and pack() convert with shifts and one F2FP a
// pair, where an array of __nv_bfloat16 would take a register each.
template <typename T, int V>
using Raw = std::conditional_t<V * sizeof(T) == 16, uint4, T>;

template <typename T, int V>
__device__ __forceinline__ void widen(const Raw<T, V>& r, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = mxt::to_f32(r);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        f[i] = __uint_as_float(w[i]);
      } else {  // bf16: element 2i in the low half of word i
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> pack(const float (&f)[V]) {
  if constexpr (V == 1) {
    return mxt::from_f32<T>(f[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        w[i] = __float_as_uint(f[i]);
      } else {
        const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&b);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the row's columns of x and res that thread t of its group owns: its
// loads sit k * TPR loads apart, at immediate offsets from one address;
// columns past D, and res where there is none, read as zeros
template <typename T, int V, int NV, int TPR>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ res,
                                         size_t base, int t, int D,
                                         Raw<T, V> (&xv)[NV],
                                         Raw<T, V> (&rv)[NV]) {
  using RT = Raw<T, V>;
  const RT* px = reinterpret_cast<const RT*>(x + base) + t;
  const RT* pr =
      res == nullptr ? nullptr : reinterpret_cast<const RT*>(res + base) + t;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const bool in = (t + k * TPR) * V < D;
    xv[k] = in ? px[k * TPR] : RT{};
    rv[k] = in && pr != nullptr ? pr[k * TPR] : RT{};
  }
}

// gamma and beta widened to f32 in shared memory (sp[0, D) and sp[D,
// 2D)), four columns of each a thread in flight together
template <typename TG>
__device__ __forceinline__ void stage_params(const TG* __restrict__ gamma,
                                             const TG* __restrict__ beta,
                                             float* sp, int D) {
  constexpr int U = 4;
  for (int c0 = threadIdx.x; c0 < D; c0 += U * ROW_THREADS) {
    float g[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * ROW_THREADS;
      g[u] = c < D ? mxt::to_f32(gamma[c]) : 0.f;
      b[u] = c < D ? mxt::to_f32(beta[c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * ROW_THREADS;
      if (c < D) {
        sp[c] = g[u];
        sp[D + c] = b[u];
      }
    }
  }
}

// h = x + res in f32 from thread t's loads of a row
template <typename T, int V, int NV>
__device__ __forceinline__ void widen_row(const Raw<T, V> (&xv)[NV],
                                          const Raw<T, V> (&rv)[NV],
                                          float (&h)[NV * V]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float a[V], b[V];
    widen<T, V>(xv[j], a);
    widen<T, V>(rv[j], b);
#pragma unroll
    for (int e = 0; e < V; ++e) h[j * V + e] = a[e] + b[e];
  }
}

// y's row (yrow) from h: the mean, then the centred sum of squares (four
// partial sums a lane, the group's through group_sum; red holds 2 * WPR
// floats of the group's), then (h - mean) * rstd * gamma + beta, stored
// in the layout of the loads; params(j, c, gm, bt) gives gamma and beta
// at the thread's vector j, column c
template <typename T, int WPR, int V, int NV, typename P>
__device__ __forceinline__ void finish_row(const float (&h)[NV * V],
                                           T* __restrict__ yrow, float* red,
                                           int rg, int t, int D, float eps,
                                           P params) {
  constexpr int TPR = 32 * WPR;
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NV * V; ++i) p[i % 4] += h[i];
  float sum[1] = {(p[0] + p[1]) + (p[2] + p[3])};
  group_sum<WPR>(sum, red, rg);
  const float mean = sum[0] / D;
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const bool in = (t + j * TPR) * V < D;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = in ? h[j * V + e] - mean : 0.f;
      p[(j * V + e) % 4] = fmaf(d, d, p[(j * V + e) % 4]);
    }
  }
  float sq[1] = {(p[0] + p[1]) + (p[2] + p[3])};
  group_sum<WPR>(sq, red + WPR, rg);
  const float rstd = 1.f / sqrtf(sq[0] / D + eps);
  Raw<T, V>* py = reinterpret_cast<Raw<T, V>*>(yrow) + t;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (t + j * TPR) * V;
    if (c < D) {
      float gm[V], bt[V], o[V];
      params(j, c, gm, bt);
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = (h[j * V + e] - mean) * rstd * gm[e] + bt[e];
      py[j * TPR] = pack<T, V>(o);
    }
  }
}

// Rows: a row to a group of WPR warps (8 / WPR groups a CTA), held in
// registers.  Thread t of a group owns the V-element vectors t, t + 32 *
// WPR, ... of the row (V = 16 bytes of T, or 1 where a row is not a
// multiple of 16 bytes or a pointer is not aligned to 16), at most 32
// columns.  CTA i's group r takes rows i * RG + r + k * G * RG (one row
// over the plain grid of fwd_plan); its first row is in flight before the
// CTA fetches gamma and beta.  ptxas leaves room for 3 CTAs a SM where a
// warp holds a bf16 row in 16-byte loads (80 registers, no spill; at 4 it
// spills); elsewhere it is not bounded (an f32 row takes 64 registers in
// flight and spills at 3 CTAs, a group of several warps a few bytes).
template <typename T, typename TG, int WPR, int V>
__global__ void __launch_bounds__(ROW_THREADS,
                                  sizeof(T) == 2 && WPR == 1 && V > 1 ? 3
                                                                      : 1)
    ln_fwd_rows(const T* __restrict__ x, const T* __restrict__ res,
                const TG* __restrict__ gamma, const TG* __restrict__ beta,
                T* __restrict__ y, int rows, int D, float eps) {
  constexpr int RG = ROW_WARPS / WPR;  // row groups a CTA
  constexpr int TPR = 32 * WPR;        // threads a row
  constexpr int NV = LANE_COLS / V;    // vectors a thread
  extern __shared__ __align__(16) float smem[];  // gamma, beta in f32
  __shared__ float red[RG][2 * WPR];             // mean, sum of squares
  const int rg = threadIdx.x / TPR, t = threadIdx.x % TPR;
  int row = blockIdx.x * RG + rg;
  Raw<T, V> xv[NV], rv[NV];
  if (row < rows)
    load_row<T, V, NV, TPR>(x, res, size_t(row) * D, t, D, xv, rv);
  stage_params(gamma, beta, smem, D);
  __syncthreads();
  const auto params = [&](int, int c, float(&gm)[V], float(&bt)[V]) {
    lds(smem + c, gm);
    lds(smem + D + c, bt);
  };
  while (row < rows) {
    float h[LANE_COLS];
    widen_row<T, V, NV>(xv, rv, h);
    finish_row<T, WPR, V, NV>(h, y + size_t(row) * D, red[rg], rg, t, D,
                              eps, params);
    row += gridDim.x * RG;
    if (row < rows)
      load_row<T, V, NV, TPR>(x, res, size_t(row) * D, t, D, xv, rv);
  }
}

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------

// Rows: the forward's row layout, over a persistent grid of fixed
// strides: CTA i's group r takes rows (i * RG + r) + k * G * RG in
// order; each thread sums dy * xhat and dy over its rows for its columns
// in its group's row of shared memory (no other thread touches those
// columns of that row), and at the end the CTA adds its groups' sums in
// group order and writes them as row i of the workspace (2, G, D).
template <typename T, typename TG, int WPR, int V>
__global__ void __launch_bounds__(ROW_THREADS, 2)
    ln_bwd_rows(const T* __restrict__ x, const T* __restrict__ res,
                const TG* __restrict__ gamma, const T* __restrict__ dy,
                T* __restrict__ dx, float* __restrict__ ws, int rows, int D,
                float eps) {
  constexpr int RG = ROW_WARPS / WPR;  // row groups a CTA
  constexpr int TPR = 32 * WPR;        // threads a row
  constexpr int NV = LANE_COLS / V;    // vectors a thread
  using VT = mxt::Vec<T, V>;
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;  // gamma in f32, then each group's dgamma, dbeta sums
  float* sp = smem + D + size_t(threadIdx.x / TPR) * 2 * D;
  __shared__ float red[RG][4 * WPR];  // mean, variance, (c1, c2)
  const int rg = threadIdx.x / TPR, t = threadIdx.x % TPR;
  for (int c = threadIdx.x; c < D; c += ROW_THREADS)
    sg[c] = mxt::to_f32(gamma[c]);
  __syncthreads();

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (t + k * TPR) * V;
    if (c < D)
#pragma unroll
      {
        const float zero[V] = {};
        sts(sp + c, zero);
        sts(sp + D + c, zero);
      }
  }

  for (int row = blockIdx.x * RG + rg; row < rows; row += gridDim.x * RG) {
    const size_t base = size_t(row) * D;
    float h[LANE_COLS];
    VT g[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (t + k * TPR) * V;
      if (c < D) {
        const VT xv = *reinterpret_cast<const VT*>(x + base + c);
        g[k] = *reinterpret_cast<const VT*>(dy + base + c);
        VT rv;
        if (res != nullptr) rv = *reinterpret_cast<const VT*>(res + base + c);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float v = mxt::to_f32(xv.x[e]);
          if (res != nullptr) v += mxt::to_f32(rv.x[e]);
          h[k * V + e] = v;
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          h[k * V + e] = 0.f;
          g[k].x[e] = mxt::from_f32<T>(0.f);
        }
      }
    }
    float sum[1] = {0.f};
#pragma unroll
    for (int i = 0; i < LANE_COLS; ++i) sum[0] += h[i];
    group_sum<WPR>(sum, red[rg], rg);
    const float mean = sum[0] / D;
    float sq[1] = {0.f};
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if ((t + k * TPR) * V < D)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = h[k * V + e] - mean;
          sq[0] = fmaf(d, d, sq[0]);
        }
    group_sum<WPR>(sq, red[rg] + WPR, rg);
    const float rstd = 1.f / sqrtf(sq[0] / D + eps);
    float cs[2] = {0.f, 0.f};  // sum of a * xhat, sum of a (a = dy * gamma)
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (t + k * TPR) * V;
      if (c < D) {
        float gm[V], pg[V], pb[V];
        lds(sg + c, gm);
        lds(sp + c, pg);
        lds(sp + D + c, pb);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int i = k * V + e;
          const float xhat = (h[i] - mean) * rstd;
          const float d = mxt::to_f32(g[k].x[e]);
          const float a = d * gm[e];
          cs[0] = fmaf(a, xhat, cs[0]);
          cs[1] += a;
          h[i] = xhat;
          pg[e] = fmaf(d, xhat, pg[e]);
          pb[e] += d;
        }
        sts(sp + c, pg);
        sts(sp + D + c, pb);
      }
    }
    group_sum<WPR>(cs, red[rg] + 2 * WPR, rg);
    const float c1 = cs[0] / D, c2 = cs[1] / D;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (t + k * TPR) * V;
      if (c < D) {
        VT o;
        float gm[V];
        lds(sg + c, gm);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float a = mxt::to_f32(g[k].x[e]) * gm[e];
          o.x[e] = mxt::from_f32<T>((a - c2 - h[k * V + e] * c1) * rstd);
        }
        *reinterpret_cast<VT*>(dx + base + c) = o;
      }
    }
  }

  // the groups' partial sums, added in group order
  __syncthreads();
  const float* s0 = smem + D;
  float* wg = ws + size_t(blockIdx.x) * D;
  float* wb = ws + size_t(gridDim.x + blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += ROW_THREADS) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      a += s0[size_t(r) * 2 * D + c];
      b += s0[size_t(r) * 2 * D + D + c];
    }
    wg[c] = a;
    wb[c] = b;
  }
}

constexpr int COL_WARPS = 8;

// Columns: dgamma[c] and dbeta[c] from the G partial rows.  A CTA takes
// 32 columns (a lane each, 128-byte rows); warp w sums its fixed slice of
// the partial rows in order, then warp 0 adds the warps' sums in warp
// order.
__global__ void __launch_bounds__(COL_WARPS * 32)
    ln_bwd_cols(const float* __restrict__ ws, float* __restrict__ dgamma,
                float* __restrict__ dbeta, int G, int D) {
  __shared__ float part[2][COL_WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const int per = (G + COL_WARPS - 1) / COL_WARPS;
  const int i1 = min(G, (warp + 1) * per);
  float sg = 0.f, sb = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int i = warp * per; i < i1; ++i) {
      sg += ws[size_t(i) * D + c];
      sb += ws[size_t(G + i) * D + c];
    }
  }
  part[0][warp][lane] = sg;
  part[1][warp][lane] = sb;
  __syncthreads();
  if (warp == 0 && c < D) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < COL_WARPS; ++w) {
      a += part[0][w][lane];
      b += part[1][w][lane];
    }
    dgamma[c] = a;
    dbeta[c] = b;
  }
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------

// the forward's gamma and beta in f32
int fwd_smem(int D) { return 2 * D * int(sizeof(float)); }

// gamma in f32 and a (dgamma, dbeta) row for each of the CTA's row groups
int bwd_smem(int D, int WPR) {
  return (1 + 2 * ROW_WARPS / WPR) * D * int(sizeof(float));
}

// sets the kernel's dynamic shared memory limit to `smem` bytes where it
// is above the 48 KB a launch may take without it
cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// resident CTAs a SM of `kernel` with `smem` bytes of dynamic shared
// memory, or minus a CUDA error
int occupancy(const void* kernel, int smem) {
  cudaError_t err = allow_smem(kernel, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        ROW_THREADS, smem);
  return err == cudaSuccess ? n : -int(err);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// whether a row of D elements of T is 16-byte vectors at every pointer
template <typename T>
bool vectors(int D, std::initializer_list<const void*> ptrs) {
  if (D * sizeof(T) % 16 != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

template <typename T, typename TG, int WPR, int V>
int fwd_rows(const void* x, const void* res, const void* gamma,
             const void* beta, void* y, int rows, int D, int G, float eps,
             cudaStream_t s) {
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ln_fwd_rows<T, TG, WPR, V>),
      fwd_smem(D));
  if (err != cudaSuccess) return err;
  ln_fwd_rows<T, TG, WPR, V><<<G, ROW_THREADS, fwd_smem(D), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const TG*>(gamma), static_cast<const TG*>(beta),
      static_cast<T*>(y), rows, D, eps);
  return cudaGetLastError();
}

template <typename T, typename TG, int WPR, int V>
int bwd_rows(const void* x, const void* res, const void* gamma, const void* dy,
             void* dx, float* ws, float* dgamma, float* dbeta, int rows, int D,
             int G, float eps, cudaStream_t s) {
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ln_bwd_rows<T, TG, WPR, V>),
      bwd_smem(D, WPR));
  if (err != cudaSuccess) return err;
  ln_bwd_rows<T, TG, WPR, V><<<G, ROW_THREADS, bwd_smem(D, WPR), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const TG*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), ws, rows, D, eps);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return launched;
  ln_bwd_cols<<<(D + 31) / 32, COL_WARPS * 32, 0, s>>>(ws, dgamma, dbeta, G,
                                                       D);
  return cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// f(Type<T>, Type<TG>, Int<WPR>, Int<V>) for the dtype codes, the warps a
// row (1, 2, 4 or 8; callers check them first) and the 16-byte (vector)
// or scalar loads
template <typename F>
int dispatch(int dtype, int g_dtype, int wpr, bool vector, F&& f) {
  auto by_v = [&](auto t, auto tg, auto w) {
    using T = typename decltype(t)::type;
    return vector ? f(t, tg, w, Int<16 / sizeof(T)>{}) : f(t, tg, w, Int<1>{});
  };
  auto by_wpr = [&](auto t, auto tg) {
    switch (wpr) {
      case 1:
        return by_v(t, tg, Int<1>{});
      case 2:
        return by_v(t, tg, Int<2>{});
      case 4:
        return by_v(t, tg, Int<4>{});
      default:
        return by_v(t, tg, Int<8>{});
    }
  };
  auto by_g = [&](auto t) {
    return g_dtype == mxt::kF32 ? by_wpr(t, Type<float>{})
                                : by_wpr(t, Type<__nv_bfloat16>{});
  };
  return dtype == mxt::kF32 ? by_g(Type<float>{}) : by_g(Type<__nv_bfloat16>{});
}

// whether the plan and the dtype codes are ones the kernels take: wpr
// warps a row (1, 2, 4 or 8) hold a row of D columns
bool takes(int wpr, int D, int dtype, int g_dtype) {
  auto known = [](int d) { return d == mxt::kF32 || d == mxt::kBF16; };
  return (wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8) && D >= 1 &&
         D <= wpr * 32 * LANE_COLS && known(dtype) && known(g_dtype);
}

}  // namespace

// Resident CTAs a SM of a direction's row kernel (backward 0: the
// forward's) at D with wpr warps a row, in its 16-byte (vector 1) or
// scalar instantiation, or minus a CUDA error: the backward's wrapper
// sizes its persistent grid G from it (ops.fused_layernorm.bwd_plan).
extern "C" int fused_layer_norm_resident(int backward, int vector, int D,
                                         int wpr, int dtype, int g_dtype,
                                         int device) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return -int(dev_err);
  if (!takes(wpr, D, dtype, g_dtype)) return -int(cudaErrorInvalidValue);
  return dispatch(dtype, g_dtype, wpr, vector,
                  [&](auto t, auto tg, auto w, auto v) {
                    using T = typename decltype(t)::type;
                    using TG = typename decltype(tg)::type;
                    constexpr int W = decltype(w)::value;
                    constexpr int V = decltype(v)::value;
                    return backward
                               ? occupancy(reinterpret_cast<const void*>(
                                               ln_bwd_rows<T, TG, W, V>),
                                           bwd_smem(D, W))
                               : occupancy(reinterpret_cast<const void*>(
                                               ln_fwd_rows<T, TG, W, V>),
                                           fwd_smem(D));
                  });
}

// x, res (nullable), y: (rows, D) in dtype (0 = f32, 1 = bf16); gamma,
// beta: (D,) in g_dtype.  Rows go to groups of wpr warps (1, 2, 4 or 8,
// 1024 * wpr >= D), 8 / wpr groups a CTA, over a grid of G CTAs, with
// 16-byte loads and stores where vector is 1 (refused unless D * the
// element size is a multiple of 16 and x, res and y are aligned to 16):
// ops.fused_layernorm.fwd_plan.
extern "C" int fused_layer_norm_fwd(const void* x, const void* res,
                                    const void* gamma, const void* beta,
                                    void* y, int rows, int D, int wpr, int G,
                                    int vector, int dtype, int g_dtype,
                                    float eps, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (rows < 1 || !takes(wpr, D, dtype, g_dtype) || G < 1 ||
      G > (rows + ROW_WARPS / wpr - 1) / (ROW_WARPS / wpr))
    return cudaErrorInvalidValue;
  return dispatch(dtype, g_dtype, wpr, vector,
                  [&](auto t, auto tg, auto w, auto v) {
                    using T = typename decltype(t)::type;
                    using TG = typename decltype(tg)::type;
                    constexpr int V = decltype(v)::value;
                    if (V > 1 && !vectors<T>(D, {x, res, y}))
                      return int(cudaErrorInvalidValue);
                    return fwd_rows<T, TG, decltype(w)::value, V>(
                        x, res, gamma, beta, y, rows, D, G, eps, s);
                  });
}

// x, res (nullable), dy, dx: (rows, D) in dtype; gamma: (D,) in g_dtype;
// ws: f32 workspace of 2 * G * D; dgamma, dbeta: (D,) f32.  1 <= G <=
// rows, 1 <= D <= 8192.  Rows go to groups of wpr warps as in the
// forward, over a grid of G CTAs; vector as in the forward, for x, res,
// dy and dx.
extern "C" int fused_layer_norm_bwd(const void* x, const void* res,
                                    const void* gamma, const void* dy,
                                    void* dx, void* ws, void* dgamma,
                                    void* dbeta, int rows, int D, int wpr,
                                    int G, int vector, int dtype, int g_dtype,
                                    float eps, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (rows < 1 || !takes(wpr, D, dtype, g_dtype) || G < 1 || G > rows)
    return cudaErrorInvalidValue;
  return dispatch(dtype, g_dtype, wpr, vector,
                  [&](auto t, auto tg, auto w, auto v) {
                    using T = typename decltype(t)::type;
                    using TG = typename decltype(tg)::type;
                    constexpr int V = decltype(v)::value;
                    if (V > 1 && !vectors<T>(D, {x, res, dy, dx}))
                      return int(cudaErrorInvalidValue);
                    return bwd_rows<T, TG, decltype(w)::value, V>(
                        x, res, gamma, dy, dx, static_cast<float*>(ws),
                        static_cast<float*>(dgamma),
                        static_cast<float*>(dbeta), rows, D, G, eps, s);
                  });
}
