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
// Forward: one CTA of 256 threads per row; the row (x + res, widened to
// f32) goes to shared memory, block reductions give the mean and the
// centered variance, then y is written once.
//
// Backward, two grids, because CTAs run in no order on Hopper (the TPU
// kernel carried dgamma/dbeta across its sequential grid steps):
//  1. ln_bwd_rows: a row belongs to a group of WPR warps (the caller's
//     plan: one warp up to D = 1024), held in registers: each lane
//     loads its columns of x, res and dy as 16-byte vectors (8 bf16 or
//     4 f32, neighbouring lanes on neighbouring addresses; scalar loads
//     in the same layout where a row is not a multiple of 16 bytes).
//     The mean, the variance and c1/c2 are warp butterflies, plus for
//     WPR > 1 one exchange through shared memory in warp order behind a
//     named barrier of the group: no __syncthreads per row.  The grid is
//     persistent (as many CTAs as are resident on the card: two a SM);
//     each thread sums dy * xhat and dy for its columns over its rows in
//     its group's row of shared memory (held in registers, the sums took
//     168 registers a thread and one CTA a SM, and ran no faster), and a
//     CTA writes one partial row of an f32 workspace (2, G, D).  gamma
//     (in f32) and those sums are read and written in shared memory as
//     float4: scalar accesses at the lanes' 16- or 32-byte stride meet
//     4- to 8-way bank conflicts, which cost a third of the time;
//  2. ln_bwd_cols: a CTA per 32 columns, a lane per column (128-byte
//     rows); each warp sums a fixed slice of the G partial rows in order,
//     then the warps' sums add in warp order.
// No float atomics: the backward is bitwise the same from run to run.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

// the CTA-wide sum of v, the same value in every thread (each thread
// adds the warps' sums in the same order); red holds NW floats
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read by the previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) t += red[w];
  return t;
}

template <typename T>
__device__ __forceinline__ float load_h(const T* x, const T* res, size_t i) {
  float v = mxt::to_f32(x[i]);
  if (res != nullptr) v += mxt::to_f32(res[i]);
  return v;
}

// mean and 1/sqrt(var + eps) of the row h (already in shared memory
// columns owned by this thread)
__device__ __forceinline__ void row_stats(const float* h, float s, int D,
                                          float eps, float* red, float& mean,
                                          float& rstd) {
  mean = block_sum(s, red) / D;
  float sq = 0.f;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float d = h[c] - mean;
    sq = fmaf(d, d, sq);
  }
  rstd = 1.f / sqrtf(block_sum(sq, red) / D + eps);
}

template <typename T, typename TG>
__global__ void __launch_bounds__(THREADS)
    ln_fwd(const T* __restrict__ x, const T* __restrict__ res,
           const TG* __restrict__ gamma, const TG* __restrict__ beta,
           T* __restrict__ y, int D, float eps) {
  extern __shared__ float h[];  // the row in f32
  __shared__ float red[NW];
  const size_t base = size_t(blockIdx.x) * D;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float v = load_h(x, res, base + c);
    h[c] = v;
    s += v;
  }
  float mean, rstd;
  row_stats(h, s, D, eps, red, mean, rstd);
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float xhat = (h[c] - mean) * rstd;
    y[base + c] = mxt::from_f32<T>(xhat * mxt::to_f32(gamma[c]) +
                                   mxt::to_f32(beta[c]));
  }
}

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
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

// Rows: a row to a group of WPR warps (8 / WPR groups a CTA), held in
// registers.  Thread t of a group owns the V-element vectors t, t + 32 *
// WPR, ... of the row (V = 16 bytes of T, or 1 where a row is not a
// multiple of 16 bytes or a pointer is not aligned to 16), at most 32
// columns.  CTA i's group r takes rows (i * RG + r) + k * G * RG in
// order; each thread sums dy * xhat and dy over its rows for its columns
// in its group's row of shared memory (no other thread touches those
// columns of that row), and at the end the CTA adds its groups' sums in
// group order and writes them as row i of the workspace (2, G, D).
template <typename T, typename TG, int WPR, int V>
__global__ void __launch_bounds__(BWD_THREADS, 2)
    ln_bwd_rows(const T* __restrict__ x, const T* __restrict__ res,
                const TG* __restrict__ gamma, const T* __restrict__ dy,
                T* __restrict__ dx, float* __restrict__ ws, int rows, int D,
                float eps) {
  constexpr int RG = BWD_WARPS / WPR;  // row groups a CTA
  constexpr int TPR = 32 * WPR;        // threads a row
  constexpr int NV = LANE_COLS / V;    // vectors a thread
  using VT = mxt::Vec<T, V>;
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;  // gamma in f32, then each group's dgamma, dbeta sums
  float* sp = smem + D + size_t(threadIdx.x / TPR) * 2 * D;
  __shared__ float red[RG][4 * WPR];  // mean, variance, (c1, c2)
  const int rg = threadIdx.x / TPR, t = threadIdx.x % TPR;
  for (int c = threadIdx.x; c < D; c += BWD_THREADS)
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
  for (int c = threadIdx.x; c < D; c += BWD_THREADS) {
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

template <typename T, typename TG>
cudaError_t fwd(const void* x, const void* res, const void* gamma,
                const void* beta, void* y, int rows, int D, float eps,
                cudaStream_t s) {
  ln_fwd<T, TG><<<rows, THREADS, D * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const TG*>(gamma), static_cast<const TG*>(beta),
      static_cast<T*>(y), D, eps);
  return cudaGetLastError();
}

// gamma in f32 and a (dgamma, dbeta) row for each of the CTA's row groups
constexpr int bwd_smem(int D, int WPR) {
  return (1 + 2 * BWD_WARPS / WPR) * D * int(sizeof(float));
}

template <typename T, typename TG, int WPR, int V>
cudaError_t bwd_rows(const void* x, const void* res, const void* gamma,
                     const void* dy, void* dx, float* ws, int rows, int D,
                     int G, float eps, cudaStream_t s) {
  auto* kernel = ln_bwd_rows<T, TG, WPR, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem(D, WPR));
  if (err != cudaSuccess) return err;
  kernel<<<G, BWD_THREADS, bwd_smem(D, WPR), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const TG*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), ws, rows, D, eps);
  return cudaGetLastError();
}

// resident CTAs a SM of ln_bwd_rows<T, TG, WPR, V> at D
template <typename T, typename TG, int WPR, int V>
int bwd_resident(int D) {
  auto* kernel = ln_bwd_rows<T, TG, WPR, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem(D, WPR));
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        BWD_THREADS,
                                                        bwd_smem(D, WPR));
  return err == cudaSuccess ? n : -int(err);
}

template <typename T, typename TG, int WPR>
int resident_wpr(int D) {
  const int a = bwd_resident<T, TG, WPR, 16 / sizeof(T)>(D);
  const int b = bwd_resident<T, TG, WPR, 1>(D);
  return a < 0 ? a : b < 0 ? b : a < b ? a : b;
}

template <typename T, typename TG>
int resident(int D, int wpr) {
  switch (wpr) {
    case 1:
      return resident_wpr<T, TG, 1>(D);
    case 2:
      return resident_wpr<T, TG, 2>(D);
    case 4:
      return resident_wpr<T, TG, 4>(D);
    default:
      return resident_wpr<T, TG, 8>(D);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename TG, int WPR>
cudaError_t bwd_wpr(const void* x, const void* res, const void* gamma,
                    const void* dy, void* dx, float* ws, int rows, int D,
                    int G, float eps, cudaStream_t s) {
  const bool vec = D * sizeof(T) % 16 == 0 && aligned16(x) &&
                   aligned16(res) && aligned16(dy) && aligned16(dx);
  if (vec)
    return bwd_rows<T, TG, WPR, 16 / sizeof(T)>(x, res, gamma, dy, dx, ws,
                                                 rows, D, G, eps, s);
  return bwd_rows<T, TG, WPR, 1>(x, res, gamma, dy, dx, ws, rows, D, G, eps,
                                 s);
}

template <typename T, typename TG>
cudaError_t bwd(const void* x, const void* res, const void* gamma,
                const void* dy, void* dx, float* ws, float* dgamma,
                float* dbeta, int rows, int D, int wpr, int G, float eps,
                cudaStream_t s) {
  cudaError_t err;
  switch (wpr) {
    case 1:
      err = bwd_wpr<T, TG, 1>(x, res, gamma, dy, dx, ws, rows, D, G, eps, s);
      break;
    case 2:
      err = bwd_wpr<T, TG, 2>(x, res, gamma, dy, dx, ws, rows, D, G, eps, s);
      break;
    case 4:
      err = bwd_wpr<T, TG, 4>(x, res, gamma, dy, dx, ws, rows, D, G, eps, s);
      break;
    default:
      err = bwd_wpr<T, TG, 8>(x, res, gamma, dy, dx, ws, rows, D, G, eps, s);
  }
  if (err != cudaSuccess) return err;
  ln_bwd_cols<<<(D + 31) / 32, COL_WARPS * 32, 0, s>>>(ws, dgamma, dbeta, G,
                                                       D);
  return cudaGetLastError();
}

// whether wpr warps a row (1, 2, 4 or 8) hold a row of D columns
bool wpr_holds(int wpr, int D) {
  return (wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8) && D >= 1 &&
         D <= wpr * 32 * LANE_COLS;
}

}  // namespace


// x, res (nullable), y: (rows, D) in dtype (0 = f32, 1 = bf16); gamma,
// beta: (D,) in g_dtype.  1 <= D <= 8192.
extern "C" int fused_layer_norm_fwd(const void* x, const void* res,
                                    const void* gamma, const void* beta,
                                    void* y, int rows, int D, int dtype,
                                    int g_dtype, float eps, int device,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (rows < 1 || D < 1 || D > 8192) return cudaErrorInvalidValue;
  if (dtype == mxt::kF32 && g_dtype == mxt::kF32)
    return fwd<float, float>(x, res, gamma, beta, y, rows, D, eps, s);
  if (dtype == mxt::kF32 && g_dtype == mxt::kBF16)
    return fwd<float, __nv_bfloat16>(x, res, gamma, beta, y, rows, D, eps,
                                     s);
  if (dtype == mxt::kBF16 && g_dtype == mxt::kF32)
    return fwd<__nv_bfloat16, float>(x, res, gamma, beta, y, rows, D, eps,
                                     s);
  if (dtype == mxt::kBF16 && g_dtype == mxt::kBF16)
    return fwd<__nv_bfloat16, __nv_bfloat16>(x, res, gamma, beta, y, rows, D,
                                             eps, s);
  return cudaErrorInvalidValue;
}

// Resident CTAs a SM of the backward's row kernel at D with wpr warps a
// row (the fewer of its 16-byte and scalar instantiations), or minus a
// CUDA error: the wrapper sizes the persistent grid G from it.
extern "C" int fused_layer_norm_bwd_resident(int D, int wpr, int dtype,
                                             int g_dtype, int device) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return -int(dev_err);
  if (!wpr_holds(wpr, D)) return -int(cudaErrorInvalidValue);
  if (dtype == mxt::kF32 && g_dtype == mxt::kF32)
    return resident<float, float>(D, wpr);
  if (dtype == mxt::kF32 && g_dtype == mxt::kBF16)
    return resident<float, __nv_bfloat16>(D, wpr);
  if (dtype == mxt::kBF16 && g_dtype == mxt::kF32)
    return resident<__nv_bfloat16, float>(D, wpr);
  if (dtype == mxt::kBF16 && g_dtype == mxt::kBF16)
    return resident<__nv_bfloat16, __nv_bfloat16>(D, wpr);
  return -int(cudaErrorInvalidValue);
}

// x, res (nullable), dy, dx: (rows, D) in dtype; gamma: (D,) in g_dtype;
// ws: f32 workspace of 2 * G * D; dgamma, dbeta: (D,) f32.  1 <= G <=
// rows, 1 <= D <= 8192.  Rows go to groups of wpr warps (1, 2, 4 or 8,
// 1024 * wpr >= D), 8 / wpr groups a CTA, over a grid of G CTAs.
extern "C" int fused_layer_norm_bwd(const void* x, const void* res,
                                    const void* gamma, const void* dy,
                                    void* dx, void* ws, void* dgamma,
                                    void* dbeta, int rows, int D, int wpr,
                                    int G, int dtype, int g_dtype, float eps,
                                    int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (rows < 1 || !wpr_holds(wpr, D) || G < 1 || G > rows)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (dtype == mxt::kF32 && g_dtype == mxt::kF32)
    return bwd<float, float>(x, res, gamma, dy, dx, w, dg, db, rows, D, wpr,
                             G, eps, s);
  if (dtype == mxt::kF32 && g_dtype == mxt::kBF16)
    return bwd<float, __nv_bfloat16>(x, res, gamma, dy, dx, w, dg, db, rows,
                                     D, wpr, G, eps, s);
  if (dtype == mxt::kBF16 && g_dtype == mxt::kF32)
    return bwd<__nv_bfloat16, float>(x, res, gamma, dy, dx, w, dg, db, rows,
                                     D, wpr, G, eps, s);
  if (dtype == mxt::kBF16 && g_dtype == mxt::kBF16)
    return bwd<__nv_bfloat16, __nv_bfloat16>(x, res, gamma, dy, dx, w, dg,
                                             db, rows, D, wpr, G, eps, s);
  return cudaErrorInvalidValue;
}
