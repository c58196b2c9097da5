// Fused LayerNorm (+ residual) for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernels mxnet_tpu/ops/fused_layernorm.py
// _forward_kernel (:79, pallas_call at :140) and _backward_kernel (:97,
// pallas_call at :159): y = LayerNorm(x [+ res]) * gamma + beta over the
// last axis, with f32 row statistics and the two-pass variance
// mean((h - mean)^2); the backward recomputes the statistics from the
// saved inputs and gives dx, dgamma and dbeta.
//
// Design (correct and simple first):
//  - forward: one CTA per row; the row (x + res, widened to f32) is read
//    from memory once into shared memory, a block reduction gives the
//    mean, a second one the centered variance, then y is written once;
//  - backward, two grids, because CTAs run in no order on Hopper (the
//    TPU kernel accumulated dgamma/dbeta across sequential grid steps):
//    1. G CTAs; CTA i takes rows i, i + G, ...: it recomputes the
//       statistics, writes dx, and sums dy * xhat and dy per column in
//       shared memory (each column always belongs to the same thread),
//       then writes its partial sums as row i of an f32 workspace (G, D);
//    2. one thread per column sums the G partial rows in order.
//    No float atomics: the backward is bitwise the same from run to run;
//  - every thread of a CTA owns columns tid, tid + 256, ..., so rows of
//    any length D <= 8192 and any row count are taken.
// Bound on the H100: memory.  The forward moves x, res and y (3 rows of
// D elements per row) against about 10 FLOPs per element; the backward
// x, res, dy and dx (4 rows).  Each row is read from memory once; the
// statistics never leave the SM.
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

template <typename T, typename TG>
__global__ void __launch_bounds__(THREADS)
    ln_bwd_rows(const T* __restrict__ x, const T* __restrict__ res,
                const TG* __restrict__ gamma, const T* __restrict__ dy,
                T* __restrict__ dx, float* __restrict__ ws, int rows, int D,
                float eps) {
  extern __shared__ float smem[];
  float* h = smem;           // the row, then xhat
  float* g = smem + D;       // dy in f32
  float* pg = smem + 2 * D;  // this CTA's partial dgamma
  float* pb = smem + 3 * D;  // this CTA's partial dbeta
  __shared__ float red[NW];
  for (int c = threadIdx.x; c < D; c += THREADS) pg[c] = pb[c] = 0.f;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = size_t(row) * D;
    float s = 0.f;
    for (int c = threadIdx.x; c < D; c += THREADS) {
      const float v = load_h(x, res, base + c);
      h[c] = v;
      s += v;
    }
    float mean, rstd;
    row_stats(h, s, D, eps, red, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < D; c += THREADS) {
      const float xhat = (h[c] - mean) * rstd;
      const float d = mxt::to_f32(dy[base + c]);
      const float a = d * mxt::to_f32(gamma[c]);
      s1 = fmaf(a, xhat, s1);
      s2 += a;
      h[c] = xhat;
      g[c] = d;
      pg[c] = fmaf(d, xhat, pg[c]);
      pb[c] += d;
    }
    const float c1 = block_sum(s1, red) / D;
    const float c2 = block_sum(s2, red) / D;
    for (int c = threadIdx.x; c < D; c += THREADS) {
      const float a = g[c] * mxt::to_f32(gamma[c]);
      dx[base + c] = mxt::from_f32<T>((a - c2 - h[c] * c1) * rstd);
    }
  }
  float* wg = ws + size_t(blockIdx.x) * D;
  float* wb = ws + size_t(gridDim.x + blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    wg[c] = pg[c];
    wb[c] = pb[c];
  }
}

// dgamma[c] and dbeta[c]: the G partial rows of the workspace, summed in
// row order
__global__ void __launch_bounds__(THREADS)
    ln_bwd_cols(const float* __restrict__ ws, float* __restrict__ dgamma,
                float* __restrict__ dbeta, int G, int D) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= D) return;
  float sg = 0.f, sb = 0.f;
  for (int i = 0; i < G; ++i) {
    sg += ws[size_t(i) * D + c];
    sb += ws[size_t(G + i) * D + c];
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
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

template <typename T, typename TG>
cudaError_t bwd(const void* x, const void* res, const void* gamma,
                const void* dy, void* dx, float* ws, float* dgamma,
                float* dbeta, int rows, int D, int G, float eps,
                cudaStream_t s) {
  const int smem = 4 * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_rows<T, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_rows<T, TG><<<G, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const TG*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), ws, rows, D, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_cols<<<(D + THREADS - 1) / THREADS, THREADS, 0, s>>>(ws, dgamma,
                                                              dbeta, G, D);
  return cudaGetLastError();
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

// x, res (nullable), dy, dx: (rows, D) in dtype; gamma: (D,) in g_dtype;
// ws: f32 workspace of 2 * G * D; dgamma, dbeta: (D,) f32.  1 <= G <=
// rows, 1 <= D <= 8192.
extern "C" int fused_layer_norm_bwd(const void* x, const void* res,
                                    const void* gamma, const void* dy,
                                    void* dx, void* ws, void* dgamma,
                                    void* dbeta, int rows, int D, int G,
                                    int dtype, int g_dtype, float eps,
                                    int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (rows < 1 || D < 1 || D > 8192 || G < 1 || G > rows)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (dtype == mxt::kF32 && g_dtype == mxt::kF32)
    return bwd<float, float>(x, res, gamma, dy, dx, w, dg, db, rows, D, G,
                             eps, s);
  if (dtype == mxt::kF32 && g_dtype == mxt::kBF16)
    return bwd<float, __nv_bfloat16>(x, res, gamma, dy, dx, w, dg, db, rows,
                                     D, G, eps, s);
  if (dtype == mxt::kBF16 && g_dtype == mxt::kF32)
    return bwd<__nv_bfloat16, float>(x, res, gamma, dy, dx, w, dg, db, rows,
                                     D, G, eps, s);
  if (dtype == mxt::kBF16 && g_dtype == mxt::kBF16)
    return bwd<__nv_bfloat16, __nv_bfloat16>(x, res, gamma, dy, dx, w, dg,
                                             db, rows, D, G, eps, s);
  return cudaErrorInvalidValue;
}
