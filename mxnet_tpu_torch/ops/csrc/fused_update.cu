// Fused flat-bucket optimizer updates for Hopper (sm_90a): K1 (SGD,
// momentum, NAG) and K2 (Adam, AdamW).
//
// Replace the TPU kernels mxnet_tpu/ops/fused_update.py _sgd_kernel (:95)
// and _adam_kernel (:118), both launched through _run_pallas (pallas_call
// at :145).  Same function per element, in the reference's order:
// g * rescale (the Trainer's flat_g * rescale), the clip, then the rule.
// Adam's bias-corrected step size lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
// is computed in f32 from the runtime step t.
//
// Design: one grid-stride pass over the flat bucket, p and the state
// updated in place (the reference donates them), no padding: the TPU's
// (rows, 128) grid becomes a bounds check.  lr, wd, rescale and t pass by
// value.  The clip keeps a NaN gradient NaN, as jnp.clip and torch.clamp
// do.  nvcc contracts a*b+c into one FMA, so results agree with the plain
// PyTorch rule to an ulp or two, not bitwise.
// Bound on the H100: memory.  K2 reads p, g, m, v and writes p, m, v (28
// bytes per element) against about 20 FLOPs per element; K1 with momentum
// moves 20 bytes per element.  The loads are scalar and coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // a few waves of CTAs per SM

__device__ __forceinline__ float clip_nan(float g, float c) {
  return g < -c ? -c : (g > c ? c : g);
}

__global__ void __launch_bounds__(kThreads)
    sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
               float* __restrict__ mom_buf, size_t n, float lr, float wd,
               float rescale, float momentum, int nesterov, int has_clip,
               float clip) {
  const size_t stride = size_t(gridDim.x) * blockDim.x;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float gi = g[i] * rescale;
    if (has_clip) gi = clip_nan(gi, clip);
    const float pi = p[i];
    gi = gi + wd * pi;
    if (mom_buf == nullptr) {
      p[i] = pi - lr * gi;
    } else if (nesterov) {
      const float m = momentum * mom_buf[i] + gi;
      mom_buf[i] = m;
      p[i] = pi - lr * (gi + momentum * m);
    } else {
      const float m = momentum * mom_buf[i] - lr * gi;
      mom_buf[i] = m;
      p[i] = pi + m;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ m_buf, float* __restrict__ v_buf,
                size_t n, float lr, float wd, float rescale, int t,
                float beta1, float beta2, float one_minus_b1,
                float one_minus_b2, float eps, int decoupled, int has_clip,
                float clip) {
  const float tf = float(t);
  const float lr_t = lr * sqrtf(1.f - powf(beta2, tf)) / (1.f - powf(beta1, tf));
  const float lr_wd = lr * wd;
  const size_t stride = size_t(gridDim.x) * blockDim.x;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float gi = g[i] * rescale;
    if (has_clip) gi = clip_nan(gi, clip);
    const float pi = p[i];
    if (!decoupled) gi = gi + wd * pi;
    const float m = beta1 * m_buf[i] + one_minus_b1 * gi;
    const float v = beta2 * v_buf[i] + one_minus_b2 * (gi * gi);
    float np = pi - lr_t * m / (sqrtf(v) + eps);
    if (decoupled) np = np - lr_wd * pi;
    m_buf[i] = m;
    v_buf[i] = v;
    p[i] = np;
  }
}

unsigned blocks_for(size_t n) {
  const size_t b = (n + kThreads - 1) / kThreads;
  return unsigned(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// p, g, mom: flat f32 buffers of n elements (mom null without momentum);
// p and mom are updated in place.  Returns a cudaError_t code.
extern "C" int fused_sgd_update(void* p, const void* g, void* mom,
                                long long n, float lr, float wd,
                                float rescale, float momentum, int nesterov,
                                int has_clip, float clip, int device,
                                void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (n <= 0) return cudaErrorInvalidValue;
  sgd_kernel<<<blocks_for(size_t(n)), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(mom), size_t(n), lr, wd, rescale, momentum,
      nesterov, has_clip, clip);
  return cudaGetLastError();
}

// p, g, m, v: flat f32 buffers of n elements; p, m, v are updated in
// place.  t is the step being taken (1 for the first update).
extern "C" int fused_adam_update(void* p, const void* g, void* m, void* v,
                                 long long n, float lr, float wd,
                                 float rescale, int t, float beta1,
                                 float beta2, float one_minus_b1,
                                 float one_minus_b2, float eps, int decoupled,
                                 int has_clip, float clip, int device,
                                 void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (n <= 0) return cudaErrorInvalidValue;
  adam_kernel<<<blocks_for(size_t(n)), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), size_t(n), lr, wd,
      rescale, t, beta1, beta2, one_minus_b1, one_minus_b2, eps, decoupled,
      has_clip, clip);
  return cudaGetLastError();
}
