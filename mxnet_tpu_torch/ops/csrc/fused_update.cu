// Fused flat-bucket optimizer updates for Hopper (sm_90a): K1 (SGD,
// momentum, NAG) and K2 (Adam, AdamW).
//
// Replace the TPU kernels mxnet_tpu/ops/fused_update.py _sgd_kernel (:95)
// and _adam_kernel (:118), both launched through _run_pallas (pallas_call
// at :145).  Same function per element, in the reference's order:
// g * rescale (the Trainer's flat_g * rescale), the clip, then the rule.
// Adam's bias-corrected step size lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
// is computed in f32 from the step t; the kernel reads t and lr from
// device memory when it runs, so a captured CUDA graph replays with the
// caller's current values.  The clip keeps a NaN
// gradient NaN, as jnp.clip and torch.clamp do.  nvcc contracts a*b+c
// into one FMA, so results agree with the plain PyTorch rule to an ulp or
// two, not bitwise.
//
// Bound on the H100: memory.  K2 reads p, g, m, v and writes p, m, v (28
// bytes per element) against about 20 FLOPs per element; K1 with momentum
// moves 20 bytes per element.  Every byte is touched once and the bucket
// is far larger than the 50 MB L2.  Design, for the HBM rate:
//  - one streaming body for every rule, templated on the rule and on the
//    clip: the loop holds no per-element branch;
//  - 16-byte vectors: each thread loads kUnroll float4s of every stream,
//    all of them before any arithmetic, so 4 * kUnroll * 16 bytes (K2) are
//    in flight per thread; loads and stores carry the streaming
//    (evict-first) hint, since nothing is read twice;
//  - a persistent grid (the resident CTAs on every SM,
//    fused_update_resident) whose CTAs draw chunks of kThreads * kUnroll
//    float4s in order from a counter.  A fixed assignment (a grid-stride
//    walk, or a contiguous range a CTA) lets the CTAs drift apart, and the
//    addresses in flight spread over the bucket: both ran 3-4% slower on
//    the H100 (tools/port_update_pairs.py --variants);
//  - head, body and tail in one launch: the caller's plan
//    (ops.fused_update.update_plan) peels `head` < 4 scalar elements up
//    to 16-byte alignment when every stream has the same offset, then
//    `nvec` vectors and a scalar `tail`; when the offsets differ the plan
//    is all scalar (nvec = 0) and the same kernel's scalar loop runs.
// p and the state are updated in place (the reference donates them).
#include <cstdint>

#include "common.cuh"

namespace {

// rule codes passed by the Python wrappers
enum Rule { kSgd = 0, kMomentum = 1, kNag = 2, kAdam = 3, kAdamW = 4 };

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4s of each stream a thread takes a chunk

struct Hyper {
  float lr, wd, rescale, clip;
  float momentum;                                       // K1
  float beta1, beta2, one_minus_b1, one_minus_b2, eps;  // K2
  int t;
};

// state buffers a rule keeps: mom (K1), m and v (K2)
__host__ __device__ constexpr int state_count(int rule) {
  return rule == kSgd ? 0 : rule <= kNag ? 1 : 2;
}

__device__ __forceinline__ float clip_nan(float g, float c) {
  return g < -c ? -c : (g > c ? c : g);
}

// one element, in the reference's order; s0/s1 are the rule's state
template <int R, bool kClip>
__device__ __forceinline__ void update(float& p, float g, float& s0,
                                       float& s1, const Hyper& h, float lr_t,
                                       float lr_wd) {
  float gi = g * h.rescale;
  if constexpr (kClip) gi = clip_nan(gi, h.clip);
  const float pi = p;
  if constexpr (R <= kNag) {
    gi = gi + h.wd * pi;
    if constexpr (R == kSgd) {
      p = pi - h.lr * gi;
    } else if constexpr (R == kNag) {
      const float m = h.momentum * s0 + gi;
      s0 = m;
      p = pi - h.lr * (gi + h.momentum * m);
    } else {
      const float m = h.momentum * s0 - h.lr * gi;
      s0 = m;
      p = pi + m;
    }
  } else {
    if constexpr (R == kAdam) gi = gi + h.wd * pi;
    const float m = h.beta1 * s0 + h.one_minus_b1 * gi;
    const float v = h.beta2 * s1 + h.one_minus_b2 * (gi * gi);
    float np = pi - lr_t * m / (sqrtf(v) + h.eps);
    if constexpr (R == kAdamW) np = np - lr_wd * pi;
    s0 = m;
    s1 = v;
    p = np;
  }
}

template <int R, bool kClip>
__device__ __forceinline__ void update4(float4& p, const float4& g,
                                        float4& s0, float4& s1,
                                        const Hyper& h, float lr_t,
                                        float lr_wd) {
  update<R, kClip>(p.x, g.x, s0.x, s1.x, h, lr_t, lr_wd);
  update<R, kClip>(p.y, g.y, s0.y, s1.y, h, lr_t, lr_wd);
  update<R, kClip>(p.z, g.z, s0.z, s1.z, h, lr_t, lr_wd);
  update<R, kClip>(p.w, g.w, s0.w, s1.w, h, lr_t, lr_wd);
}

// Adam's bias-corrected step size and lr * wd, in f32 from the step t
template <int R>
__device__ __forceinline__ void adam_scalars(const Hyper& h, float& lr_t,
                                             float& lr_wd) {
  lr_t = lr_wd = 0.f;
  if constexpr (R >= kAdam) {
    const float tf = float(h.t);
    lr_t = h.lr * sqrtf(1.f - powf(h.beta2, tf)) / (1.f - powf(h.beta1, tf));
    lr_wd = h.lr * h.wd;
  }
}

// elements [lo, hi) one at a time, thread `tid` of `nthreads` walking
// grid-stride: the plan's head and tail, or the whole bucket when its
// streams cannot be read as vectors
template <int R, bool kClip>
__device__ __forceinline__ void scalar_range(
    float* __restrict__ p, const float* __restrict__ g, float* __restrict__ s0,
    float* __restrict__ s1, long long lo, long long hi, long long tid,
    long long nthreads, const Hyper& h, float lr_t, float lr_wd) {
  constexpr int S = state_count(R);
  for (long long i = lo + tid; i < hi; i += nthreads) {
    float pi = __ldcs(p + i), a = 0.f, b = 0.f;
    if constexpr (S >= 1) a = __ldcs(s0 + i);
    if constexpr (S >= 2) b = __ldcs(s1 + i);
    update<R, kClip>(pi, __ldcs(g + i), a, b, h, lr_t, lr_wd);
    __stcs(p + i, pi);
    if constexpr (S >= 1) __stcs(s0 + i, a);
    if constexpr (S >= 2) __stcs(s1 + i, b);
  }
}

// the plan's head and tail, by every thread of the grid
template <int R, bool kClip>
__device__ __forceinline__ void head_and_tail(
    float* __restrict__ p, const float* __restrict__ g, float* __restrict__ s0,
    float* __restrict__ s1, long long head, long long nvec, long long tail,
    const Hyper& h, float lr_t, float lr_wd) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long body_end = head + 4 * nvec;
  scalar_range<R, kClip>(p, g, s0, s1, 0, head, tid, nthreads, h, lr_t,
                         lr_wd);
  scalar_range<R, kClip>(p, g, s0, s1, body_end, body_end + tail, tid,
                         nthreads, h, lr_t, lr_wd);
}

// the body's float4s of p, g and the state, from element `head` on (each
// 16-byte aligned: the plan's promise, checked by the C entry)
struct Vectors {
  float4* p;
  const float4* g;
  float4* a;
  float4* b;
  long long n;
};

template <int R>
__device__ __forceinline__ Vectors body_vectors(float* p, const float* g,
                                                float* s0, float* s1,
                                                long long head,
                                                long long nvec) {
  constexpr int S = state_count(R);
  return {reinterpret_cast<float4*>(p + head),
          reinterpret_cast<const float4*>(g + head),
          reinterpret_cast<float4*>(S >= 1 ? s0 + head : nullptr),
          reinterpret_cast<float4*>(S >= 2 ? s1 + head : nullptr), nvec};
}

// this thread's U float4s of every stream at base, base + kThreads, ...
// (those below v.n): every load issued before any arithmetic, then the
// rule and the stores.  Each warp-wide access is 512 contiguous bytes.
template <int R, bool kClip, int U>
__device__ __forceinline__ void update_vectors(const Vectors& v,
                                               long long base, const Hyper& h,
                                               float lr_t, float lr_wd) {
  constexpr int S = state_count(R);
  float4 rp[U], rg[U], ra[U], rb[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < v.n) {
      rp[k] = __ldcs(v.p + i);
      rg[k] = __ldcs(v.g + i);
      if constexpr (S >= 1) ra[k] = __ldcs(v.a + i);
      if constexpr (S >= 2) rb[k] = __ldcs(v.b + i);
    }
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < v.n) {
      update4<R, kClip>(rp[k], rg[k], ra[k], rb[k], h, lr_t, lr_wd);
      __stcs(v.p + i, rp[k]);
      if constexpr (S >= 1) __stcs(v.a + i, ra[k]);
      if constexpr (S >= 2) __stcs(v.b + i, rb[k]);
    }
  }
}

// the last CTA to finish sets the launch's two counters back to 0 (a CTA
// counts itself done only after its last draw)
__device__ __forceinline__ void release_counters(unsigned* counters) {
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&counters[1], 1u) == gridDim.x - 1) {
      counters[0] = 0;
      counters[1] = 0;
      __threadfence();
    }
  }
}

// The persistent kernel: each CTA draws chunks of kThreads * U float4s in
// order from counters[0] until the body is done.  counters: two unsigned
// ints, zero at launch and left zero.  lr_dev / t_dev, where not null,
// replace h.lr / h.t by the values in device memory when the kernel runs,
// so a captured CUDA graph replays with the caller's current learning
// rate and step (the port's entry passes lr_dev always; null only from
// the layouts of tools/update_sweep.cu, which pass the values in h).
template <int R, bool kClip, int U>
__global__ void __launch_bounds__(kThreads)
    update_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ s0, float* __restrict__ s1,
                  long long head, long long nvec, long long tail, Hyper h,
                  unsigned* counters, const float* __restrict__ lr_dev,
                  const int* __restrict__ t_dev) {
  if (lr_dev != nullptr) h.lr = *lr_dev;
  if (t_dev != nullptr) h.t = *t_dev;
  float lr_t, lr_wd;
  adam_scalars<R>(h, lr_t, lr_wd);
  head_and_tail<R, kClip>(p, g, s0, s1, head, nvec, tail, h, lr_t, lr_wd);
  const Vectors v = body_vectors<R>(p, g, s0, s1, head, nvec);
  constexpr long long kChunk = (long long)kThreads * U;
  const long long chunks = (nvec + kChunk - 1) / kChunk;
  __shared__ unsigned drawn;
  for (;;) {
    if (threadIdx.x == 0) drawn = atomicAdd(&counters[0], 1u);
    __syncthreads();
    const long long c = drawn;
    __syncthreads();
    if (c >= chunks) break;
    update_vectors<R, kClip, U>(v, c * kChunk + threadIdx.x, h, lr_t, lr_wd);
  }
  release_counters(counters);
}

using Kernel = void (*)(float*, const float*, float*, float*, long long,
                        long long, long long, Hyper, unsigned*,
                        const float*, const int*);

template <int R>
Kernel pick_clip(bool clip) {
  return clip ? update_kernel<R, true, kUnroll>
              : update_kernel<R, false, kUnroll>;
}

// the port's instance for a rule code and clip flag; null for an unknown
// rule
Kernel kernel_for(int rule, bool clip) {
  switch (rule) {
    case kSgd:
      return pick_clip<kSgd>(clip);
    case kMomentum:
      return pick_clip<kMomentum>(clip);
    case kNag:
      return pick_clip<kNag>(clip);
    case kAdam:
      return pick_clip<kAdam>(clip);
    case kAdamW:
      return pick_clip<kAdamW>(clip);
    default:
      return nullptr;
  }
}

// resident CTAs a SM of `kernel` (`threads` wide, `smem` bytes of dynamic
// shared memory), or -cudaError_t
int resident_ctas(const void* kernel, int threads, int smem, int device) {
  if (kernel == nullptr) return -int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
  return err == cudaSuccess ? n : -int(err);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// cudaSuccess when the plan covers n, the rule's streams are given and
// every stream's vectors are 16-byte aligned; then selects the device
cudaError_t check_plan(int rule, const void* p, const void* g, const void* s0,
                       const void* s1, long long n, long long head,
                       long long nvec, long long tail, int grid, int device) {
  const int S = state_count(rule);
  if (rule < kSgd || rule > kAdamW || n <= 0 || head < 0 || nvec < 0 ||
      tail < 0 || head + 4 * nvec + tail != n || grid < 1 ||
      (S >= 1 && s0 == nullptr) || (S >= 2 && s1 == nullptr))
    return cudaErrorInvalidValue;
  if (nvec > 0) {
    const float* at[4] = {static_cast<const float*>(p),
                          static_cast<const float*>(g),
                          static_cast<const float*>(s0),
                          static_cast<const float*>(s1)};
    for (int k = 0; k < 2 + S; ++k)
      if (!aligned16(at[k] + head)) return cudaErrorMisalignedAddress;
  }
  return cudaSetDevice(device);
}

}  // namespace

// Resident CTAs a SM of the kernel for `rule` (0 SGD, 1 momentum, 2 NAG,
// 3 Adam, 4 AdamW) with or without the clip; a negative cudaError_t on
// failure.  The wrapper sizes the persistent grid from it.
extern "C" int fused_update_resident(int rule, int has_clip, int device) {
  return resident_ctas(
      reinterpret_cast<const void*>(kernel_for(rule, has_clip != 0)),
      kThreads, 0, device);
}

// One launch of K1 (rule 0-2) or K2 (rule 3-4) over flat f32 buffers of
// n elements: p, g and the rule's state (s0 = mom for momentum and NAG;
// s0 = m, s1 = v for Adam; null where the rule keeps none), p and the
// state updated in place.  The learning rate and Adam's step are read
// from device memory when the kernel runs: lr_dev, one float32, and
// t_dev, one int32 holding the step being taken (null for the SGD rules,
// which keep none).  The entry makes no host read of either, allocates
// nothing and synchronizes nothing, so a CUDA graph captures it and each
// replay uses the values the caller wrote there since.  head / nvec /
// tail / grid are the wrapper's plan (update_plan); counters: two
// unsigned ints on the device, zero, left zero; one_minus_b1/b2 are
// (1 - beta) rounded to f32 by the caller.  Returns a cudaError_t code.
extern "C" int fused_update(int rule, int has_clip, void* p, const void* g,
                            void* s0, void* s1, long long n, long long head,
                            long long nvec, long long tail, int grid,
                            void* counters, const void* lr_dev,
                            const void* t_dev, float wd, float rescale,
                            float clip, float momentum, float beta1,
                            float beta2, float one_minus_b1,
                            float one_minus_b2, float eps, int device,
                            void* stream) {
  cudaError_t err = check_plan(rule, p, g, s0, s1, n, head, nvec, tail, grid,
                               device);
  if (err == cudaSuccess &&
      (counters == nullptr || lr_dev == nullptr ||
       (rule >= kAdam && t_dev == nullptr)))
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const Hyper h{0.f,   wd,           rescale,      clip, momentum, beta1,
                beta2, one_minus_b1, one_minus_b2, eps,  0};
  const Kernel kernel = kernel_for(rule, has_clip != 0);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(s0), static_cast<float*>(s1), head, nvec, tail, h,
      static_cast<unsigned*>(counters), static_cast<const float*>(lr_dev),
      static_cast<const int*>(t_dev));
  return cudaGetLastError();
}
