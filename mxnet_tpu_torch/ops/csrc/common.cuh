// Shared helpers of the port's kernels: f32/bf16/fp8 element conversion
// and the error-string entry every library exports for its Python
// wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace mxt {

// dtype codes passed by the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kFP8 = 2;  // float8_e4m3fn, storage only (read, never written)

constexpr float kNegInf = -1e30f;  // the reference's mask constant

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the reference's ``p.astype(v.dtype)``
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// N consecutive elements as one aligned vector load
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T x[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&out)[N]) {
  Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(v.x[i]);
}

}  // namespace mxt

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
