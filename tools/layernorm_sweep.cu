// Layouts of K4's forward row kernel for the sweep of
// tools/port_layernorm_pairs.py --variants.
//
// Built from the port's own pieces (mxnet_tpu_torch/ops/csrc/
// fused_layernorm.cu, included here: load_row, stage_params, widen_row,
// finish_row), at one warp a row and 16-byte vectors, for bf16 or f32
// activations with f32 gamma/beta.  A layout is a code, grid * 4 +
// gamma/beta in registers * 2 + prefetch, and the CTAs a SM ptxas leaves
// room for (1: no bound, 3 or 4):
//  - grid 0: CTA i's row group r takes rows i * RG + r + k * G * RG (a
//    plain grid when G covers the rows, a persistent one when G is the
//    resident CTAs); grid 1: a persistent grid whose groups draw rows in
//    order from counters[0], the last group to finish setting both
//    counters back to 0;
//  - gamma and beta in shared memory (as the port) or in registers;
//  - prefetch: the next row's loads issued before the current row's
//    reductions.
// Code 0 over the plain grid, at 3 CTAs (bf16) or none (f32), is the
// port's kernel.
//
//   nvcc <the port's flags> -o libln_sweep.so tools/layernorm_sweep.cu
#include "../mxnet_tpu_torch/ops/csrc/fused_layernorm.cu"

namespace {

template <int GRID, bool GB_REGS, bool PREFETCH, int MIN_CTAS>
struct Layout {
  static constexpr int grid = GRID;
  static constexpr bool gb_regs = GB_REGS;
  static constexpr bool prefetch = PREFETCH;
  static constexpr int min_ctas = MIN_CTAS;
};

// the first row of a group (k = 0), or the next one after `row`
template <int GRID>
__device__ __forceinline__ int take_row(int row, unsigned* counters, int& k,
                                        int rg, int t) {
  constexpr int RG = ROW_WARPS;
  if constexpr (GRID == 0) {
    return k++ == 0 ? int(blockIdx.x) * RG + rg : row + int(gridDim.x) * RG;
  } else {
    ++k;
    unsigned r = 0;
    if (t == 0) r = atomicAdd(&counters[0], 1u);
    return int(__shfl_sync(0xffffffffu, r, 0));
  }
}

template <typename T, int V, typename L>
__global__ void __launch_bounds__(ROW_THREADS, L::min_ctas)
    ln_fwd_variant(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y,
                   unsigned* counters, int rows, int D, float eps) {
  constexpr int RG = ROW_WARPS, TPR = 32, NV = LANE_COLS / V;
  constexpr int GC = L::gb_regs ? LANE_COLS : 1;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[RG][2];
  const int rg = threadIdx.x / TPR, t = threadIdx.x % TPR;
  int k = 0;
  int row = take_row<L::grid>(0, counters, k, rg, t);
  Raw<T, V> xv[NV], rv[NV];
  if (row < rows)
    load_row<T, V, NV, TPR>(x, res, size_t(row) * D, t, D, xv, rv);
  float gr[GC], br[GC];
  if constexpr (L::gb_regs) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (t + j * TPR) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        gr[j * V + e] = c < D ? gamma[c + e] : 0.f;
        br[j * V + e] = c < D ? beta[c + e] : 0.f;
      }
    }
  } else {
    stage_params(gamma, beta, smem, D);
    __syncthreads();
  }
  const auto params = [&](int j, int c, float(&gm)[V], float(&bt)[V]) {
    if constexpr (L::gb_regs) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        gm[e] = gr[j * V + e];
        bt[e] = br[j * V + e];
      }
    } else {
      lds(smem + c, gm);
      lds(smem + D + c, bt);
    }
  };
  while (row < rows) {
    const int next = take_row<L::grid>(row, counters, k, rg, t);
    float h[LANE_COLS];
    widen_row<T, V, NV>(xv, rv, h);
    if constexpr (L::prefetch)
      if (next < rows)
        load_row<T, V, NV, TPR>(x, res, size_t(next) * D, t, D, xv, rv);
    finish_row<T, 1, V, NV>(h, y + size_t(row) * D, red[rg], rg, t, D, eps,
                            params);
    row = next;
    if constexpr (!L::prefetch)
      if (row < rows)
        load_row<T, V, NV, TPR>(x, res, size_t(row) * D, t, D, xv, rv);
  }
  if constexpr (L::grid == 1) {
    // a group counts itself done after its last draw; the last group
    // sets the counters back to 0
    if (t == 0) {
      __threadfence();
      if (atomicAdd(&counters[1], 1u) == gridDim.x * RG - 1) {
        counters[0] = 0;
        counters[1] = 0;
        __threadfence();
      }
    }
  }
}

template <typename L>
int variant_smem(int D) {
  return L::gb_regs ? 0 : fwd_smem(D);
}

// f(Type<Layout<...>>) for a layout code 0-7 and the CTAs a SM ptxas
// leaves room for (1, 3 or 4; gamma and beta in registers: 1 only), or
// an error
template <int GRID, bool GB, bool PF, typename F>
int with_ctas(int min_ctas, F&& f) {
  switch (min_ctas) {
    case 1:
      return f(Type<Layout<GRID, GB, PF, 1>>{});
    case 3:
      if constexpr (!GB) return f(Type<Layout<GRID, GB, PF, 3>>{});
      break;
    case 4:
      if constexpr (!GB) return f(Type<Layout<GRID, GB, PF, 4>>{});
      break;
  }
  return -int(cudaErrorInvalidValue);
}

template <typename F>
int with_layout(int code, int min_ctas, F&& f) {
  switch (code) {
    case 0:
      return with_ctas<0, false, false>(min_ctas, f);
    case 1:
      return with_ctas<0, false, true>(min_ctas, f);
    case 2:
      return with_ctas<0, true, false>(min_ctas, f);
    case 3:
      return with_ctas<0, true, true>(min_ctas, f);
    case 4:
      return with_ctas<1, false, false>(min_ctas, f);
    case 5:
      return with_ctas<1, false, true>(min_ctas, f);
    case 6:
      return with_ctas<1, true, false>(min_ctas, f);
    default:
      return with_ctas<1, true, true>(min_ctas, f);
  }
}

template <typename F>
int with_dtype(int dtype, F&& f) {
  return dtype == mxt::kF32 ? f(Type<float>{}) : f(Type<__nv_bfloat16>{});
}

}  // namespace

// resident CTAs a SM of layout (code, min_ctas) at D for dtype (gamma
// f32), or minus a CUDA error
extern "C" int sweep_ln_fwd_resident(int code, int min_ctas, int D,
                                     int dtype, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -int(err);
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_layout(code, min_ctas, [&](auto l) {
      using L = typename decltype(l)::type;
      return occupancy(reinterpret_cast<const void*>(
                           ln_fwd_variant<T, 16 / sizeof(T), L>),
                       variant_smem<L>(D));
    });
  });
}

// one launch of layout (code, min_ctas) over G CTAs: x, res, y (rows, D)
// in dtype, 16-byte aligned, D <= 1024 and a multiple of 8; gamma, beta
// f32; counters: two zero int32 (left zero)
extern "C" int sweep_ln_fwd(int code, int min_ctas, const void* x,
                            const void* res, const void* gamma,
                            const void* beta, void* y, void* counters,
                            int rows, int D, int G, int dtype, float eps,
                            int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows < 1 || D < 1 || D > 1024 || G < 1 || G > (rows + 7) / 8 ||
      (dtype != mxt::kF32 && dtype != mxt::kBF16) || counters == nullptr)
    return cudaErrorInvalidValue;
  return with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    constexpr int V = 16 / sizeof(T);
    if (!vectors<T>(D, {x, res, y})) return int(cudaErrorInvalidValue);
    return with_layout(code, min_ctas, [&](auto l) {
      using L = typename decltype(l)::type;
      const void* kernel =
          reinterpret_cast<const void*>(ln_fwd_variant<T, V, L>);
      const int smem = variant_smem<L>(D);
      const cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return int(e);
      const cudaStream_t s = static_cast<cudaStream_t>(stream);
      ln_fwd_variant<T, V, L><<<G, ROW_THREADS, smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(res),
          static_cast<const float*>(gamma), static_cast<const float*>(beta),
          static_cast<T*>(y), static_cast<unsigned*>(counters), rows, D,
          eps);
      return int(cudaGetLastError());
    });
  });
}
