// The layouts of K1/K2's update kernel that `tools/port_update_pairs.py
// --variants` times against the port's, behind one C entry (momentum and
// AdamW, with the clip).  kind, a, b:
//   0  a fixed assignment of chunks: a = U float4s of each stream a thread
//      takes a chunk (1, 2, 4 or 8); b = 0 for a grid-stride walk, 1 for
//      one contiguous range of chunks a CTA;
//   1  the bulk-copy ring with a fixed assignment of tiles: a = V float4s
//      of each stream a consumer thread takes a stage (1, 2 or 4), b =
//      stages (2, 3, 4 or 8);
//   2  the same ring whose producer draws tiles in order from the
//      counters (a = 2 or 4, b = 3);
//   3  the port's kernel (chunks drawn in order) with U = a (2 or 4).
// The port's library builds only kind 3 with U = kUnroll.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupdate_sweep.so tools/update_sweep.cu
#include <type_traits>

#include "../mxnet_tpu_torch/ops/csrc/fused_update.cu"

namespace {

// a fixed assignment: CTA b takes chunks b, b + gridDim.x, ... or one
// contiguous range of chunks
template <int R, bool kClip, int U, bool kContig>
__global__ void __launch_bounds__(kThreads)
    update_static_kernel(float* __restrict__ p, const float* __restrict__ g,
                         float* __restrict__ s0, float* __restrict__ s1,
                         long long head, long long nvec, long long tail,
                         Hyper h, unsigned*, const float*, const int*) {
  float lr_t, lr_wd;
  adam_scalars<R>(h, lr_t, lr_wd);
  head_and_tail<R, kClip>(p, g, s0, s1, head, nvec, tail, h, lr_t, lr_wd);
  const Vectors v = body_vectors<R>(p, g, s0, s1, head, nvec);
  constexpr long long kChunk = (long long)kThreads * U;
  const long long chunks = (nvec + kChunk - 1) / kChunk;
  long long first = blockIdx.x, last = chunks, step = gridDim.x;
  if constexpr (kContig) {
    const long long per = (chunks + gridDim.x - 1) / gridDim.x;
    first = blockIdx.x * per;
    last = min(chunks, first + per);
    step = 1;
  }
  for (long long c = first; c < last; c += step)
    update_vectors<R, kClip, U>(v, c * kChunk + threadIdx.x, h, lr_t, lr_wd);
}

// the bulk-copy ring: 8 consumer warps and one producer warp a CTA.  The
// producer's lane 0 fills kStages stages of V * 256 float4s of every
// stream with 1-D bulk copies (cp.async.bulk, L2 evict-first), each
// stage's bytes counted on its `full` mbarrier; a consumer thread copies
// its V float4s of each stream to registers, its warp releases the stage
// on `empty`, then it computes and stores with st.global.cs.v4.  Tiles go
// to CTAs blockIdx.x, blockIdx.x + gridDim.x, ... or (kInOrder) the
// producer draws them in order from counters[0]; it passes each index to
// the consumers beside its stage, and an index past the last tile ends
// the loops.
constexpr int kConsumers = 256;
constexpr int kRingThreads = kConsumers + 32;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

template <int R, int V, int kStages>
constexpr int ring_smem() {
  return kStages * (2 + state_count(R)) * V * kConsumers * 16;
}

template <int R, int V, int kStages, bool kInOrder>
__global__ void __launch_bounds__(kRingThreads)
    update_ring_kernel(float* __restrict__ p, const float* __restrict__ g,
                       float* __restrict__ s0, float* __restrict__ s1,
                       long long head, long long nvec, long long tail,
                       Hyper h, unsigned* counters, const float*,
                       const int*) {
  constexpr bool kClip = true;
  constexpr int NS = 2 + state_count(R);
  constexpr int kTile = V * kConsumers;             // float4s a stream
  extern __shared__ __align__(128) float4 ring[];   // [kStages][NS][kTile]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ long long tile_of[kStages];
  float lr_t, lr_wd;
  adam_scalars<R>(h, lr_t, lr_wd);
  head_and_tail<R, kClip>(p, g, s0, s1, head, nvec, tail, h, lr_t, lr_wd);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&full[st]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_u32(&empty[st])),
                   "r"(kConsumers / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const float* streams[4] = {p + head, g + head, s0 + head, s1 + head};
  const long long tiles = (nvec + kTile - 1) / kTile;
  int st = 0;
  uint32_t phase = 0;
  if (threadIdx.x == kConsumers) {                  // the producer
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(policy));
    for (long long k = 0;; ++k) {
      mbar_wait(smem_u32(&empty[st]), phase ^ 1);
      const long long t = kInOrder ? (long long)atomicAdd(&counters[0], 1u)
                                   : blockIdx.x + k * gridDim.x;
      tile_of[st] = t;
      const uint32_t bar = smem_u32(&full[st]);
      if (t >= tiles) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                     : "memory");
        break;
      }
      const long long first = t * kTile;
      const uint32_t bytes =
          uint32_t(nvec - first < kTile ? nvec - first : kTile) * 16;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(bytes * NS)
                   : "memory");
      for (int s = 0; s < NS; ++s)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(
                smem_u32(ring + (st * NS + s) * kTile)),
            "l"(streams[s] + 4 * first), "r"(bytes), "r"(bar), "l"(policy)
            : "memory");
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
  } else if (threadIdx.x < kConsumers) {
    const Vectors v = body_vectors<R>(p, g, s0, s1, head, nvec);
    for (;;) {
      mbar_wait(smem_u32(&full[st]), phase);
      const long long t = tile_of[st];
      if (t >= tiles) break;
      const long long first = t * kTile;
      const float4* stage = ring + st * NS * kTile;
      float4 rp[V], rg[V], ra[V], rb[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = threadIdx.x + k * kConsumers;
        if (first + i < nvec) {
          rp[k] = stage[i];
          rg[k] = stage[kTile + i];
          if constexpr (NS >= 3) ra[k] = stage[2 * kTile + i];
          if constexpr (NS >= 4) rb[k] = stage[3 * kTile + i];
        }
      }
      __syncwarp();
      if (threadIdx.x % 32 == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                         smem_u32(&empty[st]))
                     : "memory");
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const long long i = first + threadIdx.x + k * kConsumers;
        if (i < nvec) {
          update4<R, kClip>(rp[k], rg[k], ra[k], rb[k], h, lr_t, lr_wd);
          __stcs(v.p + i, rp[k]);
          if constexpr (NS >= 3) __stcs(v.a + i, ra[k]);
          if constexpr (NS >= 4) __stcs(v.b + i, rb[k]);
        }
      }
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
  }
  if constexpr (kInOrder) {
    __syncthreads();                     // every thread is past its loop
    release_counters(counters);
  }
}

template <int U, bool kContig>
struct Static {
  static constexpr int threads = kThreads;
  template <int R>
  static Kernel kernel() {
    return update_static_kernel<R, true, U, kContig>;
  }
  template <int R>
  static int smem() {
    return 0;
  }
};

template <int V, int kStages, bool kInOrder>
struct Ring {
  static constexpr int threads = kRingThreads;
  template <int R>
  static Kernel kernel() {
    return update_ring_kernel<R, V, kStages, kInOrder>;
  }
  template <int R>
  static int smem() {
    return ring_smem<R, V, kStages>();
  }
};

template <int U>
struct InOrder {
  static constexpr int threads = kThreads;
  template <int R>
  static Kernel kernel() {
    return update_kernel<R, true, U>;
  }
  template <int R>
  static int smem() {
    return 0;
  }
};

// fn(K{}) for the layout named by (kind, a, b); err when there is none
template <class F>
int with_variant(int kind, int a, int b, int err, F fn) {
  switch (kind * 1000 + a * 10 + b) {
    case 10: return fn(Static<1, false>{});
    case 11: return fn(Static<1, true>{});
    case 20: return fn(Static<2, false>{});
    case 21: return fn(Static<2, true>{});
    case 40: return fn(Static<4, false>{});
    case 41: return fn(Static<4, true>{});
    case 80: return fn(Static<8, false>{});
    case 81: return fn(Static<8, true>{});
    case 1014: return fn(Ring<1, 4, false>{});
    case 1018: return fn(Ring<1, 8, false>{});
    case 1022: return fn(Ring<2, 2, false>{});
    case 1023: return fn(Ring<2, 3, false>{});
    case 1024: return fn(Ring<2, 4, false>{});
    case 1042: return fn(Ring<4, 2, false>{});
    case 1043: return fn(Ring<4, 3, false>{});
    case 2023: return fn(Ring<2, 3, true>{});
    case 2043: return fn(Ring<4, 3, true>{});
    case 3020: return fn(InOrder<2>{});
    case 3040: return fn(InOrder<4>{});
    default: return err;
  }
}

// fn(integral_constant<rule>) for momentum or AdamW; err otherwise
template <class F>
int with_rule(int rule, int err, F fn) {
  if (rule == kMomentum) return fn(std::integral_constant<int, kMomentum>{});
  if (rule == kAdamW) return fn(std::integral_constant<int, kAdamW>{});
  return err;
}

}  // namespace

// resident CTAs a SM of the layout (kind, a, b) for `rule` (1 momentum or
// 4 AdamW, with the clip), or -cudaError_t
extern "C" int sweep_resident(int kind, int a, int b, int rule, int device) {
  const int bad = -int(cudaErrorInvalidValue);
  return with_variant(kind, a, b, bad, [&](auto k) {
    using K = decltype(k);
    return with_rule(rule, bad, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return resident_ctas(
          reinterpret_cast<const void*>(K::template kernel<R>()), K::threads,
          K::template smem<R>(), device);
    });
  });
}

// fused_update's launch for the layout (kind, a, b), with the clip
extern "C" int sweep_update(int kind, int a, int b, int rule, void* p,
                            const void* g, void* s0, void* s1, long long n,
                            long long head, long long nvec, long long tail,
                            int grid, void* counters, float lr, float wd,
                            float rescale, float clip, float momentum, int t,
                            float beta1, float beta2, float one_minus_b1,
                            float one_minus_b2, float eps, int device,
                            void* stream) {
  const cudaError_t err = check_plan(rule, p, g, s0, s1, n, head, nvec, tail,
                                     grid, device);
  if (err != cudaSuccess) return err;
  const Hyper h{lr,    wd,           rescale,      clip, momentum, beta1,
                beta2, one_minus_b1, one_minus_b2, eps,  t};
  const int bad = int(cudaErrorInvalidValue);
  return with_variant(kind, a, b, bad, [&](auto k) {
    using K = decltype(k);
    return with_rule(rule, bad, [&](auto r) {
      constexpr int R = decltype(r)::value;
      const Kernel kernel = K::template kernel<R>();
      const int smem = K::template smem<R>();
      if (smem > 0) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return int(e);
      }
      kernel<<<grid, K::threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(p), static_cast<const float*>(g),
          static_cast<float*>(s0), static_cast<float*>(s1), head, nvec, tail,
          h, static_cast<unsigned*>(counters), nullptr, nullptr);
      return int(cudaGetLastError());
    });
  });
}
