// Paged decode attention for Hopper (sm_90a): one decode step of GQA
// attention, one query per sequence, K/V read through the block table.
//
// Replaces the TPU kernel mxnet_tpu/ops/paged_attention.py _pallas_paged
// (pallas_call at :185) for f32 and bf16 pools; the fp8 path with
// per-row scales is a later slice.
//
// Design (correct and simple first):
//  - one CTA per (sequence, kv head); it serves that head's rep = H/KVH
//    query heads, so each K/V row is read from memory once per group;
//  - the CTA reads the sequence's block table itself and walks only the
//    positions 0..pos (blocks past pos, table padding and write-ahead
//    rows are never loaded);
//  - each of the 8 warps takes every 8th group of U=4 positions; a lane
//    holds D/32 consecutive elements, K/V rows are widened to f32, the
//    q.k dot products are warp-shuffle reductions and each warp keeps an
//    online softmax (running max, denominator, accumulator) per query
//    head; the warps' partial states are merged through shared memory;
//  - inactive batch rows (pos = 0, null block) read one row of block 0
//    and produce finite output.
// Bound on the H100: memory.  A step moves 2*ctx*KVH*D*sizeof(pool) bytes
// of K/V per sequence and layer against 4*rep*D FLOPs per row, far
// below the 295 FLOP/byte ridge.
#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int U = 4;  // positions in flight per warp

template <typename TQ, typename TKV, int D, int REP>
__global__ void __launch_bounds__(NWARPS * 32)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, TQ* __restrict__ out,
                        int H, int KVH, int bs, int nbl, float scale) {
  constexpr int V = D / 32;
  __shared__ float sM[NWARPS][REP];
  __shared__ float sL[NWARPS][REP];
  __shared__ float sA[NWARPS][REP][D];

  const int b = blockIdx.x, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = min(pos[b] + 1, nbl * bs);  // positions 0..pos attend
  const int* table = tables + size_t(b) * nbl;

  float qr[REP][V], acc[REP][V], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    mxt::load_f32<TQ, V>(q + (size_t(b) * H + g * REP + r) * D + lane * V,
                         qr[r]);
    m[r] = mxt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = warp * U; t0 < n; t0 += NWARPS * U) {
    float kf[U][V], vf[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < n) {
        const size_t row =
            (size_t(table[t / bs]) * bs + t % bs) * KVH + g;
        mxt::load_f32<TKV, V>(kp + row * D + lane * V, kf[u]);
        mxt::load_f32<TKV, V>(vp + row * D + lane * V, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u >= n) break;  // warp-uniform
      float s[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d = fmaf(qr[r][e], kf[u][e], d);
        s[r] = d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < REP; ++r)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float sc = s[r] * scale;
        const float m_new = fmaxf(m[r], sc);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(sc - m_new);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = fmaf(acc[r][e], alpha,
                                                     p * vf[u][e]);
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sM[warp][r] = m[r];
      sL[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) sA[warp][r][lane * V + e] = acc[r][e];
  }
  __syncthreads();

  // merge the warps' online-softmax states; a warp that saw no position
  // holds (-1e30, 0, 0) and is weighted by exp(-1e30 - M) = 0
  for (int idx = threadIdx.x; idx < REP * D; idx += NWARPS * 32) {
    const int r = idx / D, c = idx % D;
    float M = mxt::kNegInf;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sM[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(sM[w][r] - M);
      L = fmaf(sL[w][r], f, L);
      A = fmaf(sA[w][r][c], f, A);
    }
    out[(size_t(b) * H + g * REP + r) * D + c] =
        mxt::from_f32<TQ>(A / fmaxf(L, 1e-30f));
  }
}

template <typename TQ, typename TKV, int D, int REP>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* pos, void* out, int B,
                   int H, int KVH, int bs, int nbl, float scale,
                   cudaStream_t stream) {
  dim3 grid(B, KVH);
  paged_decode_kernel<TQ, TKV, D, REP><<<grid, NWARPS * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<TQ*>(out), H, KVH, bs, nbl,
      scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t by_rep(int rep, const void* q, const void* kp, const void* vp,
                   const void* tables, const void* pos, void* out, int B,
                   int H, int KVH, int bs, int nbl, float scale,
                   cudaStream_t s) {
  switch (rep) {
    case 1:
      return launch<TQ, TKV, D, 1>(q, kp, vp, tables, pos, out, B, H, KVH,
                                   bs, nbl, scale, s);
    case 2:
      return launch<TQ, TKV, D, 2>(q, kp, vp, tables, pos, out, B, H, KVH,
                                   bs, nbl, scale, s);
    case 4:
      return launch<TQ, TKV, D, 4>(q, kp, vp, tables, pos, out, B, H, KVH,
                                   bs, nbl, scale, s);
    case 8:
      return launch<TQ, TKV, D, 8>(q, kp, vp, tables, pos, out, B, H, KVH,
                                   bs, nbl, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t by_dim(int d, int rep, const void* q, const void* kp,
                   const void* vp, const void* tables, const void* pos,
                   void* out, int B, int H, int KVH, int bs, int nbl,
                   float scale, cudaStream_t s) {
  if (d == 64)
    return by_rep<TQ, TKV, 64>(rep, q, kp, vp, tables, pos, out, B, H, KVH,
                               bs, nbl, scale, s);
  if (d == 128)
    return by_rep<TQ, TKV, 128>(rep, q, kp, vp, tables, pos, out, B, H, KVH,
                                bs, nbl, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, H, D) in q_dtype; k_pool/v_pool: (num_blocks, bs, KVH, D) in
// kv_dtype (0 = f32, 1 = bf16; a bf16 query needs a bf16 pool);
// tables: (B, nbl) int32 block ids; pos: (B,) int32 >= 0; out: (B, H*D)
// in q_dtype.  D in {64, 128}, H/KVH in {1, 2, 4, 8}.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* pos, void* out, int B,
                                      int H, int KVH, int D, int bs, int nbl,
                                      int q_dtype, int kv_dtype, float scale,
                                      int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  const int rep = H / KVH;
  if (q_dtype == mxt::kF32 && kv_dtype == mxt::kF32)
    return by_dim<float, float>(D, rep, q, k_pool, v_pool, tables, pos, out,
                                B, H, KVH, bs, nbl, scale, s);
  if (q_dtype == mxt::kF32 && kv_dtype == mxt::kBF16)
    return by_dim<float, __nv_bfloat16>(D, rep, q, k_pool, v_pool, tables,
                                        pos, out, B, H, KVH, bs, nbl, scale,
                                        s);
  if (q_dtype == mxt::kBF16 && kv_dtype == mxt::kBF16)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(D, rep, q, k_pool, v_pool,
                                                tables, pos, out, B, H, KVH,
                                                bs, nbl, scale, s);
  return cudaErrorInvalidValue;
}
