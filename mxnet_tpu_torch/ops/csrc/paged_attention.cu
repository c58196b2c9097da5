// Paged decode attention for Hopper (sm_90a): one decode step of GQA
// attention, one query per sequence, K/V read through the block table.
//
// Replaces the TPU kernel mxnet_tpu/ops/paged_attention.py _pallas_paged
// (pallas_call at :185) for f32, bf16 and fp8 (e4m3 codes with one f32
// scale per token row, :98, :130-134, :165-172) pools.
//
// Design (correct and simple first):
//  - one CTA per (sequence, kv head); it serves that head's rep = H/KVH
//    query heads, so each K/V row is read from memory once per group;
//  - the CTA reads the sequence's block table itself and walks only the
//    positions 0..pos (blocks past pos, table padding and write-ahead
//    rows are never loaded);
//  - a lane loads N consecutive elements of a row: D/32 for f32 and bf16
//    pools (one row per warp load), 8 codes (8 bytes) for an fp8 pool,
//    so there a warp loads 32/(D/8) rows at once (2 at D=128, 4 at
//    D=64); each warp takes every 8th group of U such loads;
//  - rows are widened to f32; an fp8 row's scale is folded into its
//    score (s = scale_k * q.codes) and into p (p * scale_v scales the
//    codes of V), which is the reference's codes * scale up to f32
//    rounding;
//  - q.k dot products are shuffle reductions over the row's lanes; each
//    lane keeps an online softmax (running max, denominator,
//    accumulator) per query head; the row groups of a warp, then the
//    warps, are merged (shuffles, then shared memory);
//  - inactive batch rows (pos = 0, null block) read one row of block 0
//    and produce finite output.
// Bound on the H100: memory.  A step moves ctx*KVH*D*sizeof(pool) bytes
// each of K and V per sequence and layer (plus 4*ctx bytes of each scale
// plane for fp8) against 4*rep*D FLOPs per row, far below the 295
// FLOP/byte ridge.  The loop is latency-bound at small batch: the wider
// fp8 lane load keeps 8 bytes in flight per lane.
#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int U = 4;  // row loads in flight per lane

template <typename TQ, typename TKV, int D, int REP>
__global__ void __launch_bounds__(NWARPS * 32)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, TQ* __restrict__ out,
                        int H, int KVH, int bs, int nbl, float scale) {
  constexpr bool SCALED = sizeof(TKV) == 1;    // fp8 codes carry scales
  constexpr int N = SCALED ? 8 : D / 32;       // elements a lane loads
  constexpr int LPR = D / N;                   // lanes per row
  constexpr int RPW = 32 / LPR;                // rows per warp load
  constexpr int STEP = RPW * U;                // positions per iteration
  __shared__ float sM[NWARPS][REP];
  __shared__ float sL[NWARPS][REP];
  __shared__ float sA[NWARPS][REP][D];

  const int b = blockIdx.x, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane / LPR, col = (lane % LPR) * N;
  const int n = min(pos[b] + 1, nbl * bs);  // positions 0..pos attend
  const int* table = tables + size_t(b) * nbl;

  float qr[REP][N], acc[REP][N], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    mxt::load_f32<TQ, N>(q + (size_t(b) * H + g * REP + r) * D + col, qr[r]);
    m[r] = mxt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = warp * STEP; t0 < n; t0 += NWARPS * STEP) {
    float kf[U][N], vf[U][N], ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * RPW + seg;
      ksc[u] = vsc[u] = 1.f;
      if (t < n) {
        const size_t slot = size_t(table[t / bs]) * bs + t % bs;
        const size_t row = slot * KVH + g;
        mxt::load_f32<TKV, N>(kp + row * D + col, kf[u]);
        mxt::load_f32<TKV, N>(vp + row * D + col, vf[u]);
        if constexpr (SCALED) {
          ksc[u] = ks[slot];
          vsc[u] = vs[slot];
        }
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u * RPW >= n) break;  // warp-uniform: the first row group
      const bool live = t0 + u * RPW + seg < n;
      float s[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) d = fmaf(qr[r][e], kf[u][e], d);
        s[r] = d;
      }
      // reduce over the LPR lanes that hold this row
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < REP; ++r)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      if (!live) continue;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float sc = SCALED ? s[r] * ksc[u] * scale : s[r] * scale;
        const float m_new = fmaxf(m[r], sc);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(sc - m_new);
        const float pv = SCALED ? p * vsc[u] : p;
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < N; ++e) acc[r][e] = fmaf(acc[r][e], alpha,
                                                     pv * vf[u][e]);
        m[r] = m_new;
      }
    }
  }

  // merge the row groups of the warp (fp8 only; RPW = 1 otherwise): the
  // lanes at distance LPR hold the same columns of other positions
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float M = fmaxf(m[r], mo);
      const float a = expf(m[r] - M), c = expf(mo - M);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * a + ao * c;
      }
      m[r] = M;
    }
  }

  if (seg == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (lane == 0) {
        sM[warp][r] = m[r];
        sL[warp][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < N; ++e) sA[warp][r][col + e] = acc[r][e];
    }
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

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *tables, *pos;
  void* out;
  int B, H, KVH, bs, nbl;
  float scale;
};

template <typename TQ, typename TKV, int D, int REP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.B, a.KVH);
  paged_decode_kernel<TQ, TKV, D, REP><<<grid, NWARPS * 32, 0, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ks, a.vs, a.tables, a.pos,
      static_cast<TQ*>(a.out), a.H, a.KVH, a.bs, a.nbl, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t by_rep(int rep, const Args& a, cudaStream_t s) {
  switch (rep) {
    case 1:
      return launch<TQ, TKV, D, 1>(a, s);
    case 2:
      return launch<TQ, TKV, D, 2>(a, s);
    case 4:
      return launch<TQ, TKV, D, 4>(a, s);
    case 8:
      return launch<TQ, TKV, D, 8>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t by_dim(int d, int rep, const Args& a, cudaStream_t s) {
  if (d == 64) return by_rep<TQ, TKV, 64>(rep, a, s);
  if (d == 128) return by_rep<TQ, TKV, 128>(rep, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, H, D) in q_dtype; k_pool/v_pool: (num_blocks, bs, KVH, D) in
// kv_dtype (0 = f32, 1 = bf16, 2 = fp8 e4m3; a bf16 query needs a bf16
// or fp8 pool); k_scale/v_scale: (num_blocks, bs) f32 row scales for an
// fp8 pool, null otherwise; tables: (B, nbl) int32 block ids; pos: (B,)
// int32 >= 0; out: (B, H*D) in q_dtype.  D in {64, 128}, H/KVH in
// {1, 2, 4, 8}.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* k_scale,
                                      const void* v_scale, const void* tables,
                                      const void* pos, void* out, int B,
                                      int H, int KVH, int D, int bs, int nbl,
                                      int q_dtype, int kv_dtype, float scale,
                                      int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  const bool scaled = kv_dtype == mxt::kFP8;
  if (scaled != (k_scale != nullptr) || scaled != (v_scale != nullptr))
    return cudaErrorInvalidValue;
  const Args a{q,
               k_pool,
               v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tables),
               static_cast<const int*>(pos),
               out,
               B,
               H,
               KVH,
               bs,
               nbl,
               scale};
  const int rep = H / KVH;
  if (q_dtype == mxt::kF32 && kv_dtype == mxt::kF32)
    return by_dim<float, float>(D, rep, a, s);
  if (q_dtype == mxt::kF32 && kv_dtype == mxt::kBF16)
    return by_dim<float, __nv_bfloat16>(D, rep, a, s);
  if (q_dtype == mxt::kBF16 && kv_dtype == mxt::kBF16)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(D, rep, a, s);
  if (q_dtype == mxt::kF32 && kv_dtype == mxt::kFP8)
    return by_dim<float, __nv_fp8_e4m3>(D, rep, a, s);
  if (q_dtype == mxt::kBF16 && kv_dtype == mxt::kFP8)
    return by_dim<__nv_bfloat16, __nv_fp8_e4m3>(D, rep, a, s);
  return cudaErrorInvalidValue;
}
