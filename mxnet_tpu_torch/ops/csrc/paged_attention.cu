// Paged decode attention for Hopper (sm_90a): one decode step of GQA
// attention, one query per sequence, K/V read through the block table.
//
// Replaces the TPU kernel mxnet_tpu/ops/paged_attention.py _pallas_paged
// (pallas_call at :185) for f32, bf16 and fp8 (e4m3 codes with one f32
// scale per token row, :98, :130-134, :165-172) pools.
//
// Bound on the H100: memory.  A step moves ctx*KVH*D*sizeof(pool) bytes
// each of K and V per sequence and layer (plus 4*ctx bytes of each scale
// plane for fp8) against 4*rep*D FLOPs per row, far below the 295
// FLOP/byte ridge.  At decode batch sizes the card is filled only if the
// context is split: one CTA per (sequence, kv head) is 64 CTAs at B = 8,
// each walking its whole context alone, so the time follows the longest
// sequence and a few SMs carry the load.
//
// Design:
//  - grid (B, KVH, S): the context is cut into S splits of C positions
//    (C a multiple of the block size, at most 256; S from the table's
//    width, so the host never reads pos).  A split that starts past its
//    sequence's position exits at once.  Each CTA serves the kv head's
//    rep = H/KVH query heads, so a K/V row is read from memory once per
//    group;
//  - a CTA loads its position, its split's C/bs block ids and its
//    queries (f32, into shared memory) together, then puts every K and V
//    row of the split (and, for fp8, the split's scale rows) in flight at
//    once with 16-byte cp.async copies, neighbouring lanes on
//    neighbouring bytes of a row: no register holds a row in transit,
//    and no row load waits on a table read;
//  - scores take a thread a row (K rows padded by 16 bytes, so eight
//    neighbouring rows' chunks fall in distinct banks; the queries are
//    broadcast reads, all D of them a row, too many to hold in
//    registers): s = q.k * scale, times the row's scale_k for fp8.  The
//    split's max and sum of p = exp(s - max) per query head are CTA
//    reductions in fixed order; p (times scale_v for fp8, which scales
//    the codes of V: the reference's codes * scale up to f32 rounding)
//    stays in shared memory.  p.V takes a thread 4 neighbouring columns
//    of every 4th row (8th at D = 64), the row classes added in order;
//  - the ordered combine, in the same launch: with one live split the
//    CTA writes out directly.  Otherwise each live split writes its
//    unnormalised (p.V, max, sum) to an f32 workspace, fences, and takes
//    a ticket (an integer atomicAdd on a counter per (b, g)); the CTA
//    that draws the last ticket merges the splits in split order (their
//    weights exp(max - M) computed once, in shared memory), writes out
//    and resets the counter to 0 for the next launch.  No float
//    atomics: the result does not depend on which CTA arrives last, so
//    two runs are bitwise equal;
//  - inactive batch rows (pos = 0, null block) read one row of block 0
//    and produce finite output; no row past pos is read.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using mxt::hopper::cp_async16;
using mxt::hopper::cp_async4;
using mxt::hopper::smem_u32;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_SPLIT = 256;  // positions a split (C), so C / bs <= 256
constexpr int MAX_SPLITS = 512;  // splits (S): their merge weights fit the
                                 // K/V region (2048 * rep bytes or more)

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// the K/V region: K rows padded by 16 bytes (a thread reads a row: the
// pad puts 8 neighbouring rows' chunks in distinct banks), then V rows;
// after p.V it holds the row classes' sums (4 * THREADS * rep floats)
__host__ __device__ constexpr int kv_bytes(int C, int D, int elem, int rep) {
  return C * (2 * D * elem + 16) > 16 * THREADS * rep
             ? C * (2 * D * elem + 16)
             : 16 * THREADS * rep;
}

// the shared memory a CTA takes: the K/V region, the queries in f32, p
// (C x rep), and for fp8 the split's K and V scale rows
__host__ __device__ constexpr int smem_bytes(int C, int D, int elem,
                                             int rep) {
  return kv_bytes(C, D, elem, rep) + rep * D * 4 + align16(C * rep * 4) +
         (elem == 1 ? 2 * align16(C * 4) : 0);
}

// the max (MAX) or sum of v[r] over the CTA into out[r]: a butterfly in
// each warp, then the warps' results in warp order (the same bits
// whichever thread adds them); out is read after the closing barrier
template <bool MAX, int REP>
__device__ __forceinline__ void cta_reduce(const float (&v_in)[REP],
                                           float (*red)[REP], float* out) {
  float v[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) v[r] = v_in[r];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float o = __shfl_xor_sync(0xffffffffu, v[r], off);
      v[r] = MAX ? fmaxf(v[r], o) : v[r] + o;
    }
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int r = 0; r < REP; ++r) red[threadIdx.x / 32][r] = v[r];
  __syncthreads();
  if (threadIdx.x < REP) {
    const int r = threadIdx.x;
    float t = red[0][r];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w)
      t = MAX ? fmaxf(t, red[w][r]) : t + red[w][r];
    out[r] = t;
  }
  __syncthreads();
}

// at least 4 CTAs a SM: ptxas may take up to 128 registers a thread (left
// to itself, it spilled a few bytes to stay at 40 or 56)
template <typename TQ, typename TKV, int D, int REP>
__global__ void __launch_bounds__(THREADS, 4)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, TQ* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ counters,
                        int H, int KVH, int bs, int nbl, int C,
                        float scale) {
  constexpr bool SCALED = sizeof(TKV) == 1;  // fp8 codes carry scales
  constexpr int E = sizeof(TKV);
  constexpr int ROW = D * E;       // bytes of a K or V row
  constexpr int KSTRIDE = ROW + 16;
  constexpr int CPR = ROW / 16;    // 16-byte chunks a row
  constexpr int NC = 16 / E;       // elements a chunk
  constexpr int WS_ROW = D + 2;    // acc[D], m, l
  using VC = mxt::Vec<TKV, NC>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sblk[MAX_SPLIT];
  __shared__ float red_max[NWARPS][REP], red_sum[NWARPS][REP];
  __shared__ float sMax[REP], sSum[REP];  // the split's max and sum of p
  __shared__ int s_last;

  const int b = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int S = gridDim.z;
  unsigned char* sK = smem;
  unsigned char* sV = sK + C * KSTRIDE;
  float* sQ = reinterpret_cast<float*>(smem + kv_bytes(C, D, E, REP));
  float* sP = sQ + REP * D;  // [C][REP]
  float* sKS = sP + align16(C * REP * 4) / 4;
  float* sVS = sKS + align16(C * 4) / 4;
  const int tid = threadIdx.x;
  // the position, the split's block ids and the queries, loaded together
  const int p_b = pos[b];
  const int nblk = C / bs;
  for (int i = tid; i < nblk; i += THREADS) {
    const int j = split * nblk + i;
    sblk[i] = j < nbl ? tables[size_t(b) * nbl + j] : 0;
  }
  const TQ* qg = q + (size_t(b) * H + g * REP) * D;
  for (int i = tid; i < REP * D; i += THREADS) sQ[i] = mxt::to_f32(qg[i]);
  const int n = min(p_b + 1, nbl * bs);  // positions 0..pos attend
  const int live = (n + C - 1) / C;      // splits holding a position
  if (split >= live) return;
  const int t_begin = split * C, rows = min(n, t_begin + C) - t_begin;
  __syncthreads();

  // the split's K and V rows (and scale rows) into shared memory, every
  // copy in flight at once, 16 bytes a lane, neighbouring lanes on a row
  for (int i = tid; i < rows * CPR; i += THREADS) {
    const int t = i / CPR, ch = i % CPR;
    const size_t slot = size_t(sblk[t / bs]) * bs + t % bs;
    const size_t off = (slot * KVH + g) * D + ch * NC;
    cp_async16(smem_u32(sK + t * KSTRIDE + ch * 16), kp + off, true);
    cp_async16(smem_u32(sV + t * ROW + ch * 16), vp + off, true);
  }
  if constexpr (SCALED)
    for (int t = tid; t < rows; t += THREADS) {
      const size_t slot = size_t(sblk[t / bs]) * bs + t % bs;
      cp_async4(smem_u32(sKS + t), ks + slot, true);
      cp_async4(smem_u32(sVS + t), vs + slot, true);
    }
  mxt::hopper::cp_async_commit();
  mxt::hopper::cp_async_wait<0>();
  __syncthreads();

  // scores, a thread a row: s = q.k * scale (* scale_k), into sP
  float mx[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) mx[r] = mxt::kNegInf;
  for (int t = tid; t < rows; t += THREADS) {
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r] = 0.f;
#pragma unroll
    for (int ch = 0; ch < CPR; ++ch) {
      const VC kc = *reinterpret_cast<const VC*>(sK + t * KSTRIDE + ch * 16);
#pragma unroll
      for (int e = 0; e < NC; e += 4) {
        const float k0 = mxt::to_f32(kc.x[e]), k1 = mxt::to_f32(kc.x[e + 1]);
        const float k2 = mxt::to_f32(kc.x[e + 2]);
        const float k3 = mxt::to_f32(kc.x[e + 3]);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(sQ + r * D + ch * NC + e);
          s[r] = fmaf(qv.x, k0, s[r]);
          s[r] = fmaf(qv.y, k1, s[r]);
          s[r] = fmaf(qv.z, k2, s[r]);
          s[r] = fmaf(qv.w, k3, s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float sc = SCALED ? s[r] * sKS[t] * scale : s[r] * scale;
      sP[t * REP + r] = sc;
      mx[r] = fmaxf(mx[r], sc);
    }
  }
  cta_reduce<true>(mx, red_max, sMax);

  // p = exp(s - m) and its sum; p * scale_v stays in sP for p.V
  float sum[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) sum[r] = 0.f;
  for (int t = tid; t < rows; t += THREADS)
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float p = expf(sP[t * REP + r] - sMax[r]);
      sum[r] += p;
      sP[t * REP + r] = SCALED ? p * sVS[t] : p;
    }
  cta_reduce<false>(sum, red_sum, sSum);  // its barrier publishes sP

  // p.V: a thread takes 4 neighbouring columns of every RC-th row; the RC
  // row classes' sums meet in the K/V region, added in class order
  constexpr int CG = D / 4;           // column groups
  constexpr int RC = THREADS / CG;    // row classes: 4 at D = 128
  using V4 = mxt::Vec<TKV, 4>;
  const int cg = tid % CG, cls = tid / CG;
  float acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int t = cls; t < rows; t += RC) {
    const V4 vv = *reinterpret_cast<const V4*>(sV + t * ROW + cg * 4 * E);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = mxt::to_f32(vv.x[j]);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float pr = sP[t * REP + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(pr, v[j], acc[r][j]);
    }
  }
  __syncthreads();  // every thread is done with sV
  float* sC = reinterpret_cast<float*>(smem);  // [RC][REP][D]
#pragma unroll
  for (int r = 0; r < REP; ++r)
    *reinterpret_cast<float4*>(sC + (cls * REP + r) * D + cg * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  TQ* og = out + (size_t(b) * H + g * REP) * D;
  for (int idx = tid; idx < REP * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < RC; ++k) a += sC[(k * REP + r) * D + c];
    if (live == 1) {
      og[idx] = mxt::from_f32<TQ>(a / fmaxf(sSum[r], 1e-30f));
    } else {
      float* row =
          ws + (((size_t(b) * KVH + g) * S + split) * REP + r) * WS_ROW;
      row[c] = a;
      if (c == 0) {
        row[D] = sMax[r];
        row[D + 1] = sSum[r];
      }
    }
  }
  if (live == 1) return;

  // the ticket: the CTA that finishes last merges the live splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + size_t(b) * KVH + g;
    const bool last = atomicAdd(counter, 1) == live - 1;
    if (last) *counter = 0;  // every live split has drawn: reset
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the merge: the splits' maxima M[r], their weights exp(m - M) (in the
  // K/V region, free now) and the sums L[r] once, then each output's
  // splits in split order, their loads independent
  const float* wsg = ws + (size_t(b) * KVH + g) * S * REP * WS_ROW;
  float* sW = reinterpret_cast<float*>(smem);  // [live][REP]
  if (tid < REP) {
    float M = mxt::kNegInf;
#pragma unroll 8
    for (int sp = 0; sp < live; ++sp)
      M = fmaxf(M, __ldcg(wsg + (size_t(sp) * REP + tid) * WS_ROW + D));
    sMax[tid] = M;
  }
  __syncthreads();
  for (int i = tid; i < live * REP; i += THREADS) {
    const int r = i % REP;
    sW[i] = expf(__ldcg(wsg + size_t(i) * WS_ROW + D) - sMax[r]);
  }
  __syncthreads();
  if (tid < REP) {
    float L = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < live; ++sp)
      L = fmaf(__ldcg(wsg + (size_t(sp) * REP + tid) * WS_ROW + D + 1),
               sW[sp * REP + tid], L);
    sSum[tid] = L;
  }
  __syncthreads();
  for (int idx = tid; idx < REP * D; idx += THREADS) {
    const int r = idx / D, cc = idx % D;
    float A = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < live; ++sp)
      A = fmaf(__ldcg(wsg + (size_t(sp) * REP + r) * WS_ROW + cc),
               sW[sp * REP + r], A);
    og[idx] = mxt::from_f32<TQ>(A / fmaxf(sSum[r], 1e-30f));
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *tables, *pos;
  void* out;
  float* ws;
  int* counters;
  int B, H, KVH, bs, nbl, C, S;
  float scale;
};

template <typename TQ, typename TKV, int D, int REP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto* kernel = paged_decode_kernel<TQ, TKV, D, REP>;
  const int smem = smem_bytes(a.C, D, sizeof(TKV), REP);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B, a.KVH, a.S);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ks, a.vs, a.tables, a.pos,
      static_cast<TQ*>(a.out), a.ws, a.counters, a.H, a.KVH, a.bs, a.nbl,
      a.C, a.scale);
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
// or fp8 pool), 16-byte aligned; k_scale/v_scale: (num_blocks, bs) f32
// row scales for an fp8 pool, null otherwise; tables: (B, nbl) int32
// block ids; pos: (B,) int32 >= 0; out: (B, H*D) in q_dtype.  D in
// {64, 128}, H/KVH in {1, 2, 4, 8}.  The context is cut into S splits of
// C positions (C a multiple of bs, C <= 256, S * C >= nbl * bs, S <=
// MAX_SPLITS); with S > 1, ws is an f32 workspace of B * KVH * S * rep *
// (D + 2) and counters B * KVH zeroed int32 (left zeroed); with S = 1
// both may be null.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos, void* out, void* ws, void* counters, int B, int H,
    int KVH, int D, int bs, int nbl, int C, int S, int q_dtype, int kv_dtype,
    float scale, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  const bool scaled = kv_dtype == mxt::kFP8;
  if (scaled != (k_scale != nullptr) || scaled != (v_scale != nullptr))
    return cudaErrorInvalidValue;
  if (bs < 1 || C < bs || C % bs || C > MAX_SPLIT || S < 1 ||
      S > MAX_SPLITS || size_t(S) * C < size_t(nbl) * bs ||
      smem_bytes(C, D, kv_dtype == mxt::kF32 ? 4 : scaled ? 1 : 2,
                 H / KVH) > 232448 ||
      (S > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q,
               k_pool,
               v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tables),
               static_cast<const int*>(pos),
               out,
               static_cast<float*>(ws),
               static_cast<int*>(counters),
               B,
               H,
               KVH,
               bs,
               nbl,
               C,
               S,
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
