// Flash-attention backward for Hopper (sm_90a): dq, dk, dv over
// (B*H, L, D) from the forward's output and logsumexp, without
// materialising the score matrix.
//
// Replaces the reference's backward, mxnet_tpu/ops/flash_attention.py
// _scan_backward (:174, reached through _flash_bwd :260), which is XLA
// and not Pallas.  Same function: delta = rowsum(out * g); p = exp(s -
// lse) with the causal mask (p is NOT rounded to the value dtype, unlike
// the forward); dv = p^T g; ds = p (dp - delta) scale with dp = g v^T;
// dk = ds^T q; dq = ds k.  Results are cast to the input dtype.
//
// Three launches, deterministic (no float atomics; two runs are bitwise
// equal): a delta pre-pass, one warp per query row; a dK/dV kernel per
// KV tile, looping over the Q tiles that reach it; a dQ kernel per Q
// tile, looping over the KV tiles it reaches and recomputing p from the
// saved lse.  Ragged L is masked: rows past L are computed but not
// stored, columns past L get p = 0.
//
// Bound on the H100 at the training shapes (BH=64, L=1024, D=128,
// causal): five products per score tile (counting only causal pairs),
// 43 GFLOP, against about 100 MB moved in bf16 (200 MB in f32): bound by
// operations, 0.044 ms at 989 TFLOP/s bf16 and 0.26 ms at the 165
// TFLOP/s of 3xTF32 in f32.  The kernels recompute S and dP in both
// passes (seven products), the price of having no atomics.
//
// bf16: flash_bwd_dkdv_bf16_kernel and flash_bwd_dq_bf16_kernel, on the
// tensor cores (hopper.cuh):
//  - dK/dV: a CTA of two warpgroups covers 128 KV rows, 64 each; Q, dO,
//    lse and delta tiles of 64 rows go through a two-stage cp.async ring.
//    S^T = K Q^T and dP^T = V dO^T are wgmmas with both operands in
//    shared memory; P^T and dS^T stay in the accumulator registers and
//    feed dV += P^T dO and dK += dS^T Q as the register operand, dO and Q
//    read MN-major;
//  - dQ: a CTA of two warpgroups covers 128 Q rows; K and V tiles of 64
//    rows go through the ring; S = Q K^T, dP = dO V^T, then dQ += dS K;
//  - the tensor cores take p and ds as bf16: they are rounded before
//    the three gradient products (the reference keeps them in f32), as
//    FlashAttention-2/3 do; S, dP and every sum stay f32.
//
// f32: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, on the tensor
// cores as 3xTF32 mma.sync (tf32x3.cuh): every operand is split into a
// big and a small TF32 part as it is loaded, three products each.
//  - a CTA of four warps owns 64 rows (16 a warp) of K/V (dK/dV) or of
//    Q/dO (dQ), staged once as f32 with row stride D + 4, and loops over
//    32-row tiles of the other side; 32 rows keep the dK/dV warp's dK,
//    dV (2 x 64 f32 a lane at D = 128) and its S^T, dP^T fragments in
//    registers, and the 101 KB of tiles let two CTAs share an SM;
//  - dK/dV: S^T = K Q^T and dP^T = V dO^T, then p^T and ds^T in
//    registers feed dV += P^T dO and dK += dS^T Q as the A operand, dO and
//    Q read in the permuted row order of load_b_kn;
//  - dQ: S = Q K^T, dP = dO V^T, then dQ += dS K the same way;
//  - p and ds stay f32 (split like any operand), as in the reference.
#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

namespace x3 = mxt::tf32x3;

constexpr int NT = 128;     // four warps
constexpr int OWN = 64;     // rows a CTA owns, 16 per warp
constexpr int STEP = 32;    // rows of the tiles it loops over
constexpr int NJ = STEP / 8;

template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                             float* __restrict__ delta, size_t rows) {
  const size_t row = (size_t(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp shares one row
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc += mxt::to_f32(o[row * D + c]) * mxt::to_f32(g[row * D + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// p and ds of one score entry; ok is false for masked or ragged entries
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float del,
                                     bool ok, float scale, float& p,
                                     float& ds) {
  // select, not multiply: a masked entry contributes exactly 0; the
  // scaled score is rounded before the subtraction, as the reference's
  p = ok ? expf(__fmul_rn(s, scale) - lse) : 0.f;
  ds = p * (dp - del) * scale;
}

// both f32 kernels: two OWN-row tiles, two STEP-row tiles, and (dK/dV)
// STEP lse and STEP delta values
template <int D>
constexpr size_t smem_f32() {
  return sizeof(float) *
         (size_t(2 * OWN + 2 * STEP) * x3::kStride<D> + 2 * STEP);
}

// acc[nd] += a B over the 8-row group k0 of a STEP- or OWN-row tile, B
// read in load_b_kn's order
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const x3::FragA& a,
                                         const float* tile, int k0,
                                         int lane) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    x3::FragB b;
    x3::load_b_kn<x3::kStride<D>>(b, tile, k0, 8 * nd, lane);
    x3::mma3(acc[nd], a, b);
  }
}

// s = A B^T and dp = A2 B2^T for a warp's 16 rows (r0 of sA, sA2) and
// the STEP rows of sB, sB2 (the score and dp tiles of either kernel)
template <int D>
__device__ __forceinline__ void scores(const float* sA, const float* sB,
                                       const float* sA2, const float* sB2,
                                       int r0, int lane, float (&s)[NJ][4],
                                       float (&dp)[NJ][4]) {
  constexpr int SD = x3::kStride<D>;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    x3::FragA a;
    x3::load_a<SD>(a, sA, r0, kk, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      x3::FragB b;
      x3::load_b_nk<SD>(b, sB, 8 * j, kk, lane);
      x3::mma3(s[j], a, b);
    }
    x3::load_a<SD>(a, sA2, r0, kk, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      x3::FragB b;
      x3::load_b_nk<SD>(b, sB2, 8 * j, kk, lane);
      x3::mma3(dp[j], a, b);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Lq, int Lk, int causal, float scale) {
  constexpr int SD = x3::kStride<D>;
  constexpr int ND = D / 8;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + OWN * SD;
  float* sQ = sV + OWN * SD;
  float* sG = sQ + STEP * SD;
  float* sL = sG + STEP * SD;
  float* sD = sL + STEP;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, tig = lane % 4;
  const size_t bh = blockIdx.x;
  const int n0 = blockIdx.y * OWN;  // the first tiles see the most rows
  const float* qb = q + bh * Lq * D;
  const float* gb = g + bh * Lq * D;

  x3::stage<OWN, D, NT>(sK, k + bh * Lk * D, n0, Lk);
  x3::stage<OWN, D, NT>(sV, v + bh * Lk * D, n0, Lk);

  // this lane's key rows: key0 and key0 + 8 of its warp's 16
  const int r0 = 16 * warp;
  const int key0 = n0 + r0 + lane / 4;
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.f;

  // causal: query rows before the KV tile see none of its keys
  const int m_begin = causal ? n0 : 0;
  for (int m0 = m_begin; m0 < Lq; m0 += STEP) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    x3::stage<STEP, D, NT>(sQ, qb, m0, Lq);
    x3::stage<STEP, D, NT>(sG, gb, m0, Lq);
    if (tid < STEP) {
      const int row = m0 + tid;
      sL[tid] = row < Lq ? lse[bh * Lq + row] : 0.f;
      sD[tid] = row < Lq ? delta[bh * Lq + row] : 0.f;
    }
    __syncthreads();
    // causal: every query row of the tile precedes every key of this
    // warp, so all its p are 0
    if (causal && m0 + STEP - 1 < n0 + r0) continue;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries;
    // sT[j][e] is key key0 + 8 (e / 2), query m0 + 8 j + 2 tig + e % 2
    float sT[NJ][4], dpT[NJ][4];
    scores<D>(sK, sQ, sV, sG, r0, lane, sT, dpT);

    const bool mask = m0 + STEP > Lq || n0 + r0 + 16 > Lk ||
                      (causal && n0 + r0 + 15 > m0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tig + e % 2;  // query in the tile
        const int key = key0 + 8 * (e / 2);
        const bool ok = !mask || (m0 + c < Lq && key < Lk &&
                                  (!causal || key <= m0 + c));
        float p, ds;
        p_ds(sT[j][e], dpT[j][e], sL[c], sD[c], ok, scale, p, ds);
        sT[j][e] = p;
        dpT[j][e] = ds;
      }

    // dV += P^T dO, dK += dS^T Q: k runs over the tile's queries
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      x3::FragA a;
      x3::acc_to_a(a, sT[j]);
      mma_rows<D>(acc_v, a, sG, 8 * j, lane);
      x3::acc_to_a(a, dpT[j]);
      mma_rows<D>(acc_k, a, sQ, 8 * j, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = key0 + 8 * i;
    if (row >= Lk) continue;
    const size_t off = (bh * Lk + row) * D + 2 * tig;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<float2*>(dk + off + 8 * nd) =
          make_float2(acc_k[nd][2 * i], acc_k[nd][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + off + 8 * nd) =
          make_float2(acc_v[nd][2 * i], acc_v[nd][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Lq, int Lk, int causal,
                        float scale) {
  constexpr int SD = x3::kStride<D>;
  constexpr int ND = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + OWN * SD;
  float* sK = sG + OWN * SD;
  float* sV = sK + STEP * SD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const size_t bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * OWN;  // longest rows first
  const float* kb = k + bh * Lk * D;
  const float* vb = v + bh * Lk * D;

  x3::stage<OWN, D, NT>(sQ, q + bh * Lq * D, m0, Lq);
  x3::stage<OWN, D, NT>(sG, g + bh * Lq * D, m0, Lq);

  // this lane's rows: row0 and row0 + 8 of its warp's 16
  const int r0 = 16 * warp;
  const int row0 = m0 + r0 + lane / 4;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lse_r[i] = row < Lq ? lse[bh * Lq + row] : 0.f;
    del_r[i] = row < Lq ? delta[bh * Lq + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // causal: key rows past the tile's last query row are masked for every
  // row of the tile, so those tiles are skipped outright
  const int n_end = causal ? min(Lk, m0 + OWN) : Lk;
  for (int n0 = 0; n0 < n_end; n0 += STEP) {
    __syncthreads();  // every warp is done with the previous K/V tile
    x3::stage<STEP, D, NT>(sK, kb, n0, Lk);
    x3::stage<STEP, D, NT>(sV, vb, n0, Lk);
    __syncthreads();
    // causal: every key of the tile follows every row of this warp
    if (causal && n0 > m0 + r0 + 15) continue;

    // S = Q K^T and dP = dO V^T: s[j][e] is row row0 + 8 (e / 2), key
    // n0 + 8 j + 2 tig + e % 2
    float s[NJ][4], dp[NJ][4];
    scores<D>(sQ, sK, sG, sV, r0, lane, s, dp);

    const bool mask = m0 + r0 + 16 > Lq || n0 + STEP > Lk ||
                      (causal && n0 + STEP - 1 > m0 + r0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2);
        const int col = n0 + 8 * j + 2 * tig + e % 2;
        const bool ok =
            !mask || (row < Lq && col < Lk && (!causal || col <= row));
        float p, ds;
        p_ds(s[j][e], dp[j][e], lse_r[e / 2], del_r[e / 2], ok, scale, p,
             ds);
        dp[j][e] = ds;
      }

    // dQ += dS K: k runs over the tile's keys
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      x3::FragA a;
      x3::acc_to_a(a, dp[j]);
      mma_rows<D>(acc, a, sK, 8 * j, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Lq) continue;
    float* qrow = dq + (bh * Lq + row) * D + 2 * tig;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(qrow + 8 * nd) =
          make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* g, void* dq,
                   void* dk, void* dv, void* delta, int bh, int lq, int lk,
                   int causal, float scale, cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* g_ = static_cast<const float*>(g);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const size_t rows = size_t(bh) * lq;
  const size_t delta_blocks = (rows * 32 + NT - 1) / NT;
  delta_kernel<float, D><<<unsigned(delta_blocks), NT, 0, stream>>>(
      static_cast<const float*>(o), g_, delta_, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem = smem_f32<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid_kv(bh, (lk + OWN - 1) / OWN);
  flash_bwd_dkdv_kernel<D><<<grid_kv, NT, smem, stream>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<float*>(dk),
      static_cast<float*>(dv), lq, lk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid_q(bh, (lq + OWN - 1) / OWN);
  flash_bwd_dq_kernel<D><<<grid_q, NT, smem, stream>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<float*>(dq), lq, lk, causal,
      scale);
  return cudaGetLastError();
}


// ------------------------------------------------------------------ bf16

namespace tc {

using bf16 = __nv_bfloat16;
namespace hw = mxt::hopper;

constexpr int NT = 256;     // two warpgroups
constexpr int BIG = 128;    // rows a CTA owns (64 per warpgroup)
constexpr int SMALL = 64;   // rows of the tiles it loops over
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of both bf16 kernels: two BIG-row tiles the CTA owns,
// then a two-stage ring of two SMALL-row tiles, and (dK/dV) the stage's
// 64 lse and 64 delta values
template <int D>
struct Smem {
  static constexpr int kOwn = BIG * D * 2;
  static constexpr int kTile = SMALL * D * 2;
  static constexpr int kRing = 2 * kOwn;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kStats = kRing + 2 * kStage;  // [stage][lse|delta]
  static constexpr int kAlloc = kStats + 2 * 2 * SMALL * 4 + 1024;
};

// p and ds of one score entry as p_ds, in base 2 with the scale folded
// in (lse2 = lse log2 e, sl2 = scale log2 e): exp2f is one MUFU
// instruction where expf adds a range reduction, and at bf16 tensor-core
// rates the exponentials are a visible share of the backward
__device__ __forceinline__ void p_ds_exp2(float s, float dp, float lse2,
                                          float del, bool ok, float sl2,
                                          float scale, float& p, float& ds) {
  // select, not multiply: a masked entry contributes exactly 0
  p = ok ? exp2f(fmaf(s, sl2, -lse2)) : 0.f;
  ds = p * (dp - del) * scale;
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ g,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int Lq, int Lk, int causal, float scale) {
  constexpr int P = D / 64;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hw::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + S::kOwn;
  const float* stats = reinterpret_cast<const float*>(
      smem_raw + (base - hw::smem_u32(smem_raw)) + S::kStats);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const size_t bh = blockIdx.x;
  const int n0 = blockIdx.y * BIG;  // the first tiles see the most rows
  const bf16* qb = q + bh * Lq * D;
  const bf16* gb = g + bh * Lq * D;
  const float* lb = lse + bh * Lq;
  const float* db = delta + bh * Lq;

  // causal: query rows before the KV tile see none of its keys
  const int m_begin = causal ? n0 : 0;
  const int n_q = Lq > m_begin ? (Lq - m_begin + SMALL - 1) / SMALL : 0;

  auto load_stage = [&](int it) {
    const int m0 = m_begin + it * SMALL;
    const uint32_t st = base + S::kRing + (it & 1) * S::kStage;
    hw::load_tile<SMALL, D, NT>(st, qb, m0, Lq, tid);
    hw::load_tile<SMALL, D, NT>(st + S::kTile, gb, m0, Lq, tid);
    if (tid < 2 * SMALL) {
      const int r = tid % SMALL, row = m0 + r;
      const float* src = tid < SMALL ? lb : db;
      const uint32_t dst = base + S::kStats + (it & 1) * 2 * SMALL * 4 +
                           (tid / SMALL) * SMALL * 4 + r * 4;
      hw::cp_async4(dst, src + (row < Lq ? row : 0), row < Lq);
    }
  };

  if (n_q > 0) {  // else no query reaches these keys: dk = dv = 0
    hw::load_tile<BIG, D, NT>(sK, k + bh * Lk * D, n0, Lk, tid);
    hw::load_tile<BIG, D, NT>(sV, v + bh * Lk * D, n0, Lk, tid);
    load_stage(0);
    hw::cp_async_commit();
  }

  // this thread's key rows: key0 and key0 + 8 of its warpgroup's 64
  const int wg_first = n0 + 64 * wg;
  const int key0 = wg_first + 16 * warp + lane / 4;
  const float sl2 = scale * kLog2e;
  float acc_k[P][32], acc_v[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc_k[p][j] = acc_v[p][j] = 0.f;
  float sT[32], dpT[32];

  for (int it = 0; it < n_q; ++it) {
    hw::cp_async_wait<0>();
    hw::fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_q) {
      load_stage(it + 1);
      hw::cp_async_commit();
    }
    const int m0 = m_begin + it * SMALL;
    // causal: every query row of the tile precedes every key of this
    // warpgroup, so all its p are 0
    if (causal && m0 + SMALL - 1 < wg_first) continue;
    const uint32_t sQ = base + S::kRing + (it & 1) * S::kStage;
    const uint32_t sG = sQ + S::kTile;
    const float* sL = stats + (it & 1) * 2 * SMALL;
    const float* sD = sL + SMALL;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss_n64(sT, hw::desc_kmajor<BIG>(sK, 64 * wg, kk),
                       hw::desc_kmajor<SMALL>(sQ, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss_n64(dpT, hw::desc_kmajor<BIG>(sV, 64 * wg, kk),
                       hw::desc_kmajor<SMALL>(sG, 0, kk), kk > 0);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sT);
    hw::fence_regs(dpT);

    const bool mask = m0 + SMALL > Lq || wg_first + 64 > Lk ||
                      (causal && wg_first + 63 > m0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * (j / 4) + 2 * (lane % 4) + (j % 2);  // query
      const int key = key0 + 8 * ((j / 2) % 2);
      const bool ok = !mask || (m0 + c < Lq && key < Lk &&
                                (!causal || key <= m0 + c));
      float p, ds;
      p_ds_exp2(sT[j], dpT[j], sL[c] * kLog2e, sD[c], ok, sl2, scale, p,
                ds);
      sT[j] = p;
      dpT[j] = ds;
    }

    // dV += P^T dO, dK += dS^T Q, p and ds rounded to bf16
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SMALL / 16; ++kk) {
      uint32_t ap[4], as[4];
      hw::acc_to_a(sT, kk, ap);
      hw::acc_to_a(dpT, kk, as);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        hw::wgmma_rs_n64(acc_v[p], ap, hw::desc_mnmajor<SMALL>(sG, p, kk));
        hw::wgmma_rs_n64(acc_k[p], as, hw::desc_mnmajor<SMALL>(sQ, p, kk));
      }
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      hw::fence_regs(acc_v[p]);
      hw::fence_regs(acc_k[p]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = key0 + 8 * i;
    if (row >= Lk) continue;
    const size_t off = (bh * Lk + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = 4 * c + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 64 * p + 8 * c) =
            __floats2bfloat162_rn(acc_k[p][j], acc_k[p][j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 64 * p + 8 * c) =
            __floats2bfloat162_rn(acc_v[p][j], acc_v[p][j + 1]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int Lq, int Lk,
                             int causal, float scale) {
  constexpr int P = D / 64;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hw::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sG = base + S::kOwn;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const size_t bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BIG;  // longest rows first
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;

  // causal: key columns past the tile's last row are masked for every
  // row of the tile, so those tiles are skipped outright
  const int n_end = causal ? min(Lk, m0 + BIG) : Lk;
  const int n_kv = (n_end + SMALL - 1) / SMALL;

  auto load_stage = [&](int it) {
    const uint32_t st = base + S::kRing + (it & 1) * S::kStage;
    hw::load_tile<SMALL, D, NT>(st, kb, it * SMALL, Lk, tid);
    hw::load_tile<SMALL, D, NT>(st + S::kTile, vb, it * SMALL, Lk, tid);
  };

  hw::load_tile<BIG, D, NT>(sQ, q + bh * Lq * D, m0, Lq, tid);
  hw::load_tile<BIG, D, NT>(sG, g + bh * Lq * D, m0, Lq, tid);
  load_stage(0);
  hw::cp_async_commit();

  const int wg_first = m0 + 64 * wg;
  const int row0 = wg_first + 16 * warp + lane / 4;
  const float sl2 = scale * kLog2e;
  float lse2[2], del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lse2[i] = row < Lq ? lse[bh * Lq + row] * kLog2e : 0.f;
    del[i] = row < Lq ? delta[bh * Lq + row] : 0.f;
  }
  float acc[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[p][j] = 0.f;
  float s[32], dp[32];

  for (int it = 0; it < n_kv; ++it) {
    hw::cp_async_wait<0>();
    hw::fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_kv) {
      load_stage(it + 1);
      hw::cp_async_commit();
    }
    const int n0 = it * SMALL;
    // causal: every key of the tile follows every row of this warpgroup
    if (causal && n0 > wg_first + 63) continue;
    const uint32_t sK = base + S::kRing + (it & 1) * S::kStage;
    const uint32_t sV = sK + S::kTile;

    // S = Q K^T and dP = dO V^T
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss_n64(s, hw::desc_kmajor<BIG>(sQ, 64 * wg, kk),
                       hw::desc_kmajor<SMALL>(sK, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss_n64(dp, hw::desc_kmajor<BIG>(sG, 64 * wg, kk),
                       hw::desc_kmajor<SMALL>(sV, 0, kk), kk > 0);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    hw::fence_regs(dp);

    const bool mask = wg_first + 64 > Lq || n0 + SMALL > Lk ||
                      (causal && n0 + SMALL - 1 > wg_first);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j / 2) % 2;
      const int row = row0 + 8 * i;
      const int col = n0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
      const bool ok =
          !mask || (row < Lq && col < Lk && (!causal || col <= row));
      float p, ds;
      p_ds_exp2(s[j], dp[j], lse2[i], del[i], ok, sl2, scale, p, ds);
      dp[j] = ds;
    }

    // dQ += dS K, ds rounded to bf16, K read MN-major
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SMALL / 16; ++kk) {
      uint32_t as[4];
      hw::acc_to_a(dp, kk, as);
#pragma unroll
      for (int p = 0; p < P; ++p)
        hw::wgmma_rs_n64(acc[p], as, hw::desc_mnmajor<SMALL>(sK, p, kk));
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) hw::fence_regs(acc[p]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Lq) continue;
    bf16* qrow = dq + (bh * Lq + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = 4 * c + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(qrow + 64 * p + 8 * c) =
            __floats2bfloat162_rn(acc[p][j], acc[p][j + 1]);
      }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* g, void* dq,
                   void* dk, void* dv, void* delta, int bh, int lq, int lk,
                   int causal, float scale, cudaStream_t stream) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* g_ = static_cast<const bf16*>(g);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const size_t rows = size_t(bh) * lq;
  const size_t delta_blocks = (rows * 32 + NT - 1) / NT;
  delta_kernel<bf16, D><<<unsigned(delta_blocks), NT, 0, stream>>>(
      static_cast<const bf16*>(o), g_, delta_, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem = Smem<D>::kAlloc;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid_kv(bh, (lk + BIG - 1) / BIG);
  flash_bwd_dkdv_bf16_kernel<D><<<grid_kv, NT, smem, stream>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), lq, lk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid_q(bh, (lq + BIG - 1) / BIG);
  flash_bwd_dq_bf16_kernel<D><<<grid_q, NT, smem, stream>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<bf16*>(dq), lq, lk, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, o, g, dq: (bh, lq, d); k, v, dk, dv: (bh, lk, d), all contiguous in
// dtype (0 = f32, 1 = bf16), bf16 base pointers 16-byte aligned; lse:
// (bh, lq) f32 from the forward; delta:
// (bh, lq) f32 scratch.  d must be 64 or 128.  Launches the delta, dK/dV
// and dQ kernels on ``stream``; returns a cudaError_t code.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* g, void* dq, void* dk,
                                   void* dv, void* delta, int bh, int lq,
                                   int lk, int d, int dtype, int causal,
                                   float scale, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (dtype == mxt::kF32 && d == 64)
    return launch<64>(q, k, v, o, lse, g, dq, dk, dv, delta, bh, lq, lk,
                      causal, scale, s);
  if (dtype == mxt::kF32 && d == 128)
    return launch<128>(q, k, v, o, lse, g, dq, dk, dv, delta, bh, lq, lk,
                       causal, scale, s);
  if (dtype == mxt::kBF16 && d == 64)
    return tc::launch<64>(q, k, v, o, lse, g, dq, dk, dv, delta, bh, lq, lk,
                          causal, scale, s);
  if (dtype == mxt::kBF16 && d == 128)
    return tc::launch<128>(q, k, v, o, lse, g, dq, dk, dv, delta, bh, lq, lk,
                           causal, scale, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory, in bytes, that the backward's dK/dV (pass 0) or
// dQ (pass 1) launch asks for at (dtype, d); 0 for a pair it does not
// take.  The delta pre-pass takes none.
extern "C" int flash_attention_bwd_smem(int dtype, int d, int pass) {
  if (dtype == mxt::kF32 && d == 64) return int(smem_f32<64>());
  if (dtype == mxt::kF32 && d == 128) return int(smem_f32<128>());
  if (dtype == mxt::kBF16 && d == 64) return tc::Smem<64>::kAlloc;
  if (dtype == mxt::kBF16 && d == 128) return tc::Smem<128>::kAlloc;
  return 0;
}
