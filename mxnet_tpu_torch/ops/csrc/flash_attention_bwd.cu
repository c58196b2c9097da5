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
// 43 GFLOP, against about 100 MB moved: bound by operations, 0.044 ms
// at 989 TFLOP/s bf16.  The kernels recompute S and dP in both passes
// (seven products), the price of having no atomics.
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
// f32: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, on CUDA cores:
// one CTA of 256 threads per 64-row tile, K, V, Q, G tiles staged in
// shared memory as f32; thread (ty, tx) of a 16x16 layout owns score
// rows ty+16i and columns tx+16j, as in the forward, and the padded row
// stride (D+1) keeps column reads conflict-free.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 64;   // query rows per tile
constexpr int BN = 64;   // key rows per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;
constexpr int RI = BM / TY;  // score rows per thread
constexpr int CJ = BN / TX;  // score columns per thread
constexpr int SP = BN + 1;   // padded stride of a score tile

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

// rows [r0, r0 + 64) of a (L, D) matrix into a (64, D+1) f32 tile, zero
// past L
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int r0,
                                          int L) {
  constexpr int SD = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    dst[r * SD + c] = row < L ? mxt::to_f32(src[size_t(row) * D + c]) : 0.f;
  }
}

// s = Q K^T and dp = G V^T for the thread's (RI x CJ) entries of the
// 64x64 tile: rows ty+16i of sQ/sG, rows tx+16j of sK/sV
template <int D>
__device__ __forceinline__ void score_tiles(const float* __restrict__ sQ,
                                            const float* __restrict__ sG,
                                            const float* __restrict__ sK,
                                            const float* __restrict__ sV,
                                            int ty, int tx, float (&s)[RI][CJ],
                                            float (&dp)[RI][CJ]) {
  constexpr int SD = D + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qv[RI], gv[RI], kv[CJ], vv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = sQ[(ty + TY * i) * SD + c];
      gv[i] = sG[(ty + TY * i) * SD + c];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      kv[j] = sK[(tx + TX * j) * SD + c];
      vv[j] = sV[(tx + TX * j) * SD + c];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
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

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * size_t(64) * (D + 1) + 2 * size_t(BM) * SP +
                          2 * BM);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int Lq, int Lk, int causal,
                          float scale) {
  constexpr int SD = D + 1;
  constexpr int DJ = D / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BN * SD;
  float* sQ = sV + BN * SD;
  float* sG = sQ + BM * SD;
  float* sP = sG + BM * SD;
  float* sS = sP + BM * SP;
  float* sL = sS + BM * SP;
  float* sD = sL + BM;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const size_t bh = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const T* qb = q + bh * Lq * D;
  const T* gb = g + bh * Lq * D;

  load_tile<T, D>(sK, k + bh * Lk * D, n0, Lk);
  load_tile<T, D>(sV, v + bh * Lk * D, n0, Lk);

  // thread owns key rows ty+16i and head columns tx+16jj of dk, dv
  float acc_k[RI][DJ], acc_v[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  // causal: query rows before the KV tile see none of its keys
  const int m_begin = causal ? (n0 / BM) * BM : 0;
  for (int m0 = m_begin; m0 < Lq; m0 += BM) {
    __syncthreads();  // the previous tile's reads of sQ/sG/sP/sS are done
    load_tile<T, D>(sQ, qb, m0, Lq);
    load_tile<T, D>(sG, gb, m0, Lq);
    for (int r = tid; r < BM; r += NT) {
      const int row = m0 + r;
      sL[r] = row < Lq ? lse[bh * Lq + row] : 0.f;
      sD[r] = row < Lq ? delta[bh * Lq + row] : 0.f;
    }
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    score_tiles<D>(sQ, sG, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i, row = m0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + TX * j, col = n0 + c;
        const bool ok = row < Lq && col < Lk && (!causal || col <= row);
        float p, ds;
        p_ds(s[i][j], dp[i][j], sL[r], sD[r], ok, scale, p, ds);
        sP[r * SP + c] = p;
        sS[r * SP + c] = ds;
      }
    }
    __syncthreads();

    // dv += p^T g, dk += ds^T q over the tile's query rows
#pragma unroll 4
    for (int qq = 0; qq < BM; ++qq) {
      float pv[RI], dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pv[i] = sP[qq * SP + ty + TY * i];
        dsv[i] = sS[qq * SP + ty + TY * i];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float gv = sG[qq * SD + tx + TX * jj];
        const float qv = sQ[qq * SD + tx + TX * jj];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          acc_v[i][jj] = fmaf(pv[i], gv, acc_v[i][jj]);
          acc_k[i][jj] = fmaf(dsv[i], qv, acc_k[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = n0 + ty + TY * i;
    if (row >= Lk) continue;
    T* krow = dk + (bh * Lk + row) * D;
    T* vrow = dv + (bh * Lk + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      krow[tx + TX * jj] = mxt::from_f32<T>(acc_k[i][jj]);
      vrow[tx + TX * jj] = mxt::from_f32<T>(acc_v[i][jj]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * size_t(64) * (D + 1) + size_t(BM) * SP +
                          2 * BM);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Lq, int Lk, int causal, float scale) {
  constexpr int SD = D + 1;
  constexpr int DJ = D / TX;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BM * SD;
  float* sK = sG + BM * SD;
  float* sV = sK + BN * SD;
  float* sS = sV + BN * SD;
  float* sL = sS + BM * SP;
  float* sD = sL + BM;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const size_t bh = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;

  load_tile<T, D>(sQ, q + bh * Lq * D, m0, Lq);
  load_tile<T, D>(sG, g + bh * Lq * D, m0, Lq);
  for (int r = tid; r < BM; r += NT) {
    const int row = m0 + r;
    sL[r] = row < Lq ? lse[bh * Lq + row] : 0.f;
    sD[r] = row < Lq ? delta[bh * Lq + row] : 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;

  // causal: key columns past the tile's last row are masked for every
  // row of the tile, so those tiles are skipped outright
  const int n_end = causal ? min(Lk, m0 + BM) : Lk;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's reads of sK/sV/sS are done
    load_tile<T, D>(sK, kb, n0, Lk);
    load_tile<T, D>(sV, vb, n0, Lk);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    score_tiles<D>(sQ, sG, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i, row = m0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + TX * j, col = n0 + c;
        const bool ok = row < Lq && col < Lk && (!causal || col <= row);
        float p, ds;
        p_ds(s[i][j], dp[i][j], sL[r], sD[r], ok, scale, p, ds);
        sS[r * SP + c] = ds;
      }
    }
    __syncthreads();

    // dq += ds k over the tile's key rows
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = sS[(ty + TY * i) * SP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float kv = sK[kk * SD + tx + TX * jj];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][jj] = fmaf(dsv[i], kv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = m0 + ty + TY * i;
    if (row >= Lq) continue;
    T* qrow = dq + (bh * Lq + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      qrow[tx + TX * jj] = mxt::from_f32<T>(acc[i][jj]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* g, void* dq,
                   void* dk, void* dv, void* delta, int bh, int lq, int lk,
                   int causal, float scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const size_t rows = size_t(bh) * lq;
  const size_t delta_blocks = (rows * 32 + NT - 1) / NT;
  delta_kernel<T, D><<<unsigned(delta_blocks), NT, 0, stream>>>(
      static_cast<const T*>(o), g_, delta_, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkdv_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_kv));
  if (err != cudaSuccess) return err;
  dim3 grid_kv((lk + BN - 1) / BN, bh);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, NT, smem_kv, stream>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<T*>(dk), static_cast<T*>(dv),
      lq, lk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_q));
  if (err != cudaSuccess) return err;
  dim3 grid_q((lq + BM - 1) / BM, bh);
  flash_bwd_dq_kernel<T, D><<<grid_q, NT, smem_q, stream>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<T*>(dq), lq, lk, causal,
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
    return launch<float, 64>(q, k, v, o, lse, g, dq, dk, dv, delta, bh, lq,
                             lk, causal, scale, s);
  if (dtype == mxt::kF32 && d == 128)
    return launch<float, 128>(q, k, v, o, lse, g, dq, dk, dv, delta, bh, lq,
                              lk, causal, scale, s);
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
  if (dtype == mxt::kF32 && d == 64)
    return int(pass ? dq_smem<64>() : dkdv_smem<64>());
  if (dtype == mxt::kF32 && d == 128)
    return int(pass ? dq_smem<128>() : dkdv_smem<128>());
  if (dtype == mxt::kBF16 && d == 64) return tc::Smem<64>::kAlloc;
  if (dtype == mxt::kBF16 && d == 128) return tc::Smem<128>::kAlloc;
  return 0;
}
