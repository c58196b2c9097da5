// Flash-attention backward for Hopper (sm_90a): dq, dk, dv over
// (B*H, L, D) from the forward's output and logsumexp, without
// materialising the score matrix.
//
// Replaces the reference's backward, mxnet_tpu/ops/flash_attention.py
// _scan_backward (:174, reached through _flash_bwd :260), which is XLA
// and not Pallas.  Same function, all in f32: delta = rowsum(out * g);
// p = exp(s - lse) with the causal mask (p is NOT rounded to the value
// dtype, unlike the forward); dv = p^T g; ds = p (dp - delta) scale with
// dp = g v^T; dk = ds^T q; dq = ds k.  Results are cast to the input
// dtype; a bf16 g is widened to f32 on load.
//
// Design (correct, simple and deterministic first; no float atomics):
//  - a delta pre-pass, one warp per query row;
//  - a dK/dV kernel, one CTA of 256 threads per (b*h, 64-row KV tile),
//    looping over 64-row Q tiles (causal: only tiles that reach the KV
//    tile); K, V, Q, G tiles staged in shared memory as f32;
//  - a dQ kernel, one CTA per (b*h, 64-row Q tile), looping over KV
//    tiles (causal: only tiles up to the diagonal) and recomputing p
//    from the saved lse.
//  Thread (ty, tx) of a 16x16 layout owns score rows ty+16i and columns
//  tx+16j, as in the forward; the padded row stride (D+1) keeps column
//  reads conflict-free.  Ragged L is masked as in the forward: rows past
//  L are computed but not stored, columns past L get p = 0.
// Bound on the H100 at the training shapes (BH=64, L=1024, D=128,
// causal): about 100 MB moved against about 86 GFLOP of products (five
// products per score tile, counting only causal pairs).  The products
// run on CUDA cores out of shared memory here, so this first version is
// bound by shared-memory traffic and FMA issue; wgmma/TMA tiles are
// later work.
#include "common.cuh"

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

}  // namespace

// q, o, g, dq: (bh, lq, d); k, v, dk, dv: (bh, lk, d), all contiguous in
// dtype (0 = f32, 1 = bf16); lse: (bh, lq) f32 from the forward; delta:
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
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, g, dq, dk, dv, delta,
                                     bh, lq, lk, causal, scale, s);
  if (dtype == mxt::kBF16 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, g, dq, dk, dv, delta,
                                      bh, lq, lk, causal, scale, s);
  return cudaErrorInvalidValue;
}
