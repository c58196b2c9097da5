// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over (B*H, L, D) without materialising the score matrix.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py
// _pallas_forward (pallas_call at :105).  Same function: f32 scores,
// running max and denominator per query row, p rounded to the value
// dtype before the PV product, output in the input dtype and the
// logsumexp in f32.
//
// Design (correct and simple first):
//  - one CTA of 256 threads per (b*h, 64-row query tile); the sequential
//    KV grid axis of the TPU kernel becomes a loop over 64-column K/V
//    tiles staged in shared memory as f32;
//  - thread (ty, tx) of a 16x16 layout owns score rows ty+16i and
//    columns tx+16j (i, j < 4), so row reductions are 16-lane shuffles
//    and the padded row stride (D+1) keeps column reads conflict-free;
//  - causal: tiles wholly past the query tile are never loaded;
//  - ragged tails are masked (query rows >= Lq are computed but not
//    stored, key columns >= Lk are masked), so any L works, unlike the
//    TPU kernel's 128-alignment gate.
// Bound on the H100 at the serving shapes (H=32, D=128, L<=1024): the
// score and PV products run on CUDA cores here, so this first version
// is bound by shared-memory traffic and FMA issue rather than by the
// ~32 MB per layer it must move; tensor-core tiles are later work.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // query rows per CTA
constexpr int BN = 64;   // key columns per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;
constexpr int RI = BM / TY;  // rows per thread
constexpr int CJ = BN / TX;  // score columns per thread

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BM) * (D + 1) + 2 * size_t(BN) * (D + 1) +
                          size_t(BM) * (BN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, int causal,
                     float scale) {
  constexpr int SD = D + 1;
  constexpr int SP = BN + 1;
  constexpr int DJ = D / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * SD;
  float* sV = sK + BN * SD;
  float* sP = sV + BN * SD;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const size_t bh = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const T* qb = q + bh * Lq * D;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;

  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, c = idx % D, row = m0 + r;
    sQ[r * SD + c] = row < Lq ? mxt::to_f32(qb[size_t(row) * D + c]) : 0.f;
  }

  float m_i[RI], l_i[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_i[i] = mxt::kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // causal: key columns past the tile's last row are masked for every
  // row of the tile, so those tiles are skipped outright
  const int n_end = causal ? min(Lk, m0 + BM) : Lk;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's reads of sK/sV/sP are done
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int r = idx / D, c = idx % D, col = n0 + r;
      const bool in = col < Lk;
      sK[r * SD + c] = in ? mxt::to_f32(kb[size_t(col) * D + c]) : 0.f;
      sV[r * SD + c] = in ? mxt::to_f32(vb[size_t(col) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + TY * i) * SD + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sK[(tx + TX * j) * SD + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = m0 + ty + TY * i;
      bool ok[CJ];
      float mx = mxt::kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = n0 + tx + TX * j;
        ok[j] = col < Lk && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * scale : mxt::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        // select, not multiply: a masked column contributes exactly 0
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += p;
        sP[(ty + TY * i) * SP + tx + TX * j] = mxt::round_to<T>(p);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_i[i] = l_i[i] * alpha + ps;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty + TY * i) * SP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = sV[kk * SD + tx + TX * jj];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = m0 + ty + TY * i;
    if (row >= Lq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    T* orow = o + (bh * Lq + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      orow[tx + TX * jj] = mxt::from_f32<T>(acc[i][jj] / denom);
    if (tx == 0) lse[bh * Lq + row] = m_i[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int lq, int lk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((lq + BM - 1) / BM, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      lq, lk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, L, d) contiguous in dtype (0 = f32, 1 = bf16);
// lse: (bh, lq) f32.  d must be 64 or 128.  Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int lq, int lk,
                                   int d, int dtype, int causal, float scale,
                                   int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (dtype == mxt::kF32 && d == 64)
    return launch<float, 64>(q, k, v, o, lse, bh, lq, lk, causal, scale, s);
  if (dtype == mxt::kF32 && d == 128)
    return launch<float, 128>(q, k, v, o, lse, bh, lq, lk, causal, scale, s);
  if (dtype == mxt::kBF16 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, lq, lk, causal,
                                     scale, s);
  if (dtype == mxt::kBF16 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, lq, lk, causal,
                                      scale, s);
  return cudaErrorInvalidValue;
}
