// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over (B*H, L, D) without materialising the score matrix.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py
// _pallas_forward (pallas_call at :105).  Same function: f32 scores,
// running max and denominator per query row, p rounded to the value
// dtype before the PV product, output in the input dtype and the
// logsumexp in f32.
//
// Bound on the H100 at the serving shapes (H=32, L=1024, D=128, causal):
// in bf16 the 33 MB it must move take 0.0100 ms at 3.35 TB/s, just above
// its 8.6 GFLOP of score and PV products at 989 TFLOP/s (0.0087 ms); in
// f32 those products take 0.052 ms at 165 TFLOP/s (TF32's 495 over the
// three products of 3xTF32), above the 67 MB's 0.020 ms.  Either way
// only a kernel on the tensor cores gets near the bound.
//
// bf16: flash_fwd_bf16_kernel, on the tensor cores.
//  - one CTA of two warpgroups per (b*h, 128-row query tile), each
//    warpgroup owning 64 rows (wgmma's M); query tiles are scheduled
//    last-first, so the longest causal rows start first;
//  - Q is staged once; K and V tiles of 128 rows go through a two-stage
//    ring of bf16 tiles in the 128-byte swizzle (hopper.cuh), loaded with
//    16-byte cp.async, the next tile's copy in flight while this one
//    computes;
//  - S = Q K^T is a wgmma with both operands in shared memory; the
//    online softmax runs on the accumulator fragments (a row's max and
//    sum across the four threads that share it), in base 2 with the
//    scale folded in; only the diagonal and the ragged last tile mask;
//  - p is rounded to bf16 in registers (the reference's p.astype(v.dtype))
//    and fed back as the register operand of O += P V, V read MN-major
//    through the transpose bit;
//  - rows past Lq are not stored, columns past Lk are masked, and rows of
//    K/V past Lk are zero-filled by the copy, so any L works.
//
// f32: flash_fwd_kernel, on the tensor cores as 3xTF32 mma.sync
// (tf32x3.cuh; wgmma takes TF32 operands only K-major, so V would need a
// transpose in shared memory):
//  - one CTA of four warps per (b*h, 64-row query tile), 16 rows a warp;
//    the sequential KV grid axis of the TPU kernel becomes a loop over
//    64-row K/V tiles staged in shared memory as f32 (row stride D + 4,
//    so every fragment load is free of bank conflicts); query tiles are
//    scheduled last-first, as in bf16;
//  - S = Q K^T is m16n8k8 products with each operand split into a big
//    and a small TF32 part as it is loaded (three products each, about
//    f32 accuracy); the online softmax runs on the accumulator fragments
//    in natural base, as the reference's;
//  - p stays in registers: its fragment is the A operand of O += P V,
//    with V's rows read in the matching permuted order;
//  - causal: tiles wholly past the query tile are never loaded; only the
//    diagonal and the ragged last tile mask; rows past Lq are not stored.
//
// Offset form (both kernels, the OFS instantiations; q_start non-null):
// the serving engine's chunked prefill attends a chunk of C queries that
// start at an absolute position per row to that row's whole cached
// context.  Query i of row bh sees key j when j <= q_start[bh] + i, the
// reference's chunk attention (mxnet_tpu/serving/engine.py, attend): the
// causal mask shifted by the row's start.  Key tiles wholly past a query
// tile's last visible key are skipped as in the causal form; the tile
// order stays last-first, although with offsets every tile is long.  With
// a null q_start the OFS = false instantiations are the causal and
// non-causal kernels above, unchanged.
#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

namespace x3 = mxt::tf32x3;

constexpr int BM = 64;   // query rows per CTA, 16 per warp
constexpr int BN = 64;   // key rows per K/V tile
constexpr int NT = 128;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * size_t(BM + 2 * BN) * x3::kStride<D>;
}

template <int D, bool OFS>
__global__ void __launch_bounds__(NT, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse,
                     const int* __restrict__ q_start, int Lq, int Lk,
                     int causal, float scale) {
  constexpr int SD = x3::kStride<D>;
  constexpr int ND = D / 8;  // 8-column blocks of the output
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * SD;
  float* sV = sK + BN * SD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const size_t bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  const float* kb = k + bh * Lk * D;
  const float* vb = v + bh * Lk * D;
  // OFS: query row i of this bh sits at absolute position qs + i and sees
  // keys j <= qs + i (the offset-causal mask); else qs = 0
  const int qs = OFS ? q_start[bh] : 0;
  const bool cz = OFS || causal;

  x3::stage<BM, D, NT>(sQ, q + bh * Lq * D, m0, Lq);

  // this lane's rows: row0 and row0 + 8 of its warp's 16
  const int r0 = 16 * warp;
  const int row0 = m0 + r0 + lane / 4;
  float m_r[2] = {mxt::kNegInf, mxt::kNegInf};
  float l_r[2] = {0.f, 0.f};  // this lane's share of the row sums
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // causal: key rows past the tile's last query row are masked for every
  // row of the tile, so those tiles are skipped outright
  const int n_end = cz ? min(Lk, qs + m0 + BM) : Lk;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    x3::stage<BN, D, NT>(sK, kb, n0, Lk);
    x3::stage<BN, D, NT>(sV, vb, n0, Lk);
    __syncthreads();

    // S = Q K^T: s[j][e] is row row0 + 8 (e / 2), key n0 + 8 j + 2 tig
    // + e % 2
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      x3::FragA a;
      x3::load_a<SD>(a, sQ, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        x3::FragB b;
        x3::load_b_nk<SD>(b, sK, 8 * j, kk, lane);
        x3::mma3(s[j], a, b);
      }
    }

    const bool mask = n0 + BN > Lk || (cz && n0 + BN - 1 > qs + m0 + r0);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (mask) {
          const int col = n0 + 8 * j + 2 * tig + e % 2;
          const int row = row0 + 8 * (e / 2);
          if (col >= Lk || (cz && col > qs + row)) x = mxt::kNegInf;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // select, not multiply: a masked column contributes exactly 0
        const float p = mask && s[j][e] == mxt::kNegInf
                            ? 0.f
                            : expf(s[j][e] - mx[e / 2]);
        l_r[e / 2] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e / 2];

    // O += P V, p from registers, V's rows in the permuted k order
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      x3::FragA a;
      x3::acc_to_a(a, s[j]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        x3::FragB b;
        x3::load_b_kn<SD>(b, sV, 8 * j, 8 * nd, lane);
        x3::mma3(acc[nd], a, b);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const int row = row0 + 8 * i;
    if (row >= Lq) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);
    float* orow = o + (bh * Lq + row) * D + 2 * tig;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(orow + 8 * nd) = make_float2(
          acc[nd][2 * i] / denom, acc[nd][2 * i + 1] / denom);
    if (tig == 0) lse[bh * Lq + row] = m_r[i] + logf(denom);
  }
}

template <int D, bool OFS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const int* q_start, int bh, int lq, int lk,
                   int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, OFS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (lq + BM - 1) / BM);
  flash_fwd_kernel<D, OFS><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), q_start, lq, lk, causal, scale);
  return cudaGetLastError();
}


// ------------------------------------------------------------------ bf16

namespace tc {

using bf16 = __nv_bfloat16;
namespace hw = mxt::hopper;

constexpr int BM = 128;  // query rows per CTA: two warpgroups of 64
constexpr int BN = 128;  // key rows per K/V tile
constexpr int NT = 256;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: the Q tile, then two stages of a K and a V tile, and
// room to align the start to 1024 bytes
template <int D>
struct Smem {
  static constexpr int kTile = BN * D * 2;  // one K or V tile, bytes
  static constexpr int kKV = BM * D * 2;    // stage s: K, then V
  static constexpr int kAlloc = kKV + 4 * kTile + 1024;
};

template <int D, bool OFS>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse,
                          const int* __restrict__ q_start, int Lq, int Lk,
                          int causal, float scale) {
  constexpr int P = D / 64;  // 64-column panels of the output
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hw::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const size_t bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  const bf16* qb = q + bh * Lq * D;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  // OFS: query row i sits at absolute position qs + i (as in the f32
  // kernel); else qs = 0
  const int qs = OFS ? q_start[bh] : 0;
  const bool cz = OFS || causal;

  const int n_end = cz ? min(Lk, qs + m0 + BM) : Lk;
  const int n_tiles = (n_end + BN - 1) / BN;

  hw::load_tile<BM, D, NT>(sQ, qb, m0, Lq, tid);
  hw::load_tile<BN, D, NT>(base + S::kKV, kb, 0, Lk, tid);
  hw::load_tile<BN, D, NT>(base + S::kKV + S::kTile, vb, 0, Lk, tid);
  hw::cp_async_commit();

  // this thread's rows: r[0] and r[0] + 8 of its warpgroup's 64
  const int row0 = m0 + 64 * wg + 16 * warp + lane / 4;
  const int wg_first = m0 + 64 * wg;
  const float sl2 = scale * kLog2e;  // scores in base-2 units
  float m_r[2] = {mxt::kNegInf, mxt::kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[p][j] = 0.f;
  float s[64];

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed and every warp is done with tile t - 1, whose
    // stage the next copy overwrites
    hw::cp_async_wait<0>();
    hw::fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const uint32_t nxt = base + S::kKV + ((t + 1) & 1) * 2 * S::kTile;
      hw::load_tile<BN, D, NT>(nxt, kb, (t + 1) * BN, Lk, tid);
      hw::load_tile<BN, D, NT>(nxt + S::kTile, vb, (t + 1) * BN, Lk, tid);
      hw::cp_async_commit();
    }
    const uint32_t sK = base + S::kKV + (t & 1) * 2 * S::kTile;
    const uint32_t sV = sK + S::kTile;
    const int n0 = t * BN;

    // S = Q K^T
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss_n128(s, hw::desc_kmajor<BM>(sQ, 64 * wg, kk),
                        hw::desc_kmajor<BN>(sK, 0, kk), kk > 0);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);

    // online softmax on the fragments: s[4 c + e] is row row0 + 8 (e / 2),
    // column n0 + 8 c + 2 (lane % 4) + e % 2
    const bool mask = n0 + BN > Lk || (cz && n0 + BN - 1 > qs + wg_first);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      float x = s[j] * sl2;
      if (mask) {
        const int col = n0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
        const int row = row0 + 8 * ((j / 2) % 2);
        if (col >= Lk || (cz && col > qs + row)) x = mxt::kNegInf;
      }
      s[j] = x;
      mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int i = (j / 2) % 2;
      // select, not multiply: a masked column contributes exactly 0
      const float p =
          mask && s[j] == mxt::kNegInf ? 0.f : exp2f(s[j] - mx[i]);
      l_r[i] += p;
      s[j] = p;
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[p][j] *= alpha[(j / 2) % 2];

    // O += P V, p rounded to bf16 as the register operand
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      hw::acc_to_a(s, kk, a);
#pragma unroll
      for (int p = 0; p < P; ++p)
        hw::wgmma_rs_n64(acc[p], a, hw::desc_mnmajor<BN>(sV, p, kk));
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) hw::fence_regs(acc[p]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const int row = row0 + 8 * i;
    if (row >= Lq) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);
    const float inv = 1.f / denom;
    bf16* orow = o + (bh * Lq + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(
            acc[p][4 * c + 2 * i] * inv, acc[p][4 * c + 2 * i + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * p + 8 * c) = pair;
      }
    if (lane % 4 == 0)
      lse[bh * Lq + row] = m_r[i] * 0.6931471805599453f + logf(denom);
  }
}

template <int D, bool OFS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const int* q_start, int bh, int lq, int lk,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, OFS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (lq + BM - 1) / BM);
  flash_fwd_bf16_kernel<D, OFS><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), q_start, lq, lk, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <int D, bool OFS>
cudaError_t dispatch(int dtype, const void* q, const void* k, const void* v,
                     void* o, void* lse, const int* q_start, int bh, int lq,
                     int lk, int causal, float scale, cudaStream_t s) {
  if (dtype == mxt::kF32)
    return launch<D, OFS>(q, k, v, o, lse, q_start, bh, lq, lk, causal,
                          scale, s);
  if (dtype == mxt::kBF16)
    return tc::launch<D, OFS>(q, k, v, o, lse, q_start, bh, lq, lk, causal,
                              scale, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t dispatch(int dtype, const void* q, const void* k, const void* v,
                     void* o, void* lse, const int* q_start, int bh, int lq,
                     int lk, int causal, float scale, cudaStream_t s) {
  return q_start ? dispatch<D, true>(dtype, q, k, v, o, lse, q_start, bh, lq,
                                     lk, causal, scale, s)
                 : dispatch<D, false>(dtype, q, k, v, o, lse, q_start, bh,
                                      lq, lk, causal, scale, s);
}

}  // namespace

// q, k, v, o: (bh, L, d) contiguous in dtype (0 = f32, 1 = bf16), bf16
// base pointers 16-byte aligned; lse: (bh, lq) f32.  q_start: null, or
// (bh,) int32 on the device, the absolute position of each row's query 0
// (query i of row bh then sees keys j <= q_start[bh] + i, whatever
// causal says; the chunked prefill's offset-causal mask).  d must be 64
// or 128.  Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const int* q_start,
                                   int bh, int lq, int lk, int d, int dtype,
                                   int causal, float scale, int device,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return dev_err;
  if (d == 64)
    return dispatch<64>(dtype, q, k, v, o, lse, q_start, bh, lq, lk, causal,
                        scale, s);
  if (d == 128)
    return dispatch<128>(dtype, q, k, v, o, lse, q_start, bh, lq, lk, causal,
                         scale, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory, in bytes, that the forward's launch asks for at
// (dtype, d); 0 for a pair it does not take.
extern "C" int flash_attention_fwd_smem(int dtype, int d) {
  if (dtype == mxt::kF32 && d == 64) return int(smem_bytes<64>());
  if (dtype == mxt::kF32 && d == 128) return int(smem_bytes<128>());
  if (dtype == mxt::kBF16 && d == 64) return tc::Smem<64>::kAlloc;
  if (dtype == mxt::kBF16 && d == 128) return tc::Smem<128>::kAlloc;
  return 0;
}
