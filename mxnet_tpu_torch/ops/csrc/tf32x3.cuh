// 3xTF32 products on Hopper's tensor cores through warp-level mma.sync,
// for the f32 flash-attention kernels.
//
// Each f32 operand x is split into two TF32 values, big = tf32(x) and
// small = tf32(x - big), and a product is taken as small*big + big*small
// + big*big into one f32 accumulator.  Only small*small (about 2^-22 of
// the product) is dropped, so the result is close to an f32 product.
// This is CUTLASS's OpMultiplyAddFastF32, with the small terms issued
// first.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: a warp computes a
// 16x8 D += A (16x8) B (8x8).  With g = lane / 4 and t = lane % 4, each
// lane holds (PTX ISA, the m16n8k8 .tf32 fragment figures):
//   A: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)     [row, k]
//   B: (t, g), (t + 4, g)                                 [k, col]
//   C: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) [row, col]
// A C fragment holds columns 2t and 2t + 1 where an A fragment wants k =
// t and t + 4.  The k order of a product is free as long as A and B
// agree, so a C fragment becomes an A fragment in registers when k slot
// t stands for column 2t and slot t + 4 for column 2t + 1 (acc_to_a),
// and the B operand is read in the same permuted row order (load_b_kn).
//
// Operands come from row-major f32 tiles in shared memory whose row
// stride is D + 4 words (kStride): a lane's address then falls in bank
// 4g + t for load_a and load_b_nk, and 8t + g (+4) for load_b_kn, so no
// fragment load has a bank conflict.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mxt {
namespace tf32x3 {

// row stride, in floats, of a staged tile of D columns
template <int D>
constexpr int kStride = D + 4;

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// x rounded to TF32, nearest with ties away from zero: the magnitude gets
// half of the 13 dropped bits' unit and those bits are cleared.  Equal
// to cvt.rna.tf32.f32 for every finite x (a carry moves into the
// exponent as it should); cvt.rna adds a NaN/Inf guard, which doubles
// its SASS (FSETP, VIADD, LOP3, SEL) where this is VIADD, LOP3.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in about f32 accuracy: the small terms first, then big*big
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// A = rows r0..r0+15, columns k0..k0+7 of a row-major tile
template <int LD>
__device__ __forceinline__ void load_a(FragA& a, const float* tile, int r0,
                                       int k0, int lane) {
  const float* p = tile + (r0 + lane / 4) * LD + k0 + lane % 4;
  split(p[0], a.big[0], a.small[0]);
  split(p[8 * LD], a.big[1], a.small[1]);
  split(p[4], a.big[2], a.small[2]);
  split(p[8 * LD + 4], a.big[3], a.small[3]);
}

// B = tile^T: k runs along columns k0..k0+7, n along rows n0..n0+7 (the
// keys of S = Q K^T)
template <int LD>
__device__ __forceinline__ void load_b_nk(FragB& b, const float* tile, int n0,
                                          int k0, int lane) {
  const float* p = tile + (n0 + lane / 4) * LD + k0 + lane % 4;
  split(p[0], b.big[0], b.small[0]);
  split(p[4], b.big[1], b.small[1]);
}

// B = tile: k runs down rows k0..k0+7 in acc_to_a's permuted order (slot
// t is row k0 + 2t, slot t + 4 row k0 + 2t + 1), n along columns n0..n0+7
// (V of O += P V)
template <int LD>
__device__ __forceinline__ void load_b_kn(FragB& b, const float* tile, int k0,
                                          int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane % 4)) * LD + n0 + lane / 4;
  split(p[0], b.big[0], b.small[0]);
  split(p[LD], b.big[1], b.small[1]);
}

// an accumulator fragment as the A operand of the next product, k in the
// permuted order of load_b_kn
__device__ __forceinline__ void acc_to_a(FragA& a, const float (&c)[4]) {
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
}

// rows [r0, r0 + R) of a row-major (L, D) f32 matrix into a tile of row
// stride kStride<D>, zero past L, in 16-byte copies by NT threads
template <int R, int D, int NT>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int r0,
                                      int L) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < R * C4; idx += NT) {
    const int r = idx / C4, c = 4 * (idx % C4), row = r0 + r;
    const float4 x =
        row < L ? *reinterpret_cast<const float4*>(src + size_t(row) * D + c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * kStride<D> + c) = x;
  }
}

}  // namespace tf32x3
}  // namespace mxt
