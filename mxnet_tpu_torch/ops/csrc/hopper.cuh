// PTX helpers for Hopper's tensor cores (sm_90a), shared by the bf16
// flash-attention kernels: 16-byte cp.async copies into 128-byte-swizzled
// tiles, wgmma shared-memory descriptors, and the bf16 wgmma products
// with f32 sums in registers.
//
// Tile layout.  A tile of R rows of a row-major (L, D) bf16 matrix, D a
// multiple of 64, is stored as D/64 panels of R rows x 128 bytes (64
// columns); 16-byte chunk c of row r in a panel sits at chunk c ^ (r % 8)
// (the 128-byte swizzle wgmma's descriptors expect), and each panel
// starts on a 1024-byte boundary.  The same tile is read two ways:
//  - K-major (the rows' 64 columns are the product's depth), for Q, K, V
//    and dO as the A or B operand of S = Q K^T, dP = dO V^T;
//  - MN-major (the rows are the depth, the columns the output width),
//    for V, dO, Q and K as the B operand of O = P V, dV = P^T dO,
//    dK = dS^T Q, dQ = dS K, with the transpose bit that 16-bit types
//    allow, so no tile is ever transposed in memory.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace mxt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- copies

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (the
// source is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// order this thread's shared-memory writes before later reads by the
// async proxy (wgmma); issue after cp_async_wait, before the barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk c (of D/8) of row r in an R-row tile
template <int R>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return uint32_t((c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// rows [r0, r0 + R) of a row-major (L, D) bf16 matrix into the R-row tile
// at dst, by NT threads; rows past L are zero-filled
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int r0,
                                          int L, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert((R * CPR) % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int i = 0; i < R * CPR / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / CPR, c = idx % CPR, row = r0 + r;
    const bool ok = row < L;
    cp_async16(dst + tile_offset<R>(r, c),
               src + size_t(ok ? row : 0) * D + c * 8, ok);
  }
}

// ---------------------------------------------------------- descriptors

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), base offset 0, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major operand: rows [row0, row0 + 64 or N) of an R-row tile, depth
// columns [16 kk, 16 kk + 16).  8-row groups are 1024 bytes apart; the
// 16-column step inside a 128-byte row moves the start by 32 bytes (the
// hardware applies the swizzle to the address it computes).
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0,
                                                int kk) {
  return make_desc(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32,
                   16, 1024);
}

// MN-major operand: depth rows [16 kk, 16 kk + 16) of an R-row tile,
// output columns [64 panel, 64 panel + 64).  One 64-column panel per
// instruction, so only the 8-row-group stride (1024 bytes) is used; it
// is written into both offset fields.
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int panel,
                                                 int kk) {
  return make_desc(tile + panel * R * 128 + kk * 16 * 128, 1024, 1024);
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of r across a wgmma
// issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define MXT_ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MXT_ACC32 MXT_ACC8(0), MXT_ACC8(8), MXT_ACC8(16), MXT_ACC8(24)
#define MXT_ACC64 \
  MXT_ACC32, MXT_ACC8(32), MXT_ACC8(40), MXT_ACC8(48), MXT_ACC8(56)
#define MXT_REGS32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define MXT_REGS64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64, f32) = [d +] A (64 x 16) B (16 x 64); A and B K-major in
// shared memory.  Accumulator layout (thread t of the warpgroup, warp
// w = t / 32, lane l): d[j] is row 16 w + l / 4 + 8 ((j / 2) % 2),
// column 8 (j / 4) + 2 (l % 4) + j % 2.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MXT_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MXT_ACC32
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (64 x 128, f32) = [d +] A (64 x 16) B (16 x 128), as wgmma_ss_n64
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MXT_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MXT_ACC64
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B
// MN-major in shared memory.  A's fragment: a[0] = row 16 w + l / 4,
// columns 2 (l % 4) + {0, 1}; a[1] the same columns 8 rows down; a[2],
// a[3] as a[0], a[1] at columns + 8 (the accumulator layout of 16 of
// its columns, so a product's sums feed the next product directly).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MXT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MXT_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

#undef MXT_ACC8
#undef MXT_ACC32
#undef MXT_ACC64
#undef MXT_REGS32
#undef MXT_REGS64

// two f32 as a bf16 pair (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments of 16-column slice kk of a 64 x N accumulator
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], int kk,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

}  // namespace hopper
}  // namespace mxt
