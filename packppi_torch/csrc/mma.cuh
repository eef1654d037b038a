// Tensor-core building blocks shared by the attention kernel and the chain
// kernel: warp-level mma.sync products, warpgroup wgmma products over
// shared-memory descriptors, ldmatrix fragment loads, cp.async copies and
// the 3xTF32 split that gives float32-accurate products on the TF32 tensor
// cores.
//
// Fragment layouts (PTX ISA, per warp; g = lane / 4, t = lane % 4):
//   m16n8k16 bf16  A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//                  a2 (g, 2t+8..2t+9), a3 (g+8, 2t+8..); two bf16 a register,
//                  the lower column in the low half.
//                  B (16x8): b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g).
//   m16n8k8 tf32   A (16x8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
//                  B (8x8): b0 (k t, n g), b1 (k t+4, n g).
//   both           C/D (16x8 float32): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                  c3 (g+8, 2t+1).
//
// 3xTF32: x = hi + lo, hi = x rounded to TF32 (10 mantissa bits) and lo =
// x - hi (exact in float32) rounded to TF32 in turn, so x is kept to about
// 22 bits without bias. A product a.b is summed as hi_a.hi_b + lo_a.hi_b +
// hi_a.lo_b in float32; the dropped lo_a.lo_b is about 2^-22 of a.b. TF32
// products are exact in the float32 accumulator; short partials join the
// running sum with round-to-nearest adds (mma_3xtf32).
// tests/test_torch_tf32x3.py holds this arithmetic to the JAX package's
// float32 kernels, and plain TF32 (hi.hi alone) as a control that must fail
// the same limits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace packppi {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i receives matrix i in the A/B fragment layout above
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same with each matrix transposed (B fragments from a k-major tile)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b, m16n8k16, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, m16n8k8, tf32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo. hi is x rounded to the nearest TF32 by Veltkamp's split:
// with t = (2^13 + 1) x, t - (t - x) keeps x's top 11 significant bits,
// rounded (the _rn intrinsics keep the compiler from fusing the steps);
// three float instructions, where cvt.rna.tf32 compiles to a dozen. lo =
// x - hi is exact and is rounded to the nearest TF32 on its bits (half of
// the 13 dropped bits' range added to the magnitude, then the bits
// cleared), so x is kept to about 22 bits with no bias. Cut toward zero
// instead, every operand would shrink by about 2^-21 on average and the
// dropped lo.lo term grow fourfold; on the card that moved a bias gradient
// of the chain by 5.3e-4 of its max, over the limit of 5e-4. A NaN or inf
// in x leaves hi non-finite, so it passes on.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float t = __fmul_rn(8193.f, x);
  const float h = __fsub_rn(t, __fsub_rn(t, x));
  hi = __float_as_uint(h);
  lo = (__float_as_uint(__fsub_rn(x, h)) + 0x1000u) & 0xffffe000u;
}

// d += a . b in 3xTF32 (the large product first). The tensor core rounds
// each sum toward zero, so a long sum kept in its accumulator drifts toward
// zero by about half an ulp a step; kept over the chain's 192 steps, that
// moved a bias gradient by 9.3e-4 of its max on the card (limit 5e-4).
// Callers therefore sum a short span of k (one key tile, one weight chunk)
// from zero with this and add that partial to the running sum with an
// ordinary, round-to-nearest add.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, a_hi, bh0, bh1);
  mma_tf32(d, a_lo, bh0, bh1);
  mma_tf32(d, a_hi, bl0, bl1);
}

// wgmma (sm_90a): one warpgroup of 4 warps computes a [64, N] product, B
// (and A, or A's fragments from registers) from shared memory; warp w of
// the group owns rows 16 w .. 16 w + 15 of D in the m16n8 C/D layout above,
// repeated over the N / 8 column tiles: d[4 j + i] is c_i of the tile of
// columns 8 j .. 8 j + 7.

// the shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 64 bf16 (128 bytes), 16-byte piece p of row r stored at piece p ^
// (r % 8), 8-row groups 1,024 bytes apart, the tile 1,024-byte aligned. A
// k-step of 16 inside the 64 starts 32 bytes further on.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return uint64_t((saddr & 0x3ffffu) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// byte offset of element (r, k) (k < 64) in such a tile of 2-byte elements
__device__ __forceinline__ uint32_t sw128_offset(int r, int k) {
  return uint32_t(r) * 128u + ((uint32_t((k >> 3) ^ (r & 7))) << 4) + (uint32_t(k & 7) << 1);
}

// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through; then a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

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

// d += a . b, m64n128k16, bf16 operands from shared memory (both K-major),
// float32 sums
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += a . b, m64n128k16, bf16 operands, A from registers (per warp the
// m16n8k16 A fragment of its 16 rows), B from shared memory (K-major),
// float32 sums
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a . b, m64n32k16, bf16 operands from shared memory (both K-major),
// float32 sums
__device__ __forceinline__ void wgmma_m64n32k16_bf16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d += a . b, m64n32k16, A from registers, B from shared memory (K-major)
__device__ __forceinline__ void wgmma_m64n32k16_bf16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a . b, m64n64k16, bf16 operands from shared memory (both K-major),
// float32 sums
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += a . b, m64n64k16, A from registers, B from shared memory (K-major)
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a . b over a [64, N] product (N a multiple of 32, at most 256) in
// column pieces of 128, 64 and 32, each one wgmma: its accumulator is the
// piece's registers of d (d[4 j + i] is c_i of column tile j whatever the
// split) and its B the piece's rows of the K-major B tile (128 bytes a
// row, so a piece of c0 columns on starts c0 * 128 bytes further; the
// 128-byte swizzle repeats every 8 rows). a_s / b_s: shared-memory
// addresses of the tiles' k-step (both in the 128-byte swizzle).
template <int N, int C0 = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint32_t a_s, uint32_t b_s) {
  static_assert(N % 32 == 0 && N <= 256, "wgmma N");
  constexpr int kRest = N - C0;
  if constexpr (kRest >= 128) {
    wgmma_m64n128k16_bf16(*reinterpret_cast<float(*)[64]>(&d[C0 / 2]), sw128_desc(a_s),
                          sw128_desc(b_s + C0 * 128));
    wgmma_bf16<N, C0 + 128>(d, a_s, b_s);
  } else if constexpr (kRest >= 64) {
    wgmma_m64n64k16_bf16(*reinterpret_cast<float(*)[32]>(&d[C0 / 2]), sw128_desc(a_s),
                         sw128_desc(b_s + C0 * 128));
    wgmma_bf16<N, C0 + 64>(d, a_s, b_s);
  } else if constexpr (kRest >= 32) {
    wgmma_m64n32k16_bf16(*reinterpret_cast<float(*)[16]>(&d[C0 / 2]), sw128_desc(a_s),
                         sw128_desc(b_s + C0 * 128));
  }
}

// the same with A from registers (per warp the m16n8k16 A fragment of its
// 16 rows)
template <int N, int C0 = 0>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint32_t b_s) {
  static_assert(N % 32 == 0 && N <= 256, "wgmma N");
  constexpr int kRest = N - C0;
  if constexpr (kRest >= 128) {
    wgmma_m64n128k16_bf16_rs(*reinterpret_cast<float(*)[64]>(&d[C0 / 2]), a,
                             sw128_desc(b_s + C0 * 128));
    wgmma_bf16_rs<N, C0 + 128>(d, a, b_s);
  } else if constexpr (kRest >= 64) {
    wgmma_m64n64k16_bf16_rs(*reinterpret_cast<float(*)[32]>(&d[C0 / 2]), a,
                            sw128_desc(b_s + C0 * 128));
    wgmma_bf16_rs<N, C0 + 64>(d, a, b_s);
  } else if constexpr (kRest >= 32) {
    wgmma_m64n32k16_bf16_rs(*reinterpret_cast<float(*)[16]>(&d[C0 / 2]), a,
                            sw128_desc(b_s + C0 * 128));
  }
}

// mbarriers and bulk copies by the TMA unit (sm_90): a copy writes shared
// memory through the async proxy, so wgmma reads it with no proxy fence,
// and it completes on an mbarrier that counts its bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// an mbarrier whose phases have all completed, made ready for mbar_init again
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival on bar that also expects `bytes` of copies to complete on it
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// two floats rounded to bf16 (nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the sum over the four lanes of a quad (the lanes that hold one row of an
// accumulator fragment); every lane of the quad gets the same value
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes global -> shared, asynchronous; zeros when !valid (src is then
// not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace packppi
