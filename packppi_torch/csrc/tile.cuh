// Shared pieces of the packppi_torch kernels: the element types, the
// rounding to the compute type, and one block-level product on the float32
// FMA units
//
//     acc[rows][cols] += X[rows][0:kdim] . W[0:kdim][cols]
//
// over a tile of kRows = 64 rows and kCols = 128 output columns, computed
// with float32 FMAs by 256 threads. X lives in shared memory k-major
// (X[k * kLdx + row]) so that each thread reads its 8 rows as two float4
// broadcasts; W is read from device memory in PyTorch's Linear layout
// (W[col * ldw + k]) and staged through shared memory kKc rows of k at a
// time, rounded to the compute type on the way in. Operands rounded to
// bf16 and summed in float32 are exactly "bf16 operands, f32 accumulate".
//
// Each thread owns rows r0..r0+7 (r0 = 8 * warp) and columns
// cg, cg+32, cg+64, cg+96 (cg = lane): the weight reads of a warp are 32
// consecutive floats (no bank conflicts) and the activation reads are
// warp-wide broadcasts.
//
// tile_product is the FMA body that remains, for row 4 alone:
// message_mlp.cuh's message_products, pool_tile and message_mlp, which
// message.cu's message_geom_kernel runs. Every other kernel's products run
// on tensor cores (message_tc.cuh, chain_wgmma.cuh, chain_mma.cuh, mma.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace packppi {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kCols = 128;
constexpr int kH = kCols;         // hidden width of the IPMP streams (== He)
constexpr int kLdx = kRows + 4;   // k-major activation stride: float4-aligned rows
constexpr int kKc = 32;           // weight rows of k staged per chunk
constexpr int kLdw = kCols + 1;   // staged weight stride: conflict-free transposing stores

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round to T (round to nearest even) and back; the identity for float
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// max(v, 0) that passes a NaN on, as the plain versions' relu does (fmaxf
// would return 0 and hide a non-finite input from the loss)
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// acc[i][j] += sum_{k < kdim} X[k * kLdx + r0 + i] * W(k, cg + 32 j), where
// W(k, c) = w0[c * ldw + k] for k < k_split and w1[c * ldw + k - k_split]
// beyond (two column blocks of one Linear weight). T is the compute type.
// Starts with a barrier, so writes to X made before the call are visible;
// Ws is kKc * kLdw floats of shared memory.
template <typename T>
__device__ __forceinline__ void tile_product(float (&acc)[8][4], const float* X, int kdim,
                                             const float* __restrict__ w0,
                                             const float* __restrict__ w1, int k_split,
                                             int ldw, float* Ws) {
  const int tid = threadIdx.x;
  const int cg = tid & 31;
  const int r0 = (tid >> 5) * 8;
  for (int k0 = 0; k0 < kdim; k0 += kKc) {
    __syncthreads();  // the previous chunk is consumed, X is written
    for (int e = tid; e < kKc * kCols; e += kThreads) {
      const int kk = e & (kKc - 1);
      const int c = e / kKc;
      const int k = k0 + kk;
      float w = 0.f;
      if (k < kdim) w = k < k_split ? __ldg(w0 + c * ldw + k) : __ldg(w1 + c * ldw + (k - k_split));
      Ws[kk * kLdw + c] = rnd<T>(w);
    }
    __syncthreads();
    const int kn = min(kKc, kdim - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(X + (k0 + kk) * kLdx + r0);
      const float4 a1 = *reinterpret_cast<const float4*>(X + (k0 + kk) * kLdx + r0 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float* wr = Ws + kk * kLdw + cg;
      const float w[4] = {wr[0], wr[32], wr[64], wr[96]};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace packppi

extern "C" const char* packppi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
