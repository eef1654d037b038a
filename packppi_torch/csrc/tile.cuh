// Shared pieces of the packppi_torch kernels: the tile's sizes, the element
// types, the rounding to the compute type, relu and a warp sum. Every
// product of every kernel runs on tensor cores (message_tc.cuh,
// chain_wgmma.cuh, chain_mma.cuh, mma.cuh); rounding operands to bf16 and
// summing in float32 is exactly "bf16 operands, f32 accumulate".
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace packppi {

constexpr int kThreads = 256;     // the float32 tensor-core kernels' block
constexpr int kRows = 64;         // edge rows of a message tile
constexpr int kH = 128;           // hidden width of the IPMP streams (== He)

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace packppi

extern "C" const char* packppi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
