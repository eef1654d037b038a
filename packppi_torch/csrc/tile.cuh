// Shared pieces of the packppi_torch kernels: the tile's sizes, the element
// types, the rounding to the compute type, the activation and a warp sum. Every
// product of every kernel runs on tensor cores (message_tc.cuh,
// chain_wgmma.cuh, chain_mma.cuh, mma.cuh); rounding operands to bf16 and
// summing in float32 is exactly "bf16 operands, f32 accumulate".
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace packppi {

// The network's widths, chosen when the library is built (ops/_build.py
// lib_name): -DPACKPPI_H=, -DPACKPPI_HE=, -DPACKPPI_P= (no flag: 128, 128,
// 8), one library per (source, activation, widths). The neighbour count K
// is a launch argument.
#ifndef PACKPPI_H
#define PACKPPI_H 128
#endif
#ifndef PACKPPI_HE
#define PACKPPI_HE 128
#endif
#ifndef PACKPPI_P
#define PACKPPI_P 8
#endif

constexpr int kThreads = 256;     // the float32 tensor-core kernels' block
constexpr int kRows = 64;         // edge rows of a message tile
constexpr int kH = PACKPPI_H;     // hidden width H of the IPMP node stream and messages
constexpr int kHe = PACKPPI_HE;   // width He of the edge stream h_E
constexpr int kP = PACKPPI_P;     // points a node
static_assert(kH % 32 == 0 && kH >= 32 && kH <= 256, "H: a multiple of 32 from 32 to 256");
static_assert(kHe % 32 == 0 && kHe >= 32 && kHe <= 256, "He: a multiple of 32 from 32 to 256");
static_assert(kP >= 1 && kP <= 16, "P: 1 to 16 points");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
// 128-byte swizzled panels of 64 bf16 k a row needed for a depth of k
__host__ __device__ constexpr int panels64(int k) { return (k + 63) / 64; }
// k-steps of 16 of panel p (64 k each) inside a depth of k
__host__ __device__ constexpr int ksteps16(int k, int p) { return cmin(4, (k - 64 * p) / 16); }

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

// The message and chain MLPs' activation, chosen when the library is built:
// -DPACKPPI_ACT=n picks entry n of ops/_build.py ACTS (no flag: relu), one
// library per activation, so a body carries no switch. Each is jax.nn's
// function with its constants (gelu in its tanh form), in float32 with the
// accurate expf / expm1f / tanhf, and each passes a NaN on.
#define PACKPPI_ACT_RELU 0
#define PACKPPI_ACT_GELU 1
#define PACKPPI_ACT_ELU 2
#define PACKPPI_ACT_SELU 3
#define PACKPPI_ACT_CELU 4
#define PACKPPI_ACT_LEAKY_RELU 5
#define PACKPPI_ACT_SILU 6
#define PACKPPI_ACT_SIGMOID 7
#ifndef PACKPPI_ACT
#define PACKPPI_ACT PACKPPI_ACT_RELU
#endif

__device__ __forceinline__ float act(float v) {
#if PACKPPI_ACT == PACKPPI_ACT_RELU
  // max(v, 0) that passes a NaN on (fmaxf would return 0 and hide a
  // non-finite input from the loss)
  return v < 0.f ? 0.f : v;
#elif PACKPPI_ACT == PACKPPI_ACT_GELU
  const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v))));
  return v * cdf;
#elif PACKPPI_ACT == PACKPPI_ACT_ELU
  return v > 0.f ? v : expm1f(v);
#elif PACKPPI_ACT == PACKPPI_ACT_SELU
  return 1.0507009873554805f * (v > 0.f ? v : 1.6732632423543772f * expm1f(v));
#elif PACKPPI_ACT == PACKPPI_ACT_CELU
  // max(v, 0) + expm1(min(v, 0)) with alpha 1
  return v > 0.f ? v : expm1f(v);
#elif PACKPPI_ACT == PACKPPI_ACT_LEAKY_RELU
  return v >= 0.f ? v : 0.01f * v;
#elif PACKPPI_ACT == PACKPPI_ACT_SILU
  return v * (1.f / (1.f + expf(-v)));
#elif PACKPPI_ACT == PACKPPI_ACT_SIGMOID
  return 1.f / (1.f + expf(-v));
#else
#error "PACKPPI_ACT names no activation of ops/_build.py ACTS"
#endif
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
