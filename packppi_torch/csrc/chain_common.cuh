// What the two tensor-core bodies of the residual chain share
// (csrc/chain_wgmma.cuh, bf16; csrc/chain_mma.cuh, float32): the weights,
// the LayerNorm statistics and the first LayerNorm of a tile's rows,
//
//   xx = rnd(LN_a(x0))                     LayerNorm in float32, rounded to T
//
// rnd rounds to the stream type T (the identity for float32); LayerNorm is
// flax's (eps 1e-6, variance mean(x^2) - mean(x)^2 clamped at 0). A row is
// held H / 32 values a lane across one warp (columns lane + 32 q), so every
// caller (chain.cu, the folded edge pass of message.cu, the whole-layer
// passes of layer.cu) reduces a row in the same order and gets the same
// bits from the same x0.
#pragma once

#include "tile.cuh"

namespace packppi {

constexpr int kF = 4 * kH;     // FFN hidden width
constexpr int kLnQ = kH / 32;  // values of a row a lane holds

struct ChainWeights {
  const float* lna_w;  // [H]
  const float* lna_b;
  const float* w1;     // [4H, H]
  const float* b1;     // [4H]
  const float* w2;     // [H, 4H]
  const float* b2;     // [H]
  const float* lnb_w;
  const float* lnb_b;
};

// LayerNorm statistics of one row held kLnQ values a lane across a warp:
// (mean, 1 / sqrt(var + eps)).
__device__ __forceinline__ float2 ln_stats(const float (&v)[kLnQ]) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int q = 0; q < kLnQ; ++q) {
    s += v[q];
    s2 += v[q] * v[q];
  }
  const float mean = warp_sum(s) / float(kH);
  const float var = fmaxf(warp_sum(s2) / float(kH) - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + 1e-6f));
}

// xx = rnd(LN_a(x0)) for the R rows of a tile: warp w of kWarps takes rows
// w, w + kWarps, ...; lane owns columns lane + 32 q. x0(r, c) reads x0 of a
// row r < nvalid (float32, from shared or device memory); rows from nvalid
// on are zeros. put(r, c, v) writes xx and may overwrite the value x0(r, c)
// read (the same lane's).
template <typename T, int R, int kWarps, typename X0, typename Put>
__device__ __forceinline__ void ln_a_rows(const ChainWeights& w, int nvalid, X0 x0, Put put) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += kWarps) {
    float v[kLnQ] = {};
    if (r < nvalid) {
      float x[kLnQ];
#pragma unroll
      for (int q = 0; q < kLnQ; ++q) x[q] = x0(r, lane + 32 * q);
      const float2 st = ln_stats(x);
#pragma unroll
      for (int q = 0; q < kLnQ; ++q) {
        const int c = lane + 32 * q;
        v[q] = rnd<T>((x[q] - st.x) * st.y * w.lna_w[c] + w.lna_b[c]);
      }
    }
#pragma unroll
    for (int q = 0; q < kLnQ; ++q) put(r, lane + 32 * q, v[q]);
  }
}

}  // namespace packppi
