// The residual chain of one IPMP block over one tile of kRows rows, shared
// by chain.cu (the chain alone), message.cu's folded edge pass and layer.cu
// (the whole layer). From the residual sums x0, already in the registers of
// tile_product's map (row r0 + i, column cg + 32 q; r0 = 8 * warp, cg = lane),
// in the stream type T (bf16 or float32, also the compute type):
//   xx = rnd(LN_a(x0))                     LayerNorm in float32
//   h  = rnd(relu(rnd(xx . W1 + b1)))      W1 [512, 128] Linear layout
//   h  = rnd(h . W2 + b2)                  W2 [128, 512]
//   y  = LN_b(xx + h)                      handed to store(row, col, y)
// rnd rounds to T at every point the unfused flax chain rounds; LayerNorm is
// flax's (eps 1e-6, variance mean(x^2) - mean(x)^2 clamped at 0). How x0 is
// formed (which residual is rounded) and what the store does with y (the
// mask, the output type) belong to the caller, because the chain kernel and
// the whole-layer kernels round and mask at different points.
//
// The [64, 512] FFN hidden lives in shared memory 128 columns at a time while
// the second product accumulates in registers. Shared memory: XX and Hs are
// [kH][kLdx] floats each, Ws [kKc][kLdw]; the callers alias them onto memory
// the tile's earlier work is done with.
#pragma once

#include "tile.cuh"

namespace packppi {

constexpr int kF = 4 * kH;  // FFN hidden width
constexpr size_t kChainSmem = sizeof(float) * (2 * size_t(kH) * kLdx + size_t(kKc) * kLdw);

struct ChainWeights {
  const float* lna_w;  // [128]
  const float* lna_b;
  const float* w1;     // [512, 128]
  const float* b1;     // [512]
  const float* w2;     // [128, 512]
  const float* b2;     // [128]
  const float* lnb_w;
  const float* lnb_b;
};

// LayerNorm statistics of one row held 4 values a lane across a warp:
// (mean, 1 / sqrt(var + eps)).
__device__ __forceinline__ float2 ln_stats(const float (&v)[4]) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    s += v[q];
    s2 += v[q] * v[q];
  }
  const float mean = warp_sum(s) / float(kH);
  const float var = fmaxf(warp_sum(s2) / float(kH) - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + 1e-6f));
}

// Bit i of `valid` says whether row 8 * warp + i exists; a missing row is
// zeros in xx and is not stored. Every thread of the block calls this. It
// starts with a barrier, so the caller may alias XX, Hs and Ws onto memory
// other warps were still reading.
template <typename T, typename Store>
__device__ __forceinline__ void chain_rows(float (&x0)[8][4], unsigned valid, float* XX,
                                           float* Hs, float* Ws, const ChainWeights& w,
                                           Store store) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * 8;
  __syncthreads();

  // xx = rnd(LN_a(x0)), k-major into XX (the products' input and the residual)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (valid >> i & 1u) {
      const float2 st = ln_stats(x0[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        v[q] = rnd<T>((x0[i][q] - st.x) * st.y * w.lna_w[c] + w.lna_b[c]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) XX[(lane + 32 * q) * kLdx + r0 + i] = v[q];
  }

  float acc[8][4], acc2[8][4];
  zero(acc2);
  for (int hc = 0; hc < kF / kH; ++hc) {
    // hidden columns hc*128 .. hc*128+127: rnd(relu(rnd(xx . W1 + b1)))
    zero(acc);
    tile_product<T>(acc, XX, kH, w.w1 + size_t(hc) * kH * kH, w.w1, kH, kH, Ws);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        Hs[c * kLdx + r0 + i] = rnd<T>(relu(rnd<T>(acc[i][q] + w.b1[hc * kH + c])));
      }
    // acc2 += h[:, slice] . W2[slice, :]
    tile_product<T>(acc2, Hs, kH, w.w2 + hc * kH, w.w2, kH, kF, Ws);
  }
  __syncthreads();  // every thread is done reading Hs

  // z = xx + rnd(h . W2 + b2), row-major into the Hs tile for LN_b
  float* Z = Hs;  // [kRows][kLdw]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      Z[(r0 + i) * kLdw + c] = XX[c * kLdx + r0 + i] + rnd<T>(acc2[i][q] + w.b2[c]);
    }
  __syncthreads();

  for (int i = 0; i < 8; ++i) {
    if (!(valid >> i & 1u)) continue;
    const int r = r0 + i;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = Z[r * kLdw + lane + 32 * q];
    const float2 st = ln_stats(v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      store(r, c, (v[q] - st.x) * st.y * w.lnb_w[c] + w.lnb_b[c]);
    }
  }
}

}  // namespace packppi
