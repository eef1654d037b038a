// The three products of the IPMP message MLP on the float32 FMA units
// (tile.cuh's tile_product) over one tile of kRows edge rows, for
// message.cu's geom route (message_geom_kernel, row 4) alone; every other
// message kernel runs the same function on tensor cores (message_tc.cuh):
//
//   x = relu([h_E | geom] . W_e + b_e + per_i[node] + pj[row])
//   x = relu(x . W_1 + b_1)
//   x = x . W_2 + b_2
//   pool: out[node] = sum_k mask[node,k] x[node,k] / K (float32), else
//   out[row] = x in the stream type.
//
// The caller fills X0 with the tile's [h_E | geom] rows, k-major and rounded
// to the compute type T, and the two per-row tables in shared memory: pjrow
// (row of the neighbour term in `pj`, -1 for a row past the end) and mrow
// (edge mask). W_e is read straight from the reference layout W_in
// [H, H + He + H + 9P] over [h_i | h_E | h_j | geom] by column offset.
#pragma once

#include "tile.cuh"

namespace packppi {

constexpr int kP = 8;        // points per node
constexpr int kG = 9 * kP;   // geometry features per edge
constexpr int kIn = kH + kG; // first product's depth: [h_E | geom]
constexpr int kLdIn = 2 * kH + kIn;  // row stride of W_in
constexpr size_t kMessageSmem =
    sizeof(float) * (size_t(kIn) * kLdx + size_t(kH) * kLdx + size_t(kKc) * kLdw) +
    sizeof(int64_t) * kRows + sizeof(float) * kRows;

// The tile's shared memory, carved from one dynamic allocation.
struct MessageSmem {
  float* X0;       // [kIn][kLdx]  layer-1 input, later layer-3 input
  float* X1;       // [kH][kLdx]   layer-2 input, later the pool tile
  float* Ws;       // [kKc][kLdw]  staged weights
  int64_t* pjrow;  // [kRows] row of the neighbour term, -1 = none
  float* mrow;     // [kRows] edge mask
  __device__ explicit MessageSmem(float* smem) {
    X0 = smem;
    X1 = X0 + kIn * kLdx;
    Ws = X1 + kH * kLdx;
    pjrow = reinterpret_cast<int64_t*>(Ws + kKc * kLdw);
    mrow = reinterpret_cast<float*>(pjrow + kRows);
  }
};

// Layers 1-3 over the tile: leaves x . W_2 (without b_2) of row r0 + i,
// column cg + 32 q in acc[i][q] (tile_product's map). The tile's nodes start
// at node row `node0` (global). Ends without a barrier: other warps may
// still be reading X0. Every thread of the block calls this.
template <typename T>
__device__ __forceinline__ void message_products(const MessageSmem& s, float (&acc)[8][4],
                                                 const float* __restrict__ per_i,
                                                 const T* __restrict__ pj,
                                                 const float* __restrict__ w_in,
                                                 const float* __restrict__ b_in,
                                                 const float* __restrict__ w_mid,
                                                 const float* __restrict__ b_mid,
                                                 const float* __restrict__ w_out, int K,
                                                 int64_t node0) {
  const int tid = threadIdx.x;
  const int cg = tid & 31;
  const int r0 = (tid >> 5) * 8;

  // layer 1: [h_E | geom] . W_e + b_e + per_i + pj, relu
  zero(acc);
  tile_product<T>(acc, s.X0, kIn, w_in + kH, w_in + 2 * kH + kH, kH, kLdIn, s.Ws);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    const int64_t j = s.pjrow[r];
    const int64_t node = node0 + r / K;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cg + 32 * q;
      float v = 0.f;
      if (j >= 0) {
        v = acc[i][q] + b_in[c];
        v += per_i[node * kH + c];
        v += to_f32<T>(pj[j * kH + c]);
        v = relu(v);
      }
      s.X1[c * kLdx + r] = rnd<T>(v);
    }
  }

  // layer 2: relu(x . W_1 + b_1)
  zero(acc);
  tile_product<T>(acc, s.X1, kH, w_mid, w_mid, kH, kH, s.Ws);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cg + 32 * q;
      s.X0[c * kLdx + r0 + i] = rnd<T>(relu(acc[i][q] + b_mid[c]));
    }

  // layer 3: x . W_2
  zero(acc);
  tile_product<T>(acc, s.X0, kH, w_out, w_out, kH, kH, s.Ws);
}

// The node pool of the tile, for its `rows / K` nodes: the fixed-order sum
// over k of mask[n, k] (acc + b_2), divided by K. The masked rows go
// row-major into X1, which layer 3 no longer reads; `out` points at the
// tile's first node, kH floats a node.
__device__ __forceinline__ void pool_tile(const MessageSmem& s, const float (&acc)[8][4],
                                          const float* __restrict__ b_out, float* out,
                                          int K, int rows) {
  const int tid = threadIdx.x;
  const int cg = tid & 31;
  const int r0 = (tid >> 5) * 8;
  float* Y = s.X1;  // [kRows][kLdw]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cg + 32 * q;
      Y[(r0 + i) * kLdw + c] = (acc[i][q] + b_out[c]) * s.mrow[r0 + i];
    }
  __syncthreads();
  const int nodes = rows / K;
  for (int e = tid; e < nodes * kH; e += kThreads) {
    const int n = e / kH, c = e % kH;
    float sum = 0.f;
    for (int k = 0; k < K; ++k) sum += Y[(n * K + k) * kLdw + c];
    out[n * kH + c] = sum / float(K);
  }
}

// `rows` valid edge rows of whole nodes start at edge row `erow0` and node
// row `node0` (both global). Every thread of the block calls this.
template <typename T, bool POOL>
__device__ __forceinline__ void message_mlp(const MessageSmem& s, const float* __restrict__ per_i,
                                            const T* __restrict__ pj,
                                            const float* __restrict__ w_in,
                                            const float* __restrict__ b_in,
                                            const float* __restrict__ w_mid,
                                            const float* __restrict__ b_mid,
                                            const float* __restrict__ w_out,
                                            const float* __restrict__ b_out,
                                            void* __restrict__ out_ptr, int K, int rows,
                                            int64_t erow0, int64_t node0) {
  const int tid = threadIdx.x;
  const int cg = tid & 31;
  const int r0 = (tid >> 5) * 8;
  float acc[8][4];
  message_products<T>(s, acc, per_i, pj, w_in, b_in, w_mid, b_mid, w_out, K, node0);
  if (POOL) {
    pool_tile(s, acc, b_out, static_cast<float*>(out_ptr) + node0 * kH, K, rows);
  } else {
    T* out = static_cast<T*>(out_ptr);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      if (r >= rows) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cg + 32 * q;
        out[(erow0 + r) * kH + c] = from_f32<T>(acc[i][q] + b_out[c]);
      }
    }
  }
}

}  // namespace packppi
