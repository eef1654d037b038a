// One whole IPMP layer in two passes over precomputed edge features.
//
// Replaces packppi_tpu/ops/pallas_layer.py::_node_kernel and ::_edge_kernel
// (entry fused_ipmp_layer, through _fused_pass). The neighbour term arrives
// gathered and the point geometry computed, as for message_feat.cu; the
// products are message_mlp.cuh's and the chain is chain_rows.cuh's. In the
// stream type T (bf16 or float32, also the compute type):
//
//   node pass, per node i (out [N, H]):
//     m   = the message of each of i's K edges (float32), * mask
//     x0  = h_V[i] + rnd(sum_k m * (1/K))      the residual sum NOT rounded
//     out = LN_b(xx + FFN(xx)) * mask_V[i]     xx = rnd(LN_a(x0)), as chain.cu
//   edge pass, per edge row e (out [N*K, H]):
//     x0  = h_E[e] + rnd(message[e] * mask[e])  masked in float32, sum NOT rounded
//     out = LN_b(xx + FFN(xx)) * mask[e]
//
// These are the TPU kernel's own rounding points (pallas_layer.py:331-341 and
// 360-371), not chain.cu's: the chain kernel rounds the residual sum
// (x0 = rnd(x + rnd(m))). In bf16 the whole-layer network therefore differs
// from the message-then-chain network by up to one ulp per layer input, as
// it does in the JAX package.
//
// Blocking. The edge pass owns 64 edge rows a block (64 / K whole nodes) and
// runs the chain on the same 64 rows. The node pass pools 64 / K nodes per
// 64-row message tile, while the chain's products want 64 rows: one node
// tile per block would leave the chain 1/32 full at K = 32, and 64 nodes a
// block leave 12 blocks at L = 768 on 132 SMs. So a block owns
// `nodes_per_block` <= 16 nodes (a runtime argument the wrapper chooses):
// its message loops over the 64-row tiles into a pooled [nodes, H] tile in
// shared memory, then one chain runs on it. At T1124 (L = 768, K = 32, bf16)
// 4 nodes a block (192 blocks) ran fastest: 0.3658 ms, against 0.5566 /
// 0.4546 / 0.7405 ms with 2 / 8 / 16 (chip_smoke.py, H100 80GB HBM3, 700 W).
// The result does not depend on the blocking, bit for bit.
//
// What bounds it: per edge row 116,736 message operations (plus 262,144 per
// chain row: one per edge row in the edge pass, one per node in the node
// pass) on ~650 bytes of bf16 streams, so on tensor cores memory would bound
// it; on the float32 FMA units this first version uses, operations do.
// Every intermediate stays in shared memory; each stream row is read once
// (h_E twice through L2 in the edge pass: product input and residual) and
// the output written once.

#include "chain_rows.cuh"
#include "message_mlp.cuh"

namespace packppi {

constexpr int kMaxNodes = 16;  // nodes per block of the node pass, at most
constexpr size_t kLayerNodeSmem = kMessageSmem + sizeof(float) * kMaxNodes * kH;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
layer_node_kernel(const T* __restrict__ hv, const float* __restrict__ per_i,
                  const T* __restrict__ pjg, const T* __restrict__ h_E,
                  const T* __restrict__ geom, const float* __restrict__ mask,
                  const float* __restrict__ mask_v, const float* __restrict__ w_in,
                  const float* __restrict__ b_in, const float* __restrict__ w_mid,
                  const float* __restrict__ b_mid, const float* __restrict__ w_out,
                  const float* __restrict__ b_out, ChainWeights cw, T* __restrict__ out,
                  int64_t N, int K, int nodes_per_block) {
  extern __shared__ __align__(16) float smem[];
  const MessageSmem s(smem);
  float* pooled = smem + kMessageSmem / sizeof(float);  // [kMaxNodes][kH]

  const int64_t n0 = int64_t(blockIdx.x) * nodes_per_block;   // first node of the block
  const int nodes = N - n0 < nodes_per_block ? int(N - n0) : nodes_per_block;
  const int per_tile = kRows / K;                             // whole nodes per message tile
  for (int t0 = 0; t0 < nodes; t0 += per_tile) {
    const int tn = min(per_tile, nodes - t0);
    const int64_t node0 = n0 + t0;
    __syncthreads();  // the previous tile is done with X0, X1, pjrow and mrow
    load_feature_tile<T>(s, h_E, geom, mask, node0 * K, tn * K);
    float acc[8][4];
    message_products<T>(s, acc, per_i, pjg, w_in, b_in, w_mid, b_mid, w_out, K, node0);
    pool_tile(s, acc, b_out, pooled + t0 * kH, K, tn * K, true);
  }
  __syncthreads();  // pooled

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float x0[8][4];
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    if (r < nodes) valid |= 1u << i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      x0[i][q] = r < nodes ? to_f32<T>(hv[(n0 + r) * kH + c]) + rnd<T>(pooled[r * kH + c]) : 0.f;
    }
  }
  chain_rows<T>(x0, valid, s.X0, s.X1, s.Ws, cw, [&](int r, int c, float y) {
    out[(n0 + r) * kH + c] = from_f32<T>(y * mask_v[n0 + r]);
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
layer_edge_kernel(const T* __restrict__ h_E, const float* __restrict__ per_i,
                  const T* __restrict__ pjg, const T* __restrict__ geom,
                  const float* __restrict__ mask, const float* __restrict__ w_in,
                  const float* __restrict__ b_in, const float* __restrict__ w_mid,
                  const float* __restrict__ b_mid, const float* __restrict__ w_out,
                  const float* __restrict__ b_out, ChainWeights cw, T* __restrict__ out,
                  int64_t N, int K) {
  extern __shared__ __align__(16) float smem[];
  const MessageSmem s(smem);
  const int nb = kRows / K;
  const int64_t node0 = int64_t(blockIdx.x) * nb;
  const int rows = (N - node0 < nb ? int(N - node0) : nb) * K;
  const int64_t erow0 = node0 * K;

  load_feature_tile<T>(s, h_E, geom, mask, erow0, rows);
  float acc[8][4];
  message_products<T>(s, acc, per_i, pjg, w_in, b_in, w_mid, b_mid, w_out, K, node0);

  const int cg = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    if (r < rows) valid |= 1u << i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cg + 32 * q;
      acc[i][q] = r < rows ? to_f32<T>(h_E[(erow0 + r) * kH + c])
                                 + rnd<T>((acc[i][q] + b_out[c]) * s.mrow[r])
                           : 0.f;
    }
  }
  // the chain's tiles alias the message's; its first barrier waits for
  // layer 3's last reads of X0
  chain_rows<T>(acc, valid, s.X0, s.X1, s.Ws, cw, [&](int r, int c, float y) {
    out[(erow0 + r) * kH + c] = from_f32<T>(y * s.mrow[r]);
  });
}

ChainWeights chain_weights(const void* lna_w, const void* lna_b, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* lnb_w,
                           const void* lnb_b) {
  return ChainWeights{static_cast<const float*>(lna_w), static_cast<const float*>(lna_b),
                      static_cast<const float*>(w1), static_cast<const float*>(b1),
                      static_cast<const float*>(w2), static_cast<const float*>(b2),
                      static_cast<const float*>(lnb_w), static_cast<const float*>(lnb_b)};
}

template <typename T>
cudaError_t launch_node(const void* hv, const void* per_i, const void* pjg, const void* h_E,
                        const void* geom, const void* mask, const void* mask_v,
                        const void* w_in, const void* b_in, const void* w_mid,
                        const void* b_mid, const void* w_out, const void* b_out,
                        const ChainWeights& cw, void* out, int64_t N, int K,
                        int nodes_per_block, cudaStream_t stream) {
  auto kernel = layer_node_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kLayerNodeSmem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (N + nodes_per_block - 1) / nodes_per_block;
  kernel<<<dim3((unsigned)blocks), kThreads, kLayerNodeSmem, stream>>>(
      static_cast<const T*>(hv), static_cast<const float*>(per_i), static_cast<const T*>(pjg),
      static_cast<const T*>(h_E), static_cast<const T*>(geom), static_cast<const float*>(mask),
      static_cast<const float*>(mask_v), static_cast<const float*>(w_in),
      static_cast<const float*>(b_in), static_cast<const float*>(w_mid),
      static_cast<const float*>(b_mid), static_cast<const float*>(w_out),
      static_cast<const float*>(b_out), cw, static_cast<T*>(out), N, K, nodes_per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_edge(const void* h_E, const void* per_i, const void* pjg, const void* geom,
                        const void* mask, const void* w_in, const void* b_in,
                        const void* w_mid, const void* b_mid, const void* w_out,
                        const void* b_out, const ChainWeights& cw, void* out, int64_t N, int K,
                        cudaStream_t stream) {
  auto kernel = layer_edge_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kMessageSmem));
  if (err != cudaSuccess) return err;
  const int nb = kRows / K;
  const int64_t blocks = (N + nb - 1) / nb;
  kernel<<<dim3((unsigned)blocks), kThreads, kMessageSmem, stream>>>(
      static_cast<const T*>(h_E), static_cast<const float*>(per_i), static_cast<const T*>(pjg),
      static_cast<const T*>(geom), static_cast<const float*>(mask),
      static_cast<const float*>(w_in), static_cast<const float*>(b_in),
      static_cast<const float*>(w_mid), static_cast<const float*>(b_mid),
      static_cast<const float*>(w_out), static_cast<const float*>(b_out), cw,
      static_cast<T*>(out), N, K);
  return cudaGetLastError();
}

}  // namespace packppi

// C entry points (ctypes), over N node rows of K edges each; each returns a
// cudaError_t. Stream tensors are bf16 if bf16 != 0, else f32: hv [N,128],
// pjg, h_E [N*K,128], geom [N*K,72], out [N,128] (node) or [N*K,128]
// (edge). per_i [N,128], mask [N*K], mask_v [N] f32. Message weights w_in
// [128,456], w_mid/w_out [128,128], biases [128]; chain weights: LayerNorm
// [128], w1 [512,128], b1 [512], w2 [128,512], b2 [128]; all f32 (Linear
// layout). K <= 64; 1 <= nodes_per_block <= 16.
extern "C" int packppi_layer_node(const void* hv, const void* per_i, const void* pjg,
                                  const void* h_E, const void* geom, const void* mask,
                                  const void* mask_v, const void* w_in, const void* b_in,
                                  const void* w_mid, const void* b_mid, const void* w_out,
                                  const void* b_out, const void* lna_w, const void* lna_b,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, const void* lnb_w, const void* lnb_b,
                                  void* out, long long N, int K, int nodes_per_block, int bf16,
                                  void* stream) {
  using namespace packppi;
  if (K < 1 || K > kRows || N < 1 || nodes_per_block < 1 || nodes_per_block > kMaxNodes ||
      (N + nodes_per_block - 1) / nodes_per_block > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const ChainWeights cw = chain_weights(lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS hv, per_i, pjg, h_E, geom, mask, mask_v, w_in, b_in, w_mid, b_mid, w_out, \
                     b_out, cw, out, int64_t(N), K, nodes_per_block, s
  const cudaError_t err = bf16 ? launch_node<__nv_bfloat16>(PACKPPI_ARGS)
                               : launch_node<float>(PACKPPI_ARGS);
#undef PACKPPI_ARGS
  return int(err);
}

extern "C" int packppi_layer_edge(const void* h_E, const void* per_i, const void* pjg,
                                  const void* geom, const void* mask, const void* w_in,
                                  const void* b_in, const void* w_mid, const void* b_mid,
                                  const void* w_out, const void* b_out, const void* lna_w,
                                  const void* lna_b, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* lnb_w,
                                  const void* lnb_b, void* out, long long N, int K, int bf16,
                                  void* stream) {
  using namespace packppi;
  if (K < 1 || K > kRows || N < 1 || (N + kRows / K - 1) / (kRows / K) > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const ChainWeights cw = chain_weights(lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS h_E, per_i, pjg, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out, cw, \
                     out, int64_t(N), K, s
  const cudaError_t err = bf16 ? launch_edge<__nv_bfloat16>(PACKPPI_ARGS)
                               : launch_edge<float>(PACKPPI_ARGS);
#undef PACKPPI_ARGS
  return int(err);
}
