// One whole IPMP layer in two passes over precomputed edge features.
//
// Replaces packppi_tpu/ops/pallas_layer.py::_node_kernel and ::_edge_kernel
// (entry fused_ipmp_layer, through _fused_pass). The neighbour term arrives
// gathered and the point geometry computed, as for message_feat.cu; the
// message is message_tc.cuh's tensor-core body and the chain chain.cu's
// (csrc/chain_wgmma.cuh, csrc/chain_mma.cuh). In the stream type T (bf16 or
// float32, also the compute type):
//
//   (H, He and P the build's, csrc/tile.cuh; the edge pass needs He = H)
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
// What bounds it: per edge row 116,736 message operations, plus 262,144 per
// chain row (one per edge row in the edge pass, one per node in the node
// pass), on ~650 bytes of bf16 streams: at T1124 (24,576 edge rows, 768
// nodes) the edge pass is bound by operations on the bf16 tensor cores
// (0.0094 ms), the node pass by bytes (0.0053 ms). Every intermediate stays
// in shared memory; each stream row is read once (h_E twice through L2 in
// the float32 edge pass: product input and residual), the weights stream
// from L2 once a tile, and the output is written once.
//
// Blocking. The edge pass is csrc/message_chain.cuh's edge_chain: 64 edge
// rows a block (64 / K whole nodes), the chain on the same rows, three
// blocks an SM in bf16, one in float32 (64-row chain tiles). The node pass
// pools 64 / K nodes per 64-row message tile, while the chain's products
// take 64 rows (bf16 wgmma) or 16 (float32 chain_mma<16>) a tile: one node
// tile per block would leave the bf16 chain 1/32 full at K = 32, and 64
// nodes a block leave 12 blocks at L = 768 on 132 SMs. So a block owns
// `nodes_per_block` <= 16 nodes (a runtime argument the wrapper chooses):
// its message loops over the 64-row tiles (from K = 65 on, a node's
// ceil(K / 64) tiles one after another, its pool summed across them in
// order), pooling into a [nodes, H] tile in shared memory, then one chain
// runs on it, its other rows zeros. The
// chain's form (KS = 1 in bf16, R = 16 in float32) is fixed, so the result
// does not depend on the blocking or the grid, bit for bit.

#include "message_chain.cuh"

namespace packppi {

// SPAN (K > kRows): each node's edge rows kRows at a time
template <typename T, bool SPAN>
__global__ void __launch_bounds__(MessageTc<T>::kThreads, MessageTc<T>::kMinBlocks)
layer_node_kernel(const T* __restrict__ hv, const float* __restrict__ per_i,
                  const T* __restrict__ pjg, const T* __restrict__ h_E,
                  const T* __restrict__ geom, const float* __restrict__ mask,
                  const float* __restrict__ mask_v, const void* __restrict__ wpack,
                  const float* __restrict__ b_in, const float* __restrict__ b_mid,
                  const float* __restrict__ b_out, ChainWeights cw,
                  const __nv_bfloat16* __restrict__ cpack, T* __restrict__ out, int64_t N, int K,
                  int nodes_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MessageTile<T> s(smem_raw, NodeChain<T>::kTables);
  float* pooled = reinterpret_cast<float*>(s.base + NodeChain<T>::kPooled);  // [kMaxNodes][kH]

  const int64_t n0 = int64_t(blockIdx.x) * nodes_per_block;   // first node of the block
  const int nodes = N - n0 < nodes_per_block ? int(N - n0) : nodes_per_block;
  if constexpr (!SPAN) {
    const int per_tile = kRows / K;                           // whole nodes per message tile
    for (int t0 = 0; t0 < nodes; t0 += per_tile) {
      const int tn = min(per_tile, nodes - t0);
      const int64_t node0 = n0 + t0;
      if (t0 > 0) {
        // the last tile's pool has read its rows; those writes go before the
        // next weight copies into the ring they overlap
        fence_proxy_async();
        __syncthreads();
      }
      message_tc_prefetch(s, wpack, t0 > 0);
      tile_features(s, h_E, geom, mask, node0 * K, tn * K);
      message_tc_pooled(s, per_i, pjg, wpack, b_in, b_mid, b_out, pooled + t0 * kH, K, tn * K,
                        node0, true);
    }
  } else {
    for (int n = 0; n < nodes; ++n)
      for (int k0 = 0; k0 < K; k0 += kRows) {
        if (n > 0 || k0 > 0)
          message_tc_next_tile(s, wpack);
        else
          message_tc_prefetch(s, wpack);
        const int rows = min(kRows, K - k0);
        tile_features(s, h_E, geom, mask, (n0 + n) * K + k0, rows);
        message_tc_pooled<T, true>(s, per_i, pjg, wpack, b_in, b_mid, b_out, pooled + n * kH, K,
                                   rows, n0 + n, true, k0 == 0, k0 + kRows >= K);
      }
  }
  fence_proxy_async();
  __syncthreads();  // pooled is complete; the tile and the ring are free

  auto x0 = [&](int r, int c) {
    return to_f32<T>(hv[(n0 + r) * kH + c]) + rnd<T>(pooled[r * kH + c]);
  };
  auto store = [&](int r, int c, float y0, float y1) {
    const float m = mask_v[n0 + r];
    store_pair(out + (n0 + r) * kH + c, y0 * m, y1 * m);
  };
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    unsigned char* xx = s.base + EdgeChain<T>::kChainAt;
    chain_wgmma_prefetch<1>(xx, cpack);
    chain_wgmma<1>(xx, cw, cpack, nodes, x0, store);
  } else {
    float4 pre[kWPieces];
    fetch_w(pre, cw, 0);
    chain_mma<kMaxNodes>(s.base, pre, cw, nodes, x0, store);
  }
}

template <typename T, bool SPAN>
__global__ void __launch_bounds__(EdgeChain<T>::kThreads, EdgeChain<T>::kMinBlocks)
layer_edge_kernel(const T* __restrict__ h_E, const float* __restrict__ per_i,
                  const T* __restrict__ pjg, const T* __restrict__ geom,
                  const float* __restrict__ mask, const void* __restrict__ wpack,
                  const float* __restrict__ b_in, const float* __restrict__ b_mid,
                  const float* __restrict__ b_out, ChainWeights cw,
                  const __nv_bfloat16* __restrict__ cpack, T* __restrict__ out, int64_t N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MessageTile<T> s(smem_raw, EdgeChain<T>::kTables);
  const int nb = SPAN ? 1 : kRows / K;
  const int64_t node0 = int64_t(blockIdx.x) * nb;
  const int64_t erow0 = node0 * K;

  message_tc_prefetch(s, wpack);  // the first weight units load while the tile is formed
  if constexpr (!SPAN) {
    const int rows = (N - node0 < nb ? int(N - node0) : nb) * K;
    tile_features(s, h_E, geom, mask, erow0, rows);
    edge_chain<T, false>(s, per_i, pjg, h_E, wpack, b_in, b_mid, b_out, cw, cpack, out, K, rows,
                         erow0, node0);
  } else {
    for (int k0 = 0; k0 < K; k0 += kRows) {
      if (k0 > 0) message_tc_next_tile(s, wpack);
      const int rows = min(kRows, K - k0);
      tile_features(s, h_E, geom, mask, erow0 + k0, rows);
      edge_chain<T, false>(s, per_i, pjg, h_E, wpack, b_in, b_mid, b_out, cw, cpack, out, K,
                           rows, erow0 + k0, node0, k0 + kRows < K);
    }
  }
}

ChainWeights chain_weights(const void* lna_w, const void* lna_b, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* lnb_w,
                           const void* lnb_b) {
  return ChainWeights{static_cast<const float*>(lna_w), static_cast<const float*>(lna_b),
                      static_cast<const float*>(w1), static_cast<const float*>(b1),
                      static_cast<const float*>(w2), static_cast<const float*>(b2),
                      static_cast<const float*>(lnb_w), static_cast<const float*>(lnb_b)};
}

template <typename T, bool SPAN>
cudaError_t launch_node(const void* hv, const void* per_i, const void* pjg, const void* h_E,
                        const void* geom, const void* mask, const void* mask_v,
                        const void* wpack, const void* b_in, const void* b_mid,
                        const void* b_out, const ChainWeights& cw, const void* cpack, void* out,
                        int64_t N, int K, int nodes_per_block, cudaStream_t stream) {
  auto kernel = layer_node_kernel<T, SPAN>;
  constexpr size_t kBytes = NodeChain<T>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kBytes));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (N + nodes_per_block - 1) / nodes_per_block;
  kernel<<<dim3((unsigned)blocks), MessageTc<T>::kThreads, kBytes, stream>>>(
      static_cast<const T*>(hv), static_cast<const float*>(per_i), static_cast<const T*>(pjg),
      static_cast<const T*>(h_E), static_cast<const T*>(geom), static_cast<const float*>(mask),
      static_cast<const float*>(mask_v), wpack, static_cast<const float*>(b_in),
      static_cast<const float*>(b_mid), static_cast<const float*>(b_out), cw,
      static_cast<const __nv_bfloat16*>(cpack), static_cast<T*>(out), N, K, nodes_per_block);
  return cudaGetLastError();
}

template <typename T, bool SPAN>
cudaError_t launch_edge(const void* h_E, const void* per_i, const void* pjg, const void* geom,
                        const void* mask, const void* wpack, const void* b_in, const void* b_mid,
                        const void* b_out, const ChainWeights& cw, const void* cpack, void* out,
                        int64_t N, int K, cudaStream_t stream) {
  auto kernel = layer_edge_kernel<T, SPAN>;
  constexpr size_t kBytes = EdgeChain<T>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kBytes));
  if (err != cudaSuccess) return err;
  const int nb = nodes_per_block(K);
  const int64_t blocks = (N + nb - 1) / nb;
  kernel<<<dim3((unsigned)blocks), EdgeChain<T>::kThreads, kBytes, stream>>>(
      static_cast<const T*>(h_E), static_cast<const float*>(per_i), static_cast<const T*>(pjg),
      static_cast<const T*>(geom), static_cast<const float*>(mask), wpack,
      static_cast<const float*>(b_in), static_cast<const float*>(b_mid),
      static_cast<const float*>(b_out), cw, static_cast<const __nv_bfloat16*>(cpack),
      static_cast<T*>(out), N, K);
  return cudaGetLastError();
}

}  // namespace packppi

// C entry points (ctypes), over N node rows of K edges each; each returns a
// cudaError_t. Stream tensors are bf16 if bf16 != 0, else f32: hv [N,H],
// pjg [N*K,H], h_E [N*K,He], geom [N*K,9P] (h_E and geom 16-byte aligned),
// out [N,H] (node) or [N*K,H] (edge). per_i [N,H], mask [N*K], mask_v [N]
// f32. wpack: the message weights packed for the stream type
// (ops/message_feat.py::pack_message_weights), biases [H] f32; chain
// weights: LayerNorm [H], w1 [4H,H], b1 [4H], w2 [H,4H], b2 [H], all f32
// (Linear layout); cpack, for bf16 only, w1 and w2 as the chain kernel's
// bf16 panels (ops/chain.py::pack_chain_weights). Any K >= 1;
// 1 <= nodes_per_block <= 16. The edge pass needs He = H: a build with He
// != H refuses it.
extern "C" int packppi_layer_node(const void* hv, const void* per_i, const void* pjg,
                                  const void* h_E, const void* geom, const void* mask,
                                  const void* mask_v, const void* wpack, const void* b_in,
                                  const void* b_mid, const void* b_out, const void* lna_w,
                                  const void* lna_b, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* lnb_w,
                                  const void* lnb_b, const void* cpack, void* out, long long N,
                                  int K, int nodes_per_block, int bf16, void* stream) {
  using namespace packppi;
  if (K < 1 || N < 1 || nodes_per_block < 1 || nodes_per_block > kMaxNodes ||
      (N + nodes_per_block - 1) / nodes_per_block > 0x7fffffffLL || !wpack || (bf16 && !cpack))
    return int(cudaErrorInvalidValue);
  const ChainWeights cw = chain_weights(lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS hv, per_i, pjg, h_E, geom, mask, mask_v, wpack, b_in, b_mid, b_out, cw, \
                     cpack, out, int64_t(N), K, nodes_per_block, s
  const cudaError_t err =
      K > kRows ? (bf16 ? launch_node<__nv_bfloat16, true>(PACKPPI_ARGS)
                        : launch_node<float, true>(PACKPPI_ARGS))
                : (bf16 ? launch_node<__nv_bfloat16, false>(PACKPPI_ARGS)
                        : launch_node<float, false>(PACKPPI_ARGS));
#undef PACKPPI_ARGS
  return int(err);
}

extern "C" int packppi_layer_edge(const void* h_E, const void* per_i, const void* pjg,
                                  const void* geom, const void* mask, const void* wpack,
                                  const void* b_in, const void* b_mid, const void* b_out,
                                  const void* lna_w, const void* lna_b, const void* w1,
                                  const void* b1, const void* w2, const void* b2,
                                  const void* lnb_w, const void* lnb_b, const void* cpack,
                                  void* out, long long N, int K, int bf16, void* stream) {
  using namespace packppi;
#if PACKPPI_HE != PACKPPI_H
  return int(cudaErrorInvalidValue);
#else
  if (K < 1 || N < 1 || (N + nodes_per_block(K) - 1) / nodes_per_block(K) > 0x7fffffffLL ||
      !wpack || (bf16 && !cpack))
    return int(cudaErrorInvalidValue);
  const ChainWeights cw = chain_weights(lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS h_E, per_i, pjg, geom, mask, wpack, b_in, b_mid, b_out, cw, cpack, out, \
                     int64_t(N), K, s
  const cudaError_t err =
      K > kRows ? (bf16 ? launch_edge<__nv_bfloat16, true>(PACKPPI_ARGS)
                        : launch_edge<float, true>(PACKPPI_ARGS))
                : (bf16 ? launch_edge<__nv_bfloat16, false>(PACKPPI_ARGS)
                        : launch_edge<float, false>(PACKPPI_ARGS));
#undef PACKPPI_ARGS
  return int(err);
#endif
}
