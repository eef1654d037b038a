// IPMP message MLP over precomputed edge features.
//
// Replaces packppi_tpu/ops/pallas_ipmp.py::_fused_kernel (entry
// fused_message, differentiable wrapper fused_message_diff). Same function:
// the neighbour term arrives gathered ([rows, H]) and the point geometry
// arrives computed ([rows, 9P]); the gather and the frame algebra stay in
// PyTorch, where training needs their backward. The TPU kernel pads node
// rows to a multiple of its block for Mosaic; here any number of nodes is
// taken and the last block guards its tail.
//
// Per edge row of one block of whole nodes (kRows = 64 edge rows: 64 / K
// nodes of K edges; from K = 65 on one node a block, its edge rows 64 at a
// time, pooled across them in order), H, He and P the build's:
//   x = act([h_E | geom] . W_e + b_e + per_i[node] + pj[row])
//   x = act(x . W_1 + b_1)
//   x = x . W_2 + b_2
//   pool: out[node] = sum_k mask[node,k] x[node,k] / K (float32), else
//   out[row] = x in the stream type.
// h_E, geom and the two hidden activations are in the compute type (bf16
// or float32) as product operands; sums, biases, per_i and the pj addition
// are float32 (csrc/message_tc.cuh, shared with message.cu's message_kernel).
//
// What bounds it: per edge row 2 * (He + 9P + 2H) * H = 116,736 operations
// on 1,312 bytes of float32 streams (656 in bf16). At the training shape
// (131,072 edge rows) float32 is bound by operations on the tensor cores
// (3xTF32, 165 TFLOP/s float32-accurate: 0.0927 ms), bf16 by bytes (0.0366
// ms). The products run on tensor cores (message_tc.cuh: bf16 on wgmma,
// float32 in 3xTF32 on mma.sync) over a packed copy of the weights; the
// block copies its h_E and geometry rows into shared memory once, by
// asynchronous 16-byte copies, keeps both hidden activations on chip and
// writes the output once.

#include "message_tc.cuh"

namespace packppi {

// SPAN (K > kRows): one node a block, its edge rows kRows at a time
template <typename T, bool POOL, bool SPAN>
__global__ void __launch_bounds__(MessageTc<T>::kThreads, MessageTc<T>::kMinBlocks)
message_feat_kernel(const float* __restrict__ per_i, const T* __restrict__ pj,
                    const T* __restrict__ h_E, const T* __restrict__ geom,
                    const float* __restrict__ mask, const void* __restrict__ wpack,
                    const float* __restrict__ b_in, const float* __restrict__ b_mid,
                    const float* __restrict__ b_out, void* __restrict__ out_ptr, int64_t N,
                    int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MessageTile<T> s(smem_raw);

  const int nb = SPAN ? 1 : kRows / K;               // whole nodes per block
  const int64_t node0 = int64_t(blockIdx.x) * nb;    // first node row of this block
  const int64_t erow0 = node0 * K;                   // first edge row

  message_tc_prefetch(s, wpack);  // the first weight units load while the tile is formed
  if constexpr (!SPAN) {
    const int rows = (N - node0 < nb ? int(N - node0) : nb) * K;  // valid edge rows
    tile_features(s, h_E, geom, mask, erow0, rows);
    message_tc<T, POOL>(s, per_i, pj, wpack, b_in, b_mid, b_out, out_ptr, K, rows, erow0, node0);
  } else {
    for (int k0 = 0; k0 < K; k0 += kRows) {
      if (k0 > 0) message_tc_next_tile(s, wpack);
      const int rows = min(kRows, K - k0);             // valid edge rows of this tile
      tile_features(s, h_E, geom, mask, erow0 + k0, rows);
      message_tc<T, POOL, true>(s, per_i, pj, wpack, b_in, b_mid, b_out, out_ptr, K, rows,
                                erow0 + k0, node0, k0 == 0, k0 + kRows >= K);
    }
  }
}

template <typename T, bool POOL, bool SPAN>
cudaError_t launch(const void* per_i, const void* pj, const void* h_E, const void* geom,
                   const void* mask, const void* wpack, const void* b_in, const void* b_mid,
                   const void* b_out, void* out, int64_t N, int K, cudaStream_t stream) {
  auto kernel = message_feat_kernel<T, POOL, SPAN>;
  constexpr size_t kBytes = MessageTcBytes<T>::kTotal;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kBytes));
  if (err != cudaSuccess) return err;
  const int nb = nodes_per_block(K);
  const int64_t blocks = (N + nb - 1) / nb;
  kernel<<<dim3((unsigned)blocks), MessageTc<T>::kThreads, kBytes, stream>>>(
      static_cast<const float*>(per_i), static_cast<const T*>(pj), static_cast<const T*>(h_E),
      static_cast<const T*>(geom), static_cast<const float*>(mask), wpack,
      static_cast<const float*>(b_in), static_cast<const float*>(b_mid),
      static_cast<const float*>(b_out), out, N, K);
  return cudaGetLastError();
}

}  // namespace packppi

// C entry point (ctypes). N node rows of K edges each. per_i [N,H] f32;
// pj [N*K,H], h_E [N*K,He] and geom [N*K,9P] in the stream type (bf16 if
// bf16 != 0, else f32; h_E and geom 16-byte aligned); mask [N*K] f32; wpack
// the message weights packed for the stream type
// (ops/message_feat.py::pack_message_weights, message_tc.cuh); biases [H]
// f32; out [N,H] f32 (pool) or [N*K,H] in the stream type. H, He and P are
// the build's; any K >= 1. Returns a cudaError_t.
extern "C" int packppi_message_feat(const void* per_i, const void* pj, const void* h_E,
                                    const void* geom, const void* mask, const void* wpack,
                                    const void* b_in, const void* b_mid, const void* b_out,
                                    void* out, long long N, int K, int bf16, int pool,
                                    void* stream) {
  using namespace packppi;
  if (K < 1 || N < 1 || (N + nodes_per_block(K) - 1) / nodes_per_block(K) > 0x7fffffffLL ||
      !wpack)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS per_i, pj, h_E, geom, mask, wpack, b_in, b_mid, b_out, out, int64_t(N), K, st
  cudaError_t err;
  if (K > kRows)
    err = bf16 ? (pool ? launch<__nv_bfloat16, true, true>(PACKPPI_ARGS)
                       : launch<__nv_bfloat16, false, true>(PACKPPI_ARGS))
               : (pool ? launch<float, true, true>(PACKPPI_ARGS)
                       : launch<float, false, true>(PACKPPI_ARGS));
  else if (bf16)
    err = pool ? launch<__nv_bfloat16, true, false>(PACKPPI_ARGS)
               : launch<__nv_bfloat16, false, false>(PACKPPI_ARGS);
  else
    err = pool ? launch<float, true, false>(PACKPPI_ARGS) : launch<float, false, false>(PACKPPI_ARGS);
#undef PACKPPI_ARGS
  return int(err);
}
