// IPMP message MLP with in-kernel point geometry, in four routes:
//
//   message_kernel<T, POOL, kLanes>    replaces packppi_tpu/ops/pallas_ipmp.py::
//       _geom_lanes_kernel (entry fused_message_geom_lanes);
//   message_kernel<T, POOL, kGather>   replaces ::_geom_gather_kernel (entry
//       fused_message_geom_gather);
//   message_geom_kernel<T, POOL>       replaces ::_geom_fused_kernel (entry
//       fused_message_geom);
//   message_chain_kernel<T>            replaces _geom_lanes_kernel's with_chain
//       branch (the edge pass with the residual chain folded in, behind
//       packppi_tpu/models/ipmp.py::FOLD_EDGE_CHAIN).
//
// Same functions, not the same mechanisms: the TPU kernels' lane-major
// layout, bf16x3 one-hot lane expansion, node-stack transpose and one-hot
// gathers exist for Mosaic. Here a block loads what it needs by index. The
// lanes and gather routes of the TPU (neighbour streams gathered outside,
// or inside by a one-hot product) are both an indexed load on a GPU, so the
// two share one body and differ in their instantiation only (each has its
// own entry point and launch count); the geom route takes the neighbour
// term and global-point planes already gathered ([rows, H] and [rows, 3P]
// f32: global coordinates of O(100 A) stay float32) and computes node i's
// global points from its local planes and frame, as _geom_fused_kernel does.
//
// Per edge (i, j = idx[i, k]) of one block of whole nodes (kRows = 64 edge
// rows: 64 / K nodes of K edges; from K = 65 on one node a block, its edge
// rows 64 at a time, pooled across them in order):
//   geom = [p_i (xyz interleaved, 3P) | |p_i| (P) | R_i^T (pg_j - t_i)
//           (interleaved, 3P) | |.| (P) | |pg_i - pg_j| (P)]     float32
//   x = act([h_E | geom] . W_e + b_e + per_i[i] + per_j[j])
//   x = act(x . W_1 + b_1)
//   x = x . W_2 + b_2
//   pool: out[i] = sum_k mask[i,k] x[i,k] / K (float32), else out[i,k] = x
//   in the stream type; the chain route instead runs the residual chain on
//   the tile's edge rows with the two-kernel boundary's rounding points
//   (m = rnd(rnd(x) * mask), x0 = rnd(h_E + m)) and writes the new h_E
//   (csrc/message_chain.cuh).
// Products take operands rounded to the compute type (bf16 or float32) and
// sum in float32. Every route runs them on tensor cores (csrc/message_tc.cuh:
// bf16 on wgmma, float32 in 3xTF32 on mma.sync) over a packed copy of the
// weights made once per weight version
// (ops/message_feat.py::pack_message_weights), the chain route's chain too
// (csrc/chain_wgmma.cuh over ops/chain.py::pack_chain_weights in bf16,
// csrc/chain_mma.cuh in float32), as chain.cu runs it. The routes differ
// only in how they fill the body's tile: by index (lanes, gather, chain),
// or from the gathered streams (geom).
//
// H, He and P are the build's (csrc/tile.cuh); K is a launch argument.
//
// What bounds it: per edge row 2 * (He + 9P + 2H) * H = 116,736 operations
// (plus 262,144 for the folded chain) on ~512 bytes of stream traffic
// (bf16). On the tensor cores in bf16 that is memory-bound: T1124's 24,576
// edge rows take 0.0042 ms at 3.35 TB/s, 0.0029 ms of operations at 989
// TFLOP/s (the fold: 0.0094 ms of operations). In float32 (3xTF32, 165
// TFLOP/s float32-accurate) operations bind. The design keeps every
// intermediate (the [rows, 9P] geometry, both hidden activations, the
// chain's [rows, 4H] hidden) on chip, reads h_E once (in float32 twice,
// through L2, in the chain route: once as product input, once as the
// residual), writes the output once, and streams the weights from L2 into
// shared memory once a tile; in bf16 three 64-row blocks share an SM, so one
// block's indexed loads and geometry overlap the others' products, the chain
// route included (its chain aliases the message's shared memory).

#include "message_chain.cuh"

namespace packppi {

constexpr int kLanes = 0;   // row 1 of the kernel table (fused_message_geom_lanes)
constexpr int kGather = 1;  // row 5 (fused_message_geom_gather)

// geometry column of feature q (0-8) of point p: [p xyz (3P) | |p| (P) |
// neighbour point in i's frame xyz (3P) | its norm (P) | |pg_i - pg_j| (P)]
__device__ __forceinline__ int geom_column(int p, int q) {
  return q < 3 ? 3 * p + q : q == 3 ? 3 * kP + p : q < 7 ? 4 * kP + 3 * p + q - 4
                                                          : q == 7 ? 7 * kP + p : 8 * kP + p;
}

// The nine geometry features of one (edge, point), in W_e's feature order:
// put(c, v) takes geometry column c (0 .. 9P - 1) and its float32 value.
template <typename Put>
__device__ __forceinline__ void edge_features(Put put, int p, float plx, float ply, float plz,
                                              const float* R, const float* t, float pgx,
                                              float pgy, float pgz, float ngx, float ngy,
                                              float ngz) {
  const float dx = ngx - t[0], dy = ngy - t[1], dz = ngz - t[2];
  // neighbour point in i's frame: R_i^T d (R row-major: R[a * 3 + b])
  const float nlx = R[0] * dx + R[3] * dy + R[6] * dz;
  const float nly = R[1] * dx + R[4] * dy + R[7] * dz;
  const float nlz = R[2] * dx + R[5] * dy + R[8] * dz;
  const float ddx = pgx - ngx, ddy = pgy - ngy, ddz = pgz - ngz;
  const float f[9] = {plx, ply, plz, sqrtf(plx * plx + ply * ply + plz * plz + 1e-8f),
                      nlx, nly, nlz, sqrtf(nlx * nlx + nly * nly + nlz * nlz + 1e-8f),
                      sqrtf(ddx * ddx + ddy * ddy + ddz * ddz + 1e-8f)};
#pragma unroll
  for (int q = 0; q < 9; ++q) put(geom_column(p, q), f[q]);
}

// The indexed-load tile of the lanes, gather and chain routes: mrow, the
// h_E rows (asynchronous 16-byte copies), the geometry of every (row, point)
// from pg rows loaded by index, rounded to T, and pjrow = the neighbour's
// row in the batch's node tables. The block's nodes start at node row
// nrow0 + node0 (nrow0 = b * L); `rows` valid edge rows start at erow0.
template <typename T>
__device__ __forceinline__ void load_indexed_tile_tc(const MessageTile<T>& s,
                                                     const T* __restrict__ h_E,
                                                     const int64_t* __restrict__ idx,
                                                     const float* __restrict__ p_local,
                                                     const float* __restrict__ rot,
                                                     const float* __restrict__ trans,
                                                     const float* __restrict__ pg,
                                                     const float* __restrict__ mask, int K,
                                                     int rows, int64_t erow0, int64_t nrow0,
                                                     int node0) {
  const int tid = threadIdx.x;
  int64_t* jrow = s.pjrow();  // node-local neighbour first, its row in per_j after the geometry
  if (tid < kRows) {
    const bool valid = tid < rows;
    jrow[tid] = valid ? idx[erow0 + tid] : -1;
    s.mrow()[tid] = valid ? mask[erow0 + tid] : 0.f;
  }
  tile_rows<T, kHe>(s, h_E, 0, erow0, rows);
  cp_async_commit();
  tile_zero_pad(s);
  __syncthreads();  // jrow

  for (int e = tid; e < kRows * kP; e += MessageTc<T>::kThreads) {
    const int r = e % kRows, p = e / kRows;
    const int64_t j = jrow[r];
    if (j < 0) {
#pragma unroll
      for (int q = 0; q < 9; ++q) tile_put(s, r, kHe + geom_column(p, q), 0.f);
      continue;
    }
    const int64_t i = nrow0 + node0 + r / K;
    const float* pl = p_local + (i * kP + p) * 3;
    const float* pgi = pg + i * 3 * kP;
    const float* pgj = pg + (nrow0 + j) * 3 * kP;
    edge_features([&](int c, float v) { tile_put(s, r, kHe + c, v); }, p, pl[0], pl[1], pl[2],
                  rot + i * 9, trans + i * 3, pgi[p], pgi[kP + p], pgi[2 * kP + p], pgj[p],
                  pgj[kP + p], pgj[2 * kP + p]);
  }

  __syncthreads();  // every thread has read jrow as a neighbour index
  if (tid < kRows && jrow[tid] >= 0) jrow[tid] += nrow0;
  tile_publish<T>();
}

// SPAN (K > kRows): one node a block, its edge rows kRows at a time
template <typename T, bool POOL, int ROUTE, bool SPAN>
__global__ void __launch_bounds__(MessageTc<T>::kThreads, MessageTc<T>::kMinBlocks)
message_kernel(const float* __restrict__ per_i, const T* __restrict__ per_j,
               const T* __restrict__ h_E, const int64_t* __restrict__ idx,
               const float* __restrict__ p_local, const float* __restrict__ rot,
               const float* __restrict__ trans, const float* __restrict__ pg,
               const float* __restrict__ mask, const void* __restrict__ wpack,
               const float* __restrict__ b_in, const float* __restrict__ b_mid,
               const float* __restrict__ b_out, void* __restrict__ out_ptr, int L, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MessageTile<T> s(smem_raw);
  const int nb = SPAN ? 1 : kRows / K;       // whole nodes per block
  const int node0 = blockIdx.x * nb;
  const int64_t nrow0 = int64_t(blockIdx.y) * L;       // first node row of batch b
  const int64_t erow0 = (nrow0 + node0) * K;           // first global edge row

  message_tc_prefetch(s, wpack);  // the first weight units load while the tile is formed
  if constexpr (!SPAN) {
    const int rows = min(nb, L - node0) * K;           // valid edge rows of this block
    load_indexed_tile_tc<T>(s, h_E, idx, p_local, rot, trans, pg, mask, K, rows, erow0, nrow0,
                            node0);
    message_tc<T, POOL>(s, per_i, per_j, wpack, b_in, b_mid, b_out, out_ptr, K, rows, erow0,
                        nrow0 + node0);
  } else {
    for (int k0 = 0; k0 < K; k0 += kRows) {
      if (k0 > 0) message_tc_next_tile(s, wpack);
      const int rows = min(kRows, K - k0);
      load_indexed_tile_tc<T>(s, h_E, idx, p_local, rot, trans, pg, mask, K, rows, erow0 + k0,
                              nrow0, node0);
      message_tc<T, POOL, true>(s, per_i, per_j, wpack, b_in, b_mid, b_out, out_ptr, K, rows,
                                erow0 + k0, nrow0 + node0, k0 == 0, k0 + kRows >= K);
    }
  }
}

// Row 4's tile: the h_E rows (asynchronous 16-byte copies), pjrow = the
// edge row itself (the neighbour term pjg arrives gathered), mrow, and the
// geometry of every (row, point), rounded to T: node i's global points
// computed from its local planes pl, R and t in the order of
// _geom_fused_kernel:105-107, the neighbour's read from the gathered planes
// ng (float32). The block's nodes start at node row node0 (global, N = B*L
// flattened); `rows` valid edge rows start at erow0.
template <typename T>
__device__ __forceinline__ void load_geom_tile_tc(const MessageTile<T>& s,
                                                  const T* __restrict__ h_E,
                                                  const float* __restrict__ pl,
                                                  const float* __restrict__ ng,
                                                  const float* __restrict__ rot,
                                                  const float* __restrict__ trans,
                                                  const float* __restrict__ mask, int K,
                                                  int rows, int64_t erow0, int64_t node0) {
  const int tid = threadIdx.x;
  if (tid < kRows) {
    const bool valid = tid < rows;
    s.pjrow()[tid] = valid ? erow0 + tid : -1;
    s.mrow()[tid] = valid ? mask[erow0 + tid] : 0.f;
  }
  tile_rows<T, kHe>(s, h_E, 0, erow0, rows);
  cp_async_commit();
  tile_zero_pad(s);

  for (int e = tid; e < kRows * kP; e += MessageTc<T>::kThreads) {
    const int r = e % kRows, p = e / kRows;
    if (r >= rows) {
#pragma unroll
      for (int q = 0; q < 9; ++q) tile_put(s, r, kHe + geom_column(p, q), 0.f);
      continue;
    }
    const int64_t i = node0 + r / K;
    const float* pli = pl + i * 3 * kP;
    const float* R = rot + i * 9;
    const float* t = trans + i * 3;
    const float plx = pli[p], ply = pli[kP + p], plz = pli[2 * kP + p];
    const float pgx = R[0] * plx + R[1] * ply + R[2] * plz + t[0];
    const float pgy = R[3] * plx + R[4] * ply + R[5] * plz + t[1];
    const float pgz = R[6] * plx + R[7] * ply + R[8] * plz + t[2];
    const float* ngj = ng + (erow0 + r) * 3 * kP;
    edge_features([&](int c, float v) { tile_put(s, r, kHe + c, v); }, p, plx, ply, plz, R, t,
                  pgx, pgy, pgz, ngj[p], ngj[kP + p], ngj[2 * kP + p]);
  }
  tile_publish<T>();
}

// Row 4 over N = B*L node rows, flattened: the tile from the gathered
// operands, then the tensor-core body of rows 1 and 5.
template <typename T, bool POOL, bool SPAN>
__global__ void __launch_bounds__(MessageTc<T>::kThreads, MessageTc<T>::kMinBlocks)
message_geom_kernel(const float* __restrict__ per_i, const T* __restrict__ pjg,
                    const T* __restrict__ h_E, const float* __restrict__ pl,
                    const float* __restrict__ ng, const float* __restrict__ rot,
                    const float* __restrict__ trans, const float* __restrict__ mask,
                    const void* __restrict__ wpack, const float* __restrict__ b_in,
                    const float* __restrict__ b_mid, const float* __restrict__ b_out,
                    void* __restrict__ out_ptr, int64_t N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MessageTile<T> s(smem_raw);
  const int nb = SPAN ? 1 : kRows / K;
  const int64_t node0 = int64_t(blockIdx.x) * nb;
  const int64_t erow0 = node0 * K;

  message_tc_prefetch(s, wpack);  // the first weight units load while the tile is formed
  if constexpr (!SPAN) {
    const int rows = (N - node0 < nb ? int(N - node0) : nb) * K;
    load_geom_tile_tc<T>(s, h_E, pl, ng, rot, trans, mask, K, rows, erow0, node0);
    message_tc<T, POOL>(s, per_i, pjg, wpack, b_in, b_mid, b_out, out_ptr, K, rows, erow0,
                        node0);
  } else {
    for (int k0 = 0; k0 < K; k0 += kRows) {
      if (k0 > 0) message_tc_next_tile(s, wpack);
      const int rows = min(kRows, K - k0);
      load_geom_tile_tc<T>(s, h_E, pl, ng, rot, trans, mask, K, rows, erow0 + k0, node0);
      message_tc<T, POOL, true>(s, per_i, pjg, wpack, b_in, b_mid, b_out, out_ptr, K, rows,
                                erow0 + k0, node0, k0 == 0, k0 + kRows >= K);
    }
  }
}

// Row 1b: the lanes route's edge tile and message, then the edge chain on
// the same 64 rows without leaving the block, tile by tile; writes the new
// h_E [B*L*K, H] in T (He = H).
template <typename T, bool SPAN>
__global__ void __launch_bounds__(EdgeChain<T>::kThreads, EdgeChain<T>::kMinBlocks)
message_chain_kernel(const float* __restrict__ per_i, const T* __restrict__ per_j,
                     const T* __restrict__ h_E, const int64_t* __restrict__ idx,
                     const float* __restrict__ p_local, const float* __restrict__ rot,
                     const float* __restrict__ trans, const float* __restrict__ pg,
                     const float* __restrict__ mask, const void* __restrict__ wpack,
                     const float* __restrict__ b_in, const float* __restrict__ b_mid,
                     const float* __restrict__ b_out, ChainWeights cw,
                     const __nv_bfloat16* __restrict__ cpack, T* __restrict__ out, int L, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MessageTile<T> s(smem_raw, EdgeChain<T>::kTables);
  const int nb = SPAN ? 1 : kRows / K;
  const int node0 = blockIdx.x * nb;
  const int64_t nrow0 = int64_t(blockIdx.y) * L;
  const int64_t erow0 = (nrow0 + node0) * K;

  message_tc_prefetch(s, wpack);  // the first weight units load while the tile is formed
  if constexpr (!SPAN) {
    const int rows = min(nb, L - node0) * K;
    load_indexed_tile_tc<T>(s, h_E, idx, p_local, rot, trans, pg, mask, K, rows, erow0, nrow0,
                            node0);
    edge_chain<T, true>(s, per_i, per_j, h_E, wpack, b_in, b_mid, b_out, cw, cpack, out, K,
                        rows, erow0, nrow0 + node0);
  } else {
    for (int k0 = 0; k0 < K; k0 += kRows) {
      if (k0 > 0) message_tc_next_tile(s, wpack);
      const int rows = min(kRows, K - k0);
      load_indexed_tile_tc<T>(s, h_E, idx, p_local, rot, trans, pg, mask, K, rows, erow0 + k0,
                              nrow0, node0);
      edge_chain<T, true>(s, per_i, per_j, h_E, wpack, b_in, b_mid, b_out, cw, cpack, out, K,
                          rows, erow0 + k0, nrow0 + node0, k0 + kRows < K);
    }
  }
}

template <typename T, bool POOL, int ROUTE, bool SPAN>
cudaError_t launch(const void* per_i, const void* per_j, const void* h_E, const void* idx,
                   const void* p_local, const void* rot, const void* trans, const void* pg,
                   const void* mask, const void* wpack, const void* b_in, const void* b_mid,
                   const void* b_out, void* out, int B, int L, int K, cudaStream_t stream) {
  auto kernel = message_kernel<T, POOL, ROUTE, SPAN>;
  constexpr size_t kBytes = MessageTcBytes<T>::kTotal;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kBytes));
  if (err != cudaSuccess) return err;
  const int nb = nodes_per_block(K);
  dim3 grid((L + nb - 1) / nb, B);
  kernel<<<grid, MessageTc<T>::kThreads, kBytes, stream>>>(
      static_cast<const float*>(per_i), static_cast<const T*>(per_j),
      static_cast<const T*>(h_E), static_cast<const int64_t*>(idx),
      static_cast<const float*>(p_local), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(pg),
      static_cast<const float*>(mask), wpack, static_cast<const float*>(b_in),
      static_cast<const float*>(b_mid), static_cast<const float*>(b_out), out, L, K);
  return cudaGetLastError();
}

template <typename T, bool POOL, bool SPAN>
cudaError_t launch_geom(const void* per_i, const void* pjg, const void* h_E, const void* pl,
                        const void* ng, const void* rot, const void* trans, const void* mask,
                        const void* wpack, const void* b_in, const void* b_mid,
                        const void* b_out, void* out, int64_t N, int K, cudaStream_t stream) {
  auto kernel = message_geom_kernel<T, POOL, SPAN>;
  constexpr size_t kBytes = MessageTcBytes<T>::kTotal;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kBytes));
  if (err != cudaSuccess) return err;
  const int nb = nodes_per_block(K);
  const int64_t blocks = (N + nb - 1) / nb;
  kernel<<<dim3((unsigned)blocks), MessageTc<T>::kThreads, kBytes, stream>>>(
      static_cast<const float*>(per_i), static_cast<const T*>(pjg), static_cast<const T*>(h_E),
      static_cast<const float*>(pl), static_cast<const float*>(ng),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(mask), wpack, static_cast<const float*>(b_in),
      static_cast<const float*>(b_mid), static_cast<const float*>(b_out), out, N, K);
  return cudaGetLastError();
}

template <typename T, bool SPAN>
cudaError_t launch_chain(const void* per_i, const void* per_j, const void* h_E, const void* idx,
                         const void* p_local, const void* rot, const void* trans,
                         const void* pg, const void* mask, const void* wpack, const void* b_in,
                         const void* b_mid, const void* b_out, const ChainWeights& cw,
                         const void* cpack, void* out, int B, int L, int K,
                         cudaStream_t stream) {
  auto kernel = message_chain_kernel<T, SPAN>;
  constexpr size_t kBytes = EdgeChain<T>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kBytes));
  if (err != cudaSuccess) return err;
  const int nb = nodes_per_block(K);
  dim3 grid((L + nb - 1) / nb, B);
  kernel<<<grid, EdgeChain<T>::kThreads, kBytes, stream>>>(
      static_cast<const float*>(per_i), static_cast<const T*>(per_j),
      static_cast<const T*>(h_E), static_cast<const int64_t*>(idx),
      static_cast<const float*>(p_local), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(pg),
      static_cast<const float*>(mask), wpack, static_cast<const float*>(b_in),
      static_cast<const float*>(b_mid), static_cast<const float*>(b_out), cw,
      static_cast<const __nv_bfloat16*>(cpack), static_cast<T*>(out), L, K);
  return cudaGetLastError();
}

template <int ROUTE>
int message_entry(const void* per_i, const void* per_j, const void* h_E, const void* idx,
                  const void* p_local, const void* rot, const void* trans, const void* pg,
                  const void* mask, const void* wpack, const void* b_in, const void* b_mid,
                  const void* b_out, void* out, int B, int L, int K, int bf16, int pool,
                  void* stream) {
  if (K < 1 || B < 1 || L < 1 || !wpack) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, wpack, b_in, b_mid, \
                     b_out, out, B, L, K, s
  cudaError_t err;
  if (K > kRows)
    err = bf16 ? (pool ? launch<__nv_bfloat16, true, ROUTE, true>(PACKPPI_ARGS)
                       : launch<__nv_bfloat16, false, ROUTE, true>(PACKPPI_ARGS))
               : (pool ? launch<float, true, ROUTE, true>(PACKPPI_ARGS)
                       : launch<float, false, ROUTE, true>(PACKPPI_ARGS));
  else if (bf16)
    err = pool ? launch<__nv_bfloat16, true, ROUTE, false>(PACKPPI_ARGS)
               : launch<__nv_bfloat16, false, ROUTE, false>(PACKPPI_ARGS);
  else
    err = pool ? launch<float, true, ROUTE, false>(PACKPPI_ARGS)
               : launch<float, false, ROUTE, false>(PACKPPI_ARGS);
#undef PACKPPI_ARGS
  return int(err);
}

}  // namespace packppi

// C entry points (ctypes); each returns a cudaError_t. Stream tensors are
// bf16 if bf16 != 0, else f32. H, He and P are the build's; any K >= 1.
//
// packppi_message (row 1) and packppi_message_gather (row 5): per_i
// [B,L,H] f32; per_j [B,L,H] and h_E [B,L,K,He] in the stream type; idx
// [B,L,K] int64 (node index within the batch row); p_local [B,L,P,3], rot
// [B,L,3,3], trans [B,L,3], pg [B,L,3P], mask [B,L,K] f32; wpack the
// message weights packed for the stream type
// (ops/message_feat.py::pack_message_weights, message_tc.cuh); biases [H]
// f32; out [B,L,H] f32 (pool) or [B,L,K,H] in the stream type.
extern "C" int packppi_message(const void* per_i, const void* per_j, const void* h_E,
                               const void* idx, const void* p_local, const void* rot,
                               const void* trans, const void* pg, const void* mask,
                               const void* wpack, const void* b_in, const void* b_mid,
                               const void* b_out, void* out, int B, int L, int K, int bf16,
                               int pool, void* stream) {
  return packppi::message_entry<packppi::kLanes>(per_i, per_j, h_E, idx, p_local, rot, trans,
                                                  pg, mask, wpack, b_in, b_mid, b_out, out, B, L,
                                                  K, bf16, pool, stream);
}

extern "C" int packppi_message_gather(const void* per_i, const void* per_j, const void* h_E,
                                      const void* idx, const void* p_local, const void* rot,
                                      const void* trans, const void* pg, const void* mask,
                                      const void* wpack, const void* b_in, const void* b_mid,
                                      const void* b_out, void* out, int B, int L, int K,
                                      int bf16, int pool, void* stream) {
  return packppi::message_entry<packppi::kGather>(per_i, per_j, h_E, idx, p_local, rot, trans,
                                                   pg, mask, wpack, b_in, b_mid, b_out, out, B,
                                                   L, K, bf16, pool, stream);
}

// packppi_message_geom (row 4), over N = B*L node rows: per_i [N,H] f32;
// pjg [N*K,H] and h_E [N*K,He] in the stream type; pl [N,3P] local point
// planes [x | y | z], ng [N*K,3P] gathered neighbour global-point planes,
// rot [N,9] (row-major), trans [N,3], mask [N*K] f32; wpack and the biases
// as for packppi_message; out [N,H] f32 (pool) or [N*K,H] in the stream
// type.
extern "C" int packppi_message_geom(const void* per_i, const void* pjg, const void* h_E,
                                    const void* pl, const void* ng, const void* rot,
                                    const void* trans, const void* mask, const void* wpack,
                                    const void* b_in, const void* b_mid, const void* b_out,
                                    void* out, long long N, int K, int bf16, int pool,
                                    void* stream) {
  using namespace packppi;
  if (K < 1 || N < 1 || !wpack ||
      (N + nodes_per_block(K) - 1) / nodes_per_block(K) > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS per_i, pjg, h_E, pl, ng, rot, trans, mask, wpack, b_in, b_mid, b_out, out, \
                     int64_t(N), K, st
  cudaError_t err;
  if (K > kRows)
    err = bf16 ? (pool ? launch_geom<__nv_bfloat16, true, true>(PACKPPI_ARGS)
                       : launch_geom<__nv_bfloat16, false, true>(PACKPPI_ARGS))
               : (pool ? launch_geom<float, true, true>(PACKPPI_ARGS)
                       : launch_geom<float, false, true>(PACKPPI_ARGS));
  else if (bf16)
    err = pool ? launch_geom<__nv_bfloat16, true, false>(PACKPPI_ARGS)
               : launch_geom<__nv_bfloat16, false, false>(PACKPPI_ARGS);
  else
    err = pool ? launch_geom<float, true, false>(PACKPPI_ARGS)
               : launch_geom<float, false, false>(PACKPPI_ARGS);
#undef PACKPPI_ARGS
  return int(err);
}

// packppi_message_chain (row 1b): packppi_message's operands (edge pass,
// the message weights packed as there), then the chain's: LayerNorm weights
// [H], w1 [4H,H], b1 [4H], w2 [H,4H], b2 [H], all f32; cpack,
// for bf16 only, w1 and w2 as the chain kernel's bf16 panels
// (ops/chain.py::pack_chain_weights; the kernel then reads w1 and w2 no
// more); out [B,L,K,H] in the stream type, the updated h_E. The message is
// added to h_E: a build with He != H has no such kernel and refuses.
extern "C" int packppi_message_chain(const void* per_i, const void* per_j, const void* h_E,
                                     const void* idx, const void* p_local, const void* rot,
                                     const void* trans, const void* pg, const void* mask,
                                     const void* wpack, const void* b_in, const void* b_mid,
                                     const void* b_out, const void* lna_w, const void* lna_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* lnb_w, const void* lnb_b,
                                     const void* cpack, void* out, int B, int L, int K, int bf16,
                                     void* stream) {
  using namespace packppi;
#if PACKPPI_HE != PACKPPI_H
  return int(cudaErrorInvalidValue);
#else
  if (K < 1 || B < 1 || L < 1 || !wpack || (bf16 && !cpack)) return int(cudaErrorInvalidValue);
  const ChainWeights cw{static_cast<const float*>(lna_w), static_cast<const float*>(lna_b),
                        static_cast<const float*>(w1), static_cast<const float*>(b1),
                        static_cast<const float*>(w2), static_cast<const float*>(b2),
                        static_cast<const float*>(lnb_w), static_cast<const float*>(lnb_b)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, wpack, b_in, b_mid, \
                     b_out, cw, cpack, out, B, L, K, s
  const cudaError_t err =
      K > kRows ? (bf16 ? launch_chain<__nv_bfloat16, true>(PACKPPI_ARGS)
                        : launch_chain<float, true>(PACKPPI_ARGS))
                : (bf16 ? launch_chain<__nv_bfloat16, false>(PACKPPI_ARGS)
                        : launch_chain<float, false>(PACKPPI_ARGS));
#undef PACKPPI_ARGS
  return int(err);
#endif
}
