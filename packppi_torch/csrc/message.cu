// IPMP message MLP with in-kernel point geometry.
//
// Replaces packppi_tpu/ops/pallas_ipmp.py::_geom_lanes_kernel (entry
// fused_message_geom_lanes). Same function, not the same mechanism: the
// TPU kernel's lane-major layout, bf16x3 one-hot lane expansion and
// node-stack transpose exist for Mosaic; here each block loads its own
// neighbour rows by index.
//
// Per edge (i, j = idx[i, k]) of one block of whole nodes (kRows = 64 edge
// rows: 64 / K nodes of K edges):
//   geom = [p_i (xyz interleaved, 3P) | |p_i| (P) | R_i^T (pg_j - t_i)
//           (interleaved, 3P) | |.| (P) | |pg_i - pg_j| (P)]     float32
//   x = relu([h_E | geom] . W_e + b_e + per_i[i] + per_j[j])
//   x = relu(x . W_1 + b_1)
//   x = x . W_2 + b_2
//   pool: out[i] = sum_k mask[i,k] x[i,k] / K (float32), else out[i,k] = x
//   in the stream type.
// Products take operands rounded to the compute type (bf16 or float32) and
// sum in float32 FMAs (tile.cuh). W_e is read straight from the reference
// layout W_in [H, H + He + H + 9P] over [h_i | h_E | h_j | geom].
//
// What bounds it: per edge row it does 2 * (He + 9P + 2H) * H = 116,736
// operations on ~512 bytes of stream traffic (bf16), so on Hopper's tensor
// cores it would be bound by memory; this first version runs its products
// on the float32 FMA units (67 TFLOP/s peak), which bound it instead. The
// design keeps every intermediate (the [rows, 9P] geometry, both hidden
// activations) in shared memory, reads h_E once and writes the output
// once, and reads the weights through L2 into shared memory per block.
// Tensor-core products (wgmma) are the next step.

#include "message_mlp.cuh"

namespace packppi {

template <typename T, bool POOL>
__global__ void __launch_bounds__(kThreads, 2)
message_kernel(const float* __restrict__ per_i, const T* __restrict__ per_j,
               const T* __restrict__ h_E, const int64_t* __restrict__ idx,
               const float* __restrict__ p_local, const float* __restrict__ rot,
               const float* __restrict__ trans, const float* __restrict__ pg,
               const float* __restrict__ mask, const float* __restrict__ w_in,
               const float* __restrict__ b_in, const float* __restrict__ w_mid,
               const float* __restrict__ b_mid, const float* __restrict__ w_out,
               const float* __restrict__ b_out, void* __restrict__ out_ptr, int L, int K) {
  extern __shared__ __align__(16) float smem[];
  const MessageSmem s(smem);
  float* X0 = s.X0;
  int64_t* jrow = s.pjrow;  // node-local neighbour first, its row in per_j after the geometry

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int nb = kRows / K;                  // whole nodes per block
  const int node0 = blockIdx.x * nb;
  const int rows = min(nb, L - node0) * K;   // valid edge rows of this block
  const int64_t erow0 = (int64_t(b) * L + node0) * K;  // first global edge row
  const int64_t nrow0 = int64_t(b) * L;                // first node row of batch b

  if (tid < kRows) {
    const bool valid = tid < rows;
    jrow[tid] = valid ? idx[erow0 + tid] : -1;
    s.mrow[tid] = valid ? mask[erow0 + tid] : 0.f;
  }
  // h_E rows, k-major, rounded to the compute type (a no-op for the stream type)
  for (int e = tid; e < kRows * kH; e += kThreads) {
    const int r = e / kH, c = e % kH;
    const float v = r < rows ? to_f32<T>(h_E[(erow0 + r) * kH + c]) : 0.f;
    X0[c * kLdx + r] = rnd<T>(v);
  }
  __syncthreads();  // jrow

  // the 9P geometry features of every (row, point)
  for (int e = tid; e < kRows * kP; e += kThreads) {
    const int r = e % kRows, p = e / kRows;
    const int64_t j = jrow[r];
    float f[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j >= 0) {
      const int64_t i = nrow0 + node0 + r / K;
      const float* pl = p_local + (i * kP + p) * 3;
      const float* R = rot + i * 9;
      const float* t = trans + i * 3;
      const float* pgi = pg + i * 3 * kP;
      const float* pgj = pg + (nrow0 + j) * 3 * kP;
      const float plx = pl[0], ply = pl[1], plz = pl[2];
      const float ngx = pgj[p], ngy = pgj[kP + p], ngz = pgj[2 * kP + p];
      const float dx = ngx - t[0], dy = ngy - t[1], dz = ngz - t[2];
      // neighbour point in i's frame: R_i^T d (R row-major: R[a * 3 + b])
      const float nlx = R[0] * dx + R[3] * dy + R[6] * dz;
      const float nly = R[1] * dx + R[4] * dy + R[7] * dz;
      const float nlz = R[2] * dx + R[5] * dy + R[8] * dz;
      const float ddx = pgi[p] - ngx, ddy = pgi[kP + p] - ngy, ddz = pgi[2 * kP + p] - ngz;
      f[0] = plx; f[1] = ply; f[2] = plz;
      f[3] = sqrtf(plx * plx + ply * ply + plz * plz + 1e-8f);
      f[4] = nlx; f[5] = nly; f[6] = nlz;
      f[7] = sqrtf(nlx * nlx + nly * nly + nlz * nlz + 1e-8f);
      f[8] = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz + 1e-8f);
    }
    // feature order of W_e's geometry rows
    const int at[9] = {3 * p, 3 * p + 1, 3 * p + 2, 3 * kP + p,
                       4 * kP + 3 * p, 4 * kP + 3 * p + 1, 4 * kP + 3 * p + 2,
                       7 * kP + p, 8 * kP + p};
#pragma unroll
    for (int q = 0; q < 9; ++q) X0[(kH + at[q]) * kLdx + r] = rnd<T>(f[q]);
  }

  __syncthreads();  // every thread has read jrow as a neighbour index
  if (tid < kRows && jrow[tid] >= 0) jrow[tid] += nrow0;
  // the three products; message_mlp's first barrier publishes X0 and jrow
  message_mlp<T, POOL>(s, per_i, per_j, w_in, b_in, w_mid, b_mid, w_out, b_out, out_ptr, K, rows,
                       erow0, nrow0 + node0);
}

template <typename T, bool POOL>
cudaError_t launch(const void* per_i, const void* per_j, const void* h_E, const void* idx,
                   const void* p_local, const void* rot, const void* trans, const void* pg,
                   const void* mask, const void* w_in, const void* b_in, const void* w_mid,
                   const void* b_mid, const void* w_out, const void* b_out, void* out, int B,
                   int L, int K, cudaStream_t stream) {
  auto kernel = message_kernel<T, POOL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kMessageSmem));
  if (err != cudaSuccess) return err;
  const int nb = kRows / K;
  dim3 grid((L + nb - 1) / nb, B);
  kernel<<<grid, kThreads, kMessageSmem, stream>>>(
      static_cast<const float*>(per_i), static_cast<const T*>(per_j),
      static_cast<const T*>(h_E), static_cast<const int64_t*>(idx),
      static_cast<const float*>(p_local), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(pg),
      static_cast<const float*>(mask), static_cast<const float*>(w_in),
      static_cast<const float*>(b_in), static_cast<const float*>(w_mid),
      static_cast<const float*>(b_mid), static_cast<const float*>(w_out),
      static_cast<const float*>(b_out), out, L, K);
  return cudaGetLastError();
}

}  // namespace packppi

// C entry point (ctypes). Shapes: per_i [B,L,128] f32; per_j [B,L,128] and
// h_E [B,L,K,128] in the stream type (bf16 if bf16 != 0, else f32); idx
// [B,L,K] int64; p_local [B,L,8,3], rot [B,L,3,3], trans [B,L,3], pg
// [B,L,24], mask [B,L,K] f32; w_in [128,456], w_mid/w_out [128,128] f32
// (Linear layout), biases [128] f32; out [B,L,128] f32 (pool) or
// [B,L,K,128] in the stream type. K <= 64. Returns a cudaError_t.
extern "C" int packppi_message(const void* per_i, const void* per_j, const void* h_E,
                               const void* idx, const void* p_local, const void* rot,
                               const void* trans, const void* pg, const void* mask,
                               const void* w_in, const void* b_in, const void* w_mid,
                               const void* b_mid, const void* w_out, const void* b_out,
                               void* out, int B, int L, int K, int bf16, int pool,
                               void* stream) {
  using namespace packppi;
  if (K < 1 || K > kRows || B < 1 || L < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, w_in, b_in, \
                     w_mid, b_mid, w_out, b_out, out, B, L, K, s
  cudaError_t err;
  if (bf16)
    err = pool ? launch<__nv_bfloat16, true>(PACKPPI_ARGS) : launch<__nv_bfloat16, false>(PACKPPI_ARGS);
  else
    err = pool ? launch<float, true>(PACKPPI_ARGS) : launch<float, false>(PACKPPI_ARGS);
#undef PACKPPI_ARGS
  return int(err);
}
