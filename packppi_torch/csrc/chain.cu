// Post-message residual chain of one IPMP block.
//
// Replaces packppi_tpu/ops/pallas_layer.py::_chain_kernel (entry
// fused_chain). Over flat rows [N, 128] in the stream type T (bf16 or
// float32, also the compute type of the FFN products):
//   [m = msg * mask]                       (pre_mask: edge chains)
//   x0 = rnd(x + rnd(m))                   residual add in T
//   xx = rnd(LN_a(x0))                     LayerNorm in float32
//   h  = rnd(relu(rnd(xx . W1 + b1)))      W1 [512, 128] Linear layout
//   h  = rnd(h . W2 + b2)                  W2 [128, 512]
//   y  = LN_b(xx + h) [* mask], written in T
// rnd rounds to T at every point the unfused flax chain rounds; LayerNorm is
// flax's (eps 1e-6, variance mean(x^2) - mean(x)^2 clamped at 0). Everything
// after x0 is csrc/chain_rows.cuh, shared with the folded edge pass
// (message.cu) and the whole-layer kernels (layer.cu).
//
// What bounds it: 2 * 2 * 128 * 512 = 262,144 operations per row on ~768
// bytes of traffic (bf16), so on tensor cores it would be bound by
// operations at about the same time as by memory; this first version runs
// the two products on the float32 FMA units, which bound it. The design
// reads each row once and writes it once: one block owns 64 rows, the
// LayerNorms are warp reductions, and the [64, 512] FFN hidden lives in
// shared memory 128 columns at a time while the second product accumulates
// in registers.

#include "chain_rows.cuh"

namespace packppi {

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads, 2)
chain_kernel(const T* __restrict__ x, const M* __restrict__ msg, const float* __restrict__ mask,
             ChainWeights w, T* __restrict__ out, int N, bool pre_mask) {
  extern __shared__ __align__(16) float smem[];
  float* XX = smem;               // [kH][kLdx] xx, k-major (product input and residual)
  float* Hs = XX + kH * kLdx;     // [kH][kLdx] one 128-column slice of the FFN hidden
  float* Ws = Hs + kH * kLdx;     // [kKc][kLdw]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = int64_t(blockIdx.x) * kRows;

  // x0 = rnd(x + rnd(m)): warp w owns rows 8w..8w+7, lane owns columns lane + 32q
  float x0[8][4];
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t g = row0 + warp * 8 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) x0[i][q] = 0.f;
    if (g >= N) continue;
    valid |= 1u << i;
    const float mk = mask ? mask[g] : 1.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      float m = to_f32<M>(msg[g * kH + c]);
      if (pre_mask && mask) m = rnd<M>(m * mk);
      x0[i][q] = rnd<T>(to_f32<T>(x[g * kH + c]) + rnd<T>(m));
    }
  }
  chain_rows<T>(x0, valid, XX, Hs, Ws, w, [&](int r, int c, float y) {
    const int64_t g = row0 + r;
    if (mask) y *= mask[g];
    out[g * kH + c] = from_f32<T>(y);
  });
}

template <typename T, typename M>
cudaError_t launch(const void* x, const void* msg, const void* mask, const void* lna_w,
                   const void* lna_b, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* lnb_w, const void* lnb_b, void* out, int N,
                   bool pre_mask, cudaStream_t stream) {
  auto kernel = chain_kernel<T, M>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kChainSmem));
  if (err != cudaSuccess) return err;
  const int blocks = (N + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, kChainSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const M*>(msg), static_cast<const float*>(mask),
      ChainWeights{static_cast<const float*>(lna_w), static_cast<const float*>(lna_b),
                   static_cast<const float*>(w1), static_cast<const float*>(b1),
                   static_cast<const float*>(w2), static_cast<const float*>(b2),
                   static_cast<const float*>(lnb_w), static_cast<const float*>(lnb_b)},
      static_cast<T*>(out), N, pre_mask);
  return cudaGetLastError();
}

}  // namespace packppi

// C entry point (ctypes). x and out [N,128] in the stream type (bf16 if
// bf16 != 0, else f32); msg [N,128] in the stream type if msg_bf16 == bf16
// else f32; mask [N] f32 or null (no masking); LayerNorm weights [128],
// w1 [512,128], b1 [512], w2 [128,512], b2 [128], all f32. Returns a
// cudaError_t.
extern "C" int packppi_chain(const void* x, const void* msg, const void* mask,
                             const void* lna_w, const void* lna_b, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* lnb_w, const void* lnb_b, void* out, int N,
                             int bf16, int msg_bf16, int pre_mask, void* stream) {
  using namespace packppi;
  if (N < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PACKPPI_ARGS x, msg, mask, lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, out, N, \
                     pre_mask != 0, s
  cudaError_t err;
  if (!bf16) {
    if (msg_bf16) return int(cudaErrorInvalidValue);
    err = launch<float, float>(PACKPPI_ARGS);
  } else {
    err = msg_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(PACKPPI_ARGS)
                   : launch<__nv_bfloat16, float>(PACKPPI_ARGS);
  }
#undef PACKPPI_ARGS
  return int(err);
}
