// Post-message residual chain of one IPMP block.
//
// Replaces packppi_tpu/ops/pallas_layer.py::_chain_kernel (entry
// fused_chain). Over flat rows [N, H] in the stream type T (bf16 or
// float32, also the compute type of the FFN products), H = kH of the build
// (csrc/tile.cuh):
//   [m = msg * mask]                       (pre_mask: edge chains)
//   x0 = rnd(x + rnd(m))                   residual add in T
//   xx = rnd(LN_a(x0))                     LayerNorm in float32
//   h  = rnd(act(rnd(xx . W1 + b1)))      W1 [4H, H] Linear layout
//   h  = rnd(h . W2 + b2)                  W2 [H, 4H]
//   y  = LN_b(xx + h) [* mask], written in T
// rnd rounds to T at every point the unfused flax chain rounds; LayerNorm is
// flax's (eps 1e-6, variance mean(x^2) - mean(x)^2 clamped at 0). A block
// forms its rows' x0 in shared memory; from there the chain is the one the
// folded edge pass (message.cu) and the whole-layer kernels (layer.cu) run,
// instruction for instruction: bf16 on wgmma (csrc/chain_wgmma.cuh), float32
// in 3xTF32 on mma.sync (csrc/chain_mma.cuh).
//
// What bounds it (H = 128): 2 * 2 * 128 * 512 = 262,144 operations per row against
// 512-768 bytes of row traffic (bf16) and the weights read once: at T1124's
// 24,576 edge rows 6.4 GFLOP and 19 MB, bound by operations at the bf16
// tensor-core rate (0.0065 ms) and about equally by bytes (0.0057 ms); in
// float32 (3xTF32, 165 TFLOP/s float32-accurate) by operations. The design:
// one block owns a tile of rows, reads each row once and writes it once, and
// streams the weights from L2 once a tile. bf16: 64-row tiles, three
// blocks an SM; the weights come as a bf16 copy in the panels' own layout,
// by bulk copies through a ring; where there are fewer tiles than SMs (the
// 768 node rows of T1124: 12 tiles) four warpgroups split a tile's hidden
// slices, adding their second products in turn so a row's bits do not
// depend on the launch's size (from H = 160 on, with five to eight
// slices, one warpgroup takes them all). float32: 64-row tiles where every SM gets a
// block, else 16 rows (which regroups LN_b's row sums: the same values to
// about 1e-7 of their scale, not the same bits);
// [H, 32] float32 chunks ([H, 16] from H = 224 on), each loaded while the one before it is
// multiplied, split into TF32 parts once a block.

#include "chain_mma.cuh"
#include "chain_wgmma.cuh"

namespace packppi {

// x0 = rnd(x + rnd(m)) for the R rows of a tile from row0: warp w of kWarps
// takes rows w, w + kWarps, ..., loading up to 8 rows together; lane owns
// columns lane + 32 q; rows past N are zeros. put(r, c, x0) writes x0
// (rounded to T, so a tile of T holds it exactly).
template <typename T, typename M, int R, int kWarps, typename Put>
__device__ __forceinline__ void residual_x0(const T* __restrict__ x, const M* __restrict__ msg,
                                            const float* __restrict__ mask, int64_t row0, int N,
                                            bool pre_mask, Put put) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kBatch = R / kWarps < 8 ? R / kWarps : 8;
  for (int rb = warp; rb < R; rb += kWarps * kBatch) {
    float xv[kBatch][kLnQ], mv[kBatch][kLnQ], mk[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t g = row0 + rb + kWarps * b;
      const bool in = g < N;
      mk[b] = in && mask ? mask[g] : 1.f;
#pragma unroll
      for (int q = 0; q < kLnQ; ++q) {
        const int c = lane + 32 * q;
        xv[b][q] = in ? to_f32<T>(x[g * kH + c]) : 0.f;
        mv[b][q] = in ? to_f32<M>(msg[g * kH + c]) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = rb + kWarps * b;
      const bool in = row0 + r < N;
#pragma unroll
      for (int q = 0; q < kLnQ; ++q) {
        const float m = pre_mask && mask ? rnd<M>(mv[b][q] * mk[b]) : mv[b][q];
        put(r, lane + 32 * q, in ? rnd<T>(xv[b][q] + rnd<T>(m)) : 0.f);
      }
    }
  }
}

// bf16 on wgmma: 64 rows a block of KS warpgroups
template <typename M, int KS>
__global__ void __launch_bounds__(ChainWg<KS>::kThreads, ChainWg<KS>::kMinBlocks)
chain_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const M* __restrict__ msg,
                   const float* __restrict__ mask, ChainWeights w,
                   const __nv_bfloat16* __restrict__ wpack, __nv_bfloat16* __restrict__ out,
                   int N, bool pre_mask) {
  using C = ChainWg<KS>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need a 1,024-byte aligned base
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int64_t row0 = int64_t(blockIdx.x) * kTileRows;

  chain_wgmma_prefetch<KS>(smem, wpack);  // the first panels load while xx is formed
  auto at = [&](int r, int c) { return reinterpret_cast<__nv_bfloat16*>(smem + act_offset(r, c)); };
  residual_x0<__nv_bfloat16, M, kTileRows, C::kThreads / 32>(
      x, msg, mask, row0, N, pre_mask, [&](int r, int c, float v) { *at(r, c) = __float2bfloat16_rn(v); });
  const int nvalid = N - row0 < kTileRows ? int(N - row0) : kTileRows;
  chain_wgmma<KS>(smem, w, wpack, nvalid, [&](int r, int c) { return __bfloat162float(*at(r, c)); },
                  [&](int r, int c, float y0, float y1) {
    const int64_t g = row0 + r;
    if (mask) {
      y0 *= mask[g];
      y1 *= mask[g];
    }
    *reinterpret_cast<uint32_t*>(out + g * kH + c) = pack_bf16(y0, y1);
  });
}

// float32 in 3xTF32 on mma.sync: R = 16 or 64 rows a block of 8 warps
// (at 16 rows and H <= 128, three blocks an SM)
template <int R>
__global__ void __launch_bounds__(kThreads, R == 16 && kH <= 128 ? 3 : 1)
chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ msg,
                 const float* __restrict__ mask, ChainWeights w, float* __restrict__ out, int N,
                 bool pre_mask) {
  using C = ChainMma<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* XX = reinterpret_cast<float*>(smem);  // [R][kLdA] xx (product input, residual)
  const int64_t row0 = int64_t(blockIdx.x) * R;

  float4 pre[kWPieces];
  fetch_w(pre, w, 0);  // the first weight chunk is in flight while xx is formed
  residual_x0<float, float, R, kThreads / 32>(x, msg, mask, row0, N, pre_mask,
                                              [&](int r, int c, float v) { XX[r * C::kLdA + c] = v; });
  const int nvalid = N - row0 < R ? int(N - row0) : R;
  chain_mma<R>(smem, pre, w, nvalid, [&](int r, int c) { return XX[r * C::kLdA + c]; },
               [&](int r, int c, float y0, float y1) {
    const int64_t g = row0 + r;
    if (mask) {
      y0 *= mask[g];
      y1 *= mask[g];
    }
    *reinterpret_cast<float2*>(out + g * kH + c) = make_float2(y0, y1);
  });
}

// the SM count of a device, read once
inline cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!cached[dev]) err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  *sms = cached[dev];
  return err;
}

template <typename K, typename... Args>
cudaError_t launch_kernel(K kernel, int blocks, int threads, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename M, int KS>
cudaError_t launch_wg(const __nv_bfloat16* x, const M* msg, const float* mask,
                      const ChainWeights& w, const __nv_bfloat16* wpack, __nv_bfloat16* out, int N,
                      bool pre_mask, int tiles, cudaStream_t stream) {
  return launch_kernel(chain_wgmma_kernel<M, KS>, tiles, ChainWg<KS>::kThreads,
                       ChainWg<KS>::kBytes, stream, x, msg, mask, w, wpack, out, N, pre_mask);
}

template <typename M>
cudaError_t launch_bf16(const __nv_bfloat16* x, const M* msg, const float* mask,
                        const ChainWeights& w, const __nv_bfloat16* wpack, __nv_bfloat16* out,
                        int N, bool pre_mask, int sms, cudaStream_t stream) {
  const int tiles = (N + kTileRows - 1) / kTileRows;
  // fewer tiles than SMs (the node passes): four warpgroups a tile, each
  // taking one of the four hidden slices (H <= 128)
  if constexpr (kWgSlices == 4) {
    if (tiles < sms) return launch_wg<M, 4>(x, msg, mask, w, wpack, out, N, pre_mask, tiles, stream);
  }
  return launch_wg<M, 1>(x, msg, mask, w, wpack, out, N, pre_mask, tiles, stream);
}

cudaError_t launch_f32(const float* x, const float* msg, const float* mask, const ChainWeights& w,
                       float* out, int N, bool pre_mask, int sms, cudaStream_t stream) {
  // 64-row tiles when that still gives every SM a block, else 16 rows
  if (N >= 64 * sms)
    return launch_kernel(chain_f32_kernel<64>, (N + 63) / 64, kThreads, ChainMma<64>::kBytes,
                         stream, x, msg, mask, w, out, N, pre_mask);
  return launch_kernel(chain_f32_kernel<16>, (N + 15) / 16, kThreads, ChainMma<16>::kBytes,
                       stream, x, msg, mask, w, out, N, pre_mask);
}

}  // namespace packppi

// C entry point (ctypes). x and out [N,H] in the stream type (bf16 if
// bf16 != 0, else f32); msg [N,H] in the stream type if msg_bf16 == bf16
// else f32; mask [N] f32 or null (no masking); LayerNorm weights [H],
// w1 [4H,H], b1 [4H], w2 [H,4H], b2 [H], all f32; wpack, for bf16
// only, W1 and W2 as bf16 in the panel layout of csrc/chain_wgmma.cuh
// (ops/chain.py::pack_chain_weights; the kernel then reads w1 and w2 no
// more). Returns a cudaError_t.
extern "C" int packppi_chain(const void* x, const void* msg, const void* mask,
                             const void* lna_w, const void* lna_b, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* lnb_w, const void* lnb_b, const void* wpack, void* out,
                             int N, int bf16, int msg_bf16, int pre_mask, void* stream) {
  using namespace packppi;
  if (N < 1) return int(cudaErrorInvalidValue);
  const ChainWeights w{static_cast<const float*>(lna_w), static_cast<const float*>(lna_b),
                       static_cast<const float*>(w1),    static_cast<const float*>(b1),
                       static_cast<const float*>(w2),    static_cast<const float*>(b2),
                       static_cast<const float*>(lnb_w), static_cast<const float*>(lnb_b)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return int(err);
  if (!bf16) {
    if (msg_bf16) return int(cudaErrorInvalidValue);
    return int(launch_f32(static_cast<const float*>(x), static_cast<const float*>(msg), mk, w,
                          static_cast<float*>(out), N, pre_mask != 0, sms, s));
  }
  if (!wpack) return int(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(wpack);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  err = msg_bf16 ? launch_bf16(xb, static_cast<const __nv_bfloat16*>(msg), mk, w, wp, ob, N,
                               pre_mask != 0, sms, s)
                 : launch_bf16(xb, static_cast<const float*>(msg), mk, w, wp, ob, N,
                               pre_mask != 0, sms, s);
  return int(err);
}
