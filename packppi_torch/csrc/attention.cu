// Multi-head attention with an additive key bias: ESM-2's self-attention.
//
// Replaces packppi_tpu/ops/pallas_attention.py::_mha_kernel (entry
// flash_mha). For every (batch b, head h) and query row r:
//   s[c] = q[r] . k[c] + bias[b, c]            float32 logits
//   p[c] = exp(s[c] - max s) / sum exp(s - max s)  float32 softmax
//   out[r] = sum_c rnd(p[c]) * v[c]            float32 sum
// q, k, v are [B, H, T, D] in T_in (float32 or bf16), bias [B, T] float32
// (0 on real keys, -1e9 on padded ones), out [B, H, T, D] float32. rnd
// rounds the normalised weights to T_in (the TPU kernel's
// w.astype(v.dtype)); bf16 operands are widened to float32, so every
// product is the exact bf16 product and every sum a float32 sum. Float32
// runs true float32 FMAs (no TF32).
//
// The TPU kernel keeps a whole [blk_q, T] logit block and each head's K and
// V in its 16 MB of VMEM. A block here has at most 227 KB of shared memory,
// so the keys are tiled: one block of 256 threads owns 64 query rows of one
// (b, h) and walks over 64-key tiles of K and V staged in shared memory,
// in two passes. Pass 1 keeps each row's running max and sum of exp (the
// sum rescaled as the max grows); pass 2 recomputes the logits, forms the
// normalised weights, rounds them and accumulates p . v in registers. The
// weights are rounded where the TPU kernel rounds them, with no running
// rescale of the output. T has no cap: a ragged last key tile is masked
// (-inf logits, zero V rows) and the rows of a ragged last query tile are
// computed on zeros and not stored.
//
// What bounds it: at ESM-2 650M's main-path shape (B = 1, H = 20, T = 768,
// D = 64) the two products are 4 H T^2 D = 3.02 GFLOP, 0.045 ms at the
// float32 FMA peak of 67 TFLOP/s (bf16 operands on tensor cores: 0.003 ms),
// against 15.7 MB of q, k, v and output (0.005 ms at 3.35 TB/s): bound by
// operations. This first version recomputes the logits in pass 2 (1.5x the
// bound's operations) and runs all products on the FMA units.

#include <math_constants.h>

#include "tile.cuh"

namespace packppi {

constexpr int kAttnThreads = 256;
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kLdq = kBQ + 4;     // k-major Q and P: float4-aligned rows
constexpr int kLdk = kBK + 1;     // k-major K: conflict-free transposing stores

template <int D>
constexpr size_t attn_smem_bytes() {
  return sizeof(float) * (size_t(D) * kLdq + size_t(D) * kLdk + size_t(kBK) * D +
                          size_t(kBK) * kLdq);
}

// s[i][j] = q[4 ty + i] . k[k0 + tx + 16 j] + bias, -inf for keys past T
template <int D>
__device__ __forceinline__ void tile_logits(float (&s)[4][4], const float* Qs, const float* Ks,
                                            const float* __restrict__ bias, int k0, int T,
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(Qs + d * kLdq + 4 * ty);
    const float qa[4] = {a.x, a.y, a.z, a.w};
    const float* kr = Ks + d * kLdk + tx;
    const float kv[4] = {kr[0], kr[16], kr[32], kr[48]};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = k0 + tx + 16 * j;
    const float bj = c < T ? bias[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][j] = c < T ? s[i][j] + bj : -CUDART_INF_F;
  }
}

// the 16 lanes of a row group (one half of a warp) combine their values
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, float* __restrict__ out, int H, int T_len) {
  constexpr int DJ = D / 16;      // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [D][kLdq]  q tile, k-major
  float* Ks = Qs + D * kLdq;      // [D][kLdk]  key tile, k-major
  float* Vs = Ks + D * kLdk;      // [kBK][D]   value tile, row-major
  float* Ps = Vs + kBK * D;       // [kBK][kLdq] weights, key-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // key / output columns tx + 16 j
  const int ty = tid >> 4;        // query rows 4 ty .. 4 ty + 3
  const int q0 = blockIdx.x * kBQ;
  const size_t head = (size_t(blockIdx.z) * H + blockIdx.y) * size_t(T_len) * D;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  const float* bias_b = bias + size_t(blockIdx.z) * T_len;

  for (int e = tid; e < kBQ * D; e += kAttnThreads) {
    const int r = e / D, d = e % D;
    const int g = q0 + r;
    Qs[d * kLdq + r] = g < T_len ? to_f32<T>(qh[size_t(g) * D + d]) : 0.f;
  }

  const int ntiles = (T_len + kBK - 1) / kBK;
  float s[4][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }

  // pass 1: each row's max logit and sum of exp(s - max)
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed; Qs is written
    for (int e = tid; e < kBK * D; e += kAttnThreads) {
      const int c = e / D, d = e % D;
      const int g = k0 + c;
      Ks[d * kLdk + c] = g < T_len ? to_f32<T>(kh[size_t(g) * D + d]) : 0.f;
    }
    __syncthreads();
    tile_logits<D>(s, Qs, Ks, bias_b, k0, T_len, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = group_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float mn = fmaxf(m[i], mx);
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + group_sum(e);
      m[i] = mn;
    }
  }

  // pass 2: p = rnd(exp(s - max) / sum), out += p . v
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    for (int e = tid; e < kBK * D; e += kAttnThreads) {
      const int c = e / D, d = e % D;
      const int g = k0 + c;
      const bool in = g < T_len;
      Ks[d * kLdk + c] = in ? to_f32<T>(kh[size_t(g) * D + d]) : 0.f;
      Vs[c * D + d] = in ? to_f32<T>(vh[size_t(g) * D + d]) : 0.f;
    }
    __syncthreads();
    tile_logits<D>(s, Qs, Ks, bias_b, k0, T_len, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(tx + 16 * j) * kLdq + 4 * ty + i] = rnd<T>(expf(s[i][j] - m[i]) / l[i]);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Ps + c * kLdq + 4 * ty);
      const float pa[4] = {a.x, a.y, a.z, a.w};
      const float* vr = Vs + c * D + tx;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vr[16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pa[i], vv, o[i][j]);
      }
    }
  }

  float* oh = out + head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = q0 + 4 * ty + i;
    if (g >= T_len) break;
#pragma unroll
    for (int j = 0; j < DJ; ++j) oh[size_t(g) * D + tx + 16 * j] = o[i][j];
  }
}

template <typename T, int D>
cudaError_t launch_mha(const void* q, const void* k, const void* v, const void* bias,
                       void* out, int B, int H, int T_len, cudaStream_t stream) {
  auto kernel = mha_kernel<T, D>;
  constexpr size_t smem = attn_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), H, T_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mha(const void* q, const void* k, const void* v, const void* bias,
                         void* out, int B, int H, int T_len, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mha<T, 16>(q, k, v, bias, out, B, H, T_len, stream);
    case 32: return launch_mha<T, 32>(q, k, v, bias, out, B, H, T_len, stream);
    case 64: return launch_mha<T, 64>(q, k, v, bias, out, B, H, T_len, stream);
    case 128: return launch_mha<T, 128>(q, k, v, bias, out, B, H, T_len, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace packppi

// C entry point (ctypes). q, k, v [B, H, T, D] contiguous, bf16 if bf16 != 0
// else float32; bias [B, T] float32; out [B, H, T, D] float32. D is one of
// the ESM-2 head widths 16, 32, 64, 128. Returns a cudaError_t.
extern "C" int packppi_mha(const void* q, const void* k, const void* v, const void* bias,
                           void* out, int B, int H, int T_len, int D, int bf16, void* stream) {
  using namespace packppi;
  if (B < 1 || H < 1 || T_len < 1 || H > 65535 || B > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? dispatch_mha<__nv_bfloat16>(q, k, v, bias, out, B, H, T_len, D, s)
                  : dispatch_mha<float>(q, k, v, bias, out, B, H, T_len, D, s));
}
