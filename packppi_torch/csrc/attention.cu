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
// w.astype(v.dtype)). bf16 products are exact bf16 products summed in
// float32; float32 products are float32-accurate (3xTF32, csrc/mma.cuh).
//
// What bounds it: at ESM-2 650M's shape (B = 1, H = 20, T = 896, D = 64)
// the two products are 4 H T^2 D = 4.11 GFLOP against 18.4 MB of q, k, v,
// bias and output, so operations bound it: 0.004 ms at the bf16 tensor-core
// rate, 0.025 ms at the float32-accurate one (3xTF32: three TF32 products
// for each, 495 / 3 TFLOP/s). The softmax's exponentials (T^2 H a pass) are
// the next cost.
//
// Design (FlashAttention-2 on mma.sync): a block of 4 warps owns 64 query
// rows of one (b, h), each warp 16 rows; the warp's Q fragments stay in
// registers for the whole key walk (splitting each key tile over two warp
// halves, merged through shared memory, measured slower on the card). K
// and V walk in 64-key tiles through a two-stage cp.async ring in shared
// memory, so the next tile's copy overlaps the current tile's products; the
// rows are padded (16 bytes) so the fragment loads (ldmatrix for bf16,
// 32-bit loads for float32) are free of bank conflicts. The softmax runs in
// the accumulator's register layout, with quad shuffles for each row's max
// and sum.
//   bf16: the weights are rounded after normalisation, so two passes. Pass 1
//   runs only q . k^T and keeps each row's running max and sum (exp on the
//   special-function unit: its 2^-22 error is far below the bf16 rounding
//   of the weights); pass 2 recomputes the logits with the same
//   instructions (every weight <= 1), forms rnd(exp(s - max) / sum)
//   straight into the A fragments of the m16n8k16 P . V product and
//   accumulates in float32.
//   float32: rounding to float32 is the identity, so one pass with an online
//   softmax (the output rescaled as the max grows, divided by the sum at the
//   end). Both products in 3xTF32 on m16n8k8, each tile's P . V summed from
//   zero and added to the output; the P . V product takes the logit
//   accumulator as its A fragment by relabelling the keys of each group of
//   8 (A's k index t is key 2t, t + 4 is key 2t + 1) and reading V rows in
//   the same order.
// T has no cap. A ragged last key tile is copied as zeros and its logits
// are -inf; the rows of a ragged last query tile are computed on zeros and
// not stored. Grid (ceil(T / 64), H, B).

#include <math_constants.h>

#include "mma.cuh"
#include "tile.cuh"

namespace packppi {

constexpr int kAttnThreads = 128;  // 4 warps of 16 query rows
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile

template <typename T, int D>
struct AttnTile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kLd = D + (kBf16 ? 8 : 4);          // padded row (elements)
  static constexpr int kPieces = D * int(sizeof(T)) / 16;  // 16-byte copies a row
  static constexpr int kStage = kBK * kLd;                  // elements of one tile
  // K x 2, V x 2; the Q tile is staged in the second V stage before the walk
  static constexpr size_t kBytes = 4 * size_t(kStage) * sizeof(T);
  // blocks an SM the registers are budgeted for (float32 at three an SM
  // measured slower: the register cap costs more than the wave it saves)
  static constexpr int kMinBlocks = D <= 64 ? (kBf16 ? 4 : 2) : 1;
};

// rows [r0, r0 + 64) of one head's [T, D] matrix into a padded tile, zeros
// past T; asynchronous, joins the next committed group
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int r0, int T_len) {
  using A = AttnTile<T, D>;
  constexpr int kPer = 16 / int(sizeof(T));
  for (int e = threadIdx.x; e < kBK * A::kPieces; e += kAttnThreads) {
    const int r = e / A::kPieces, c = e % A::kPieces;
    const int g = r0 + r;
    const bool in = g < T_len;
    cp_async16(dst + r * A::kLd + c * kPer, src + size_t(in ? g : 0) * D + c * kPer, in);
  }
}

// walk the key tiles through the two-stage ring: body(k0, K tile, V tile)
// runs on each tile while the next one is copied (V only if kV)
template <typename T, int D, bool kV, typename Body>
__device__ __forceinline__ void walk_keys(T* Ks, T* Vs, const T* __restrict__ kh,
                                          const T* __restrict__ vh, int T_len, int ntiles,
                                          Body body) {
  constexpr int kStage = AttnTile<T, D>::kStage;
  load_tile<T, D>(Ks, kh, 0, T_len);
  if (kV) load_tile<T, D>(Vs, vh, 0, T_len);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_tile<T, D>(Ks + (st ^ 1) * kStage, kh, (it + 1) * kBK, T_len);
      if (kV) load_tile<T, D>(Vs + (st ^ 1) * kStage, vh, (it + 1) * kBK, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(it * kBK, Ks + st * kStage, Vs + st * kStage);
    __syncthreads();  // the tile is consumed before the ring refills it
  }
}

// s[n] (keys 8n .. 8n + 7 of the tile) = the warp's 16 query rows . K^T
template <int D>
__device__ __forceinline__ void logits(float (&s)[8][4], const uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* Kt, int lane) {
  constexpr int ld = AttnTile<__nv_bfloat16, D>::kLd;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, Kt + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * ld + ks * 16 +
                     (((lane >> 3) & 1) << 3));
      mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
    }
}

template <int D>
__device__ __forceinline__ void logits(float (&s)[8][4], const float (&qf)[D / 8][4],
                                       const float* Kt, int lane) {
  constexpr int ld = AttnTile<float, D>::kLd;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(qf[ks][i], ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* kr = Kt + (n * 8 + g) * ld + ks * 8 + t;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(kr[0], bh0, bl0);
      split_tf32(kr[4], bh1, bl1);
      mma_3xtf32(s[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// s += bias on keys inside T, -inf past it
__device__ __forceinline__ void add_bias(float (&s)[8][4], const float* __restrict__ bias,
                                         int k0, int T_len, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = k0 + n * 8 + 2 * t + j;
      const bool in = c < T_len;
      const float b = in ? bias[c] : 0.f;
      s[n][j] = in ? s[n][j] + b : -CUDART_INF_F;
      s[n][j + 2] = in ? s[n][j + 2] + b : -CUDART_INF_F;
    }
}

// the max over the tile of row g (r = 0) or g + 8 (r = 1)
__device__ __forceinline__ float tile_max(const float (&s)[8][4], int r) {
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
}

// 2^x on the special-function unit (relative error about 2^-22); bf16 only
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the logits times log2(e), so that exp(s - max) is exp2 of a difference
__device__ __forceinline__ void scale_log2e(float (&s)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] *= 1.4426950408889634f;
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads, AttnTile<T, D>::kMinBlocks)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, float* __restrict__ out, int H, int T_len) {
  using A = AttnTile<T, D>;
  constexpr int ld = A::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // 2 x [kBK][ld]
  T* Vs = Ks + 2 * A::kStage;               // 2 x [kBK][ld]
  T* Qs = Vs + A::kStage;                   // [kBQ][ld], until the fragments are read

  const int lane = threadIdx.x & 31;
  const int w16 = (threadIdx.x >> 5) * 16;  // the warp's first query row in the tile
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const size_t head = (size_t(blockIdx.z) * H + blockIdx.y) * size_t(T_len) * D;
  const T* kh = k + head;
  const T* vh = v + head;
  const float* bias_b = bias + size_t(blockIdx.z) * T_len;
  const int ntiles = (T_len + kBK - 1) / kBK;

  load_tile<T, D>(Qs, q + head, q0, T_len);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dn][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float s[8][4];

  if constexpr (A::kBf16) {
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      ldsm_x4(qf[ks], Qs + (w16 + (lane & 15)) * ld + ks * 16 + ((lane >> 4) << 3));
    __syncthreads();  // Q is read before the walk refills its stage

    // pass 1: each row's max logit and sum of exp(s - max), in units of
    // log2(e) (the weights are rounded to bf16, far above exp2's error)
    walk_keys<T, D, false>(Ks, Vs, kh, vh, T_len, ntiles, [&](int k0, const T* Kt, const T*) {
      logits<D>(s, qf, Kt, lane);
      add_bias(s, bias_b, k0, T_len, t);
      scale_log2e(s);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], tile_max(s, r));
        float e = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          e += exp2_approx(s[n][2 * r] - mn) + exp2_approx(s[n][2 * r + 1] - mn);
        l[r] = l[r] * exp2_approx(m[r] - mn) + quad_sum(e);
        m[r] = mn;
      }
    });

    // pass 2: p = rnd(exp(s - max) / sum) as the A fragments, out += p . v
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    walk_keys<T, D, true>(Ks, Vs, kh, vh, T_len, ntiles, [&](int k0, const T* Kt, const T* Vt) {
      logits<D>(s, qf, Kt, lane);
      add_bias(s, bias_b, k0, T_len, t);
      scale_log2e(s);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * kk + h;
          a[2 * h] = pack_bf16(exp2_approx(s[n][0] - m[0]) * inv[0],
                               exp2_approx(s[n][1] - m[0]) * inv[0]);
          a[2 * h + 1] = pack_bf16(exp2_approx(s[n][2] - m[1]) * inv[1],
                                   exp2_approx(s[n][3] - m[1]) * inv[1]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(b, Vt + (kk * 16 + (((lane >> 3) & 1) << 3) + (lane & 7)) * ld + dp * 16 +
                           ((lane >> 4) << 3));
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    });
  } else {
    float qf[D / 8][4];
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const T* qr = Qs + (w16 + g) * ld + ks * 8 + t;
      qf[ks][0] = qr[0];
      qf[ks][1] = qr[8 * ld];
      qf[ks][2] = qr[4];
      qf[ks][3] = qr[8 * ld + 4];
    }
    __syncthreads();  // Q is read before the walk refills its stage

    // one pass, online softmax
    walk_keys<T, D, true>(Ks, Vs, kh, vh, T_len, ntiles, [&](int k0, const T* Kt, const T* Vt) {
      logits<D>(s, qf, Kt, lane);
      add_bias(s, bias_b, k0, T_len, t);
      float sc[2], e[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], tile_max(s, r));
        sc[r] = expf(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = expf(s[n][i] - m[i >> 1]);
          e[i >> 1] += s[n][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * sc[r] + quad_sum(e[r]);
      // the tile's p . v from zero, then o = o * sc + that (round to nearest)
      float ot[D / 8][4];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int i = 0; i < 4; ++i) ot[dn][i] = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        // A's k index t is key 2t of the group, t + 4 is key 2t + 1
        uint32_t ah[4], al[4];
        split_tf32(s[n][0], ah[0], al[0]);
        split_tf32(s[n][2], ah[1], al[1]);
        split_tf32(s[n][1], ah[2], al[2]);
        split_tf32(s[n][3], ah[3], al[3]);
        const T* vr = Vt + (n * 8 + 2 * t) * ld + g;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[dn * 8], bh0, bl0);
          split_tf32(vr[ld + dn * 8], bh1, bl1);
          mma_3xtf32(ot[dn], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[dn][i] = fmaf(o[dn][i], sc[i >> 1], ot[dn][i]);
    });
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dn][i] *= inv[i >> 1];
  }

  float* oh = out + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w16 + g + 8 * r;
    if (row >= T_len) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(oh + size_t(row) * D + dn * 8 + 2 * t) =
          make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
  }
}

template <typename T, int D>
cudaError_t launch_mha(const void* q, const void* k, const void* v, const void* bias,
                       void* out, int B, int H, int T_len, cudaStream_t stream) {
  auto kernel = mha_kernel<T, D>;
  constexpr size_t smem = AttnTile<T, D>::kBytes;
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

// C entry point (ctypes). q, k, v [B, H, T, D] contiguous and 16-byte
// aligned, bf16 if bf16 != 0 else float32; bias [B, T] float32; out
// [B, H, T, D] float32. D is one of the ESM-2 head widths 16, 32, 64, 128.
// Returns a cudaError_t.
extern "C" int packppi_mha(const void* q, const void* k, const void* v, const void* bias,
                           void* out, int B, int H, int T_len, int D, int bf16, void* stream) {
  using namespace packppi;
  if (B < 1 || H < 1 || T_len < 1 || H > 65535 || B > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? dispatch_mha<__nv_bfloat16>(q, k, v, bias, out, B, H, T_len, D, s)
                  : dispatch_mha<float>(q, k, v, bias, out, B, H, T_len, D, s));
}
