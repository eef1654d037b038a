// A float32-accurate linear map on the TF32 tensor cores: ESM-2's matrix
// products.
//
//   y = epilogue(x . W^T + b)      x [M, K], W [N, K] (Linear layout), y [M, N]
//
// all float32; the epilogue applies, in this order, the bias b [N] (if
// given), the erf-GELU 0.5 v (1 + erf(v / sqrt 2)) (if gelu) and adds a
// residual r [M, N] (if given): F.linear, F.gelu(approximate="none") and
// r + y as the model writes them. The heads epilogue (packppi_gemm_tf32x3_heads)
// takes W as ESM-2's query, key and value stacked, [3 D', K], and x as B
// rows of T tokens: y's columns are q, k and v, each H = D' / D heads of
// D; q is scaled (by D^-0.5), q and k take the half-split rotary with
// the tables cos, sin [T, D] (q' = q cos + rotate_half(q) sin,
// rotate_half(q) = (-q2, q1)), and the three are written in the
// attention's layout [3, B, H, T, D]: the operations of
// models/esm2.py's apply_rope on the same float32 values, rounded alike.
//
// Replaces no TPU kernel: the JAX package leaves ESM-2's products to XLA.
// On the card cuBLAS runs float32 products on the FMA units (TF32 stays
// off, packppi_torch/__init__.py), at 67 TFLOP/s at most; this kernel
// computes them on the tensor cores as 3xTF32 (csrc/mma.cuh), whose bound
// is 495 / 3 = 165 TFLOP/s. At ESM-2 650M's maps (K = 1,280 or 5,120, N =
// 1,280 to 5,120, M = rows x tokens >= 1,280) operations bound it: a
// [4480, 5120] x [5120, 1280] product is 58.7 GFLOP against 133 MB.
//
// Arithmetic: x = hi_x + lo_x (mma.cuh split_tf32: Veltkamp's split to
// the nearest TF32, lo rounded to the nearest TF32) and W = hi_W + lo_W;
// x . W^T is summed as hi_x hi_W + lo_x hi_W + hi_x lo_W. hi_W is W itself:
// the tensor core reads a float32 operand as TF32 by dropping its low 13
// bits. lo_W [N, K] is what those bits hold, rounded to the nearest TF32
// (ops/gemm.py low_part, made once per weight version), so hi_W + lo_W is W
// to 2^-22 of |W|, as with the nearest split; x is split in registers as
// its fragments are loaded. The
// tensor core rounds its running sums toward zero, so each k-tile of 32 is
// summed from zero in the wgmma accumulator (12 products) and added to the
// float32 sum with a round-to-nearest add (mma.cuh mma_3xtf32).
//
// Design: one block a 128 x 128 tile of y, three warpgroups. Warpgroup 2
// is the producer: one thread streams the k-tiles of x ([128 m][32 k]),
// W and lo_W ([128 n][32 k] each), 48 KB a stage, by TMA copies (the
// 128-byte swizzle, zeros past M, N and K) through a ring of kStages
// stages in shared memory, each completing on an mbarrier. Warpgroups 0
// and 1 are the consumers, 64 rows each: per k-tile a thread loads its x
// fragments from shared memory (conflict-free in the swizzle), splits
// them, and issues the 12 wgmma m64n128k8 TF32 products with A from
// registers and B (W, lo_W) from shared memory; it waits for them,
// releases the stage, and adds the partial to its sum while the other
// consumer's products run. The epilogue writes y from registers (the
// heads epilogue: a thread's columns c and c + D / 2 of a head are its
// own, D / 16 column tiles apart, so the rotary needs no exchange). Grid
// (ceil(M / 128), ceil(N / 128)): the row tiles of one column band run
// side by side and share its weights in L2.
#include <cuda.h>

#include "mma.cuh"
#include "tile.cuh"

namespace packppi {

constexpr int kGemmBM = 128;                 // rows of y a block
constexpr int kGemmBN = 128;                 // columns of y a block
constexpr int kGemmBK = 32;                  // k a stage: one 128-byte swizzle row of float32
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 384;            // two consumer warpgroups, one producer
constexpr uint32_t kGemmTile = kGemmBM * kGemmBK * 4;   // 16 KB: one operand's k-tile
constexpr uint32_t kGemmStage = 3 * kGemmTile;           // x, W, lo_W
constexpr size_t kGemmSmem = kGemmStages * size_t(kGemmStage) + 2 * kGemmStages * 8 + 1024;

// d (+)= a . b, m64n128k8, TF32 operands: A from registers (per warp the
// m16n8k8 TF32 A fragment of its 16 rows, mma.cuh), B from shared memory
// (K-major, 128-byte swizzle); float32 sums; scale_d = 0 ignores d's
// old value
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// one plain arrival on bar
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the box at (c0 inner, c1 outer) of a 2-D tensor map into shared memory,
// completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.f + erff(v * 0.70710678118654752f));
}

// what the epilogue adds and where it writes
struct GemmEpilogue {
  const float* bias;       // [N] or null
  const float* residual;   // [M, N] or null (the plain epilogue)
  float* out;              // [M, N]; the heads epilogue: [3, M / T, N / (3 D), T, D]
  int gelu;                // the plain epilogue
  const float* cos;        // [T, D]: the heads epilogue
  const float* sin;
  int T;
  float scale;             // q's
};

// the plain epilogue: y = residual + gelu(sum + bias) at row r, columns col, col + 1
__device__ __forceinline__ void store_plain(const GemmEpilogue& ep, int N, int r, int col,
                                            float2 b, float s0, float s1) {
  float2 y = make_float2(s0 + b.x, s1 + b.y);
  if (ep.gelu) y = make_float2(gelu_erf(y.x), gelu_erf(y.y));
  const size_t at = size_t(r) * N + col;
  if (ep.residual != nullptr) {
    const float2 res = *reinterpret_cast<const float2*>(ep.residual + at);
    y = make_float2(res.x + y.x, res.y + y.y);
  }
  *reinterpret_cast<float2*>(ep.out + at) = y;
}

// the heads epilogue over a thread's row r (v: its 16 column pairs, bias
// added): q scaled, q and k rotated, written in the heads' layout
template <int kHeadD>
__device__ __forceinline__ void store_heads(const GemmEpilogue& ep, int M, int N, int r, int n0,
                                            int t, float (&v)[32]) {
  const int width = N / 3, heads = width / kHeadD;
  const int b = r / ep.T, tok = r % ep.T;
#pragma unroll
  for (int j = 0; j < kGemmBN / 8; ++j)
    if ((n0 + 8 * j) / width == 0) {
      v[2 * j] = __fmul_rn(v[2 * j], ep.scale);
      v[2 * j + 1] = __fmul_rn(v[2 * j + 1], ep.scale);
    }
#pragma unroll
  for (int j = 0; j < kGemmBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= N) continue;
    const int part = col / width, c = col % width, d = c % kHeadD;
    float2 o = make_float2(v[2 * j], v[2 * j + 1]);
    if (part < 2) {
      // the partner column d + D / 2 (first half) or d - D / 2, D / 16 tiles away
      constexpr int kShift = kHeadD / 16;
      const bool first = (8 * j) % kHeadD < kHeadD / 2;
      const int jp = first ? j + kShift : j - kShift;
      const float rx = first ? -v[2 * jp] : v[2 * jp], ry = first ? -v[2 * jp + 1] : v[2 * jp + 1];
      const float2 cs = *reinterpret_cast<const float2*>(ep.cos + size_t(tok) * kHeadD + d);
      const float2 sn = *reinterpret_cast<const float2*>(ep.sin + size_t(tok) * kHeadD + d);
      o = make_float2(__fadd_rn(__fmul_rn(o.x, cs.x), __fmul_rn(rx, sn.x)),
                      __fadd_rn(__fmul_rn(o.y, cs.y), __fmul_rn(ry, sn.y)));
    }
    const size_t at =
        ((size_t(part) * (M / ep.T) + b) * heads + c / kHeadD) * size_t(ep.T) * kHeadD +
        size_t(tok) * kHeadD + d;
    *reinterpret_cast<float2*>(ep.out + at) = o;
  }
}

// kHeadD: 0 for the plain epilogue, else the heads epilogue's head width
template <int kHeadD>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_hi,
                   const __grid_constant__ CUtensorMap map_lo, const GemmEpilogue ep, int M,
                   int N, int K) {
  extern __shared__ unsigned char gemm_smem_raw[];
  // the swizzled tiles want 1,024-byte alignment
  unsigned char* smem = gemm_smem_raw + ((1024u - (smem_u32(gemm_smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGemmStages * kGemmStage);
  uint64_t* empty = full + kGemmStages;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kGemmBM, n0 = blockIdx.y * kGemmBN;
  const int k_tiles = (K + kGemmBK - 1) / kGemmBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival from each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0 && lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kGemmStages;
        if (kt >= kGemmStages) mbar_wait(&empty[s], ((kt / kGemmStages) & 1) ^ 1);
        unsigned char* st = smem + s * kGemmStage;
        mbar_expect_tx(&full[s], kGemmStage);
        tma_load_2d(st, &map_x, kt * kGemmBK, m0, &full[s]);
        tma_load_2d(st + kGemmTile, &map_hi, kt * kGemmBK, n0, &full[s]);
        tma_load_2d(st + 2 * kGemmTile, &map_lo, kt * kGemmBK, n0, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = lane / 4, t = lane % 4;
    // this thread's fragment rows in an x tile: r and r + 8, r % 8 = g
    const int row = wg * 64 + warp * 16 + g;
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kGemmStages;
      mbar_wait(&full[s], (kt / kGemmStages) & 1);
      const unsigned char* st = smem + s * kGemmStage;
      const float* xs = reinterpret_cast<const float*>(st);
      // A fragments of the 4 k-steps: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
      // a3 (g + 8, t + 4); column c of row r sits in 16-byte piece (c / 4) ^ (r % 8)
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row + 8 * (i & 1);
          const int piece = (2 * ks + (i >> 1)) ^ g;
          split_tf32(xs[r * kGemmBK + piece * 4 + t], ah[ks][i], al[ks][i]);
        }
      const uint32_t hi_s = smem_u32(st + kGemmTile), lo_s = smem_u32(st + 2 * kGemmTile);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dh = sw128_desc(hi_s + 32 * ks), dl = sw128_desc(lo_s + 32 * ks);
        wgmma_m64n128k8_tf32_rs(acc, ah[ks], dh, ks);   // from zero at the tile's first
        wgmma_m64n128k8_tf32_rs(acc, al[ks], dh, 1);
        wgmma_m64n128k8_tf32_rs(acc, ah[ks], dl, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      // the products wrote acc behind the compiler's back: nothing that reads
      // it may move above the wait
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    }

    // d[4 j + i]: c_i of column tile j; c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
    if constexpr (kHeadD == 0) {
#pragma unroll
      for (int j = 0; j < kGemmBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= N) continue;
        float2 b = make_float2(0.f, 0.f);
        if (ep.bias != nullptr) b = *reinterpret_cast<const float2*>(ep.bias + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          if (r < M) store_plain(ep, N, r, col, b, sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + row + 8 * h;
        if (r >= M) continue;
        float v[32];
#pragma unroll
        for (int j = 0; j < kGemmBN / 8; ++j) {
          const int col = min(n0 + 8 * j + 2 * t, N - 2);   // past N: read, never stored
          const float2 b = *reinterpret_cast<const float2*>(ep.bias + col);
          v[2 * j] = sum[4 * j + 2 * h] + b.x;
          v[2 * j + 1] = sum[4 * j + 2 * h + 1] + b.y;
        }
        store_heads<kHeadD>(ep, M, N, r, n0, t, v);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                        cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a row-major float32 [rows, K] matrix in boxes of [128 rows][32 k],
// 128-byte swizzle, zeros past the edges
bool tile_map(CUtensorMap* map, const float* base, int rows, int K) {
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K) * 4};
  const cuuint32_t box[2] = {kGemmBK, kGemmBM};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kHeadD>
cudaError_t launch_gemm(const float* x, const float* w, const float* lo, int M, int N, int K,
                        const GemmEpilogue& ep, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_x, map_hi, map_lo;
  if (!tile_map(&map_x, x, M, K) || !tile_map(&map_hi, w, N, K) || !tile_map(&map_lo, lo, N, K))
    return cudaErrorInvalidValue;
  auto kernel = gemm_tf32x3_kernel<kHeadD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kGemmSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kGemmBM - 1) / kGemmBM, (N + kGemmBN - 1) / kGemmBN);
  kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(map_x, map_hi, map_lo, ep, M, N, K);
  return cudaGetLastError();
}

}  // namespace packppi

// C entry points (ctypes); each returns a cudaError_t. Every operand
// float32, contiguous, 16-byte aligned; K and N multiples of 4.
//
// x [M, K], w [N, K], lo [N, K] (w's low part, TF32 values), bias [N] or
// null, residual [M, N] or null, out [M, N]. gelu != 0 applies the
// erf-GELU after the bias.
extern "C" int packppi_gemm_tf32x3(const float* x, const float* w, const float* lo,
                                   const float* bias, const float* residual, float* out, int M,
                                   int N, int K, int gelu, void* stream) {
  using namespace packppi;
  if (M < 1 || N < 1 || K < 1 || K % 4 || N % 4 || (N + kGemmBN - 1) / kGemmBN > 65535)
    return int(cudaErrorInvalidValue);
  const GemmEpilogue ep{bias, residual, out, gelu, nullptr, nullptr, 1, 1.f};
  return int(launch_gemm<0>(x, w, lo, M, N, K, ep, static_cast<cudaStream_t>(stream)));
}

// The heads epilogue: x [M = B T, K], w and lo [N = 3 D', K] (query, key,
// value stacked), bias [N], cos and sin [T, D] (D = 64, ESM-2's head width
// at every size, dividing D'), out [3, B, D' / D, T, D]; q scaled by scale.
extern "C" int packppi_gemm_tf32x3_heads(const float* x, const float* w, const float* lo,
                                         const float* bias, const float* cos, const float* sin,
                                         float* out, int M, int N, int K, int T, int D,
                                         float scale, void* stream) {
  using namespace packppi;
  if (M < 1 || N < 1 || K < 1 || K % 4 || N % 4 || (N + kGemmBN - 1) / kGemmBN > 65535 ||
      T < 1 || M % T || N % 3 || D != 64 || (N / 3) % D || bias == nullptr)
    return int(cudaErrorInvalidValue);
  const GemmEpilogue ep{bias, nullptr, out, 0, cos, sin, T, scale};
  return int(launch_gemm<64>(x, w, lo, M, N, K, ep, static_cast<cudaStream_t>(stream)));
}
