// The residual chain in float32 on tensor cores, over one tile of R rows
// (R = 16 or 64). From x0 rows in shared memory (chain_mma):
//   xx = LN_a(x0)                          csrc/chain_common.cuh
//   h  = act(xx . W1 + b1)                W1 [4H, H] Linear layout
//   h  = h . W2 + b2                       W2 [H, 4H]
//   y  = LN_b(xx + h)                      handed to store(row, col, y, y')
// (in float32 every rounding point of the bf16 chain is the identity; bf16
// runs on wgmma, csrc/chain_wgmma.cuh). chain.cu, message.cu's
// message_chain_kernel (R = 64) and layer.cu's two passes (edge R = 64,
// node R = 16) all run it through chain_mma<R>. R can change a row's bits
// (the products' sums do not depend on it, but LN_b's row sums add the
// partial sums of CW column warps, 4 at R = 64 and 8 at R = 16, in another
// grouping), so equal bits need equal x0 and equal R.
//
// The products run in 3xTF32 on mma.sync m16n8k8 (csrc/mma.cuh), each
// weight chunk's partial summed from zero and added to the running sum. 8
// warps; a warp owns a (R / RW) x (8 kNT) block of each [R, H] product, RW
// x CW = 8 (2 x 4 at R = 64, 1 x 8 at 16), kNT = ceil(H / 8 / CW) n-tiles
// of 8 columns: where CW does not divide H / 8 (R = 16 at H = 32, 96, 160,
// 224) the last column warps own fewer tiles, or none. The hidden is made H
// columns at a time: its [R, H] slice lives in shared memory, while the
// second product's [R, H] sum stays in registers across the four slices.
//
// Weights stream from L2 in [H, kWk] float32 chunks (kWk = 32, 16 from H =
// 224 on so that two stages fit beside the tiles; 32 chunks a tile at H =
// 128: W1 then W2 for each slice). Each chunk is loaded into registers
// while the chunk before it is multiplied, then split into its TF32 hi and
// lo parts in the other of two shared-memory stages once for all warps,
// with one barrier a chunk. LN_b's row sums combine the CW warps of a row
// through `stats`.
#pragma once

#include "chain_common.cuh"
#include "mma.cuh"

namespace packppi {

constexpr int kWk = kH <= 192 ? 32 : 16;         // k of one staged weight chunk
constexpr int kSlices = kF / kH;                 // hidden slices of H
constexpr int kWChunksSlice = kH / kWk;          // chunks of one product of a slice
constexpr int kWChunks = 2 * kSlices * kWChunksSlice;
constexpr int kWRowPieces = kWk / 4;             // float4 pieces of a chunk row
constexpr int kWAll = kH * kWRowPieces;          // float4 pieces of a chunk
constexpr int kWPieces = (kWAll + kThreads - 1) / kThreads;  // a thread's

template <int R>
struct ChainMma {
  static constexpr int kRW = R == 64 ? 2 : 1;                  // warps along rows
  static constexpr int kCW = 8 / kRW;                          // warps along columns
  static constexpr int kMT = R / kRW / 16;                     // m16 tiles a warp
  static constexpr int kNT = (kH / 8 + kCW - 1) / kCW;         // n8 tiles a warp, at most
  static constexpr bool kRagged = (kH / 8) % kCW != 0;         // some warps own fewer
  static constexpr int kLdA = kH + 4;                          // XX and Hs row (floats)
  static constexpr int kLdW = kWk + 4;                         // staged weight row
  static constexpr size_t kABytes = size_t(R) * kLdA * sizeof(float);
  static constexpr size_t kWBytes = size_t(kH) * kLdW * 8;     // hi + lo
  static constexpr size_t kBytes = 2 * kABytes + 2 * kWBytes + size_t(R) * kCW * sizeof(float2);
  static_assert(kMT >= 1 && kNT >= 1, "warp tile");
  static_assert(kBytes <= 232448, "the chain's tiles and weight stages fit a block");
  // n-tile nt of the warp whose columns start at wc0 lies inside H
  __device__ static bool owns(int wc0, int nt) { return !kRagged || wc0 + 8 * nt < kH; }
};

// Chunk c of a tile is [H, kWk] floats: slice hc = c / (2 kWChunksSlice);
// the first kWChunksSlice of a slice are W1 rows hc * H + n, k = kc * kWk +
// j; the others W2 rows n, k = hc * H + kc * kWk + j (kc = c %
// kWChunksSlice, n < H, j < kWk). A thread loads the float4 pieces tid +
// 256 i, i < kWPieces (row piece / kWRowPieces, columns 4 (piece %
// kWRowPieces) ...).
__device__ __forceinline__ void fetch_w(float4 (&v)[kWPieces], const ChainWeights& w, int c) {
  const unsigned uc = c;
  const int hc = uc / (2 * kWChunksSlice), kc = uc % kWChunksSlice;
  const bool second = (uc / kWChunksSlice) & 1;
  const float* base = second ? w.w2 + hc * kH + kc * kWk : w.w1 + size_t(hc) * kH * kH + kc * kWk;
  const int ld = second ? kF : kH;
#pragma unroll
  for (int i = 0; i < kWPieces; ++i) {
    const unsigned e = threadIdx.x + kThreads * i;
    if (kWAll % kThreads == 0 || e < kWAll)
      v[i] = __ldg(reinterpret_cast<const float4*>(base + size_t(e / kWRowPieces) * ld) +
                   (e % kWRowPieces));
  }
}

// the fetched pieces into a stage, split into TF32 hi and lo parts (two
// [H][kLdW] arrays), once for all warps
template <int R>
__device__ __forceinline__ void stash_w(const float4 (&v)[kWPieces], unsigned char* stage) {
  using C = ChainMma<R>;
  uint32_t* hi = reinterpret_cast<uint32_t*>(stage);
#pragma unroll
  for (int i = 0; i < kWPieces; ++i) {
    const unsigned e = threadIdx.x + kThreads * i;
    if (kWAll % kThreads != 0 && e >= kWAll) continue;
    const int at = (e / kWRowPieces) * C::kLdW + (e % kWRowPieces) * 4;
    uint4 h, l;
    split_tf32(v[i].x, h.x, l.x);
    split_tf32(v[i].y, h.y, l.y);
    split_tf32(v[i].z, h.z, l.z);
    split_tf32(v[i].w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(hi + kH * C::kLdW + at) = l;
  }
}

// acc += A[:, a_col : a_col + 32] . chunk^T over the warp's block (rows
// wr0.., chunk rows = output columns wc0..): the chunk's 3xTF32 sum from
// zero, then one round-to-nearest add
template <int R>
__device__ __forceinline__ void chunk_product(float (&acc)[ChainMma<R>::kMT][ChainMma<R>::kNT][4],
                                              const float* A, int a_col,
                                              const unsigned char* stage, int lane, int wr0,
                                              int wc0) {
  using C = ChainMma<R>;
  const uint32_t* Wh = reinterpret_cast<const uint32_t*>(stage);
  const uint32_t* Wl = Wh + kH * C::kLdW;
  const int g = lane >> 2, t = lane & 3;
  float p[C::kMT][C::kNT][4];
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[mt][nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kWk / 8; ++ks) {
    uint32_t ah[C::kMT][4], al[C::kMT][4];
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      const float* ar = A + (wr0 + mt * 16 + g) * C::kLdA + a_col + ks * 8 + t;
      split_tf32(ar[0], ah[mt][0], al[mt][0]);
      split_tf32(ar[8 * C::kLdA], ah[mt][1], al[mt][1]);
      split_tf32(ar[4], ah[mt][2], al[mt][2]);
      split_tf32(ar[8 * C::kLdA + 4], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt) {
      if (!C::owns(wc0, nt)) continue;
      const int o = (wc0 + nt * 8 + g) * C::kLdW + ks * 8 + t;
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
        mma_3xtf32(p[mt][nt], ah[mt], al[mt], Wh[o], Wh[o + 4], Wl[o], Wl[o + 4]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += p[mt][nt][i];
}

// One chunk c: load chunk c + 1 into registers, multiply chunk c, stash
// c + 1 in the other stage, barrier.
template <int R>
__device__ __forceinline__ void chain_step(float (&acc)[ChainMma<R>::kMT][ChainMma<R>::kNT][4],
                                           const float* A, int a_col, int c,
                                           float4 (&pre)[kWPieces],
                                           const ChainWeights& w, unsigned char* Wst, int lane,
                                           int wr0, int wc0) {
  using C = ChainMma<R>;
  if (c + 1 < kWChunks) fetch_w(pre, w, c + 1);
  chunk_product<R>(acc, A, a_col, Wst + (c & 1) * C::kWBytes, lane, wr0, wc0);
  if (c + 1 < kWChunks) stash_w<R>(pre, Wst + ((c + 1) & 1) * C::kWBytes);
  __syncthreads();
}

template <int R>
__device__ __forceinline__ void zero_acc(float (&acc)[ChainMma<R>::kMT][ChainMma<R>::kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < ChainMma<R>::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < ChainMma<R>::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// smem is ChainMma<R>::kBytes of shared memory. Its first [R][kLdA]
// elements hold xx (rows >= nvalid zeros), written by every thread before
// the call; the rest is scratch. pre holds chunk 0 of the weights
// (fetch_w), loaded by the caller before it formed xx. store(row, col, y,
// y1) takes columns col and col + 1 of a row < nvalid.
template <int R, typename Store>
__device__ __forceinline__ void chain_ffn_mma(unsigned char* smem, float4 (&pre)[kWPieces],
                                              const ChainWeights& w, int nvalid, Store store) {
  using C = ChainMma<R>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wcol = warp % C::kCW;
  const int wr0 = (warp / C::kCW) * (R / C::kRW);
  const int wc0 = wcol * (8 * C::kNT);

  const float* XX = reinterpret_cast<const float*>(smem);         // [R][kLdA]
  float* Hs = reinterpret_cast<float*>(smem + C::kABytes);        // [R][kLdA] one hidden slice
  unsigned char* Wst = smem + 2 * C::kABytes;                      // two weight stages
  float2* stats = reinterpret_cast<float2*>(Wst + 2 * C::kWBytes);  // [R][kCW]
  stash_w<R>(pre, Wst);
  __syncthreads();  // xx and chunk 0 are in place

  float acc[C::kMT][C::kNT][4], acc2[C::kMT][C::kNT][4];
  zero_acc<R>(acc2);
  for (int hc = 0; hc < kSlices; ++hc) {
    zero_acc<R>(acc);
#pragma unroll
    for (int kc = 0; kc < kWChunksSlice; ++kc)
      chain_step<R>(acc, XX, kc * kWk, hc * 2 * kWChunksSlice + kc, pre, w, Wst, lane, wr0, wc0);
    // hidden columns hc * H + col: act(xx . W1 + b1)
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
        if (!C::owns(wc0, nt)) continue;
        const int col = wc0 + nt * 8 + 2 * t;
        const float b0 = w.b1[hc * kH + col], b1 = w.b1[hc * kH + col + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wr0 + mt * 16 + g + 8 * r;
          *reinterpret_cast<float2*>(Hs + row * C::kLdA + col) =
              make_float2(act(acc[mt][nt][2 * r] + b0), act(acc[mt][nt][2 * r + 1] + b1));
        }
      }
    __syncthreads();
    // acc2 += h[:, slice] . W2[:, slice]^T
#pragma unroll
    for (int kc = 0; kc < kWChunksSlice; ++kc)
      chain_step<R>(acc2, Hs, kc * kWk, (2 * hc + 1) * kWChunksSlice + kc, pre, w, Wst, lane,
                    wr0, wc0);
  }

  // z = xx + h . W2 + b2 in acc2; LN_b's row sums over the CW warps
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr0 + mt * 16 + g + 8 * r;
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!C::owns(wc0, nt)) continue;
          const int col = wc0 + nt * 8 + 2 * t + j;
          float& z = acc2[mt][nt][2 * r + j];
          z = XX[row * C::kLdA + col] + (z + w.b2[col]);
          s += z;
          s2 += z * z;
        }
      s = quad_sum(s);
      s2 = quad_sum(s2);
      if (t == 0) stats[row * C::kCW + wcol] = make_float2(s, s2);
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr0 + mt * 16 + g + 8 * r;
      if (row >= nvalid) continue;
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int cw = 0; cw < C::kCW; ++cw) {
        const float2 p = stats[row * C::kCW + cw];
        s += p.x;
        s2 += p.y;
      }
      const float mean = s / float(kH);
      const float rs = rsqrtf(fmaxf(s2 / float(kH) - mean * mean, 0.f) + 1e-6f);
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
        if (!C::owns(wc0, nt)) continue;
        const int col = wc0 + nt * 8 + 2 * t;
        store(row, col,
              (acc2[mt][nt][2 * r] - mean) * rs * w.lnb_w[col] + w.lnb_b[col],
              (acc2[mt][nt][2 * r + 1] - mean) * rs * w.lnb_w[col + 1] + w.lnb_b[col + 1]);
      }
    }
}

// The chain of one tile: every thread calls this once x0 is in shared
// memory (x0(r, c) reads it, as in ln_a_rows), with chunk 0 of the weights
// in pre (fetch_w). smem is ChainMma<R>::kBytes; xx is formed in place into
// its first [R][kLdA] floats, which x0 may occupy (each lane overwrites
// only the values it read).
template <int R, typename X0, typename Store>
__device__ __forceinline__ void chain_mma(unsigned char* smem, float4 (&pre)[kWPieces],
                                          const ChainWeights& w, int nvalid, X0 x0, Store store) {
  float* XX = reinterpret_cast<float*>(smem);
  __syncthreads();  // x0 is written
  ln_a_rows<float, R, kThreads / 32>(w, nvalid, x0,
                                     [&](int r, int c, float v) { XX[r * ChainMma<R>::kLdA + c] = v; });
  chain_ffn_mma<R>(smem, pre, w, nvalid, store);
}

}  // namespace packppi
