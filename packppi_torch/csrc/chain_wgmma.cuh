// The residual chain in bf16 on wgmma, over one tile of 64 rows, by KS
// warpgroups of 4 warps that split the FFN's hidden slices between them
// (chain.cu takes KS = 4 where there are too few tiles to fill the card
// and the FFN has four slices, else 1; the folded edge pass and the
// whole-layer passes always take 1). From x0 rows in shared memory
// (chain_wgmma):
//   xx = rnd(LN_a(x0))                     csrc/chain_common.cuh
//   h  = rnd(act(rnd(xx . W1 + b1)))      W1 [4H, H] Linear layout
//   h  = rnd(h . W2 + b2)                  W2 [H, 4H]
//   y  = LN_b(xx + h)                      handed to store(row, col, y, y')
// rnd rounds to bf16 at every point the unfused flax chain rounds. chain.cu,
// message.cu's message_chain_kernel and layer.cu's two passes all run the
// chain through chain_wgmma<KS>, so for equal x0 and KS they give equal bits.
//
// The products are wgmma m64nNk16 (bf16 operands, float32 sums: the TPU
// kernel's "bf16 operands, f32 accumulate"; csrc/mma.cuh, N up to 256 in
// pieces of 128, 64 and 32). The hidden is made S = min(H, 128) columns at
// a time (4H / S slices: 4 up to H = 128, then 5 to 8) into a [64, S]
// accumulator from xx in shared memory (128-byte swizzle); rounded to bf16
// it is, register for register, the A fragment of the second product, so
// it never leaves the registers; the second product's [64, H] sum stays in
// registers across the slices (with KS > 1 the warpgroups make their
// hidden slices together, then add their second products to the sum one
// after another, in the order of the slices, handing it on through shared
// memory: so a row gets the same bits whatever KS its tile took, and a
// complex the same bits alone and in a batch). A thread holds whole quads
// of its two rows' H columns, so LN_b needs only quad shuffles.
//
// The weights come as one bf16 copy (ops/chain.py makes it once per weight
// version) already in the order and swizzle of the shared-memory panels,
// slice by slice W1 ([S n][64 k] panels over k < H) then W2 ([H n][64 k]
// panels over the slice's S columns): 16 panels of 16 KB at H = 128. One
// thread of each warpgroup streams its slices' panels by bulk copies of
// the TMA unit through a ring of kStages panels, each completing on an
// mbarrier; the panels of a product are multiplied two at a time in one
// batch of wgmma, then their stages take the next two panels. A tile reads
// 8 H^2 bf16 weights from L2 (256 KB at H = 128) and converts nothing. A
// small ring keeps the block small: with KS = 1 and H <= 128 three blocks
// fit an SM (at most 168 registers a thread), and while one forms its xx or
// stores its rows the others multiply; from H = 160 on the [64, H] sum
// alone takes 80-128 registers, and a block takes the SM's registers. With
// KS = 4 a warpgroup's one slice needs at most 128 registers (the first
// product's sum is dead once it is the second's A fragments).
#pragma once

#include "chain_common.cuh"
#include "mma.cuh"

namespace packppi {

constexpr int kPanelK = 64;                                // k of one swizzled panel
constexpr int kSliceW = kH < 128 ? kH : 128;               // hidden columns a slice: S
constexpr int kWgSlices = kF / kSliceW;                    // 4 (H <= 128) to 8
constexpr int kPanels1 = panels64(kH);                     // W1 panels a slice (k = H)
constexpr int kPanels2 = panels64(kSliceW);                // W2 panels a slice (k = S)
constexpr int kPanelsSlice = kPanels1 + kPanels2;
constexpr int kPanels = kWgSlices * kPanelsSlice;          // 16 weight panels a tile at H = 128
constexpr uint32_t kPanel1Bytes = kSliceW * kPanelK * 2;   // [S n][64 k] bf16
constexpr uint32_t kPanel2Bytes = kH * kPanelK * 2;        // [H n][64 k] bf16: 16 KB at 128
constexpr uint32_t kSliceBytes = kPanels1 * kPanel1Bytes + kPanels2 * kPanel2Bytes;
constexpr uint32_t kPanelBytes = kPanel2Bytes;             // a ring stage (the larger panel)
constexpr int kStages = 2;
constexpr int kTileRows = 64;

template <int KS>
struct ChainWg {
  static constexpr int kThreads = 128 * KS;
  static constexpr int kPanelsWg = kPanels / KS;             // a warpgroup's panels
  // the xx tile: [64][H] bf16 as 64-column panels ([2][64][64] at H = 128)
  static constexpr uint32_t kActBytes = uint32_t(kTileRows) * kPanels1 * kPanelK * 2;
  static constexpr uint32_t kRingBytes = uint32_t(kStages) * kPanelBytes;  // one warpgroup's
  // xx, the rings, their mbarriers, and slack to align the base to 1,024
  static constexpr size_t kBytes = kActBytes + KS * (kRingBytes + 8 * kStages) + 1024;
  static constexpr int kMinBlocks = KS == 1 && kH <= 128 ? 3 : 1;   // blocks an SM
  static_assert(KS == 1 || (kWgSlices == KS && kRingBytes >= kTileRows * kH * 4),
                "one slice a warpgroup; its ring holds a [64, H] sum");
  static_assert(kBytes <= 232448, "the chain's tile and rings fit a block");
};

// byte offset of bf16 element (r, c) of the [64, H] xx tile: 64-column
// panels of 64 swizzled rows
__device__ __forceinline__ uint32_t act_offset(int r, int c) {
  return uint32_t(c >> 6) * uint32_t(kTileRows * 128) + sw128_offset(r, c & 63);
}

template <int KS>
__device__ __forceinline__ unsigned char* wg_ring(unsigned char* smem, int wg) {
  return smem + ChainWg<KS>::kActBytes + wg * ChainWg<KS>::kRingBytes;
}

template <int KS>
__device__ __forceinline__ uint64_t* wg_bars(unsigned char* smem, int wg) {
  return reinterpret_cast<uint64_t*>(smem + ChainWg<KS>::kActBytes +
                                     KS * ChainWg<KS>::kRingBytes) + wg * kStages;
}

// panel i of warpgroup wg's ring into stage i % kStages (by one thread):
// panel j = i % kPanelsSlice of hidden slice (i / kPanelsSlice) KS + wg
template <int KS>
__device__ __forceinline__ void request_panel(unsigned char* smem, const __nv_bfloat16* wpack,
                                              int wg, int i) {
  const int s = i % kStages;
  const int hc = (i / kPanelsSlice) * KS + wg, j = i % kPanelsSlice;
  const bool first = j < kPanels1;
  const uint32_t bytes = first ? kPanel1Bytes : kPanel2Bytes;
  const size_t at = size_t(hc) * kSliceBytes +
                    (first ? j * kPanel1Bytes
                           : kPanels1 * kPanel1Bytes + (j - kPanels1) * kPanel2Bytes);
  uint64_t* bar = wg_bars<KS>(smem, wg) + s;
  mbar_expect_tx(bar, bytes);
  bulk_copy(wg_ring<KS>(smem, wg) + s * kPanelBytes,
            reinterpret_cast<const unsigned char*>(wpack) + at, bytes, bar);
}

// smem: kBytes - 1024 bytes at 1,024-byte alignment. Called by every
// thread before xx is formed: the first thread of each warpgroup sets up
// its ring's mbarriers and requests its first kStages panels, which then
// load while xx is formed.
template <int KS>
__device__ __forceinline__ void chain_wgmma_prefetch(unsigned char* smem,
                                                     const __nv_bfloat16* wpack) {
  if (threadIdx.x % 128 == 0) {
    const int wg = threadIdx.x / 128;
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(wg_bars<KS>(smem, wg) + s, 1);
    fence_mbar_init();
#pragma unroll
    for (int i = 0; i < kStages; ++i) request_panel<KS>(smem, wpack, wg, i);
  }
  __syncthreads();  // the mbarriers are set up before anyone waits on them
}

// the 128 threads of warpgroup wg (named barrier wg + 1; 0 is the block's)
template <int KS>
__device__ __forceinline__ void wg_sync(int wg) {
  if constexpr (KS == 1) {
    __syncthreads();
  } else {
    switch (wg) {
      case 0: asm volatile("bar.sync 1, 128;\n" ::: "memory"); break;
      case 1: asm volatile("bar.sync 2, 128;\n" ::: "memory"); break;
      case 2: asm volatile("bar.sync 3, 128;\n" ::: "memory"); break;
      default: asm volatile("bar.sync 4, 128;\n" ::: "memory"); break;
    }
  }
}

// The first kActBytes of smem hold xx (rows >= nvalid zeros), written by
// every thread after chain_wgmma_prefetch. store(row, col, y, y1) takes
// columns col and col + 1 of a row < nvalid.
template <int KS, typename Store>
__device__ __forceinline__ void chain_ffn_wgmma(unsigned char* smem, const ChainWeights& w,
                                                const __nv_bfloat16* wpack, int nvalid,
                                                Store store) {
  using C = ChainWg<KS>;
  const unsigned char* XX = smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int r0 = (warp & 3) * 16 + g;  // the thread's rows r0 and r0 + 8
  const uint32_t xx_s = smem_u32(XX);
  const uint32_t ring_s = smem_u32(wg_ring<KS>(smem, wg));
  uint64_t* full = wg_bars<KS>(smem, wg);
  fence_proxy_async();  // xx, written through the generic proxy, for wgmma
  __syncthreads();

  // the warpgroup's panel i (its stage), once its bytes have landed
  auto wait_panel = [&](int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    return ring_s + uint32_t(i % kStages) * kPanelBytes;
  };
  // the warpgroup is done with its panels i .. i + n - 1: their stages take
  // the panels kStages further on
  auto release = [&](int i, int n) {
    wg_sync<KS>(wg);
    if (threadIdx.x % 128 == 0) {
      for (int k = i; k < i + n; ++k)
        if (k + kStages < C::kPanelsWg) request_panel<KS>(smem, wpack, wg, k + kStages);
    }
  };

  float acc[kSliceW / 2], acc2[kH / 2];
#pragma unroll
  for (int i = 0; i < kH / 2; ++i) acc2[i] = 0.f;
  for (int sl = 0; sl < kWgSlices / KS; ++sl) {
    const int hc = sl * KS + wg;  // the hidden slice
    const int p0 = sl * kPanelsSlice;
    // acc = xx . W1[hc * S .., :]^T over k < H, two panels a batch
#pragma unroll
    for (int i = 0; i < kSliceW / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kPanels1; kp += 2) {
      const int n = cmin(2, kPanels1 - kp);
      uint32_t b_s[2];
#pragma unroll
      for (int q = 0; q < n; ++q) b_s[q] = wait_panel(p0 + kp + q);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < n; ++q)
#pragma unroll
        for (int j = 0; j < ksteps16(kH, kp + q); ++j)
          wgmma_bf16<kSliceW>(acc, xx_s + uint32_t(kp + q) * (kTileRows * 128) + 32 * j,
                              b_s[q] + 32 * j);
      wgmma_commit();
      wgmma_wait<0>();
      release(p0 + kp, n);
    }
    // h = rnd(act(rnd(acc + b1))) as A fragments: k-step s of the second
    // product takes hidden columns 16 s .. 16 s + 15, i.e. the accumulator's
    // column tiles 2 s and 2 s + 1
    uint32_t ha[kSliceW / 16][4];
#pragma unroll
    for (int s = 0; s < kSliceW / 16; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * s + half, col = hc * kSliceW + 8 * j + 2 * t;
        const float b0 = w.b1[col], b1 = w.b1[col + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          ha[s][2 * half + r] = pack_bf16(
              rnd<__nv_bfloat16>(act(rnd<__nv_bfloat16>(acc[4 * j + 2 * r] + b0))),
              rnd<__nv_bfloat16>(act(rnd<__nv_bfloat16>(acc[4 * j + 2 * r + 1] + b1))));
      }
    // acc2 += h . W2[:, hc * S ..]^T (the slice's W2 panels). With KS > 1
    // (one slice a warpgroup) the warpgroups take their turns in the order
    // of the slices, each starting from the sum the one before left in its
    // (finished) ring: the same products in the same order as KS = 1, so
    // the same bits whatever KS the tile count picks (thread i of every
    // warpgroup holds the same elements)
    const int i = threadIdx.x % 128;
#pragma unroll 1
    for (int turn = 0; turn < KS; ++turn) {
      if (turn == wg) {
        if (turn > 0) {
          const float* prev = reinterpret_cast<const float*>(wg_ring<KS>(smem, turn - 1));
#pragma unroll
          for (int e = 0; e < kH / 2; ++e) acc2[e] = prev[e * 128 + i];
        }
#pragma unroll
        for (int kp = 0; kp < kPanels2; kp += 2) {
          const int n = cmin(2, kPanels2 - kp);
          uint32_t b_s[2];
#pragma unroll
          for (int q = 0; q < n; ++q) b_s[q] = wait_panel(p0 + kPanels1 + kp + q);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < n; ++q)
#pragma unroll
            for (int j = 0; j < ksteps16(kSliceW, kp + q); ++j)
              wgmma_bf16_rs<kH>(acc2, ha[4 * (kp + q) + j], b_s[q] + 32 * j);
          wgmma_commit();
          wgmma_wait<0>();
          release(p0 + kPanels1 + kp, n);
        }
        if (turn + 1 < KS) {
          float* mine = reinterpret_cast<float*>(wg_ring<KS>(smem, wg));
#pragma unroll
          for (int e = 0; e < kH / 2; ++e) mine[e * 128 + i] = acc2[e];
        }
      }
      if constexpr (KS > 1) __syncthreads();
    }
  }
  // the last warpgroup holds the whole sum
  if (wg != KS - 1) return;

  // z = xx + rnd(h . W2 + b2); LN_b over the quad's H columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kH / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(XX + act_offset(row, col));
      float& z0 = acc2[4 * j + 2 * r];
      float& z1 = acc2[4 * j + 2 * r + 1];
      z0 = __low2float(xv) + rnd<__nv_bfloat16>(z0 + w.b2[col]);
      z1 = __high2float(xv) + rnd<__nv_bfloat16>(z1 + w.b2[col + 1]);
      s += z0 + z1;
      s2 += z0 * z0 + z1 * z1;
    }
    s = quad_sum(s);
    s2 = quad_sum(s2);
    if (row >= nvalid) continue;
    const float mean = s / float(kH);
    const float rs = rsqrtf(fmaxf(s2 / float(kH) - mean * mean, 0.f) + 1e-6f);
#pragma unroll
    for (int j = 0; j < kH / 8; ++j) {
      const int col = 8 * j + 2 * t;
      store(row, col, (acc2[4 * j + 2 * r] - mean) * rs * w.lnb_w[col] + w.lnb_b[col],
            (acc2[4 * j + 2 * r + 1] - mean) * rs * w.lnb_w[col + 1] + w.lnb_b[col + 1]);
    }
  }
}

// The chain of one tile: every thread calls this once x0 is in shared
// memory (x0(r, c) reads it, as in ln_a_rows), after chain_wgmma_prefetch.
// xx is formed in place into the first kActBytes of smem, which x0 may
// occupy (each lane overwrites only the values it read).
template <int KS, typename X0, typename Store>
__device__ __forceinline__ void chain_wgmma(unsigned char* smem, const ChainWeights& w,
                                            const __nv_bfloat16* wpack, int nvalid, X0 x0,
                                            Store store) {
  __syncthreads();  // x0 is written
  ln_a_rows<__nv_bfloat16, kTileRows, ChainWg<KS>::kThreads / 32>(
      w, nvalid, x0, [&](int r, int c, float v) {
        *reinterpret_cast<__nv_bfloat16*>(smem + act_offset(r, c)) = __float2bfloat16_rn(v);
      });
  chain_ffn_wgmma<KS>(smem, w, wpack, nvalid, store);
}

}  // namespace packppi
