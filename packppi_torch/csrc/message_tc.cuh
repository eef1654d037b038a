// The three products of the IPMP message MLP on tensor cores, over one tile
// of kRows = 64 edge rows of whole nodes (64 / K nodes of K edges; from K =
// 65 on, one node's edge rows kRows at a time), for the
// kernels whose streams are in the compute type T (message.cu
// message_kernel, message_geom_kernel and message_chain_kernel,
// message_feat.cu, layer.cu):
//
//   x = act([h_E | geom] . W_e + b_e + per_i[node] + pj[row])
//   x = act(x . W_1 + b_1)
//   x = x . W_2 + b_2
//
// message_tc_rows hands x, float32, to the caller's rows(r, c, x, x') in
// the accumulator's own layout, after a barrier past which the tile and the
// ring are free. On it: message_tc's two endings (pool: out[node] = sum_k
// mask[node,k] x[node,k] / K, float32, summed over k in order, across a
// node's tiles too; else out[row]
// = x in the stream type), the whole-layer node pass's pool (the same sum
// times 1/K, into shared memory) and the edge rows of the folded edge pass
// and of the whole-layer edge pass, which go on into the residual chain.
// Product operands are T's values; sums, biases, per_i and the pj addition
// float32; relu passes a NaN on. The widths H, He and P are the build's
// (csrc/tile.cuh). The first product's depth He + 9P (200 at 128 and 8) is
// padded to kIn1, a multiple of 16 (208: a bf16 k-step, a float32 chunk),
// with zero operand columns and zero weight rows.
//
// bf16 (MessageTc<__nv_bfloat16>): one warpgroup, wgmma m64nHk16 (bf16
// operands, float32 sums). The tile's [h_E | geom] rows are A from shared
// memory in the 128-byte swizzle ([64][64] panels, four at 128 and 8, the
// last read to k kIn1 only). Layer 1's accumulator, plus b_e, per_i and pj,
// through relu and rounded to bf16, is register for register the A
// fragment of the second product, and the second's of the third
// (csrc/chain_wgmma.cuh's register-A form), so the hidden activations never
// go to shared memory; the A panels past h_E's are free from layer 2 on (the
// A tile has at least twice H's panels, for the folded chain's xx tile).
// float32 (MessageTc<float>): 8 warps, mma.sync m16n8k8 in 3xTF32
// (csrc/mma.cuh); each warp owns a 32 x H / 4 block of each [64, H] product.
// A is read from shared memory and split into TF32 parts as it is loaded;
// each 16-k weight chunk's partial is summed from zero and added to the
// running sum with a round-to-nearest add (the tensor core sums toward
// zero); the hidden activations go through shared memory.
//
// The weights come as one packed copy per weight version
// (ops/message_feat.py::pack_message_weights): [W_e | W_1 | W_2] over
// k = kIn1 + H + H (208 + 128 + 128), W_e being W_in's h_E and geometry
// column blocks. In bf16, [H n][64 k] panels in the 128-byte swizzle that
// the wgmma descriptors read, each weight's k padded to whole panels (eight
// at 128 and 8: the fourth W_e panel holds k 192-255, of which 192-207 are
// read: 128 KB copied, 116 KB read); in float32, kIn1 / 16 + H / 8 chunks
// of 16 k (29 at 128 and 8) holding each weight's TF32 high and low parts,
// split once when the copy
// is made (not in every block), in the order of the mma.sync B fragments
// (one 16-byte shared-memory load gives a lane both parts of both
// registers). One thread streams them
// by bulk copies of the TMA unit into a ring of kStages stages of 128 H
// bytes (16 KB), each completing on an mbarrier; the first stages load while
// the tile is formed.
//
// Shared memory at 128, 128 and 8: the A tile (bf16 32 KB, float32 54 KB,
// later the hidden rows and the pool tile), the ring, then the tables (the
// per-row pjrow and mrow, the mbarriers; a kernel that needs more room at
// the base puts them further on): bf16 66 KB, three blocks an SM, so that
// while one block forms its tile (indexed loads, geometry) or stores its
// rows the others multiply; float32 102 KB, two blocks an SM. From H = 160
// on a thread's accumulators and A fragments take most of its registers,
// and a block takes an SM.
//
// Use: message_tc_prefetch by every thread first; then the caller fills the
// tile (tile_rows, tile_put, tile_zero_pad and the pjrow / mrow tables, see
// MessageTile; tile_features for precomputed streams) and calls
// tile_publish; then message_tc or message_tc_rows.
#pragma once

#include <type_traits>

#include "mma.cuh"
#include "tile.cuh"

namespace packppi {

constexpr int kG = 9 * kP;                    // geometry features an edge
constexpr int kIn = kHe + kG;                 // first product's depth: [h_E | geom]
constexpr int kIn1 = (kIn + 15) / 16 * 16;    // first product's depth, padded: 208
constexpr int kMsgDepth = kIn1 + 2 * kH;      // k rows of the packed weights: 464
constexpr uint32_t kMsgUnitBytes = 128u * kH; // one panel (bf16) or chunk (float32): 16 KB
constexpr int kWePanels = panels64(kIn1);     // bf16 W_e panels: 4
constexpr int kHPanels = panels64(kH);        // bf16 W_1 (and W_2) panels: 2

template <typename T>
struct MessageTc;

template <>
struct MessageTc<__nv_bfloat16> {
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = kH <= 128 ? 3 : 1;
  static constexpr int kStages = 2;
  static constexpr int kUnits = kWePanels + 2 * kHPanels;          // W_e 4, W_1 2, W_2 2 panels
  static constexpr uint32_t kPanelA = uint32_t(kRows) * 128;        // one [64][64] A panel
  // [h_E | geom], and room for h_E and the folded chain's xx tile after it
  static constexpr uint32_t kActBytes = cmax(kWePanels, 2 * kHPanels) * kPanelA;
  static constexpr int kLdY = kH + 8;                               // pool tile row (floats)
  // byte offset of element (r, k) of the A tile
  __device__ static uint32_t a_offset(int r, int k) {
    return uint32_t(k >> 6) * kPanelA + sw128_offset(r, k & 63);
  }
};

template <>
struct MessageTc<float> {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = kH <= 128 ? 2 : 1;
  static constexpr int kStages = 3;
  static constexpr int kChunkK = 16;
  static constexpr int kUnits = kMsgDepth / kChunkK;                // 29 chunks
  static constexpr int kLdA = kIn1 + 4;                             // A row (floats)
  static constexpr int kLdH = kH + 4;                               // hidden and pool rows
  static constexpr int kLdY = kLdH;
  static constexpr int kNT = kH / 32;                               // n8 tiles a warp: 4
  // the A tile, later the hidden rows
  static constexpr uint32_t kActBytes = uint32_t(kRows) * cmax(kLdA, kLdH) * 4;
  __device__ static uint32_t a_offset(int r, int k) { return uint32_t(r * kLdA + k) * 4u; }
};

constexpr uint32_t align16(uint32_t n) { return (n + 15u) & ~15u; }

template <typename T>
struct MessageTcBytes {
  using C = MessageTc<T>;
  static constexpr uint32_t kRing = C::kActBytes;                   // offsets from the base
  static constexpr uint32_t kTables = kRing + C::kStages * kMsgUnitBytes;
  // pjrow, mrow, the mbarriers
  static constexpr uint32_t kTableBytes = kRows * 8 + kRows * 4 + C::kStages * 8;
  // the dynamic shared memory of a kernel whose tables start at tables_at
  // (and slack to align the base to 1,024, for the swizzled panels)
  static constexpr size_t total(uint32_t tables_at) { return tables_at + kTableBytes + 1024; }
  static constexpr size_t kTotal = total(kTables);
  static_assert(kRows * C::kLdY * 4 <= kTables, "the pool tile fits the tile and the ring");
  static_assert(kMsgUnitBytes == (std::is_same<T, float>::value ? 16 * kH * 8 : kH * 64 * 2),
                "a ring stage is one panel or one chunk");
  static_assert(kTotal <= 232448, "the message tile and ring fit a block");
};

// The block's shared memory: the A tile and the ring from the base, the
// tables (pjrow: row of the neighbour term in pj, -1 for a row past the
// end; mrow: edge mask; the mbarriers) at `tables_at` from it.
template <typename T>
struct MessageTile {
  using B = MessageTcBytes<T>;
  unsigned char* base;
  unsigned char* tables;
  __device__ explicit MessageTile(unsigned char* raw, uint32_t tables_at = B::kTables)
      : base(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)), tables(base + tables_at) {}
  __device__ unsigned char* ring() const { return base + B::kRing; }
  __device__ int64_t* pjrow() const { return reinterpret_cast<int64_t*>(tables); }
  __device__ float* mrow() const { return reinterpret_cast<float*>(tables + kRows * 8); }
  __device__ uint64_t* bars() const { return reinterpret_cast<uint64_t*>(tables + kRows * 12); }
};

// Weight unit i (panel or chunk) into stage i % kStages, by one thread.
template <typename T>
__device__ __forceinline__ void message_tc_request(const MessageTile<T>& s, const void* wpack,
                                                   int i) {
  const int st = i % MessageTc<T>::kStages;
  uint64_t* bar = s.bars() + st;
  mbar_expect_tx(bar, kMsgUnitBytes);
  bulk_copy(s.ring() + st * kMsgUnitBytes,
            static_cast<const unsigned char*>(wpack) + size_t(i) * kMsgUnitBytes, kMsgUnitBytes,
            bar);
}

// The first thread sets up the ring's mbarriers and requests the first
// kStages units. A barrier must follow before anyone waits (tile_publish's).
// reinit: the block's tile before this one used the mbarriers (all their
// phases complete), which are invalidated first.
template <typename T>
__device__ __forceinline__ void message_tc_prefetch(const MessageTile<T>& s, const void* wpack,
                                                    bool reinit = false) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MessageTc<T>::kStages; ++i) {
      if (reinit) mbar_inval(s.bars() + i);
      mbar_init(s.bars() + i, 1);
    }
    fence_mbar_init();
#pragma unroll
    for (int i = 0; i < MessageTc<T>::kStages; ++i) message_tc_request(s, wpack, i);
  }
}

// Unit i, once its bytes have landed: its stage's shared-memory address.
template <typename T>
__device__ __forceinline__ uint32_t message_tc_wait(const MessageTile<T>& s, int i) {
  constexpr int kStages = MessageTc<T>::kStages;
  mbar_wait(s.bars() + i % kStages, (i / kStages) & 1);
  return smem_u32(s.ring()) + uint32_t(i % kStages) * kMsgUnitBytes;
}

// Every thread is done with units first .. last: their stages take the units
// kStages further on.
template <typename T>
__device__ __forceinline__ void message_tc_release(const MessageTile<T>& s, const void* wpack,
                                                   int first, int last) {
  constexpr int kStages = MessageTc<T>::kStages;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = first; i <= last; ++i)
      if (i + kStages < MessageTc<T>::kUnits) message_tc_request(s, wpack, i + kStages);
}

// The tile's rows of a stream [*, W] in T (h_E, precomputed geometry),
// from edge row erow0, into A columns k0 .. k0 + W - 1, by asynchronous
// 16-byte copies where W * sizeof(T) is a multiple of 16 (the stream's base
// address is then one too), else value by value; rows past `rows` zeros.
template <typename T, int W>
__device__ __forceinline__ void tile_rows(const MessageTile<T>& s, const T* __restrict__ src,
                                          int k0, int64_t erow0, int rows) {
  if constexpr (W * sizeof(T) % 16 == 0) {
    constexpr int kPer = 16 / int(sizeof(T));  // values a copy
    constexpr int pieces = W / kPer;
    for (int e = threadIdx.x; e < kRows * pieces; e += MessageTc<T>::kThreads) {
      const int r = e / pieces, k = k0 + (e % pieces) * kPer;
      const bool valid = r < rows;
      // a row past the end copies nothing (src must still be a valid address)
      cp_async16(s.base + MessageTc<T>::a_offset(r, k),
                 src + (valid ? (erow0 + r) * W + (k - k0) : 0), valid);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * W; e += MessageTc<T>::kThreads) {
      const int r = e / W, k = e % W;
      *reinterpret_cast<T*>(s.base + MessageTc<T>::a_offset(r, k0 + k)) =
          r < rows ? src[(erow0 + r) * W + k] : from_f32<T>(0.f);
    }
  }
}

// one value of the A tile, rounded to T
template <typename T>
__device__ __forceinline__ void tile_put(const MessageTile<T>& s, int r, int k, float v) {
  *reinterpret_cast<T*>(s.base + MessageTc<T>::a_offset(r, k)) = from_f32<T>(v);
}

// columns kIn .. kIn1 - 1 of every row: zeros (threads 0-63)
template <typename T>
__device__ __forceinline__ void tile_zero_pad(const MessageTile<T>& s) {
  constexpr int kPer = 16 / int(sizeof(T));  // values of 16 bytes
  const int r = threadIdx.x;
  if (r >= kRows) return;
  if constexpr (kIn % kPer == 0) {
#pragma unroll
    for (int k = kIn; k < kIn1; k += kPer)
      *reinterpret_cast<uint4*>(s.base + MessageTc<T>::a_offset(r, k)) = make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int k = kIn; k < kIn1; ++k)
      *reinterpret_cast<T*>(s.base + MessageTc<T>::a_offset(r, k)) = from_f32<T>(0.f);
  }
}

// The tile's pieces have landed and every write is visible to the products
// (wgmma reads the A tile through the async proxy).
template <typename T>
__device__ __forceinline__ void tile_publish() {
  cp_async_wait<0>();
  if constexpr (std::is_same<T, __nv_bfloat16>::value) fence_proxy_async();
  __syncthreads();
}

// The tile from precomputed streams [*, He] h_E and [*, 9P] geometry in T
// (message_feat.cu, layer.cu): `rows` valid edge rows from erow0, pjrow =
// the edge row itself (the neighbour term arrives gathered), mrow; then
// published.
template <typename T>
__device__ __forceinline__ void tile_features(const MessageTile<T>& s, const T* __restrict__ h_E,
                                              const T* __restrict__ geom,
                                              const float* __restrict__ mask, int64_t erow0,
                                              int rows) {
  const int tid = threadIdx.x;
  if (tid < kRows) {
    const bool valid = tid < rows;
    s.pjrow()[tid] = valid ? erow0 + tid : -1;
    s.mrow()[tid] = valid ? mask[erow0 + tid] : 0.f;
  }
  tile_rows<T, kHe>(s, h_E, 0, erow0, rows);
  tile_rows<T, kG>(s, geom, kHe, erow0, rows);
  cp_async_commit();
  tile_zero_pad(s);
  tile_publish<T>();
}

// The node pool from the masked rows Y [kRows][ldy] (float32): the sum over
// k in order, divided by K, or times the float 1/K with `reciprocal` (the
// whole-layer node pass, pallas_layer.py:333); `out` is the tile's first
// node, kH floats a node (device or shared memory). SPAN (K > kRows): the
// tile holds `rows` edge rows of one node, from its edge kRows t on (tile t
// of its ceil(K / kRows)); the tiles before it (not `first`) left their sum
// in out, which this one goes on from (the same thread owns the same
// columns), and the last (`last`) divides. So the node's sum runs over k in
// order across its tiles, in a fixed order, with no atomics.
template <bool SPAN = false>
__device__ __forceinline__ void message_tc_pool(const float* Y, int ldy, float* __restrict__ out,
                                                int K, int rows, int threads,
                                                bool reciprocal = false, bool first = true,
                                                bool last = true) {
  if constexpr (!SPAN) {
    const int nodes = rows / K;
    for (int e = threadIdx.x; e < nodes * kH; e += threads) {
      const int n = e / kH, c = e % kH;
      float sum = 0.f;
      for (int k = 0; k < K; ++k) sum += Y[(n * K + k) * ldy + c];
      out[n * kH + c] = reciprocal ? sum * (1.f / float(K)) : sum / float(K);
    }
  } else {
    for (int c = threadIdx.x; c < kH; c += threads) {
      float sum = first ? 0.f : out[c];
      for (int k = 0; k < rows; ++k) sum += Y[k * ldy + c];
      out[c] = !last ? sum : reciprocal ? sum * (1.f / float(K)) : sum / float(K);
    }
  }
}

// two values of a row, x at column c, in the stream type
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// ---------------------------------------------------------------- bf16 (wgmma)

template <typename Rows>
__device__ __forceinline__ void message_tc_bf16(const MessageTile<__nv_bfloat16>& s,
                                                const float* __restrict__ per_i,
                                                const __nv_bfloat16* __restrict__ pj,
                                                const void* __restrict__ wpack,
                                                const float* __restrict__ b_in,
                                                const float* __restrict__ b_mid,
                                                const float* __restrict__ b_out, int K,
                                                int64_t node0, Rows rows) {
  using C = MessageTc<__nv_bfloat16>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // the thread's rows r0 and r0 + 8
  const uint32_t a_s = smem_u32(s.base);
  const int64_t* pjrow = s.pjrow();
  auto wait = [&](int i) { return message_tc_wait(s, i); };

  float acc[kH / 2];
#pragma unroll
  for (int i = 0; i < kH / 2; ++i) acc[i] = 0.f;
  // layer 1 over k < kIn1: A panel p against W_e panel p, two panels a batch
  // (at 128 and 8: panels 0-1, then panel 2 and the first k-step of panel 3)
#pragma unroll
  for (int p = 0; p < kWePanels; p += 2) {
    const int n = cmin(2, kWePanels - p);
    uint32_t w[2];
#pragma unroll
    for (int q = 0; q < n; ++q) w[q] = wait(p + q);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < n; ++q)
#pragma unroll
      for (int j = 0; j < ksteps16(kIn1, p + q); ++j)
        wgmma_bf16<kH>(acc, a_s + (p + q) * C::kPanelA + 32 * j, w[q] + 32 * j);
    wgmma_commit();
    wgmma_wait<0>();
    message_tc_release(s, wpack, p, p + n - 1);
  }
  // act(acc + b_e + per_i + pj), rounded, as A fragments: k-step q of the
  // next product takes columns 16 q .. 16 q + 15, the accumulator's column
  // tiles 2 q and 2 q + 1
  uint32_t ha[kH / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int64_t j = pjrow[r];
    const float* pi = per_i + (node0 + r / K) * kH;
    const __nv_bfloat16* pr = pj + j * kH;
#pragma unroll
    for (int jt = 0; jt < kH / 8; ++jt) {
      const int col = 8 * jt + 2 * t;
      float v0 = 0.f, v1 = 0.f;
      if (j >= 0) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(b_in + col));
        const float2 p = *reinterpret_cast<const float2*>(pi + col);
        const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(pr + col);
        v0 = act(acc[4 * jt + 2 * h] + b.x + p.x + __low2float(q));
        v1 = act(acc[4 * jt + 2 * h + 1] + b.y + p.y + __high2float(q));
      }
      ha[jt >> 1][2 * (jt & 1) + h] = pack_bf16(v0, v1);
    }
  }

  // x . W over the H-deep A fragments ha and the kHPanels weight panels
  // from unit u0, two panels a batch; every batch but the product's last
  // (`release_last`) hands its stages on
  auto hidden_product = [&](int u0, bool release_last) {
#pragma unroll
    for (int i = 0; i < kH / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < kHPanels; p += 2) {
      const int n = cmin(2, kHPanels - p);
      uint32_t w[2];
#pragma unroll
      for (int q = 0; q < n; ++q) w[q] = wait(u0 + p + q);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < n; ++q)
#pragma unroll
        for (int j = 0; j < ksteps16(kH, p + q); ++j)
          wgmma_bf16_rs<kH>(acc, ha[4 * (p + q) + j], w[q] + 32 * j);
      wgmma_commit();
      wgmma_wait<0>();
      if (release_last || p + 2 < kHPanels) message_tc_release(s, wpack, u0 + p, u0 + p + n - 1);
    }
  };

  // layer 2: act(x . W_1 + b_1), rounded, as A fragments
  hidden_product(kWePanels, true);
#pragma unroll
  for (int jt = 0; jt < kH / 8; ++jt) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(b_mid + 8 * jt + 2 * t));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ha[jt >> 1][2 * (jt & 1) + h] =
          pack_bf16(act(acc[4 * jt + 2 * h] + b.x), act(acc[4 * jt + 2 * h + 1] + b.y));
  }

  // layer 3: x . W_2
  hidden_product(kWePanels + kHPanels, false);

  __syncthreads();  // every warp's products are done: the tile and the ring are free
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int jt = 0; jt < kH / 8; ++jt) {
      const int col = 8 * jt + 2 * t;
      const float2 b = __ldg(reinterpret_cast<const float2*>(b_out + col));
      rows(r, col, acc[4 * jt + 2 * h] + b.x, acc[4 * jt + 2 * h + 1] + b.y);
    }
  }
}

// ------------------------------------------------------ float32 (3xTF32 mma)

// acc = A . W over `chunks` weight chunks from chunk c0 on (A [kRows][lda]
// floats at the tile's base, columns 16 i .. for chunk c0 + i): each chunk's
// 3xTF32 partial from zero, then one round-to-nearest add. Warp w owns rows
// 32 (w / 4) .., columns H / 4 (w % 4) ... (kNT n-tiles). Ends with every
// thread done reading A (the last chunk's barrier).
__device__ __forceinline__ void message_tc_f32_product(float (&acc)[2][MessageTc<float>::kNT][4],
                                                       const MessageTile<float>& s,
                                                       const void* wpack, int lda, int c0,
                                                       int chunks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kNT = MessageTc<float>::kNT;
  const int wr0 = (warp >> 2) * 32, nt0 = (warp & 3) * kNT;
  const float* A = reinterpret_cast<const float*>(s.base);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int i = 0; i < chunks; ++i) {
    const int c = c0 + i;
    const uint4* st = reinterpret_cast<const uint4*>(s.ring() + (c % MessageTc<float>::kStages) *
                                                                    kMsgUnitBytes);
    message_tc_wait(s, c);
    float p[2][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = A + (wr0 + 16 * mt + g) * lda + 16 * i + 8 * ks + t;
        split_tf32(ar[0], ah[mt][0], al[mt][0]);
        split_tf32(ar[8 * lda], ah[mt][1], al[mt][1]);
        split_tf32(ar[4], ah[mt][2], al[mt][2]);
        split_tf32(ar[8 * lda + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // (hi b0, hi b1, lo b0, lo b1) of n-tile nt0 + nt, k-step ks
        const uint4 b = st[(ks * (kH / 8) + nt0 + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(p[mt][nt], ah[mt], al[mt], b.x, b.y, b.z, b.w);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[mt][nt][e];
    message_tc_release(s, wpack, c, c);
  }
}

template <typename Rows>
__device__ __forceinline__ void message_tc_f32(const MessageTile<float>& s,
                                               const float* __restrict__ per_i,
                                               const float* __restrict__ pj,
                                               const void* __restrict__ wpack,
                                               const float* __restrict__ b_in,
                                               const float* __restrict__ b_mid,
                                               const float* __restrict__ b_out, int K,
                                               int64_t node0, Rows rows) {
  using C = MessageTc<float>;
  constexpr int kLdH = C::kLdH, kNT = C::kNT;
  constexpr int kChunks1 = kIn1 / C::kChunkK, kChunksH = kH / C::kChunkK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = (warp >> 2) * 32, wc0 = (warp & 3) * (kH / 4);
  float* hid = reinterpret_cast<float*>(s.base);
  const int64_t* pjrow = s.pjrow();
  float acc[2][kNT][4];

  // layer 1: act(A . W_e + b_e + per_i + pj) into the (consumed) A tile
  message_tc_f32_product(acc, s, wpack, C::kLdA, 0, kChunks1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr0 + 16 * mt + g + 8 * h;
      const int64_t j = pjrow[r];
      const float* pi = per_i + (node0 + r / K) * kH;
      const float* pr = pj + j * kH;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = wc0 + 8 * nt + 2 * t;
        float v0 = 0.f, v1 = 0.f;
        if (j >= 0) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(b_in + col));
          const float2 p = *reinterpret_cast<const float2*>(pi + col);
          const float2 q = *reinterpret_cast<const float2*>(pr + col);
          v0 = act(acc[mt][nt][2 * h] + b.x + p.x + q.x);
          v1 = act(acc[mt][nt][2 * h + 1] + b.y + p.y + q.y);
        }
        *reinterpret_cast<float2*>(hid + r * kLdH + col) = make_float2(v0, v1);
      }
    }
  __syncthreads();

  // layer 2: act(x . W_1 + b_1), in place
  message_tc_f32_product(acc, s, wpack, kLdH, kChunks1, kChunksH);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr0 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = wc0 + 8 * nt + 2 * t;
        const float2 b = __ldg(reinterpret_cast<const float2*>(b_mid + col));
        *reinterpret_cast<float2*>(hid + r * kLdH + col) =
            make_float2(act(acc[mt][nt][2 * h] + b.x), act(acc[mt][nt][2 * h + 1] + b.y));
      }
    }
  __syncthreads();

  // layer 3: x . W_2 + b_2
  message_tc_f32_product(acc, s, wpack, kLdH, kChunks1 + kChunksH, kChunksH);
  __syncthreads();  // every warp's products are done: the tile and the ring are free
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr0 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = wc0 + 8 * nt + 2 * t;
        const float2 b = __ldg(reinterpret_cast<const float2*>(b_out + col));
        rows(r, col, acc[mt][nt][2 * h] + b.x, acc[mt][nt][2 * h + 1] + b.y);
      }
    }
}

// The three products with the bias and neighbour terms over the tile, whose
// nodes start at node row node0 (global): rows(r, c, x, x') takes columns c
// and c + 1 of tile row r, x . W_2 + b_2 in float32, for every row of the
// tile (past the valid ones too), after a barrier: the A tile and the ring
// are free then. Every thread of the block calls this after tile_publish.
template <typename T, typename Rows>
__device__ __forceinline__ void message_tc_rows(const MessageTile<T>& s,
                                                const float* __restrict__ per_i,
                                                const T* __restrict__ pj,
                                                const void* __restrict__ wpack,
                                                const float* __restrict__ b_in,
                                                const float* __restrict__ b_mid,
                                                const float* __restrict__ b_out, int K,
                                                int64_t node0, Rows rows) {
  if constexpr (std::is_same<T, float>::value)
    message_tc_f32(s, per_i, pj, wpack, b_in, b_mid, b_out, K, node0, rows);
  else
    message_tc_bf16(s, per_i, pj, wpack, b_in, b_mid, b_out, K, node0, rows);
}

// The pool of the tile's rows / K nodes into out (the tile's first node):
// the masked rows into the tile at the base (float32 [kRows][kLdY]), then
// message_tc_pool.
template <typename T, bool SPAN = false>
__device__ __forceinline__ void message_tc_pooled(const MessageTile<T>& s,
                                                  const float* __restrict__ per_i,
                                                  const T* __restrict__ pj,
                                                  const void* __restrict__ wpack,
                                                  const float* __restrict__ b_in,
                                                  const float* __restrict__ b_mid,
                                                  const float* __restrict__ b_out, float* out,
                                                  int K, int rows, int64_t node0,
                                                  bool reciprocal, bool first = true,
                                                  bool last = true) {
  using C = MessageTc<T>;
  float* Y = reinterpret_cast<float*>(s.base);
  const float* mrow = s.mrow();
  message_tc_rows(s, per_i, pj, wpack, b_in, b_mid, b_out, K, node0,
                  [&](int r, int c, float x0, float x1) {
                    const float m = mrow[r];
                    *reinterpret_cast<float2*>(Y + r * C::kLdY + c) = make_float2(x0 * m, x1 * m);
                  });
  __syncthreads();
  message_tc_pool<SPAN>(Y, C::kLdY, out, K, rows, C::kThreads, reciprocal, first, last);
}

// How a block's edge rows fall into tiles: K <= kRows, one tile of
// kRows / K whole nodes; K > kRows (the kernels' SPAN instantiation), one
// node a block, its K edge rows in ceil(K / kRows) tiles (the rows of tile
// t from the node's edge kRows t on: min(kRows, K - kRows t)).
inline __host__ __device__ int nodes_per_block(int K) { return K <= kRows ? kRows / K : 1; }

// Between two tiles of a block: every thread is done with the tile before
// (its writes to the tile and the ring go before the next weight copies
// into the ring), then the ring's mbarriers start again and the first
// weight units load.
template <typename T>
__device__ __forceinline__ void message_tc_next_tile(const MessageTile<T>& s, const void* wpack) {
  fence_proxy_async();
  __syncthreads();
  message_tc_prefetch(s, wpack, true);
}

// The three products and the output of the tile: `rows` valid edge rows of
// whole nodes from edge row erow0 and node row node0 (both global); pool
// into out [*, H] float32, else the edge rows into out [*, H] in T. first
// / last: the tile is its node's first / last (SPAN: message_tc_pool).
template <typename T, bool POOL, bool SPAN = false>
__device__ __forceinline__ void message_tc(const MessageTile<T>& s, const float* __restrict__ per_i,
                                           const T* __restrict__ pj, const void* __restrict__ wpack,
                                           const float* __restrict__ b_in,
                                           const float* __restrict__ b_mid,
                                           const float* __restrict__ b_out,
                                           void* __restrict__ out_ptr, int K, int rows,
                                           int64_t erow0, int64_t node0, bool first = true,
                                           bool last = true) {
  if constexpr (POOL) {
    message_tc_pooled<T, SPAN>(s, per_i, pj, wpack, b_in, b_mid, b_out,
                               static_cast<float*>(out_ptr) + node0 * kH, K, rows, node0, false,
                               first, last);
  } else {
    T* out = static_cast<T*>(out_ptr);
    message_tc_rows(s, per_i, pj, wpack, b_in, b_mid, b_out, K, node0,
                    [&](int r, int c, float x0, float x1) {
                      if (r < rows) store_pair(out + (erow0 + r) * kH + c, x0, x1);
                    });
  }
}

}  // namespace packppi
