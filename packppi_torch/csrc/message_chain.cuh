// A message tile followed by the residual chain in one block: the edge pass
// with the chain folded in (message.cu message_chain_kernel, row 1b) and the
// whole layer's edge pass (layer.cu layer_edge_kernel, row 6), and the
// shared-memory plans of both and of the whole layer's node pass.
//
// The message is message_tc_rows (csrc/message_tc.cuh); its edge rows go on
// to the chain of chain.cu, instruction for instruction (chain_wgmma<1> in
// bf16, chain_mma<64> in float32; csrc/chain_common.cuh forms xx), with
// the rounding points of the caller's kernel:
//   fold (row 1b):  x0 = rnd(h_E + rnd(rnd(m) * mask))   the two-kernel boundary
//   layer (row 6):  x0 = h_E + rnd(m * mask)              masked in float32, NOT rounded
// then out = LN_b(xx + FFN(xx)) * mask in the stream type. A fold whose x0
// equals message-then-chain's gives its bits where chain.cu runs the same
// form (KS = 1, R = 64: at least as many 64-row tiles as SMs).
//
// Shared memory. bf16: the message tile as it is (66 KB at 128, 128 and 8,
// three blocks an SM); the chain's xx tile on the last H / 64 A panels
// (2-3 at H = 128, free from layer 2 on), its ring on the message's ring
// (free after layer 3; a stage of both is 128 H bytes), its two mbarriers
// on pjrow (read by layer 1 only); h_E stays in the first A panels, in the
// xx tile's own layout, for the residual. float32: chain_mma<64>'s bytes
// (140 KB at H = 128) from the base, over the message's A tile and ring,
// and the tables after the larger of the two: one block an SM (64-row chain
// tiles, the form chain.cu runs at T1124's edge rows; 16-row tiles beside
// the message would fit two blocks an SM but stream the chain's weights
// four times a tile and break the bits against chain.cu); h_E is read again
// through L2 for the residual. The edge passes add the message to h_E, so
// they need He = H.
#pragma once

#include "chain_mma.cuh"
#include "chain_wgmma.cuh"
#include "message_tc.cuh"

namespace packppi {

constexpr int kMaxNodes = 16;  // nodes per block of the whole layer's node pass, at most

template <typename T>
struct EdgeChain;

template <>
struct EdgeChain<__nv_bfloat16> {
  using B = MessageTcBytes<__nv_bfloat16>;
  static constexpr int kThreads = MessageTc<__nv_bfloat16>::kThreads;
  static constexpr int kMinBlocks = MessageTc<__nv_bfloat16>::kMinBlocks;
  // the last H / 64 A panels (2-3 at H = 128)
  static constexpr uint32_t kChainAt = B::kRing - ChainWg<1>::kActBytes;
  static constexpr uint32_t kTables = B::kTables;
  static constexpr size_t kBytes = B::kTotal;
  static_assert(ChainWg<1>::kRingBytes == uint32_t(MessageTc<__nv_bfloat16>::kStages) *
                                              kMsgUnitBytes &&
                    B::kRing + ChainWg<1>::kRingBytes == kTables,
                "the chain's ring on the message's, its mbarriers on pjrow");
};

template <>
struct EdgeChain<float> {
  using B = MessageTcBytes<float>;
  static constexpr int kThreads = MessageTc<float>::kThreads;
  static constexpr int kMinBlocks = 1;
  static constexpr uint32_t kTables = cmax(int(ChainMma<64>::kBytes), int(B::kTables));
  static constexpr size_t kBytes = B::total(kTables);
  static_assert(kThreads == packppi::kThreads, "chain_mma's 8 warps");
  static_assert(kBytes <= 232448, "the chain's tile, the message's and the tables fit a block");
};

// The node pass: the message tile (the chain over it as in EdgeChain<bf16>,
// chain_mma<16> from the base in float32), the tables after the larger of
// the two, then the pooled [kMaxNodes][kH] float32 rows.
template <typename T>
struct NodeChain {
  using B = MessageTcBytes<T>;
  static constexpr uint32_t kTables =
      std::is_same<T, float>::value ? cmax(int(ChainMma<kMaxNodes>::kBytes), int(B::kTables))
                                    : B::kTables;
  static constexpr uint32_t kPooled = align16(kTables + B::kTableBytes);
  static constexpr size_t kBytes = kPooled + sizeof(float) * kMaxNodes * kH + 1024;
  static_assert(kBytes <= 232448, "the node pass's tiles, tables and pooled rows fit a block");
};

// The edge rows' masked message as the kernel rounds it: the fold rounds
// the message to T first (the two-kernel boundary), the whole layer masks in
// float32; both round the product (exact for a 0/1 mask).
template <typename T, bool FOLD>
__device__ __forceinline__ float masked_message(float m, float mask) {
  return FOLD ? rnd<T>(rnd<T>(m) * mask) : rnd<T>(m * mask);
}

// The tile's message, then the chain on its edge rows (`rows` valid from
// edge row erow0; node row node0; h_E [*, H] in T), out = the new h_E
// rows. Every thread of the block calls this after tile_publish. `more`:
// another tile of the block follows (K > kRows), which rewrites pjrow, so
// the chain's mbarriers there are invalidated once the chain is done.
template <typename T, bool FOLD>
__device__ __forceinline__ void edge_chain(const MessageTile<T>& s, const float* __restrict__ per_i,
                                           const T* __restrict__ pj, const T* __restrict__ h_E,
                                           const void* __restrict__ wpack,
                                           const float* __restrict__ b_in,
                                           const float* __restrict__ b_mid,
                                           const float* __restrict__ b_out, const ChainWeights& cw,
                                           const __nv_bfloat16* __restrict__ cpack,
                                           T* __restrict__ out, int K, int rows, int64_t erow0,
                                           int64_t node0, bool more = false) {
  const float* mrow = s.mrow();
  auto store = [&](int r, int c, float y0, float y1) {
    const float m = mrow[r];
    store_pair(out + (erow0 + r) * kH + c, y0 * m, y1 * m);
  };
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(EdgeChain<T>::kChainAt >= uint32_t(panels64(kHe)) * MessageTc<T>::kPanelA,
                  "h_E's A panels before the xx tile");
    unsigned char* xx = s.base + EdgeChain<T>::kChainAt;
    auto at = [](unsigned char* tile, int r, int c) {
      return reinterpret_cast<__nv_bfloat16*>(tile + act_offset(r, c));
    };
    // the masked message into the xx tile (rounded to bf16: exact there)
    message_tc_rows(s, per_i, pj, wpack, b_in, b_mid, b_out, K, node0,
                    [&](int r, int c, float m0, float m1) {
                      const float m = mrow[r];
                      store_pair(at(xx, r, c), masked_message<T, FOLD>(m0, m),
                                 masked_message<T, FOLD>(m1, m));
                    });
    chain_wgmma_prefetch<1>(xx, cpack);  // the ring is free past message_tc_rows' barrier
    chain_wgmma<1>(
        xx, cw, cpack, rows,
        [&](int r, int c) {
          // h_E from the first A panels plus the masked message
          const float x = __bfloat162float(*at(s.base, r, c)) + __bfloat162float(*at(xx, r, c));
          return FOLD ? rnd<T>(x) : x;
        },
        store);
    if (more) {
      __syncthreads();  // every thread is past its last wait on them
      if (threadIdx.x == 0)
        for (int i = 0; i < kStages; ++i) mbar_inval(wg_bars<1>(xx, 0) + i);
    }
  } else {
    constexpr int kLd = ChainMma<64>::kLdA;
    float* XX = reinterpret_cast<float*>(s.base);
    message_tc_rows(s, per_i, pj, wpack, b_in, b_mid, b_out, K, node0,
                    [&](int r, int c, float m0, float m1) {
                      if (r >= rows) return;
                      const float m = mrow[r];
                      const float2 h = *reinterpret_cast<const float2*>(h_E + (erow0 + r) * kH + c);
                      float x0 = h.x + masked_message<T, FOLD>(m0, m);
                      float x1 = h.y + masked_message<T, FOLD>(m1, m);
                      if (FOLD) {
                        x0 = rnd<T>(x0);
                        x1 = rnd<T>(x1);
                      }
                      *reinterpret_cast<float2*>(XX + r * kLd + c) = make_float2(x0, x1);
                    });
    float4 pre[kWPieces];
    fetch_w(pre, cw, 0);
    chain_mma<64>(s.base, pre, cw, rows, [&](int r, int c) { return XX[r * kLd + c]; }, store);
  }
}

}  // namespace packppi
