// Between-residue clash loss over flat atoms: per-atom sums and their
// gradient to the positions.
//
// Replaces packppi_tpu/ops/pallas_clash.py::_clash_kernel (entries
// between_residue_clash_pallas, between_residue_clash_diff, sc_clash_screen)
// and ::_clash_grad_kernel (the custom VJP's backward). For atoms a, b of one
// complex (A = 14 L, slot = a % 14, ridx = residue_index[a / 14]), lo/hi the
// pair ordered by residue index:
//   d_ab   = sqrt(|x_a - x_b|^2 + 1e-10)
//   S_ab   = exists_a exists_b [ridx_a != ridx_b]
//            (1 - [slot_a < 4][slot_b < 4])                           backbone-backbone
//            (1 - [ridx_hi = ridx_lo + 1][slot_lo = 2][slot_hi = 0])  C(i)-N(i+1)
//            (1 - [slot_a = 5][slot_b = 5])                           SG-SG
//   over   = rad_a + rad_b - tol - d_ab
//   forward:  per_atom[a] = sum_b S_ab relu(over)
//   gradient: dx[a]       = sum_b -(w_a + w_b) S_ab [over > 0] (x_a - x_b) / d_ab
// All float32 on the FMA units: with coordinates of O(100 A) a Gram-matrix
// product on tensor cores (bf16 or TF32) leaves errors of the size of the
// overlaps themselves.
//
// What bounds it: by the rule "every byte moved once, only the overlapping
// pairs' operations" it is bytes, O(A) of them (a few hundred KB at 768
// residues), far less than one launch costs. What the kernels spend their
// time on is the distance test of pairs that turn out not to overlap, so
// the design culls finely and makes each test cheap.
//
// Design. The TPU kernels walk their tile grid in order and add column sums
// into one scratch buffer that persists across grid steps; blocks here run
// at once, so that would need float atomics, whose order changes from run to
// run. Instead every row atom sums over ALL its partners in the symmetric
// form above: each pair is evaluated from both ends, and no sum crosses a
// block, so the same launch gives the same bits every time.
//
// 1. pack_kernel (one warp a tile of 32 flat atoms): each atom's 16-byte
//    record (x, y, z, radius), an absent atom (exists == 0) far away, its
//    key (residue index, exists), and each tile's box (lo xyz, hi xyz of
//    the atoms with exists > 0, their largest radius, whether any exists).
// 2. pair_kernel, one block of kWarps warps a row tile of 32 atoms, a lane
//    an atom. The forward first lists the row tile's live column tiles in
//    ascending order (tiles whose boxes come within the largest radius sum
//    of each other, and whose column box comes within reach of one of the
//    row atoms) into shared memory and into tiles [B, T, T] / counts
//    [B, T], which the gradient walks again. Warp w takes the listed tiles t with t % kWarps
//    == w, ascending; each lane holds one column atom's record and key in
//    registers (the next tile's already on their way), and the warp tests
//    the 32 x 32 pairs in 32 steps, the records rotated through the lanes by
//    __shfl_sync (no shared memory, no block barrier a tile). The tests only
//    set bits. Pairs whose mask is zero by position alone (the atom's own
//    residue, backbone-backbone) are dropped from them; the warp then takes
//    the columns any lane still holds in ascending order, broadcasting each
//    column's record and key, and every lane adds its own pairs: in
//    ascending column order, from registers. The kWarps partial sums of an
//    atom are joined in warp order. Every listed tile and every column of
//    it are visited in a fixed order, and a pair left out (a culled tile,
//    a pair too far apart, one masked by position) would have added an
//    exact zero, so the sums are bit-identical with culling off. Positions
//    move at every optimizer step, so all of this stays on the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace packppi {

constexpr int kTile = 32;                   // atoms a tile: a lane each
constexpr int kWarps = 8;                   // warps sharing one row tile
constexpr int kThreads = kTile * kWarps;
constexpr int kBox = 8;                     // floats a tile box
constexpr int kSlots = 14;                  // atom14
constexpr int kMaxTiles = 32767;            // tile numbers are int16
constexpr float kEps = 1e-10f;
constexpr float kBig = 1e30f;
constexpr float kFar = 1e18f;               // an absent atom: beyond any reach
// The box test and the pair test round differently; the slack keeps the box
// test on the safe side of the pair test.
constexpr float kCullSlack = 1.0001f;
// The pair scan's reach is summed in another order than the pair's own;
// the slack keeps the scan on the safe side.
constexpr float kNearSlack = 1.001f;
constexpr unsigned kAll = 0xffffffffu;

// records [B, A] float4; keys [B, A] int2 (residue index, exists's bits);
// boxes [B, T, 8]: lo xyz, hi xyz, largest radius, any atom exists.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ pos, const float* __restrict__ exists,
            const float* __restrict__ radius, const long long* __restrict__ ridx, int A, int L,
            int T, float4* __restrict__ rec, int2* __restrict__ keys, float* __restrict__ boxes) {
  const int lane = threadIdx.x & 31, b = blockIdx.y;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= T) return;  // the whole warp
  const int a = tile * kTile + lane;
  float v[kBox] = {kBig, kBig, kBig, -kBig, -kBig, -kBig, -kBig, 0.f};
  if (a < A) {
    const size_t i = size_t(b) * A + a;
    const float e = exists[i], x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
    const float r = radius[i];
    rec[i] = e != 0.f ? make_float4(x, y, z, r) : make_float4(kFar, kFar, kFar, 0.f);
    keys[i] = make_int2(int(ridx[size_t(b) * L + a / kSlots]), __float_as_int(e));
    if (e > 0.f) {
      v[0] = v[3] = x;
      v[1] = v[4] = y;
      v[2] = v[5] = z;
      v[6] = r;
      v[7] = 1.f;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = fminf(v[k], __shfl_xor_sync(kAll, v[k], off));
#pragma unroll
    for (int k = 3; k < kBox; ++k) v[k] = fmaxf(v[k], __shfl_xor_sync(kAll, v[k], off));
  }
  float mine = v[0];
#pragma unroll
  for (int k = 1; k < kBox; ++k)
    if (lane == k) mine = v[k];
  if (lane < kBox) boxes[(size_t(b) * T + tile) * kBox + lane] = mine;
}

// Whether box c (lo xyz in c0.xyz, hi xyz in c0.w, c1.xy; largest radius
// c1.z) comes within reach of box (lx, ly, lz)-(hx, hy, hz) of largest
// radius rad: the gap between them, squared, within (rad + c1.z - tol)^2,
// times a slack; in the float32 operations and order of
// ops/clash.py::_within_reach (no contraction into FMAs). A point is a box
// of lo = hi.
__device__ __forceinline__ bool within_reach(const float4 c0, const float4 c1, float lx,
                                             float ly, float lz, float hx, float hy, float hz,
                                             float rad, float tol) {
  const float g0 = fmaxf(0.f, fmaxf(c0.x - hx, lx - c0.w));
  const float g1 = fmaxf(0.f, fmaxf(c0.y - hy, ly - c1.x));
  const float g2 = fmaxf(0.f, fmaxf(c0.z - hz, lz - c1.y));
  const float gap2 = __fadd_rn(__fadd_rn(__fmul_rn(g0, g0), __fmul_rn(g1, g1)), __fmul_rn(g2, g2));
  const float thr = __fsub_rn(__fadd_rn(rad, c1.z), tol);
  return thr > 0.f && gap2 <= __fmul_rn(__fmul_rn(thr, thr), kCullSlack);
}

// The block's list: row tile r's live column tiles (every tile without
// cull) in ascending order, into list (shared) and glist (global); returns
// their number, after a barrier. A column tile is live when both boxes hold
// an atom that exists, the boxes come within reach of each other, and one
// of the row atoms comes within reach of the column box (this lane's atom:
// pa, its exists > 0 in mine). words: (T + 31) / 32 words of shared memory.
__device__ int list_tiles(const float* __restrict__ boxes, int r, int T, float tol, int cull,
                          float4 pa, bool mine, uint32_t* words, short* list,
                          short* __restrict__ glist, int* s_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwords = (T + 31) / 32;
  const float4* cb = reinterpret_cast<const float4*>(boxes);
  const float4 r0 = cb[2 * r], r1 = cb[2 * r + 1];
  for (int wd = warp; wd < nwords; wd += kWarps) {
    const int c = wd * 32 + lane;
    bool live = c < T;
    if (cull && live) {
      const float4 c0 = cb[2 * c], c1 = cb[2 * c + 1];
      live = r1.w > 0.f && c1.w > 0.f &&
             within_reach(c0, c1, r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, tol);
    }
    uint32_t bits = __ballot_sync(kAll, live);
    if (cull) {  // each live column tile against the row atoms, a lane each
      for (uint32_t todo = bits; todo; todo &= todo - 1) {
        const int t = wd * 32 + __ffs(todo) - 1;
        const bool reach = mine && within_reach(cb[2 * t], cb[2 * t + 1], pa.x, pa.y, pa.z,
                                                pa.x, pa.y, pa.z, pa.w, tol);
        if (!__any_sync(kAll, reach)) bits &= ~(1u << (t - wd * 32));
      }
    }
    if (lane == 0) words[wd] = bits;
  }
  __syncthreads();
  if (warp == 0) {  // compaction: each lane a word, offsets by a warp scan
    int offset = 0;
    for (int w0 = 0; w0 < nwords; w0 += 32) {
      uint32_t word = w0 + lane < nwords ? words[w0 + lane] : 0u;
      const int n = __popc(word);
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += y;
      }
      int at = offset + incl - n;
      while (word) {
        const short t = short((w0 + lane) * 32 + __ffs(word) - 1);
        word &= word - 1;
        list[at] = t;
        glist[at] = t;
        ++at;
      }
      offset += __shfl_sync(kAll, incl, 31);
    }
    if (lane == 0) *s_count = offset;
  }
  __syncthreads();
  return *s_count;
}

// The warp's listed tiles, ascending: those t of list[0, count) with
// t % kWarps == warp, a chunk of 32 entries at a time. Warp-uniform.
struct TileCursor {
  const short* list;
  int count, k0 = 0, t = -1;
  uint32_t mine = 0;
  // the next tile, or -1
  __device__ int next(int lane, int warp) {
    while (!mine) {
      if (k0 >= count) return -1;
      t = k0 + lane < count ? int(list[k0 + lane]) : -1;
      mine = __ballot_sync(kAll, t >= 0 && t % kWarps == warp);
      k0 += 32;
    }
    const int src = __ffs(mine) - 1;
    mine &= mine - 1;
    return __shfl_sync(kAll, t, src);
  }
};

// One lane's column atom: record, key (and w for the gradient).
struct Column {
  float4 p = make_float4(kFar, kFar, kFar, 0.f);
  int2 key = make_int2(0, 0);
  float w = 0.f;
};

template <bool kGrad>
__device__ __forceinline__ Column load_column(const float4* __restrict__ rec,
                                              const int2* __restrict__ keys,
                                              const float* __restrict__ w, size_t base, int A,
                                              int c) {
  Column col;
  if (c < A) {
    col.p = rec[base + c];
    col.key = keys[base + c];
    if (kGrad) col.w = w[base + c];
  }
  return col;
}

// bits lo .. hi - 1 of a word (clipped to 0 .. 31)
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 32);
  if (lo >= hi) return 0u;
  return (hi == 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// out: per_atom [B, A] (kGrad false) or dx [B, A, 3] (kGrad true). build:
// list the tiles here (into tiles [B, T, T] and counts [B, T]); else walk
// the lists there. Dynamic shared memory: the list's, when building.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float4* __restrict__ rec, const int2* __restrict__ keys,
            const float* __restrict__ w, const float* __restrict__ boxes,
            short* __restrict__ tiles, int* __restrict__ counts, float tol, int A, int T,
            int build, int cull, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[kWarps][kGrad ? 3 : 1][kTile];
  __shared__ int s_count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x, b = blockIdx.y;
  const size_t base = size_t(b) * A;
  short* glist = tiles + (size_t(b) * T + r) * T;
  // this lane's row atom
  const int a = r * kTile + lane;
  const int slot_a = a % kSlots;
  const Column row = load_column<kGrad>(rec, keys, w, base, A, a);
  const float4 pa = row.p;
  const int ria = row.key.x;
  const float ea = __int_as_float(row.key.y);
  const bool active = a < A && ea != 0.f;

  TileCursor cursor{glist, 0};
  if (build) {
    uint32_t* words = reinterpret_cast<uint32_t*>(smem);
    short* slist = reinterpret_cast<short*>(words + (T + 31) / 32);
    cursor.count = list_tiles(boxes + size_t(b) * T * kBox, r, T, tol, cull, pa,
                              a < A && ea > 0.f, words, slist, glist, &s_count);
    if (threadIdx.x == 0) counts[size_t(b) * T + r] = cursor.count;
    cursor.list = slist;
  } else {
    cursor.count = counts[size_t(b) * T + r];
  }
  const float reach0 = pa.w - tol;  // the scan's reach: reach0 + rad_b
  // columns j of a tile from c0 in this atom's own residue: S = 0
  const int own = (a / kSlots) * kSlots;

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  int tile = cursor.next(lane, warp);
  Column next;
  if (tile >= 0) next = load_column<kGrad>(rec, keys, w, base, A, tile * kTile + lane);
  while (tile >= 0) {
    const int c0 = tile * kTile;
    const Column col = next;
    tile = cursor.next(lane, warp);
    if (tile >= 0) next = load_column<kGrad>(rec, keys, w, base, A, tile * kTile + lane);

    // step s tests column (lane + s) % 32 and sets bit s
    uint32_t near = 0;
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const float xb = __shfl_sync(kAll, col.p.x, lane + s);
      const float yb = __shfl_sync(kAll, col.p.y, lane + s);
      const float zb = __shfl_sync(kAll, col.p.z, lane + s);
      const float rb = __shfl_sync(kAll, col.p.w, lane + s);
      const float dx = pa.x - xb, dy = pa.y - yb, dz = pa.z - zb;
      const float reach = reach0 + rb;
      near |= uint32_t(dx * dx + dy * dy + dz * dz <= reach * reach * kNearSlack) << s;
    }
    // rotated left by lane, bit j is column j; less the pairs masked by
    // position: the atom's own residue, backbone-backbone
    const uint32_t backbone = __ballot_sync(kAll, (c0 + lane) % kSlots < 4);
    uint32_t cols = active ? __funnelshift_l(near, near, lane) : 0u;
    cols &= ~bit_range(own - c0, own - c0 + kSlots);
    if (slot_a < 4) cols &= ~backbone;

    // the columns any lane holds, ascending: each broadcast, each lane adds its own
    for (uint32_t any = __reduce_or_sync(kAll, cols); any; any &= any - 1) {
      const int j = __ffs(any) - 1;
      const float xb = __shfl_sync(kAll, col.p.x, j), yb = __shfl_sync(kAll, col.p.y, j);
      const float zb = __shfl_sync(kAll, col.p.z, j), radb = __shfl_sync(kAll, col.p.w, j);
      const int rb = __shfl_sync(kAll, col.key.x, j);
      const float eb = __int_as_float(__shfl_sync(kAll, col.key.y, j));
      const float wb = kGrad ? __shfl_sync(kAll, col.w, j) : 0.f;
      if (!((cols >> j) & 1u)) continue;
      const float dx = pa.x - xb, dy = pa.y - yb, dz = pa.z - zb;
      const float d = sqrtf(dx * dx + dy * dy + dz * dz + kEps);
      const float over = pa.w + radb - tol - d;
      if (!(over > 0.f)) continue;
      const int sb = (c0 + j) % kSlots;
      float m = ea * eb;
      if (ria == rb) m = 0.f;
      if (slot_a < 4 && sb < 4) m = 0.f;
      if (slot_a == 5 && sb == 5) m = 0.f;
      const bool a_lo = ria < rb;
      const int lo_r = a_lo ? ria : rb, hi_r = a_lo ? rb : ria;
      const int lo_s = a_lo ? slot_a : sb, hi_s = a_lo ? sb : slot_a;
      if (hi_r == lo_r + 1 && lo_s == 2 && hi_s == 0) m = 0.f;
      if constexpr (kGrad) {
        const float coef = -(row.w + wb) * m / d;
        acc0 += coef * dx;
        acc1 += coef * dy;
        acc2 += coef * dz;
      } else {
        acc0 += m * over;
      }
    }
  }

  // join the warps' partial sums of each row atom, in warp order
  part[warp][0][lane] = acc0;
  if constexpr (kGrad) {
    part[warp][1][lane] = acc1;
    part[warp][2][lane] = acc2;
  }
  __syncthreads();
  if (warp != 0 || a >= A) return;
#pragma unroll
  for (int k = 0; k < (kGrad ? 3 : 1); ++k) {
    float sum = part[0][k][lane];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) sum += part[wp][k][lane];
    out[(kGrad ? 3 : 1) * (base + a) + k] = sum;
  }
}

constexpr int kMaxBatch = 65535;  // gridDim.y

template <bool kGrad>
cudaError_t launch_pairs(const void* rec, const void* keys, const void* w, const void* boxes,
                         void* tiles, void* counts, void* out, int B, int L, float tol, int cull,
                         int build, cudaStream_t stream) {
  const int A = kSlots * L;
  const int T = (A + kTile - 1) / kTile;
  const size_t smem = build ? ((T + 31) / 32) * 4 + T * 2 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pair_kernel<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  pair_kernel<kGrad><<<dim3(T, B), kThreads, smem, stream>>>(
      static_cast<const float4*>(rec), static_cast<const int2*>(keys),
      static_cast<const float*>(w), static_cast<const float*>(boxes),
      static_cast<short*>(tiles), static_cast<int*>(counts), tol, A, T, build, cull,
      static_cast<float*>(out));
  return cudaGetLastError();
}

inline bool valid_shape(int B, int L) {
  return B >= 1 && B <= kMaxBatch && L >= 1 && (kSlots * L + kTile - 1) / kTile <= kMaxTiles;
}

}  // namespace packppi

extern "C" const char* packppi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C entry points (ctypes), each returning a cudaError_t. A = 14 L atoms, T =
// ceil(A / 32) tiles (at most 32,767). pos [B, L, 14, 3], exists, radius and
// w [B, L, 14] float32; ridx [B, L] int64; rec [B, A, 4] float32, keys
// [B, A, 2] int32 and boxes [B, T, 8] float32 (packppi_clash_pack's); tiles
// [B, T, T] int16 and counts [B, T] int32 (the lists, written by the
// forward).

extern "C" int packppi_clash_pack(const void* pos, const void* exists, const void* radius,
                                  const void* ridx, void* rec, void* keys, void* boxes, int B,
                                  int L, void* stream) {
  using namespace packppi;
  if (!valid_shape(B, L)) return int(cudaErrorInvalidValue);
  const int A = kSlots * L;
  const int T = (A + kTile - 1) / kTile;
  pack_kernel<<<dim3((T + kWarps - 1) / kWarps, B), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(exists),
      static_cast<const float*>(radius), static_cast<const long long*>(ridx), A, L, T,
      static_cast<float4*>(rec), static_cast<int2*>(keys), static_cast<float*>(boxes));
  return int(cudaGetLastError());
}

// out: per_atom [B, L, 14]; lists the tiles (every tile without cull).
extern "C" int packppi_clash_forward(const void* rec, const void* keys, const void* boxes,
                                     void* tiles, void* counts, void* out, int B, int L,
                                     float tol, int cull, void* stream) {
  using namespace packppi;
  if (!valid_shape(B, L)) return int(cudaErrorInvalidValue);
  return int(launch_pairs<false>(rec, keys, nullptr, boxes, tiles, counts, out, B, L, tol, cull,
                                 1, static_cast<cudaStream_t>(stream)));
}

// out: d(sum(w * per_atom)) / d pos, [B, L, 14, 3]. build != 0: list the
// tiles here (cull as in the forward); else walk the forward's lists.
extern "C" int packppi_clash_backward(const void* rec, const void* keys, const void* w,
                                      const void* boxes, void* tiles, void* counts, void* out,
                                      int B, int L, float tol, int cull, int build,
                                      void* stream) {
  using namespace packppi;
  if (!valid_shape(B, L)) return int(cudaErrorInvalidValue);
  return int(launch_pairs<true>(rec, keys, w, boxes, tiles, counts, out, B, L, tol, cull, build,
                                static_cast<cudaStream_t>(stream)));
}
