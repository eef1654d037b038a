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
// residues), far less than one launch costs. What the kernel spends its
// time on is the distance test of pairs that turn out not to overlap:
// O(A * atoms of the live tiles) after culling, O(A^2) before it.
//
// Design. The TPU kernels walk their tile grid in order and add column sums
// into one scratch buffer that persists across grid steps; blocks here run
// at once, so that would need float atomics, whose order changes from run to
// run. Instead every row atom sums over ALL its partners in the symmetric
// form above: each pair is evaluated from both ends, and no sum crosses a
// block, so the same launch gives the same bits every time. One block owns
// 32 consecutive row atoms, four lanes to an atom; it walks the column tiles
// of 128 atoms in ascending order, stages a live tile in shared memory, each
// lane takes every fourth column atom, and the four partial sums are joined
// by two shuffles in a fixed order.
//
// Culling: a first small kernel writes one bounding box per column tile
// (existing atoms only, with their largest radius). Each block builds the
// box of its own 32 row atoms and skips a column tile when the gap between
// the boxes is wider than any radius sum in them can reach. A skipped tile
// would have added exact zeros, so the sums are bit-identical with culling
// off. Positions move at every optimizer step, so all of this stays on the
// device.

#include <cuda_runtime.h>

namespace packppi {

constexpr int kThreads = 128;               // threads per block
constexpr int kSplit = 4;                   // lanes that share one row atom
constexpr int kRows = kThreads / kSplit;    // row atoms per block
constexpr int kCols = 128;                  // column atoms per staged tile
constexpr int kBox = 8;                     // floats per tile box
constexpr int kSlots = 14;                  // atom14
constexpr float kEps = 1e-10f;
constexpr float kBig = 1e30f;
// The box test and the pair test round differently; the slack keeps the box
// test on the safe side of the pair test.
constexpr float kCullSlack = 1.0001f;
// Pairs beyond this multiple of the squared reach skip the square root.
constexpr float kNearSlack = 1.001f;

static_assert(kCols == kThreads, "one thread stages one column atom");

// boxes [B, ncol, 8]: lo xyz, hi xyz, largest radius, any atom exists.
__global__ void __launch_bounds__(kThreads)
boxes_kernel(const float* __restrict__ pos, const float* __restrict__ exists,
             const float* __restrict__ radius, int A, int ncol, float* __restrict__ boxes) {
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int a = c * kCols + tid;
  float v[kBox] = {kBig, kBig, kBig, -kBig, -kBig, -kBig, -kBig, 0.f};
  if (a < A) {
    const size_t i = size_t(b) * A + a;
    if (exists[i] > 0.f) {
      for (int k = 0; k < 3; ++k) v[k] = v[3 + k] = pos[3 * i + k];
      v[6] = radius[i];
      v[7] = 1.f;
    }
  }
  for (int off = 16; off; off >>= 1) {
    for (int k = 0; k < 3; ++k) v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
    for (int k = 3; k < kBox; ++k) v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  __shared__ float part[kThreads / 32][kBox];
  if (tid % 32 == 0)
    for (int k = 0; k < kBox; ++k) part[tid / 32][k] = v[k];
  __syncthreads();
  if (tid < kBox) {
    float r = part[0][tid];
    for (int wp = 1; wp < kThreads / 32; ++wp)
      r = tid < 3 ? fminf(r, part[wp][tid]) : fmaxf(r, part[wp][tid]);
    boxes[(size_t(b) * ncol + c) * kBox + tid] = r;
  }
}

// out: per_atom [B, A] (kGrad false) or dx [B, A, 3] (kGrad true).
// live_count [B, gridDim.x] or null: tiles this block visited.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ pos, const float* __restrict__ exists,
            const float* __restrict__ radius, const long long* __restrict__ ridx,
            const float* __restrict__ w, const float* __restrict__ boxes, float tol, int A,
            int L, int ncol, int cull, float* __restrict__ out, int* __restrict__ live_count) {
  __shared__ float sx[kCols], sy[kCols], sz[kCols], srad[kCols], sex[kCols], sw[kCols];
  __shared__ int sridx[kCols], sslot[kCols];
  __shared__ float rowbuf[kRows][5];
  __shared__ unsigned char slive[kThreads];

  const int b = blockIdx.y, tid = threadIdx.x;
  const int q = tid % kSplit, row = tid / kSplit;
  const int a = blockIdx.x * kRows + row;
  const size_t base = size_t(b) * A;
  const bool valid = a < A;

  float xa = 0.f, ya = 0.f, za = 0.f, ra = 0.f, ea = 0.f, wa = 0.f;
  int ria = 0;
  const int slot_a = a % kSlots;
  if (valid) {
    xa = pos[3 * (base + a)];
    ya = pos[3 * (base + a) + 1];
    za = pos[3 * (base + a) + 2];
    ra = radius[base + a];
    ea = exists[base + a];
    ria = int(ridx[size_t(b) * L + a / kSlots]);
    if (kGrad) wa = w[base + a];
  }
  if (q == 0) {
    rowbuf[row][0] = xa;
    rowbuf[row][1] = ya;
    rowbuf[row][2] = za;
    rowbuf[row][3] = ra;
    rowbuf[row][4] = ea;
  }
  __syncthreads();

  // the box of this block's existing row atoms
  float rlo[3] = {kBig, kBig, kBig}, rhi[3] = {-kBig, -kBig, -kBig}, rrad = -kBig;
  bool rany = false;
  for (int i = 0; i < kRows; ++i) {
    if (rowbuf[i][4] > 0.f) {
      rany = true;
      for (int k = 0; k < 3; ++k) {
        rlo[k] = fminf(rlo[k], rowbuf[i][k]);
        rhi[k] = fmaxf(rhi[k], rowbuf[i][k]);
      }
      rrad = fmaxf(rrad, rowbuf[i][3]);
    }
  }

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  int nlive = 0;
  for (int cb = 0; cb < ncol; cb += kThreads) {
    // each thread tests one tile of this chunk of tiles
    const int c = cb + tid;
    bool live = false;
    if (c < ncol) {
      if (!cull) {
        live = true;
      } else {
        const float* bx = boxes + (size_t(b) * ncol + c) * kBox;
        if (rany && bx[7] > 0.f) {
          float gap2 = 0.f;
          for (int k = 0; k < 3; ++k) {
            const float g = fmaxf(0.f, fmaxf(bx[k] - rhi[k], rlo[k] - bx[3 + k]));
            gap2 += g * g;
          }
          const float thr = rrad + bx[6] - tol;
          live = thr > 0.f && gap2 <= thr * thr * kCullSlack;
        }
      }
    }
    slive[tid] = live;
    __syncthreads();

    const int nt = min(kThreads, ncol - cb);
    for (int t = 0; t < nt; ++t) {
      if (!slive[t]) continue;               // the same for the whole block
      ++nlive;
      const int ac = (cb + t) * kCols + tid;
      if (ac < A) {
        sx[tid] = pos[3 * (base + ac)];
        sy[tid] = pos[3 * (base + ac) + 1];
        sz[tid] = pos[3 * (base + ac) + 2];
        srad[tid] = radius[base + ac];
        sex[tid] = exists[base + ac];
        sridx[tid] = int(ridx[size_t(b) * L + ac / kSlots]);
        if (kGrad) sw[tid] = w[base + ac];
      } else {
        sx[tid] = sy[tid] = sz[tid] = srad[tid] = sex[tid] = 0.f;
        sridx[tid] = 0;
        if (kGrad) sw[tid] = 0.f;
      }
      sslot[tid] = ac % kSlots;
      __syncthreads();

      for (int j = q; j < kCols; j += kSplit) {
        const float dx = xa - sx[j], dy = ya - sy[j], dz = za - sz[j];
        const float d2 = dx * dx + dy * dy + dz * dz + kEps;
        const float reach = ra + srad[j] - tol;
        if (d2 <= reach * reach * kNearSlack) {
          const float d = sqrtf(d2);
          const float over = reach - d;
          if (over > 0.f) {
            const int rb = sridx[j], sb = sslot[j];
            float m = ea * sex[j];
            if (ria == rb) m = 0.f;
            if (slot_a < 4 && sb < 4) m = 0.f;
            if (slot_a == 5 && sb == 5) m = 0.f;
            const bool a_lo = ria < rb;
            const int lo_r = a_lo ? ria : rb, hi_r = a_lo ? rb : ria;
            const int lo_s = a_lo ? slot_a : sb, hi_s = a_lo ? sb : slot_a;
            if (hi_r == lo_r + 1 && lo_s == 2 && hi_s == 0) m = 0.f;
            if (kGrad) {
              const float coef = -(wa + sw[j]) * m / d;
              acc0 += coef * dx;
              acc1 += coef * dy;
              acc2 += coef * dz;
            } else {
              acc0 += m * over;
            }
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();
  }

  // join the four lanes of each row atom, in a fixed order
  for (int off = 1; off < kSplit; off <<= 1) {
    acc0 += __shfl_xor_sync(0xffffffffu, acc0, off);
    if (kGrad) {
      acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
      acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
    }
  }
  if (q == 0 && valid) {
    if (kGrad) {
      out[3 * (base + a)] = acc0;
      out[3 * (base + a) + 1] = acc1;
      out[3 * (base + a) + 2] = acc2;
    } else {
      out[base + a] = acc0;
    }
  }
  if (live_count != nullptr && tid == 0) live_count[size_t(b) * gridDim.x + blockIdx.x] = nlive;
}

template <bool kGrad>
cudaError_t launch_pairs(const void* pos, const void* exists, const void* radius,
                         const void* ridx, const void* w, const void* boxes, void* out,
                         void* live_count, int B, int L, float tol, int cull,
                         cudaStream_t stream) {
  const int A = kSlots * L;
  const int ncol = (A + kCols - 1) / kCols;
  const dim3 grid((A + kRows - 1) / kRows, B);
  pair_kernel<kGrad><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(pos), static_cast<const float*>(exists),
      static_cast<const float*>(radius), static_cast<const long long*>(ridx),
      static_cast<const float*>(w), static_cast<const float*>(boxes), tol, A, L, ncol, cull,
      static_cast<float*>(out), static_cast<int*>(live_count));
  return cudaGetLastError();
}

constexpr int kMaxBatch = 65535;  // gridDim.y

}  // namespace packppi

extern "C" const char* packppi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C entry points (ctypes). pos [B, L, 14, 3], exists, radius and w
// [B, L, 14] float32; ridx [B, L] int64; boxes [B, ceil(14 L / 128), 8]
// float32; live_count [B, ceil(14 L / 32)] int32 or null. Each returns a
// cudaError_t.

extern "C" int packppi_clash_boxes(const void* pos, const void* exists, const void* radius,
                                   void* boxes, int B, int L, void* stream) {
  using namespace packppi;
  if (B < 1 || B > kMaxBatch || L < 1) return int(cudaErrorInvalidValue);
  const int A = kSlots * L;
  const int ncol = (A + kCols - 1) / kCols;
  boxes_kernel<<<dim3(ncol, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(exists),
      static_cast<const float*>(radius), A, ncol, static_cast<float*>(boxes));
  return int(cudaGetLastError());
}

// out: per_atom [B, L, 14].
extern "C" int packppi_clash_forward(const void* pos, const void* exists, const void* radius,
                                     const void* ridx, const void* boxes, void* out,
                                     void* live_count, int B, int L, float tol, int cull,
                                     void* stream) {
  using namespace packppi;
  if (B < 1 || B > kMaxBatch || L < 1) return int(cudaErrorInvalidValue);
  return int(launch_pairs<false>(pos, exists, radius, ridx, nullptr, boxes, out, live_count, B,
                                 L, tol, cull, static_cast<cudaStream_t>(stream)));
}

// out: d(sum(w * per_atom)) / d pos, [B, L, 14, 3].
extern "C" int packppi_clash_backward(const void* pos, const void* exists, const void* radius,
                                      const void* ridx, const void* w, const void* boxes,
                                      void* out, void* live_count, int B, int L, float tol,
                                      int cull, void* stream) {
  using namespace packppi;
  if (B < 1 || B > kMaxBatch || L < 1) return int(cudaErrorInvalidValue);
  return int(launch_pairs<true>(pos, exists, radius, ridx, w, boxes, out, live_count, B, L, tol,
                                cull, static_cast<cudaStream_t>(stream)));
}
