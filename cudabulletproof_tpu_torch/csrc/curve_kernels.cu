// Point kernels of the port.
//
//   ge_add_kernel         replaces cudabulletproof_tpu/ops/pallas_curve.py::_add_kernel
//   ge_double_kernel      replaces pallas_curve.py::_double_kernel
//   ge_ladder_win_kernel  replaces pallas_curve.py::_ladder_win_kernel
//   ge_ladder_bin_kernel  replaces pallas_curve.py::_ladder_kernel
//   ge_reduce_kernel      replaces pallas_curve.py::_reduce_kernel
//
// Layout: rows of 80 int32 (x|y|z|t, 20 limbs each), [n, 80] row-major.
//
// What bounds them on Hopper: integer multiplies.  An add is 9 field
// multiplies (~4,000 IMADs) against 960 bytes moved; the ladder is ~2,800
// field-multiply equivalents per point against 400 bytes, so it is
// compute-bound.  ge_add, ge_double, ge_ladder_bin and ge_reduce run a
// point's whole operation in one thread (fe25519.cuh's ge_padd / ge_pdbl).
//
// The window ladder (w = 4 fixed window, the default of scalarmult_raw)
// runs on the four-lane group law (fe25519.cuh's ge4_*): a point's four
// coordinates on four lanes of a warp, one field product a lane a stage.
// At the verify and prove paths' 2 to 1024 points the card is far from
// full (one warp a scheduler fills it at ~4,200 points), so what bounds the
// kernel is the latency of one point's chain of ~340 group operations,
// each a chain of dependent field multiplies issued by one warp; four
// lanes a point cut a window (4 doublings and an add) from ~41 multiply
// latencies to ~11 and spread the points over 4 times as many warps (a
// block is one warp of 8 points, so 402 points take 51 SMs, not 13).
//   * table: tab[0] = identity, tab[1] = P, then for j = 2..15
//     tab[j] = pdbl(tab[j/2]) if j is even, else padd(tab[j-1], P), in
//     shared memory as [16][20 limbs][32 lanes] (40 KB a block): a lane
//     reads back only the coordinate it wrote, bank-conflict free whatever
//     the digits of the warp's points;
//   * 65 windows, most significant first, over the 260-bit radix-2^13
//     scalar: 4 pdbl, then padd(acc, tab[digit]), always (digit 0 adds the
//     identity, as the Pallas kernel's one-hot select does);
//   * points past n run as the identity with a zero scalar and store
//     nothing: every lane stays, so every group's shuffles are defined.
// The TPU kernel shifts its scalar register left 4 bits a window because
// Mosaic has no dynamic lane index; here window w reads value bits
// 256-4w .. 259-4w directly, and a window that straddles a 13-bit limb
// boundary takes its high bits from the next limb.  That equals the TPU's
// digit for scalar limbs in [0, 2^13) (what to_field_limbs produces).
//
// The binary ladder (ge_ladder_bin, scalarmult_raw with
// PALLAS_LADDER_WINDOW = 0): 260 steps over the scalar's bits, most
// significant first (bit 12 of limb 19 down to bit 0 of limb 0); a step is
// acc = padd(acc, acc) -- the unified add as a doubling, as the Pallas
// kernel does, not pdbl -- then added = padd(acc, P), and acc = added where
// the bit is 1, by a mask select rather than a branch on the secret bit.
// The TPU kernel shifts its scalar register a bit a step (no dynamic lane
// index on Mosaic); here the bit is read straight from its limb.  520
// unified adds a point (4,680 field multiplies, ~1.7x the window ladder's)
// and no table: the accumulator and P stay in registers.
//
// The tile reduction (ge_reduce, the _reduce_kernel of tree_reduce and
// pallas_curve.msm): one block of 128 threads sums a tile of 256 points to
// one by log-depth halving in shared memory, lane i + half added into lane
// i, the Pallas order (p = the low half, q = the high half).  The tile is
// 256 x 320 B = 80 KB of dynamic shared memory; rows past n are the
// identity, as the Pallas wrapper pads them.  255 unified adds (~1.0M
// IMADs) against 80 KB read per tile: compute-bound, and at the MSM sizes
// that use it (n <= 1024, 1 to 4 tiles) latency-bound on 8 halving rounds.
// One partial per tile; the caller folds the partials with ge_add.
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

constexpr int kThreads = 128;
// Few points per call: small blocks spread them over more SMs.
constexpr int kLadderThreads = 32;
// The window ladder: one warp a block, 8 points of 4 lanes.
constexpr int kLadderWinThreads = 32;
constexpr int kLadderWinPoints = kLadderWinThreads / 4;
constexpr int kWindows = (bp::FE_L * bp::FE_W) / 4;   // 65

__global__ void ge_add_kernel(const int32_t* __restrict__ p,
                              const int32_t* __restrict__ q,
                              int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const bp::ge a = bp::ge_load(p + i * 4 * bp::FE_L);
  const bp::ge b = bp::ge_load(q + i * 4 * bp::FE_L);
  bp::ge_store(out + i * 4 * bp::FE_L, bp::ge_padd(a, b));
}

__global__ void ge_double_kernel(const int32_t* __restrict__ p,
                                 int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const bp::ge a = bp::ge_load(p + i * 4 * bp::FE_L);
  bp::ge_store(out + i * 4 * bp::FE_L, bp::ge_pdbl(a));
}

// 4-bit digit of window w (0 = most significant): value bits 256-4w ..
// 259-4w of the scalar sum_k s[k] 2^(13k).
__device__ __forceinline__ int ladder_digit(const int32_t* __restrict__ s,
                                            int w) {
  const int lo = 256 - 4 * w;
  const int k = lo / bp::FE_W;
  const int off = lo % bp::FE_W;
  int32_t bits = s[k] >> off;
  if (off + 4 > bp::FE_W) bits |= s[k + 1] << (bp::FE_W - off);
  return bits & 15;
}

// The ladder's table in shared memory: entry j, limb i of lane l at
// [j][i][l].
__device__ __forceinline__ bp::fe tab_load(int32_t (*tab)[bp::FE_L][kLadderWinThreads],
                                           int j) {
  bp::fe r;
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) r.v[i] = tab[j][i][threadIdx.x];
  return r;
}

__device__ __forceinline__ void tab_store(int32_t (*tab)[bp::FE_L][kLadderWinThreads],
                                          int j, const bp::fe& a) {
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) tab[j][i][threadIdx.x] = a.v[i];
}

__global__ void __launch_bounds__(kLadderWinThreads)
ge_ladder_win_kernel(const int32_t* __restrict__ p,
                     const int32_t* __restrict__ s,
                     int32_t* __restrict__ out, int64_t n) {
  __shared__ int32_t tab[16][bp::FE_L][kLadderWinThreads];
  const bp::lane4 g = bp::lane4_here();
  const int64_t i = blockIdx.x * static_cast<int64_t>(kLadderWinPoints) +
                    threadIdx.x / 4;
  const bool valid = i < n;
  const int32_t* sc = s + (valid ? i : 0) * bp::FE_L;
  const bp::fe base = valid ? bp::fe_load(p + i * 4 * bp::FE_L + g.c * bp::FE_L)
                            : bp::ge4_identity(g);
  tab_store(tab, 0, bp::ge4_identity(g));
  tab_store(tab, 1, base);
#pragma unroll 1
  for (int j = 2; j < 16; ++j)
    tab_store(tab, j, (j % 2 == 0) ? bp::ge4_pdbl(g, tab_load(tab, j / 2))
                                   : bp::ge4_padd(g, tab_load(tab, j - 1), base));
  bp::fe acc = bp::ge4_identity(g);
#pragma unroll 1
  for (int w = 0; w < kWindows; ++w) {
#pragma unroll 1
    for (int r = 0; r < 4; ++r) acc = bp::ge4_pdbl(g, acc);
    acc = bp::ge4_padd(g, acc, tab_load(tab, valid ? ladder_digit(sc, w) : 0));
  }
  if (valid) bp::fe_store(out + i * 4 * bp::FE_L + g.c * bp::FE_L, acc);
}

// acc = bit ? b : acc, limb for limb, without a branch (bit is 0 or 1).
__device__ __forceinline__ void ge_select(bp::ge& acc, const bp::ge& b,
                                          int32_t bit) {
  const int32_t mask = -bit;
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) {
    acc.x.v[i] ^= (acc.x.v[i] ^ b.x.v[i]) & mask;
    acc.y.v[i] ^= (acc.y.v[i] ^ b.y.v[i]) & mask;
    acc.z.v[i] ^= (acc.z.v[i] ^ b.z.v[i]) & mask;
    acc.t.v[i] ^= (acc.t.v[i] ^ b.t.v[i]) & mask;
  }
}

__global__ void ge_ladder_bin_kernel(const int32_t* __restrict__ p,
                                     const int32_t* __restrict__ s,
                                     int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int32_t* sc = s + i * bp::FE_L;
  const bp::ge base = bp::ge_load(p + i * 4 * bp::FE_L);
  bp::ge acc = bp::ge_identity();
#pragma unroll 1
  for (int k = bp::FE_L * bp::FE_W - 1; k >= 0; --k) {
    acc = bp::ge_padd(acc, acc);
    const bp::ge added = bp::ge_padd(acc, base);
    ge_select(acc, added, (sc[k / bp::FE_W] >> (k % bp::FE_W)) & 1);
  }
  bp::ge_store(out + i * 4 * bp::FE_L, acc);
}

constexpr int kReduceTile = 256;                 // pallas_field.LANES
constexpr int kReduceThreads = kReduceTile / 2;
constexpr int kReduceSmem = kReduceTile * static_cast<int>(sizeof(bp::ge));

__global__ void __launch_bounds__(kReduceThreads)
ge_reduce_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ out,
                 int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  bp::ge* tile = reinterpret_cast<bp::ge*>(smem);
  const int64_t base = blockIdx.x * static_cast<int64_t>(kReduceTile);
  for (int j = threadIdx.x; j < kReduceTile; j += blockDim.x) {
    const int64_t i = base + j;
    tile[j] = i < n ? bp::ge_load(p + i * 4 * bp::FE_L) : bp::ge_identity();
  }
  __syncthreads();
#pragma unroll 1
  for (int half = kReduceTile / 2; half > 0; half >>= 1) {
    // lane i reads lanes i and i + half and writes lane i: no other lane
    // of this round touches either, so one barrier per round suffices
    if (threadIdx.x < half)
      tile[threadIdx.x] = bp::ge_padd(tile[threadIdx.x], tile[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) bp::ge_store(out + blockIdx.x * 4 * bp::FE_L, tile[0]);
}

unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int bp_ge_add(const int32_t* p, const int32_t* q, int32_t* out,
                         int64_t n, void* stream) {
  if (n <= 0) return 0;
  ge_add_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(p, q, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_ge_double(const int32_t* p, int32_t* out, int64_t n,
                            void* stream) {
  if (n <= 0) return 0;
  ge_double_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_ge_ladder_win(const int32_t* p, const int32_t* s,
                                int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  ge_ladder_win_kernel<<<blocks_for(n, kLadderWinPoints), kLadderWinThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, s, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_ge_ladder_bin(const int32_t* p, const int32_t* s,
                                int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  ge_ladder_bin_kernel<<<blocks_for(n, kLadderThreads), kLadderThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, s, out, n);
  return static_cast<int>(cudaGetLastError());
}

// p [n, 80] -> out [ceil(n / 256), 80], one partial sum per tile.
extern "C" int bp_ge_reduce(const int32_t* p, int32_t* out, int64_t n,
                            void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      ge_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kReduceSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ge_reduce_kernel<<<blocks_for(n, kReduceTile), kReduceThreads, kReduceSmem,
                     static_cast<cudaStream_t>(stream)>>>(p, out, n);
  return static_cast<int>(cudaGetLastError());
}
