// Point kernels of the port.
//
//   ge_add_kernel         replaces cudabulletproof_tpu/ops/pallas_curve.py::_add_kernel
//   ge_double_kernel      replaces pallas_curve.py::_double_kernel
//   ge_ladder_win_kernel  replaces pallas_curve.py::_ladder_win_kernel
//   ge_ladder_bin_kernel  replaces pallas_curve.py::_ladder_kernel
//   ge_reduce_kernel      replaces pallas_curve.py::_reduce_kernel
//
// Layout: rows of 80 int32 (x|y|z|t, 20 limbs each), [n, 80] row-major,
// except the operands of ge_add, ge_double and ge_reduce (below).
//
// What bounds them on Hopper: integer multiplies.  An add is 9 field
// multiplies (~4,000 IMADs) against 960 bytes moved; the ladder is ~2,800
// field-multiply equivalents per point against 400 bytes, so it is
// compute-bound.  All five run on the four-lane group law.
//
// The four-lane kernels: lane c of a point's four lanes holds coordinate c
// and runs fe25519.cuh's ge4_padd / ge4_pdbl, chains 3 and 2 multiply
// latencies deep (one thread's are 9 and 8), and a block is one warp of 8
// points, so the paths' 1 to 1024 points spread over up to 128 SMs (one
// thread a point in 32- or 128-thread blocks filled a few).  Points past n
// run as the identity (the ladders with a zero scalar), so every shuffle
// group is defined, and store nothing.
//
// The batched add and doubling (ge_add, ge_double) carry 2-26 us of device
// work under a host call that cost 0.13-0.35 ms when the wrapper packed its
// operands, so their operands are read in place, and so are the tile
// reduction's: each coordinate (x, y, z, t of p, then of q for the add)
// comes as a base pointer and a row stride in int32 -- 80 for a coordinate
// view of an [n, 80] output, 20 for a contiguous [n, 20], 0 for one point
// broadcast -- and lane c reads coordinate c of row i at base[c] + i *
// stride[c] (the doubling's lane 3 reads nothing: t is not an input of the
// doubling).  The output is one [n, 80] row-major tensor ([ceil(n / 256),
// 80] for the reduction).
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
// PALLAS_LADDER_WINDOW = 0), on the four-lane group law in one-warp blocks
// of 8 points: 260 steps over the scalar's bits, most significant first
// (bit 12 of limb 19 down to bit 0 of limb 0); a step is acc = padd(acc,
// acc) -- the unified add as a doubling, as the Pallas kernel does, not
// pdbl -- then added = padd(acc, P), and acc = added where the bit is 1, by
// a mask select on each lane rather than a branch on the secret bit (the
// four lanes of a point read the same bit).  The TPU kernel shifts its
// scalar register a bit a step (no dynamic lane index on Mosaic); here the
// bit is read straight from its limb.  520 unified adds a point, a chain
// of ~1,560 multiply latencies (~4,680 in one thread), and no table: the
// accumulator and P stay in registers.
//
// The tile reduction (ge_reduce, the _reduce_kernel of tree_reduce and
// pallas_curve.msm) sums each tile of 256 points to one by 8 rounds of
// halving, lane i + half added into lane i, the Pallas order (p = the low
// half, q = the high half), so its limbs are the one-thread tree's; rows
// past n are the identity, as the Pallas wrapper pads them.  255 unified
// adds (~1.0M IMADs) against 80 KB read a tile, but at the sizes that use
// it (msm_auto's ladder route: 64 to 1024 points, 1 to 4 tiles) the card
// holds a handful of blocks, so what bounds it is the latency of the 8
// rounds, each a dependent add.  A tile is 128 units of four lanes on a
// cluster of two 256-thread blocks: unit u adds its points u and u + 128
// (round 1, from device memory; ~0.5M IMADs, split over two SMs).  Then
// in each round the units of the upper half write their sums into a tile
// in block 0's shared memory and leave, and the lower half reads and adds
// them: round 64's writers are all of block 1, through distributed shared
// memory and one cluster barrier; rounds 32, 16 and 8 stay in block 0, one
// named barrier a round over the warps still there.  The tile is
// limb-major, [20 limbs][128 units x 4 lanes] (40 KB): a warp's access to a
// limb is 32 consecutive words, free of bank conflicts, and no column is
// written twice, so one barrier a round suffices.  Rounds 4, 2 and 1 are
// warp 0's 8 points, by __shfl_down_sync of 4 half lanes: no shared memory,
// no barrier.  Lanes 0-3 of unit 0 store the tile's partial; the caller
// folds the partials with ge_add.  A round is one four-lane add, 3
// multiply latencies deep where the one-thread tree's was 9.  One block of
// 512 threads a tile was ~10% slower (round 1's 128 adds on one SM, and
// 128 registers a thread, which spilled) (bench_group4 on an H100,
// PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace cg = cooperative_groups;

namespace {

// The four-lane kernels: one warp a block, 8 points of 4 lanes.
constexpr int kWarpThreads = 32;
constexpr int kWarpPoints = kWarpThreads / 4;
constexpr int kWindows = (bp::FE_L * bp::FE_W) / 4;   // 65

// A point operand read in place: coordinate c of row i at
// c[c] + i * s[c] (s in int32; 0 broadcasts one point).
struct ge_rows {
  const int32_t* c[4];
  int64_t s[4];
};

// Coordinate `c` of row i (c picked by selects, not by a dynamic index
// into the kernel's parameters).
__device__ __forceinline__ bp::fe ge_rows_load(const ge_rows& r, int c,
                                               int64_t i) {
  const int32_t* base = r.c[0];
  int64_t stride = r.s[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (c == k) {
      base = r.c[k];
      stride = r.s[k];
    }
  }
  return bp::fe_load(base + i * stride);
}

// This lane's point: its row (past n for the identity padding).
__device__ __forceinline__ int64_t warp_point() {
  return blockIdx.x * static_cast<int64_t>(kWarpPoints) + threadIdx.x / 4;
}

__global__ void __launch_bounds__(kWarpThreads)
ge_add_kernel(const ge_rows p, const ge_rows q, int32_t* __restrict__ out,
              int64_t n) {
  const bp::lane4 g = bp::lane4_here();
  const int64_t i = warp_point();
  const bool valid = i < n;
  const bp::fe a = valid ? ge_rows_load(p, g.c, i) : bp::ge4_identity(g);
  const bp::fe b = valid ? ge_rows_load(q, g.c, i) : bp::ge4_identity(g);
  const bp::fe r = bp::ge4_padd(g, a, b);
  if (valid) bp::fe_store(out + i * 4 * bp::FE_L + g.c * bp::FE_L, r);
}

__global__ void __launch_bounds__(kWarpThreads)
ge_double_kernel(const ge_rows p, int32_t* __restrict__ out, int64_t n) {
  const bp::lane4 g = bp::lane4_here();
  const int64_t i = warp_point();
  const bool valid = i < n;
  // the doubling never reads t: lane 3 loads nothing
  const bp::fe a = valid && g.c < 3 ? ge_rows_load(p, g.c, i)
                                    : bp::ge4_identity(g);
  const bp::fe r = bp::ge4_pdbl(g, a);
  if (valid) bp::fe_store(out + i * 4 * bp::FE_L + g.c * bp::FE_L, r);
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
__device__ __forceinline__ bp::fe tab_load(int32_t (*tab)[bp::FE_L][kWarpThreads],
                                           int j) {
  bp::fe r;
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) r.v[i] = tab[j][i][threadIdx.x];
  return r;
}

__device__ __forceinline__ void tab_store(int32_t (*tab)[bp::FE_L][kWarpThreads],
                                          int j, const bp::fe& a) {
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) tab[j][i][threadIdx.x] = a.v[i];
}

__global__ void __launch_bounds__(kWarpThreads)
ge_ladder_win_kernel(const int32_t* __restrict__ p,
                     const int32_t* __restrict__ s,
                     int32_t* __restrict__ out, int64_t n) {
  __shared__ int32_t tab[16][bp::FE_L][kWarpThreads];
  const bp::lane4 g = bp::lane4_here();
  const int64_t i = warp_point();
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

// a = bit ? b : a, limb for limb, without a branch (bit is 0 or 1).
__device__ __forceinline__ void fe_select(bp::fe& a, const bp::fe& b,
                                          int32_t bit) {
  const int32_t mask = -bit;
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) a.v[i] ^= (a.v[i] ^ b.v[i]) & mask;
}

__global__ void __launch_bounds__(kWarpThreads)
ge_ladder_bin_kernel(const int32_t* __restrict__ p,
                     const int32_t* __restrict__ s,
                     int32_t* __restrict__ out, int64_t n) {
  const bp::lane4 g = bp::lane4_here();
  const int64_t i = warp_point();
  const bool valid = i < n;
  const int32_t* sc = s + (valid ? i : 0) * bp::FE_L;
  const bp::fe base = valid ? bp::fe_load(p + i * 4 * bp::FE_L + g.c * bp::FE_L)
                            : bp::ge4_identity(g);
  bp::fe acc = bp::ge4_identity(g);
#pragma unroll 1
  for (int k = bp::FE_L * bp::FE_W - 1; k >= 0; --k) {
    acc = bp::ge4_padd(g, acc, acc);
    const bp::fe added = bp::ge4_padd(g, acc, base);
    const int32_t bit = (sc[k / bp::FE_W] >> (k % bp::FE_W)) & 1;
    fe_select(acc, added, valid ? bit : 0);
  }
  if (valid) bp::fe_store(out + i * 4 * bp::FE_L + g.c * bp::FE_L, acc);
}

constexpr int kReduceTile = 256;                 // pallas_field.LANES
constexpr int kReduceUnits = kReduceTile / 2;    // round 1: points u, u + 128
constexpr int kReduceBlocks = 2;                 // a cluster a tile
constexpr int kReduceThreads = 4 * kReduceUnits / kReduceBlocks;
constexpr int kReduceCols = 4 * kReduceUnits;    // a column a lane

// Named barrier 1 over the first `threads` threads of the block (the warps
// still in the reduction).
__device__ __forceinline__ void reduce_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// This lane's sum into column `col` of the tile `tile` points into.
__device__ __forceinline__ void tile_put(int32_t* tile, int col,
                                         const bp::fe& a) {
#pragma unroll
  for (int k = 0; k < bp::FE_L; ++k) tile[k * kReduceCols + col] = a.v[k];
}

__device__ __forceinline__ bp::fe tile_get(const int32_t* tile, int col) {
  bp::fe r;
#pragma unroll
  for (int k = 0; k < bp::FE_L; ++k) r.v[k] = tile[k * kReduceCols + col];
  return r;
}

// A tile of 256 points on a cluster of two blocks: unit u (block u / 64)
// adds its points u and u + 128, then the tree of halvings.  One call site
// of ge4_padd serves all 8 rounds (one inlined copy of its three field
// products' code, not one a round).
__global__ void __cluster_dims__(kReduceBlocks, 1, 1)
__launch_bounds__(kReduceThreads)
ge_reduce_kernel(const ge_rows p, int32_t* __restrict__ out, int64_t n) {
  // limb k of lane l (unit l / 4, coordinate l % 4) at [k][l]
  __shared__ int32_t tile[bp::FE_L][kReduceCols];
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster has started before one writes another's
  // tile: arrive now, wait before the round that crosses
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  const bp::lane4 g = bp::lane4_here();
  const int rank = static_cast<int>(cluster.block_rank());
  const int unit = rank * (kReduceUnits / kReduceBlocks) +
                   static_cast<int>(threadIdx.x) / 4;
  const int lane = 4 * unit + g.c;
  const int64_t t = blockIdx.x / kReduceBlocks;
  const int64_t i = t * kReduceTile + unit;
  bp::fe acc = i < n ? ge_rows_load(p, g.c, i) : bp::ge4_identity(g);
  bp::fe q = i + kReduceUnits < n ? ge_rows_load(p, g.c, i + kReduceUnits)
                                  : bp::ge4_identity(g);
  int32_t* own = &tile[0][0];
  // round `half`: unit u < half adds unit u + half's sum q into its own
#pragma unroll 1
  for (int half = kReduceUnits;; half >>= 1) {
    acc = bp::ge4_padd(g, acc, q);
    if (half == 1) break;
    const int next = half / 2;
    if (next < kWarpPoints) {
      // warp 0's 8 points: unit u + next's lanes lie 4 next above
#pragma unroll
      for (int k = 0; k < bp::FE_L; ++k)
        q.v[k] = __shfl_down_sync(bp::kFullWarp, acc.v[k], 4 * next);
      continue;
    }
    // units next .. half - 1 hand their sums down and leave: each column
    // is written once and read once in the whole reduction
    if (next == kReduceUnits / kReduceBlocks) {    // block 1's units
      asm volatile("barrier.cluster.wait;" ::: "memory");
      if (unit >= next) tile_put(cluster.map_shared_rank(own, 0), lane, acc);
      cluster.sync();
    } else {
      if (unit >= next) tile_put(own, lane, acc);
      reduce_sync(4 * half);          // units 0 .. half - 1, 4 lanes each
    }
    if (unit >= next) return;
    q = tile_get(own, lane + 4 * next);
  }
  if (unit == 0) bp::fe_store(out + t * 4 * bp::FE_L + g.c * bp::FE_L, acc);
}

unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace

// The version of the library's C interface (utils/build.py's ABI): raised
// whenever an entry's arguments change, so that a library built from
// other sources is refused rather than called with the wrong arguments.
extern "C" int bp_abi_version() { return 7; }

// p, q: coordinates x, y, z, t, each a base pointer and a row stride in
// int32 (0 = one point broadcast); out [n, 80].
extern "C" int bp_ge_add(const int32_t* px, const int32_t* py,
                         const int32_t* pz, const int32_t* pt, int64_t spx,
                         int64_t spy, int64_t spz, int64_t spt,
                         const int32_t* qx, const int32_t* qy,
                         const int32_t* qz, const int32_t* qt, int64_t sqx,
                         int64_t sqy, int64_t sqz, int64_t sqt, int32_t* out,
                         int64_t n, void* stream) {
  if (n <= 0) return 0;
  const ge_rows p{{px, py, pz, pt}, {spx, spy, spz, spt}};
  const ge_rows q{{qx, qy, qz, qt}, {sqx, sqy, sqz, sqt}};
  ge_add_kernel<<<blocks_for(n, kWarpPoints), kWarpThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(p, q, out, n);
  return static_cast<int>(cudaGetLastError());
}

// p: coordinates x, y, z, t, each a base pointer and a row stride in int32
// (0 = one point broadcast; t is taken as ge_add's and not read); out
// [n, 80].
extern "C" int bp_ge_double(const int32_t* px, const int32_t* py,
                            const int32_t* pz, const int32_t* pt, int64_t spx,
                            int64_t spy, int64_t spz, int64_t spt,
                            int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const ge_rows p{{px, py, pz, pt}, {spx, spy, spz, spt}};
  ge_double_kernel<<<blocks_for(n, kWarpPoints), kWarpThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_ge_ladder_win(const int32_t* p, const int32_t* s,
                                int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  ge_ladder_win_kernel<<<blocks_for(n, kWarpPoints), kWarpThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, s, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_ge_ladder_bin(const int32_t* p, const int32_t* s,
                                int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  ge_ladder_bin_kernel<<<blocks_for(n, kWarpPoints), kWarpThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, s, out, n);
  return static_cast<int>(cudaGetLastError());
}

// p: coordinates x, y, z, t, each a base pointer and a row stride in int32
// (0 = one point broadcast); out [ceil(n / 256), 80], one partial sum per
// tile.
extern "C" int bp_ge_reduce(const int32_t* px, const int32_t* py,
                            const int32_t* pz, const int32_t* pt, int64_t spx,
                            int64_t spy, int64_t spz, int64_t spt,
                            int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const ge_rows p{{px, py, pz, pt}, {spx, spy, spz, spt}};
  ge_reduce_kernel<<<kReduceBlocks * blocks_for(n, kReduceTile),
                     kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out, n);
  return static_cast<int>(cudaGetLastError());
}
