// Kernels of the sort-plus-scan bucket MSM (pippenger.msm_pippenger).
//
//   ge_seg_scan_lanes_kernel + ge_lane_scan_stage_kernel (x stages)
//       replace cudabulletproof_tpu/ops/pallas_curve.py::_seg_scan_kernel
//       (seg_scan; _lane_scan_incl with head flags)
//   ge_bucket_fold_lanes_kernel + ge_lane_scan_stage_kernel (x stages) +
//   ge_halve_kernel (x rounds) + ge_halve_tail_kernel
//       replace pallas_curve.py::_bucket_fold_kernel (bucket_fold)
//   sort_hist_kernel
//       replaces cudabulletproof_tpu/ops/pallas_sort.py::_hist_kernel
//   sort_rank_kernel
//       replaces pallas_sort.py::_rank_kernel
//
// Segmented scan.  In: pt [depth, 80, lanes] points, element (j, l) the
// sorted point l * depth + j; ht [depth, lanes] head flags (1 = the element
// starts a segment).  Out: the same layout of scan values (lane l scans its
// chunk alone: a lane whose first element does not start a segment holds
// chunk-local partials for its leading run) and carry [80, lanes], lane l's
// exclusive segmented sum of the lanes before it.
//   * kernel 1: depth dependent steps a lane, acc = head ? row : padd(acc,
//     row), each written out; the lane's last value and "has a head" flag
//     go to a global double buffer;
//   * the Hillis-Steele scan across lanes of the Pallas kernel, stage s = 1,
//     2, 4, ...: lane l >= s whose flag is 0 takes padd(v[l - s], v[l]), and
//     its flag becomes max(f[l], f[l - s]); each stage reads one half of the
//     buffer and writes the other; at the last stage lane l computes lane l
//     - 1's value (the identity for lane 0) and writes it as its carry.
//
// Bucket fold.  In: body [m, 80], a bucket table in descending bucket
// order, identity-padded at the front to depth * lanes (depth the power of
// two at least m / lanes), element (j, l) = padded[l * depth + j].  Out:
// sum over the padded table of its prefix sums, i.e. sum_b b * S_b.
//   * kernel 1, per lane: s = padd(s, row); w = padd(w, s) over its depth
//     rows (front padding read as the identity, no copy); w's add of row j
//     and s's add of row j + 1 are independent and run side by side;
//   * the unsegmented cross-lane scan of the s values as above; at its last
//     stage lane l takes the exclusive carry (lane l - 1's value), doubles
//     it log2(depth) times and adds it to its w;
//   * the lanes halved, lane l + half into lane l, one launch a round until
//     2 * kTailUnits lanes are left, then the rest in one block with the
//     points in shared memory.
// Every step in the Pallas kernels' order, so the outputs equal the plain
// twins (pippenger.seg_scan_plain, bucket_fold_plain) limb for limb at the
// same layout.
//
// Design on Hopper.  Every point operation runs on the four-lane group law
// (fe25519.cuh's ge4_*): a unit of four threads holds a point, thread c its
// coordinate c, so a unified add is 3 multiply latencies deep (9 on one
// thread) and a doubling 2 (8).  The head and merge selects are per unit:
// a unit's four threads share the lane, so a branch around an add splits
// only whole units, and kernel 1's add runs on every step with the head
// picking the row after it (one converged multiply stream).  A block is one
// warp, eight points, so 1024 lanes are 128 blocks over the 132 SMs where
// the one-thread design ran 32 blocks; each data-parallel step across lanes
// (a scan stage, a halving round) is its own launch over all the lanes'
// blocks, issued from the same C entry on the caller's stream (no
// allocation, no host sync: a CUDA graph can capture it), instead of one
// block walking every stage.  The stage's points stay in the global double
// buffer: a stage reads its neighbour's point from another block, and at
// 1024 lanes the 320 KB buffer lives in L2.  Kernel 1 loads the next row
// before the current step's add.
//
// What bounds them: the latency of one warp's chain, one warp a scheduler
// at 1024 lanes.  Kernel 1 is depth (scan) or depth + 1 (fold) dependent
// adds at ~4.2 us a link (an H100: 0.27 ms for the scan's 64 links); each
// stage and halving round is one add, 5-7 us of device time where every
// lane adds (~2 us where the flags stop most), and a launch.  More lanes
// trade chain length for stages: the card path folds in 1024 lanes
// (config.MSM_FOLD_LANES_CUDA, 8 rows a lane for w = 13, where the JAX
// package's 128 lanes take 64) and scans in the JAX package's 1024
// (config.MSM_SCAN_LANES; PERF.md §6 rows 14-15 have the sweep).  ptxas
// (sm_90a): 168 registers a thread for kernel 1 of the scan and the stage
// kernel, 200 for kernel 1 of the fold, 128 for the halving kernels (the
// tail 20 KB of shared memory); no stack, no spills.
//
// Counting sort, one LSD pass over keys [nblk, 8, 128] with values below
// radix <= 256.  Each of the 1024 (sublane, lane) slots sorts its own
// column of nblk keys; a slot's ranks are stable in (slot, block) order, the
// traversal convention of ops/sort.py.  sort_hist counts each slot's keys
// of each value; sort_rank hands each key base[key, slot] (the exclusive
// prefix of the counts, computed in torch between the two) plus the number
// of equal keys in earlier blocks of its slot.  A key outside [0, radix)
// matches no counter: uncounted, rank 0, as in the Pallas kernels.
//
// Design on Hopper.  The Pallas kernels walk the grid of key blocks in
// order on one core with the counters in VMEM; one thread a slot walking
// its column with a global read-modify-write a key (the first port) kept
// 16 blocks busy and ran nblk dependent round trips to L2.  Here a block
// of 256 threads owns G consecutive slots outright, thread x slot x % G:
// its key loads and rank stores are whole 32-byte sectors, its counters
// [v][G] live in shared memory (never in global memory), and no block
// reads another's output.
//   * sort_hist, G = 8 (128 blocks): the block's 32 row phases count rows
//     t = x / 8 (mod 32) into [radix][8] int32 counters with shared
//     atomicAdd (threads collide only on equal keys of a slot), then the
//     block stores its columns of counts.
//   * sort_rank, G = 16 (64 blocks): the 16 row chunks of ceil(nblk / 16)
//     rows each.  Phase 1: chunk c counts its rows into its own counters
//     [radix][16] (a thread the only writer of its column: plain
//     read-modify-writes).  Phase 2: each counter becomes the exclusive
//     prefix over the chunks' tables, and the block loads base[., slot]
//     into shared memory.  Phase 3: the chunk walks its rows again and
//     hands out base + counter, counter += 1: ranks in row order, since
//     every earlier chunk's equal keys are in the prefix.  The counters are
//     16 bits while nblk < 2^16 (no count or prefix reaches 2^16; phase 2
//     adds two of them a 32-bit word), else 32 bits in 8 chunks of 128
//     threads: at most 144 KB of shared memory (radix 256).
// Each G beat the other two of 8, 16 and 32 slots a block in turns on the
// card at [2^16, radix 128] (PERF.md).  sort_hist reads 4 bytes a key and
// writes a [radix, 8, 128] table, sort_rank reads the keys and the table
// and writes 4 bytes a key; at 2^16 keys a launch's fixed latency is most
// of either's time.
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

constexpr int kRow = 4 * bp::FE_L;     // int32 per point row
constexpr int kPointThreads = 32;      // a block of the point kernels: 8 units
constexpr int kTailUnits = 64;         // units of the fold's last block
constexpr int kSlots = 8 * 128;        // slots of the counting sort
constexpr int kHistSlots = 8;          // slots a block of sort_hist
constexpr int kRankSlots = 16;         // slots a block of sort_rank
constexpr int kSortThreads = 256;
constexpr int kMaxRadix = 256;

// One coordinate: limb i at p[i * stride].
__device__ __forceinline__ bp::fe fe_ld(const int32_t* p, int64_t stride) {
  bp::fe r;
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) r.v[i] = p[i * stride];
  return r;
}

__device__ __forceinline__ void fe_st(int32_t* p, int64_t stride,
                                      const bp::fe& a) {
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) p[i * stride] = a.v[i];
}

// The point (lane of the scan or fold) of this thread's unit.  Blocks are
// whole units, so a unit's four threads exit together.
__device__ __forceinline__ int unit_here() {
  return static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / 4);
}

// Offset of coordinate c of point l in a [n, 80] row layout.
__device__ __forceinline__ int64_t row_at(int l, int c) {
  return static_cast<int64_t>(l) * kRow + c * bp::FE_L;
}

// A point of unit t in shared memory laid out [20 limbs][4 * units]: lane
// c of unit t at column 4t + c, so a warp's 32 lanes hit 32 banks.
__device__ __forceinline__ bp::fe unit_load(const int32_t* sm, int t, int c) {
  return fe_ld(sm + 4 * t + c, 4 * kTailUnits);
}

__device__ __forceinline__ void unit_store(int32_t* sm, int t, int c,
                                           const bp::fe& a) {
  fe_st(sm + 4 * t + c, 4 * kTailUnits, a);
}

__global__ void __launch_bounds__(kPointThreads)
ge_seg_scan_lanes_kernel(const int32_t* __restrict__ pt,
                         const int32_t* __restrict__ ht,
                         int32_t* __restrict__ out, int32_t* __restrict__ buf,
                         int32_t* __restrict__ flags, int depth, int lanes) {
  const bp::lane4 g = bp::lane4_here();
  const int l = unit_here();
  if (l >= lanes) return;
  const int64_t step = static_cast<int64_t>(kRow) * lanes;
  const int64_t at = static_cast<int64_t>(g.c) * bp::FE_L * lanes + l;
  bp::fe acc = bp::ge4_identity(g);
  bp::fe row = fe_ld(pt + at, lanes);
  int32_t h = ht[l], hh = 0;
#pragma unroll 1
  for (int j = 0; j < depth; ++j) {
    bp::fe next = row;
    int32_t hn = 0;
    if (j + 1 < depth) {
      next = fe_ld(pt + (j + 1) * step + at, lanes);
      hn = ht[static_cast<int64_t>(j + 1) * lanes + l];
    }
    acc = bp::fe_sel(h > 0, row, bp::ge4_padd(g, acc, row));
    fe_st(out + j * step + at, lanes, acc);
    hh = max(hh, h);
    row = next;
    h = hn;
  }
  fe_st(buf + row_at(l, g.c), 1, acc);
  if (g.c == 0) flags[l] = hh;
}

// Lane l's value after the Hillis-Steele stage s over src ([lanes, 80]),
// segmented by fsrc unless it is null.
__device__ __forceinline__ bp::fe stage_value(const bp::lane4& g,
                                              const int32_t* src,
                                              const int32_t* fsrc, int l,
                                              int s) {
  const int32_t* mine = src + row_at(l, g.c);
  bp::fe v = fe_ld(mine, 1);
  if (l >= s && (fsrc == nullptr || fsrc[l] == 0))
    v = bp::ge4_padd(g, fe_ld(mine - static_cast<int64_t>(s) * kRow, 1), v);
  return v;
}

// A stage of the cross-lane scan.  Before the last: src -> dst, the flags
// fsrc -> fdst (when segmented).  The last: lane l's carry, the stage's
// value of lane l - 1 (the identity for lane 0), to dst in the layout
// (dpoint, dlimb) (the seg scan's [80, lanes]); or, where w is given (the
// fold), the carry doubled dbls times and added to w[l] in place.
__global__ void __launch_bounds__(kPointThreads)
ge_lane_scan_stage_kernel(const int32_t* __restrict__ src,
                          const int32_t* __restrict__ fsrc,
                          int32_t* __restrict__ dst,
                          int32_t* __restrict__ fdst, int32_t* w, int s,
                          int lanes, int last, int64_t dpoint, int64_t dlimb,
                          int dbls) {
  const bp::lane4 g = bp::lane4_here();
  const int l = unit_here();
  if (l >= lanes) return;
  if (!last) {
    fe_st(dst + row_at(l, g.c), 1, stage_value(g, src, fsrc, l, s));
    if (fsrc != nullptr && g.c == 0)
      fdst[l] = l >= s ? max(fsrc[l], fsrc[l - s]) : fsrc[l];
    return;
  }
  bp::fe e = l == 0 ? bp::ge4_identity(g) : stage_value(g, src, fsrc, l - 1, s);
  if (w == nullptr) {
    fe_st(dst + l * dpoint + g.c * bp::FE_L * dlimb, dlimb, e);
    return;
  }
#pragma unroll 1
  for (int k = 0; k < dbls; ++k) e = bp::ge4_pdbl(g, e);
  int32_t* mine = w + row_at(l, g.c);
  fe_st(mine, 1, bp::ge4_padd(g, fe_ld(mine, 1), e));
}

__global__ void __launch_bounds__(kPointThreads)
ge_bucket_fold_lanes_kernel(const int32_t* __restrict__ body,
                            int32_t* __restrict__ buf,
                            int32_t* __restrict__ wacc, int64_t m, int depth,
                            int lanes) {
  const bp::lane4 g = bp::lane4_here();
  const int l = unit_here();
  if (l >= lanes) return;
  const int64_t pad = static_cast<int64_t>(depth) * lanes - m;
  const int64_t e0 = static_cast<int64_t>(l) * depth;
  auto row = [&](int j) {
    const int64_t e = e0 + j;
    return e < pad ? bp::ge4_identity(g)
                   : fe_ld(body + (e - pad) * kRow + g.c * bp::FE_L, 1);
  };
  bp::fe s = bp::ge4_padd(g, bp::ge4_identity(g), row(0));
  bp::fe w = bp::ge4_identity(g);
  bp::fe p = depth > 1 ? row(1) : s;
#pragma unroll 1
  for (int j = 1; j < depth; ++j) {
    const bp::fe next = j + 1 < depth ? row(j + 1) : p;
    const bp::fe w2 = bp::ge4_padd(g, w, s);       // w after row j - 1
    s = bp::ge4_padd(g, s, p);                     // s after row j
    w = w2;
    p = next;
  }
  w = bp::ge4_padd(g, w, s);
  fe_st(buf + row_at(l, g.c), 1, s);
  fe_st(wacc + row_at(l, g.c), 1, w);
}

// One halving round in place: lane l < half takes padd(r[l], r[l + half]);
// no other lane of the round touches either.
__global__ void __launch_bounds__(kPointThreads)
ge_halve_kernel(int32_t* r, int half) {
  const bp::lane4 g = bp::lane4_here();
  const int l = unit_here();
  if (l >= half) return;
  int32_t* mine = r + row_at(l, g.c);
  fe_st(mine, 1, bp::ge4_padd(g, fe_ld(mine, 1),
                              fe_ld(mine + static_cast<int64_t>(half) * kRow,
                                    1)));
}

// The last rounds, from `live` <= 2 * kTailUnits lanes of r down to one, in
// one block with the points in shared memory; the result to out [80].
__global__ void __launch_bounds__(4 * kTailUnits)
ge_halve_tail_kernel(const int32_t* __restrict__ r, int32_t* __restrict__ out,
                     int live) {
  __shared__ int32_t sm[bp::FE_L * 4 * kTailUnits];
  const bp::lane4 g = bp::lane4_here();
  const int t = threadIdx.x / 4;
  int half = live / 2;
  if (half == 0) {
    if (t == 0) fe_st(out + g.c * bp::FE_L, 1, fe_ld(r + row_at(0, g.c), 1));
    return;
  }
  if (t < half)
    unit_store(sm, t, g.c,
               bp::ge4_padd(g, fe_ld(r + row_at(t, g.c), 1),
                            fe_ld(r + row_at(t + half, g.c), 1)));
  __syncthreads();
#pragma unroll 1
  for (half /= 2; half > 0; half /= 2) {
    if (t < half)
      unit_store(sm, t, g.c,
                 bp::ge4_padd(g, unit_load(sm, t, g.c),
                              unit_load(sm, t + half, g.c)));
    __syncthreads();
  }
  if (t == 0) fe_st(out + g.c * bp::FE_L, 1, unit_load(sm, 0, g.c));
}

// key < radix, counted: the compare of the Pallas kernels, -1 and radix
// out as well.
__device__ __forceinline__ bool in_radix(int32_t k, int radix) {
  return static_cast<unsigned>(k) < static_cast<unsigned>(radix);
}

// f(t, key of row t) for rows t, t + step, ... < end of one slot's column
// `col`, four loads in flight before their four calls.
template <typename F>
__device__ __forceinline__ void walk(const int32_t* __restrict__ col,
                                     int64_t t, int64_t end, int64_t step,
                                     F f) {
#pragma unroll 1
  for (; t + 3 * step < end; t += 4 * step) {
    int32_t k[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = col[(t + u * step) * kSlots];
#pragma unroll
    for (int u = 0; u < 4; ++u) f(t + u * step, k[u]);
  }
#pragma unroll 1
  for (; t < end; t += step) f(t, col[t * kSlots]);
}

// counts[v, slot] for the G = kHistSlots slots of block g: slot g * G +
// (thread % G), rows t = thread / G (mod threads / G).
__global__ void __launch_bounds__(kSortThreads)
sort_hist_kernel(const int32_t* __restrict__ keys,
                 int32_t* __restrict__ counts, int64_t nblk, int radix) {
  constexpr int G = kHistSlots;
  __shared__ int32_t cnt[kMaxRadix * G];                 // [radix][G]
  const int lane = threadIdx.x % G, phase = threadIdx.x / G;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * G;
  for (int i = threadIdx.x; i < radix * G; i += kSortThreads) cnt[i] = 0;
  __syncthreads();
  int32_t* mine = cnt + lane;
  walk(keys + slot0 + lane, phase, nblk, kSortThreads / G,
       [&](int64_t, int32_t k) {
         if (in_radix(k, radix)) atomicAdd(mine + k * G, 1);
       });
  __syncthreads();
  for (int i = threadIdx.x; i < radix * G; i += kSortThreads)
    counts[(i / G) * kSlots + slot0 + i % G] = cnt[i];
}

// rank[t, slot] for the G = kRankSlots slots of block g, T threads: slot
// g * G + (thread % G) in chunk thread / G of the T / G chunks of rows.
template <typename Cnt, int T>
__global__ void __launch_bounds__(T)
sort_rank_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ base,
                 int32_t* __restrict__ rank, int64_t nblk, int radix) {
  constexpr int G = kRankSlots, C = T / G;               // C chunks of rows
  extern __shared__ int4 smem[];
  const int table = radix * G;                           // a chunk's counters
  int32_t* first = reinterpret_cast<int32_t*>(smem);     // [radix][G]
  Cnt* cnt = reinterpret_cast<Cnt*>(first + table);      // [C][radix][G]
  const int lane = threadIdx.x % G, part = threadIdx.x / G;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * G;
  const int zeros = C * table * static_cast<int>(sizeof(Cnt)) / 16;
  int4* z = reinterpret_cast<int4*>(cnt);
  for (int i = threadIdx.x; i < zeros; i += T) z[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int64_t chunk = (nblk + C - 1) / C;
  const int64_t t0 = part * chunk < nblk ? part * chunk : nblk;
  const int64_t t1 = t0 + chunk < nblk ? t0 + chunk : nblk;
  const int32_t* col = keys + slot0 + lane;
  Cnt* mine = cnt + part * table + lane;
  walk(col, t0, t1, 1, [&](int64_t, int32_t k) {
    if (in_radix(k, radix)) mine[k * G] += 1;
  });
  for (int i = threadIdx.x; i < table; i += T)
    first[i] = base[(i / G) * kSlots + slot0 + i % G];
  __syncthreads();
  // the exclusive prefix over the C tables, a 32-bit word at a time: a
  // word holds 4 / sizeof(Cnt) counters, and no sum carries out of its own
  // (it is at most nblk, below 2^16 for 16-bit counters)
  uint32_t* words = reinterpret_cast<uint32_t*>(cnt);
  const int per = table * static_cast<int>(sizeof(Cnt)) / 4;
  for (int i = threadIdx.x; i < per; i += T) {
    uint32_t run = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint32_t v = words[c * per + i];
      words[c * per + i] = run;
      run += v;
    }
  }
  __syncthreads();
  int32_t* out = rank + slot0 + lane;
  walk(col, t0, t1, 1, [&](int64_t t, int32_t k) {
    int32_t r = 0;
    if (in_radix(k, radix)) {
      const Cnt c = mine[k * G];
      mine[k * G] = static_cast<Cnt>(c + 1);
      r = first[k * G + lane] + static_cast<int32_t>(c);
    }
    out[t * kSlots] = r;
  });
}

bool pow2(int64_t v) { return v >= 1 && (v & (v - 1)) == 0; }

unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// The cross-lane scan of buf's first half ([2, lanes, 80]), segmented by
// flags' first half ([2, lanes]) unless flags is null: one launch a stage
// s = 1, 2, 4, ... < lanes, the halves alternating, the last stage as
// ge_lane_scan_stage_kernel says.
cudaError_t lane_scan(int32_t* buf, int32_t* flags, int lanes, int32_t* dst,
                      int64_t dpoint, int64_t dlimb, int32_t* w, int dbls,
                      cudaStream_t st) {
  const int64_t half = static_cast<int64_t>(lanes) * kRow;
  const unsigned int blocks = blocks_for(4LL * lanes, kPointThreads);
  int cur = 0, s = 1;
  for (; 2 * s < lanes; s *= 2, cur = 1 - cur) {
    ge_lane_scan_stage_kernel<<<blocks, kPointThreads, 0, st>>>(
        buf + cur * half, flags ? flags + cur * lanes : nullptr,
        buf + (1 - cur) * half, flags ? flags + (1 - cur) * lanes : nullptr,
        nullptr, s, lanes, 0, kRow, 1, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ge_lane_scan_stage_kernel<<<blocks, kPointThreads, 0, st>>>(
      buf + cur * half, flags ? flags + cur * lanes : nullptr, dst, nullptr,
      w, s, lanes, 1, dpoint, dlimb, dbls);
  return cudaGetLastError();
}

template <typename Cnt, int T>
cudaError_t launch_rank(const int32_t* keys, const int32_t* base,
                        int32_t* rank, int64_t nblk, int radix,
                        cudaStream_t st) {
  // the bases [radix][G] int32, then T / G chunks' counters [radix][G]
  const int bytes =
      radix * kRankSlots * static_cast<int>(4 + T / kRankSlots * sizeof(Cnt));
  const cudaError_t err = cudaFuncSetAttribute(
      sort_rank_kernel<Cnt, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  sort_rank_kernel<Cnt, T><<<kSlots / kRankSlots, T, bytes, st>>>(
      keys, base, rank, nblk, radix);
  return cudaGetLastError();
}

}  // namespace

// pt [depth, 80, lanes], ht [depth, lanes] -> out [depth, 80, lanes],
// carry [80, lanes]; buf [2, lanes, 80] and flags [2, lanes] are scratch.
extern "C" int bp_ge_seg_scan(const int32_t* pt, const int32_t* ht,
                              int32_t* out, int32_t* carry, int32_t* buf,
                              int32_t* flags, int64_t depth, int64_t lanes,
                              void* stream) {
  if (depth <= 0 || lanes <= 0) return 0;
  if (depth > (1 << 24) || lanes > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int d = static_cast<int>(depth), l = static_cast<int>(lanes);
  ge_seg_scan_lanes_kernel<<<blocks_for(4 * lanes, kPointThreads),
                             kPointThreads, 0, st>>>(pt, ht, out, buf, flags,
                                                     d, l);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(lane_scan(buf, flags, l, carry, 1, lanes, nullptr,
                                    0, st));
}

// body [m, 80] -> out [80]; depth and lanes powers of two with depth * lanes
// >= m; buf [2, lanes, 80] and wacc [lanes, 80] are scratch.
extern "C" int bp_ge_bucket_fold(const int32_t* body, int32_t* buf,
                                 int32_t* wacc, int32_t* out, int64_t m,
                                 int64_t depth, int64_t lanes, void* stream) {
  if (m <= 0 || !pow2(depth) || !pow2(lanes) || lanes > (1 << 20) ||
      depth > (1 << 24) || depth * lanes < m)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int d = static_cast<int>(depth), l = static_cast<int>(lanes);
  ge_bucket_fold_lanes_kernel<<<blocks_for(4 * lanes, kPointThreads),
                                kPointThreads, 0, st>>>(body, buf, wacc, m, d,
                                                        l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dbls = 0;
  for (int k = d; k > 1; k /= 2) ++dbls;
  err = lane_scan(buf, nullptr, l, nullptr, 0, 0, wacc, dbls, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int live = l;
  for (; live > 2 * kTailUnits; live /= 2) {
    ge_halve_kernel<<<blocks_for(2LL * live, kPointThreads), kPointThreads,
                      0, st>>>(wacc, live / 2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ge_halve_tail_kernel<<<1, 4 * kTailUnits, 0, st>>>(wacc, out, live);
  return static_cast<int>(cudaGetLastError());
}

// keys [nblk, 8, 128] -> counts [radix, 8, 128]; radix in 1..256.
extern "C" int bp_sort_hist(const int32_t* keys, int32_t* counts, int64_t nblk,
                            int64_t radix, void* stream) {
  if (nblk < 0 || radix < 1 || radix > kMaxRadix)
    return static_cast<int>(cudaErrorInvalidValue);
  sort_hist_kernel<<<kSlots / kHistSlots, kSortThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, counts, nblk, static_cast<int>(radix));
  return static_cast<int>(cudaGetLastError());
}

// keys [nblk, 8, 128], base [radix, 8, 128] -> rank [nblk, 8, 128]; radix
// in 1..256.
extern "C" int bp_sort_rank(const int32_t* keys, const int32_t* base,
                            int32_t* rank, int64_t nblk, int64_t radix,
                            void* stream) {
  if (nblk < 0 || radix < 1 || radix > kMaxRadix)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(radix);
  return static_cast<int>(
      nblk < (1 << 16)
          ? launch_rank<uint16_t, kSortThreads>(keys, base, rank, nblk, r,
                                                st)
          : launch_rank<uint32_t, kSortThreads / 2>(keys, base, rank, nblk,
                                                    r, st));
}
