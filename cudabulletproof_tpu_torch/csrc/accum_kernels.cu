// The signed-bucket accumulator MSM of the port.
//
//   ge_bucket_accum_kernel + ge_bucket_combine_kernel
//       replace cudabulletproof_tpu/ops/pallas_curve.py::_bucket_accum_kernel
//       (msm_bucket_accum, _madd)
//
// What it computes: sum_i s_i P_i from the precomputed mixed-add operands of
// the points (pre [n, 80], rows y+x | y-x | 2d*t | -2d*t with Z = 1, as
// pippenger.madd_precomp makes them) and the signed window digits of the
// scalars (dg [nw, n] int32, least significant window first, each digit in
// [-2^(w-1), 2^(w-1)], as pippenger.extract_digits_signed makes them):
// per window j, W_j = sum_b b * S_b over the buckets S_b = sum of the
// points whose digit has magnitude b (negated when the digit is negative);
// then acc = 2^w acc + W_j, most significant window first.
//
// Design.  The TPU kernel keeps all buckets of a lane block in VMEM and
// picks a point's bucket with select chains, because Mosaic has no dynamic
// index.  Here a bucket is indexed directly by |digit|, and every point
// operation runs on the four-lane group law (fe25519.cuh's ge4_*): a *unit*
// of 4 lanes holds a point, lane c its coordinate c.
//   * kernel 1, grid (slices, nw): the `threads` units of block (slice,
//     window j) are units k = slice * threads + t (t < threads); unit k
//     owns the points k, k + K, k + 2K, ... (K = slices * threads) and its
//     own 2^(w-1) buckets in local memory (one coordinate a lane), all
//     starting at the identity.  A CUDA block runs at most kUnits
//     units at once (4 * 32 = 128 threads), so a block of more units runs
//     them in turns;
//   * per owned point with digit d != 0: one mixed add of the operand into
//     bucket |d| - 1, each lane loading the one operand row its product
//     needs; a negative digit negates the operand by the row swap y+x <->
//     y-x and 2d*t -> -2d*t.  Digit 0 (and every padding point, whose
//     scalar is 0) touches no bucket; a unit's four lanes share the digit,
//     so the branch splits only whole groups;
//   * the unit's weighted fold sum_b b * S_b by suffix and total running
//     sums, buckets from the top: suf += S_b; tot += suf (the Pallas fold);
//   * a halving tree over the block's units in shared memory (unit t +
//     half into unit t); unit 0 writes the block's partial to part
//     [nw, slices, 80];
//   * kernel 2, one block of kUnits units: unit j sums window j's
//     partials in slice order; then unit 0 runs the Horner combine, w
//     doublings and one add per window, most significant first, and writes
//     the result.
// No atomics: every sum runs in a fixed order, so the plain twin
// (pippenger.bucket_accum_plain) follows it and equals the kernel limb for
// limb.
//
// What bounds it on Hopper: integer multiplies, issued by too few warps.
// Per point and window one mixed add is 7 field multiplies (~3,100 IMADs)
// against 80 B of operand rows and a 4 B digit read.  The fixed cost per
// unit is the fold, 2 * 2^(w-1) unified adds, so a unit needs on the order
// of 2^(w-1) * 2.5 points before the stream outweighs it; that, and the
// local memory of 2^(w-1) * 320 B a unit, is the trade the plan
// (config.MSM_ACCUM_PLAN) makes between the window width and the number of
// units.  On four lanes a mixed add is 2 multiply latencies deep (was 7)
// and an add 3 (was 9), and a warp's bucket reads split over 8 units'
// buckets, not 32 threads'.  The buckets stay in local memory: in shared
// memory ([bucket][limb][lane], bank-conflict free) an H100 ran kernel 1
// 3-7% faster at w = 5, 128 units a block, on 4096 and 8192 points, and
// 25% slower at 65536 points, w = 4, where 80 KB of buckets a block left
// fewer blocks an SM (benchmarks/bench_group4.py --against a copy so
// changed).  Kernel 2's Horner chain, ~253 doublings and
// nw adds, is one unit's latency whatever n is (~550 multiply latencies
// where one thread took ~2,500): at batch sizes it is most of the time.
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

constexpr int kRow = 4 * bp::FE_L;     // int32 per point row
constexpr int kUnits = 32;             // units a CUDA block runs at once
constexpr int kMaxWindows = 128;

// A point of unit t in shared memory laid out [20 limbs][4 * units]: lane
// c of unit t at column 4t + c, so a warp's 32 lanes hit 32 banks.
__device__ __forceinline__ bp::fe unit_load(const int32_t* __restrict__ sm,
                                            int cols, int t, int c) {
  bp::fe r;
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) r.v[i] = sm[i * cols + 4 * t + c];
  return r;
}

__device__ __forceinline__ void unit_store(int32_t* __restrict__ sm, int cols,
                                           int t, int c, const bp::fe& a) {
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) sm[i * cols + 4 * t + c] = a.v[i];
}

// The row of a point's operand that lane c's product reads: lane 0 y-x,
// lane 1 y+x, lane 3 2d*t, each swapped for a negative digit (lane 2 reads
// 2d*t and discards its product).
__device__ __forceinline__ int operand_row(int c, bool neg) {
  if (c == 0) return neg ? 0 : 1;
  if (c == 1) return neg ? 1 : 0;
  return neg ? 3 : 2;
}

template <int W>
__global__ void __launch_bounds__(4 * kUnits)
ge_bucket_accum_kernel(const int32_t* __restrict__ pre,
                       const int32_t* __restrict__ dg,
                       int32_t* __restrict__ part, int64_t n, int threads) {
  constexpr int NB = 1 << (W - 1);
  extern __shared__ __align__(16) int32_t tot_sm[];   // [20][4 * threads]
  const bp::lane4 g = bp::lane4_here();
  const int cols = 4 * threads;
  const int u = threadIdx.x / 4;
  const int units = blockDim.x / 4;
  const int win = blockIdx.y;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * threads;
  const int32_t* __restrict__ drow = dg + win * n;

  bp::fe bucket[NB];
#pragma unroll 1
  for (int t = u; t < threads; t += units) {
    const int64_t k = static_cast<int64_t>(blockIdx.x) * threads + t;
#pragma unroll 1
    for (int b = 0; b < NB; ++b) bucket[b] = bp::ge4_identity(g);
#pragma unroll 1
    for (int64_t i = k; i < n; i += stride) {
      const int d = drow[i];
      if (d == 0) continue;
      const bool neg = d < 0;
      const int m = neg ? -d : d;
      const bp::fe q = bp::fe_load(pre + i * kRow +
                                   operand_row(g.c, neg) * bp::FE_L);
      bucket[m - 1] = bp::ge4_madd(g, bucket[m - 1], q);
    }
    bp::fe suf = bp::ge4_identity(g);
    bp::fe tot = bp::ge4_identity(g);
#pragma unroll 1
    for (int b = NB - 1; b >= 0; --b) {
      suf = bp::ge4_padd(g, suf, bucket[b]);
      tot = bp::ge4_padd(g, tot, suf);
    }
    unit_store(tot_sm, cols, t, g.c, tot);
  }
  __syncthreads();
#pragma unroll 1
  for (int half = threads / 2; half > 0; half >>= 1) {
    // unit t reads units t and t + half and writes unit t: no other unit
    // of this round touches either, so one barrier per round suffices
#pragma unroll 1
    for (int t = u; t < half; t += units)
      unit_store(tot_sm, cols, t, g.c,
                 bp::ge4_padd(g, unit_load(tot_sm, cols, t, g.c),
                              unit_load(tot_sm, cols, t + half, g.c)));
    __syncthreads();
  }
  if (u == 0)
    bp::fe_store(part + (static_cast<int64_t>(win) * gridDim.x + blockIdx.x) * kRow +
                     g.c * bp::FE_L,
                 unit_load(tot_sm, cols, 0, g.c));
}

__global__ void __launch_bounds__(4 * kUnits)
ge_bucket_combine_kernel(const int32_t* __restrict__ part,
                         int32_t* __restrict__ out, int nw, int slices,
                         int w) {
  extern __shared__ __align__(16) int32_t window[];   // [20][4 * nw]
  const bp::lane4 g = bp::lane4_here();
  const int cols = 4 * nw;
  const int u = threadIdx.x / 4;
  for (int j = u; j < nw; j += blockDim.x / 4) {
    const int32_t* row = part + static_cast<int64_t>(j) * slices * kRow +
                         g.c * bp::FE_L;
    bp::fe acc = bp::fe_load(row);
#pragma unroll 1
    for (int s = 1; s < slices; ++s)
      acc = bp::ge4_padd(g, acc, bp::fe_load(row + s * kRow));
    unit_store(window, cols, j, g.c, acc);
  }
  __syncthreads();
  if (u != 0) return;
  bp::fe acc = bp::ge4_identity(g);
#pragma unroll 1
  for (int j = nw - 1; j >= 0; --j) {
#pragma unroll 1
    for (int r = 0; r < w; ++r) acc = bp::ge4_pdbl(g, acc);
    acc = bp::ge4_padd(g, acc, unit_load(window, cols, j, g.c));
  }
  bp::fe_store(out + g.c * bp::FE_L, acc);
}

template <int W>
cudaError_t launch_accum(const int32_t* pre, const int32_t* dg, int32_t* part,
                         int64_t n, int nw, int threads, int slices,
                         cudaStream_t stream) {
  const int bytes = threads * kRow * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      ge_bucket_accum_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int units = threads < kUnits ? threads : kUnits;
  ge_bucket_accum_kernel<W><<<dim3(slices, nw), 4 * units, bytes, stream>>>(
      pre, dg, part, n, threads);
  return cudaGetLastError();
}

}  // namespace

// pre [n, 80], dg [nw, n] -> part [nw, slices, 80] (scratch) and out [80].
// w in 4..8; threads a power of two in 32..256; nw <= 128.  Returns the
// first CUDA error of the two launches, or cudaErrorInvalidValue for an
// argument outside those ranges.
extern "C" int bp_ge_bucket_accum(const int32_t* pre, const int32_t* dg,
                                  int32_t* part, int32_t* out, int64_t n,
                                  int64_t nw, int64_t w, int64_t threads,
                                  int64_t slices, void* stream) {
  if (n <= 0) return 0;
  if (nw < 1 || nw > kMaxWindows || threads < 32 || threads > 256 ||
      (threads & (threads - 1)) != 0 || slices < 1 || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int inw = static_cast<int>(nw), it = static_cast<int>(threads);
  const int is = static_cast<int>(slices);
  cudaError_t err;
  switch (w) {
    case 4: err = launch_accum<4>(pre, dg, part, n, inw, it, is, st); break;
    case 5: err = launch_accum<5>(pre, dg, part, n, inw, it, is, st); break;
    case 6: err = launch_accum<6>(pre, dg, part, n, inw, it, is, st); break;
    case 7: err = launch_accum<7>(pre, dg, part, n, inw, it, is, st); break;
    case 8: err = launch_accum<8>(pre, dg, part, n, inw, it, is, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = inw * kRow * static_cast<int>(sizeof(int32_t));
  ge_bucket_combine_kernel<<<1, 4 * kUnits, bytes, st>>>(
      part, out, inw, is, static_cast<int>(w));
  return static_cast<int>(cudaGetLastError());
}
