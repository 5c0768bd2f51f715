// Kernels of the sort-plus-scan bucket MSM (pippenger.msm_pippenger).
//
//   ge_seg_scan_lanes_kernel + ge_seg_scan_carry_kernel
//       replace cudabulletproof_tpu/ops/pallas_curve.py::_seg_scan_kernel
//       (seg_scan; _lane_scan_incl with head flags)
//   ge_bucket_fold_lanes_kernel + ge_bucket_fold_finish_kernel
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
// exclusive segmented sum of the lanes before it.  The Pallas kernel walks
// a sequential grid over depth with the [80, lanes] accumulator in VMEM
// and runs the cross-lane carry in its last step.  Blocks here run in no
// order and 1024 points (320 KB) exceed a block's shared memory, so:
//   * kernel 1, one thread per lane (blocks of 32): depth dependent steps,
//     acc = head ? row : padd(acc, row), each written out; the lane's last
//     value and "has a head" flag go to a global double buffer;
//   * kernel 2, one block: the Hillis-Steele scan across lanes of the
//     Pallas kernel, stage s = 1, 2, 4, ...: lane l >= s whose flag is 0
//     takes padd(v[l - s], v[l]), and its flag becomes max(f[l], f[l - s]);
//     each stage reads one buffer and writes the other, a barrier between;
//     then carry[l] = S[l - 1], the identity for lane 0.
// The [depth, 80, lanes] layout puts neighbouring lanes on neighbouring
// addresses, so kernel 1's loads and stores are coalesced.
//
// Bucket fold.  In: body [m, 80], a bucket table in descending bucket
// order, identity-padded at the front to depth * lanes (depth the power of
// two at least m / lanes), element (j, l) = padded[l * depth + j].  Out:
// sum over the padded table of its prefix sums, i.e. sum_b b * S_b.
//   * kernel 1, one thread per lane: s = padd(s, row); w = padd(w, s) over
//     the lane's depth rows (front padding read as the identity, no copy);
//   * kernel 2, one block: the unsegmented cross-lane scan of the s values,
//     the exclusive carry scaled by depth with log2(depth) dedicated
//     doublings, added to w, then the lanes halved, lane l + half into
//     lane l.  Every step in the Pallas kernel's order.
//
// Counting sort, one LSD pass over keys [nblk, 8, 128] with values below
// radix <= 256: 1024 (sublane, lane) slots, each with its own counters,
// laid out [radix, 8, 128] in global memory so a warp's counters are
// neighbours.  One thread per slot walks the nblk blocks in order, so a
// slot's ranks are stable in (slot, block) order by construction, the
// traversal convention of ops/sort.py.  sort_hist counts; sort_rank starts
// each counter at its base (the exclusive prefix of the counts, computed in
// torch between the two) and hands out ranks.  A key outside [0, radix)
// matches no counter: uncounted, rank 0, as in the Pallas kernels.
//
// What bounds them on Hopper.  The scan and the fold are chains of unified
// adds (9 field multiplies, ~4,000 IMADs each) whose length is the depth
// and log2(lanes): latency, not throughput, at 1024 or 128 threads.  The
// sort kernels move 4 bytes a key per pass plus the counters, and at 2^16
// keys are bound by the 1024 threads' dependent read-modify-writes.  These
// are the simple designs; parallelism within a lane's chain is later work.
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

constexpr int kRow = 4 * bp::FE_L;     // int32 per point row
constexpr int kLaneThreads = 32;       // per-lane kernels: spread over SMs
constexpr int kCrossThreads = 256;     // the one block of a cross-lane pass
constexpr int kSlots = 8 * 128;        // counter slots of the counting sort
constexpr int kSortThreads = 64;

// Point i of a strided layout: limb c of the 80 at p[c * stride].  No
// __restrict__: the scratch buffers are written and read in one kernel.
__device__ __forceinline__ bp::ge ge_ld(const int32_t* p, int64_t stride) {
  bp::ge r;
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) {
    r.x.v[i] = p[i * stride];
    r.y.v[i] = p[(bp::FE_L + i) * stride];
    r.z.v[i] = p[(2 * bp::FE_L + i) * stride];
    r.t.v[i] = p[(3 * bp::FE_L + i) * stride];
  }
  return r;
}

__device__ __forceinline__ void ge_st(int32_t* p, int64_t stride,
                                      const bp::ge& a) {
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) {
    p[i * stride] = a.x.v[i];
    p[(bp::FE_L + i) * stride] = a.y.v[i];
    p[(2 * bp::FE_L + i) * stride] = a.z.v[i];
    p[(3 * bp::FE_L + i) * stride] = a.t.v[i];
  }
}

// Inclusive Hillis-Steele scan across the lanes of buf[0] ([2, lanes, 80],
// the second half scratch), segmented by flags[0] ([2, lanes]) unless flags
// is null; run by one whole block.  Returns which half holds the result.
__device__ int lane_scan_incl(int32_t* buf, int32_t* flags, int lanes) {
  const int64_t half = static_cast<int64_t>(lanes) * kRow;
  int cur = 0;
#pragma unroll 1
  for (int s = 1; s < lanes; s *= 2) {
    const int32_t* src = buf + cur * half;
    int32_t* dst = buf + (1 - cur) * half;
    const int32_t* fsrc = flags ? flags + cur * lanes : nullptr;
    int32_t* fdst = flags ? flags + (1 - cur) * lanes : nullptr;
#pragma unroll 1
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
      const bool merge = l >= s && (!flags || fsrc[l] == 0);
      bp::ge v = ge_ld(src + static_cast<int64_t>(l) * kRow, 1);
      if (merge)
        v = bp::ge_padd(ge_ld(src + static_cast<int64_t>(l - s) * kRow, 1), v);
      ge_st(dst + static_cast<int64_t>(l) * kRow, 1, v);
      if (flags) fdst[l] = l >= s ? max(fsrc[l], fsrc[l - s]) : fsrc[l];
    }
    __syncthreads();
    cur = 1 - cur;
  }
  return cur;
}

__global__ void __launch_bounds__(kLaneThreads)
ge_seg_scan_lanes_kernel(const int32_t* __restrict__ pt,
                         const int32_t* __restrict__ ht,
                         int32_t* __restrict__ out, int32_t* buf,
                         int32_t* flags, int depth, int lanes) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  bp::ge acc = bp::ge_identity();
  int32_t hh = 0;
#pragma unroll 1
  for (int j = 0; j < depth; ++j) {
    const int64_t off = static_cast<int64_t>(j) * kRow * lanes + l;
    const bp::ge row = ge_ld(pt + off, lanes);
    const int32_t h = ht[static_cast<int64_t>(j) * lanes + l];
    acc = h > 0 ? row : bp::ge_padd(acc, row);
    ge_st(out + off, lanes, acc);
    hh = max(hh, h);
  }
  ge_st(buf + static_cast<int64_t>(l) * kRow, 1, acc);
  flags[l] = hh;
}

__global__ void __launch_bounds__(kCrossThreads)
ge_seg_scan_carry_kernel(int32_t* buf, int32_t* flags,
                         int32_t* __restrict__ carry, int lanes) {
  const int cur = lane_scan_incl(buf, flags, lanes);
  const int32_t* S = buf + cur * static_cast<int64_t>(lanes) * kRow;
#pragma unroll 1
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    const bp::ge c = l == 0 ? bp::ge_identity()
                            : ge_ld(S + static_cast<int64_t>(l - 1) * kRow, 1);
    ge_st(carry + l, lanes, c);
  }
}

__global__ void __launch_bounds__(kLaneThreads)
ge_bucket_fold_lanes_kernel(const int32_t* __restrict__ body, int32_t* buf,
                            int32_t* wacc, int64_t m, int depth, int lanes) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int64_t pad = static_cast<int64_t>(depth) * lanes - m;
  bp::ge s = bp::ge_identity();
  bp::ge w = bp::ge_identity();
#pragma unroll 1
  for (int j = 0; j < depth; ++j) {
    const int64_t e = static_cast<int64_t>(l) * depth + j;
    const bp::ge p = e < pad ? bp::ge_identity()
                             : ge_ld(body + (e - pad) * kRow, 1);
    s = bp::ge_padd(s, p);
    w = bp::ge_padd(w, s);
  }
  ge_st(buf + static_cast<int64_t>(l) * kRow, 1, s);
  ge_st(wacc + static_cast<int64_t>(l) * kRow, 1, w);
}

__global__ void __launch_bounds__(kCrossThreads)
ge_bucket_fold_finish_kernel(int32_t* buf, const int32_t* wacc,
                             int32_t* __restrict__ out, int depth,
                             int lanes) {
  const int cur = lane_scan_incl(buf, nullptr, lanes);
  const int64_t half_buf = static_cast<int64_t>(lanes) * kRow;
  const int32_t* incl = buf + cur * half_buf;
  int32_t* r = buf + (1 - cur) * half_buf;
#pragma unroll 1
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    bp::ge excl = l == 0 ? bp::ge_identity()
                         : ge_ld(incl + static_cast<int64_t>(l - 1) * kRow, 1);
#pragma unroll 1
    for (int k = depth; k > 1; k /= 2) excl = bp::ge_pdbl(excl);
    ge_st(r + static_cast<int64_t>(l) * kRow, 1,
          bp::ge_padd(ge_ld(wacc + static_cast<int64_t>(l) * kRow, 1), excl));
  }
  __syncthreads();
#pragma unroll 1
  for (int half = lanes / 2; half > 0; half /= 2) {
    // lane l reads lanes l and l + half and writes lane l: no other lane
    // of this round touches either
#pragma unroll 1
    for (int l = threadIdx.x; l < half; l += blockDim.x)
      ge_st(r + static_cast<int64_t>(l) * kRow, 1,
            bp::ge_padd(ge_ld(r + static_cast<int64_t>(l) * kRow, 1),
                        ge_ld(r + static_cast<int64_t>(l + half) * kRow, 1)));
    __syncthreads();
  }
  if (threadIdx.x == 0) ge_st(out, 1, ge_ld(r, 1));
}

__global__ void __launch_bounds__(kSortThreads)
sort_hist_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ counts,
                 int64_t nblk, int radix) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= kSlots) return;
#pragma unroll 1
  for (int b = 0; b < radix; ++b) counts[b * kSlots + slot] = 0;
#pragma unroll 1
  for (int64_t t = 0; t < nblk; ++t) {
    const int32_t k = keys[t * kSlots + slot];
    if (k >= 0 && k < radix) counts[k * kSlots + slot] += 1;
  }
}

__global__ void __launch_bounds__(kSortThreads)
sort_rank_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ base, int32_t* __restrict__ cnt,
                 int32_t* __restrict__ rank, int64_t nblk, int radix) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= kSlots) return;
#pragma unroll 1
  for (int b = 0; b < radix; ++b)
    cnt[b * kSlots + slot] = base[b * kSlots + slot];
#pragma unroll 1
  for (int64_t t = 0; t < nblk; ++t) {
    const int32_t k = keys[t * kSlots + slot];
    int32_t r = 0;
    if (k >= 0 && k < radix) {
      r = cnt[k * kSlots + slot];
      cnt[k * kSlots + slot] = r + 1;
    }
    rank[t * kSlots + slot] = r;
  }
}

bool pow2(int64_t v) { return v >= 1 && (v & (v - 1)) == 0; }

unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
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
  ge_seg_scan_lanes_kernel<<<blocks_for(l, kLaneThreads), kLaneThreads, 0,
                             st>>>(pt, ht, out, buf, flags, d, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ge_seg_scan_carry_kernel<<<1, kCrossThreads, 0, st>>>(buf, flags, carry, l);
  return static_cast<int>(cudaGetLastError());
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
  ge_bucket_fold_lanes_kernel<<<blocks_for(l, kLaneThreads), kLaneThreads, 0,
                                st>>>(body, buf, wacc, m, d, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ge_bucket_fold_finish_kernel<<<1, kCrossThreads, 0, st>>>(buf, wacc, out, d,
                                                            l);
  return static_cast<int>(cudaGetLastError());
}

// keys [nblk, 8, 128] -> counts [radix, 8, 128]; radix in 1..256.
extern "C" int bp_sort_hist(const int32_t* keys, int32_t* counts, int64_t nblk,
                            int64_t radix, void* stream) {
  if (nblk < 0 || radix < 1 || radix > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  sort_hist_kernel<<<blocks_for(kSlots, kSortThreads), kSortThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, counts, nblk, static_cast<int>(radix));
  return static_cast<int>(cudaGetLastError());
}

// keys [nblk, 8, 128], base [radix, 8, 128] -> rank [nblk, 8, 128]; cnt
// [radix, 8, 128] is scratch.  radix in 1..256.
extern "C" int bp_sort_rank(const int32_t* keys, const int32_t* base,
                            int32_t* cnt, int32_t* rank, int64_t nblk,
                            int64_t radix, void* stream) {
  if (nblk < 0 || radix < 1 || radix > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  sort_rank_kernel<<<blocks_for(kSlots, kSortThreads), kSortThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, base, cnt, rank, nblk, static_cast<int>(radix));
  return static_cast<int>(cudaGetLastError());
}
