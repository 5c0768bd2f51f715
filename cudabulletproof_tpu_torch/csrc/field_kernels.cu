// Field kernels of the port: one thread per field element, but for the
// Fermat chains, which run each element on a group of G lanes.
//
//   fe_mul_kernel      replaces cudabulletproof_tpu/ops/pallas_field.py::_mul_kernel
//   fe_sq_kernel       replaces pallas_field.py::_sq_kernel
//   fe_pow2523_kernel  replaces pallas_field.py::_pow2523_kernel
//   fe_invert_kernel   replaces pallas_field.py::_invert_kernel
//   fe_add3_kernel     replaces pallas_field.py::_add_kernel
//   fe_sub3_kernel     replaces pallas_field.py::_sub_kernel
//   fe_inner_product_kernel replaces pallas_field.py::_inner_product_kernel
//                      (bp_fe_inner_product) and
//                      _inner_product_batched_kernel
//                      (bp_fe_inner_product_batched), with the glue after
//                      them (pallas_field.py:305-326, :379-393)
//   fe_mul_chain_kernel replaces the kernel `kern` of
//                      benchmarks/bench_radix16.py::chain13
//
// Layout: rows of 20 int32 limbs, [n, 20] row-major, as the port's public
// functions hold them (the Pallas kernels transposed to [20, n] tiles to put
// the batch on the TPU's lanes).  A warp's loads are therefore strided by
// 80 bytes; a [20, n] layout is left for a later change, since these
// kernels are compute-bound (see fe25519.cuh).  fe_mul and fe_sq read their
// operands in place: each a base pointer and a row stride in int32 (20 for
// a contiguous [n, 20], 80 for a coordinate of an [n, 80] point row, 0 for
// one element broadcast), so a call allocates only its output (the paths
// hand fe_sq contiguous rows only; it shares fe_mul's operand plan).  Their
// blocks are one warp: the paths' 17 to 272 elements spread over 1 to 9
// SMs, one warp a scheduler, as 128-thread blocks spread them over 1 to 3.
//
// What bounds them on Hopper: fe_mul / fe_sq are 400 / 210 IMADs against
// 240 / 160 bytes of traffic per element, so integer-multiply throughput,
// or launch latency at the verify path's small batches (17 to 272
// elements).  fe_pow2523 (251 squarings + 11 multiplies) and fe_invert
// (254 squarings + 11 multiplies) run the whole Fermat chain on
// register-resident limbs (no memory traffic between the ops, which is
// what the Pallas kernels' VMEM-resident chain bought on the TPU): ~265
// dependent field products an element against 160 bytes of traffic.  The
// paths run them on 1 element (batch_invert's total, one point's
// to_bytes) to 17 x B (decompression), where one thread an element leaves
// the card nearly empty and the launch takes the chain's latency (~900
// cycles a product).  So each element runs on a group of G lanes (G | 20,
// fe25519.cuh's split product feg_mul): each link of the chain is 400 / G
// IMADs a lane plus ~44 shuffles, shorter for a wide group, while a narrow
// one does fewer instructions an element for a large batch; the wrapper
// picks G by the count (config.chain_lanes, from bench_group4 --sweep).
// Both share feg_pow_chain_250, as the Pallas kernels share
// _pow_chain_250_block.
//
// fe_add3 / fe_sub3 are a + b and a + (K - b) (K the multiple of p of
// fe25519.cuh, limbs 2*8191 - 1214 | 2*8191), then exactly three rounds of
// the parallel relaxation, as the Pallas kernels do (fe_relax<3>).  They are
// not bp::fe_add / bp::fe_sub, which relax twice, as the curve kernels'
// in-kernel _fadd / _fsub do: the same value mod p, other limbs.  With ~100
// integer operations against 240 bytes an element they are bound by memory
// traffic, and at the CLI's 10,000 elements (2.4 MB) by the launch.
//
// fe_inner_product computes <a, b> mod p for [B, n, 20] operands as the
// JAX package's weak limbs, in one launch.  What fixes the limbs is the
// Pallas partition: elements in tiles of 256, tile t adding into column
// t % 128 of a partial, each element's coefficient c_k (< 2^31) split into
// lo = c_k & MASK and hi = c_k >> 13 before any sum; then the glue splits
// each hi column's sum again (its low 13 bits one limb up, the rest two
// up), folds 41 terms to 20 (fe_fold_wide, two rounds) and relaxes three
// times.  lo sums may be grouped freely; hi's split is of a column's sum.
// Design: block (c, row) owns column c of a row, all its tiles (at most 4
// at n <= 2^17, the wrapper's limit), one element a thread (two from 129
// tiles on, in 512-thread blocks); each thread forms its element's 39
// coefficients in registers (400 IMADs, five 16-byte loads an operand),
// the warp sums the 78 split values by a reduce-scatter butterfly (77
// shuffles a thread where summing each value over the warp takes 390),
// shared memory sums the warps; the block splits its column's hi sums and
// writes the column's 41 terms with plain stores (nothing to zero, no
// atomicAdd on data), and the row's last block to finish (a ticket) sums
// the columns' terms, folds and relaxes, and writes out [B, 20].  Integer
// sums, so the limbs are the same in every run whatever the order.  What
// bounds it: 160 bytes read an element against 400 IMADs, so memory
// traffic (3.1 us at 2^16 elements) over the multiplies (1.6 us), with the
// launch and the last block's combine (a few us) on top.
// Bounds: a coefficient < 20 * 8799^2 < 2^31; a column's lo sum < 2^23 and
// hi sum < 4 * 256 * 2^18 = 2^28; over the columns s0 <= 2^17 * 8191 <
// 2^30, h0 < 128 * 2^13 = 2^20, h1 < 128 * 2^15 = 2^22; a term < 2^31 and
// the fold's rounds stay below 2^31 (as in the JAX glue).

// fe_mul_chain is the radix-13 side of the radix-16 A/B
// (benchmarks/bench_radix16.py): x <- x * b, `reps` times (a runtime loop)
// in one launch, b and x held in registers, the same bp::fe_mul as fe_mul
// (_conv_fold limb for limb).  441 IMADs a multiply against 240 bytes an
// element for the whole chain, so at reps = 64 it is bound by the
// multiplies.
//
// C interface: each entry takes device pointers, the count n and a
// cudaStream_t (PyTorch's current stream), launches without synchronizing
// and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMulThreads = 32;
constexpr int kWarp = 32;

unsigned int blocks_for(int64_t n, int threads = kThreads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// a, b rows at strides sa, sb (int32; 0 = one element broadcast).
__global__ void __launch_bounds__(kMulThreads)
fe_mul_kernel(const int32_t* __restrict__ a, int64_t sa,
              const int32_t* __restrict__ b, int64_t sb,
              int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  bp::fe_store(out + i * bp::FE_L,
               bp::fe_mul(bp::fe_load(a + i * sa), bp::fe_load(b + i * sb)));
}

// a rows at stride sa (int32; 0 = one element broadcast).
__global__ void __launch_bounds__(kMulThreads)
fe_sq_kernel(const int32_t* __restrict__ a, int64_t sa,
             int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  bp::fe_store(out + i * bp::FE_L, bp::fe_sq(bp::fe_load(a + i * sa)));
}

// The Fermat chains: one-warp blocks of 32 / G elements, each on a group of
// G lanes (fe25519.cuh's feg_*); lanes past the last group and elements
// past n run on zeros and store nothing, so every shuffle is defined.
template <int G, bool kInvert>
__device__ __forceinline__ void fe_chain(const int32_t* __restrict__ a,
                                         int32_t* __restrict__ out,
                                         int64_t n) {
  constexpr int K = bp::FE_L / G;
  constexpr int kElems = kWarp / G;
  const bp::laneg<G> l = bp::laneg_here<G>();
  const int slot = static_cast<int>(threadIdx.x) / G;
  const int64_t e = blockIdx.x * static_cast<int64_t>(kElems) + slot;
  const bool live = slot < kElems && e < n;
  const int64_t at = e * bp::FE_L + l.g * K;
  bp::feg<G> z;
#pragma unroll
  for (int r = 0; r < K; ++r) z.v[r] = 0;
  if (live) {
#pragma unroll
    for (int r = 0; r < K; ++r) z.v[r] = a[at + r];
  }
  bp::feg<G> y;
  if constexpr (kInvert) {
    y = bp::feg_invert(l, z);
  } else {
    y = bp::feg_pow2523(l, z);
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < K; ++r) out[at + r] = y.v[r];
  }
}

template <int G>
__global__ void __launch_bounds__(kWarp)
fe_pow2523_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                  int64_t n) {
  fe_chain<G, false>(a, out, n);
}

template <int G>
__global__ void __launch_bounds__(kWarp)
fe_invert_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                 int64_t n) {
  fe_chain<G, true>(a, out, n);
}

template <int G, bool kInvert>
int launch_chain_at(const int32_t* a, int32_t* out, int64_t n,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = blocks_for(n, kWarp / G);
  if constexpr (kInvert) {
    fe_invert_kernel<G><<<blocks, kWarp, 0, stream>>>(a, out, n);
  } else {
    fe_pow2523_kernel<G><<<blocks, kWarp, 0, stream>>>(a, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chain at group width `lanes` (config.CHAIN_WIDTHS: 1, 5 or 10, the
// widths config.chain_lanes picks; any other refused).
template <bool kInvert>
int launch_chain(const int32_t* a, int32_t* out, int64_t n, int64_t lanes,
                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch_chain_at<1, kInvert>(a, out, n, s);
    case 5: return launch_chain_at<5, kInvert>(a, out, n, s);
    case 10: return launch_chain_at<10, kInvert>(a, out, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void fe_add3_kernel(const int32_t* __restrict__ a,
                               const int32_t* __restrict__ b,
                               int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const bp::fe x = bp::fe_load(a + i * bp::FE_L);
  const bp::fe y = bp::fe_load(b + i * bp::FE_L);
  bp::fe r;
#pragma unroll
  for (int k = 0; k < bp::FE_L; ++k) r.v[k] = x.v[k] + y.v[k];
  bp::fe_relax<3>(r);
  bp::fe_store(out + i * bp::FE_L, r);
}

__global__ void fe_sub3_kernel(const int32_t* __restrict__ a,
                               const int32_t* __restrict__ b,
                               int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const bp::fe x = bp::fe_load(a + i * bp::FE_L);
  const bp::fe y = bp::fe_load(b + i * bp::FE_L);
  bp::fe r;
  r.v[0] = x.v[0] + (bp::FE_KNEG0 - y.v[0]);
#pragma unroll
  for (int k = 1; k < bp::FE_L; ++k) r.v[k] = x.v[k] + (bp::FE_KNEG - y.v[k]);
  bp::fe_relax<3>(r);
  bp::fe_store(out + i * bp::FE_L, r);
}

__global__ void fe_mul_chain_kernel(const int32_t* __restrict__ a,
                                    const int32_t* __restrict__ b,
                                    int32_t* __restrict__ out, int64_t n,
                                    int64_t reps) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const bp::fe y = bp::fe_load(b + i * bp::FE_L);
  bp::fe x = bp::fe_load(a + i * bp::FE_L);
#pragma unroll 1
  for (int64_t r = 0; r < reps; ++r) x = bp::fe_mul(x, y);
  bp::fe_store(out + i * bp::FE_L, x);
}

constexpr int kIpLanes = 256;     // elements a tile, threads a block
constexpr int kIpColumns = 128;   // tile t belongs to column t % 128
constexpr int kIpWarps = kIpLanes / kWarp;
constexpr int kIpSums = 2 * bp::FE_NC;    // a thread's lo and hi sums (78)
constexpr int kIpTerms = bp::FE_NC + 2;   // s0 at k, h0 at k + 1, h1 at k + 2
constexpr int kIpVec = bp::FE_L / 4;      // int4 loads a row
constexpr int64_t kIpMaxN = int64_t{1} << 17;
constexpr int64_t kIpMaxRows = 65535;     // the grid's y extent

// Row e of a contiguous [.., 20] operand in five 16-byte loads.
__device__ __forceinline__ void ip_row(const int32_t* __restrict__ p,
                                       int32_t (&r)[bp::FE_L]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int i = 0; i < kIpVec; ++i) {
    const int4 w = __ldg(q + i);
    r[4 * i] = w.x;
    r[4 * i + 1] = w.y;
    r[4 * i + 2] = w.z;
    r[4 * i + 3] = w.w;
  }
}

// One step of the warp's reduce-scatter butterfly: the lanes with bit `off`
// set keep the upper half of v (2H values, zero-padded by the caller), the
// others the lower half, each adding its partner's copy of the half it
// keeps (H shuffles).
template <int H, int N>
__device__ __forceinline__ void ip_halve(const int32_t (&v)[2 * H],
                                         int32_t (&out)[N], int off,
                                         bool up) {
  static_assert(N >= H, "ip_halve: output too short");
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int32_t lower = v[i], upper = v[H + i];
    out[i] = (up ? upper : lower) +
             __shfl_xor_sync(0xffffffffu, up ? lower : upper, off);
  }
}

// The combine of one row by a block of 64 * G threads: the 41 sums of the
// row's column terms [columns, 41] (thread j + 64 q sums term j of the
// columns q, q + G, ..; then the G partial sums of each term), fold_wide
// (41 -> 22 -> 20) and three relax passes, out [20].
template <int G>
__device__ __forceinline__ void ip_combine_row(
    const int32_t* __restrict__ terms, int columns, int32_t* __restrict__ out) {
  __shared__ int32_t part[G][kIpTerms];
  __shared__ int32_t sum[kIpTerms];
  const int j = static_cast<int>(threadIdx.x) % 64;
  const int q = static_cast<int>(threadIdx.x) / 64;
  if (j < kIpTerms) {
    int32_t s = 0;
#pragma unroll 4
    for (int c = q; c < columns; c += G) {
      s += __ldcg(terms + c * kIpTerms + j);
    }
    part[q][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kIpTerms) {
    int32_t s = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) s += part[g][threadIdx.x];
    sum[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t t[kIpTerms];
#pragma unroll
    for (int k = 0; k < kIpTerms; ++k) t[k] = sum[k];
    bp::fe r = bp::fe_fold_wide(t);
    bp::fe_relax<3>(r);
    bp::fe_store(out, r);
  }
}

// One element's 39 coefficients (x, y its limbs; zeros for a lane past n),
// each split into lo = c & MASK and hi = c >> 13, summed over the warp by a
// reduce-scatter butterfly (39 + 20 + 10 + 5 + 3 shuffles) and added to the
// lane's three slots: slot s of lane l holds the warp's sum of value
// b16 * 39 + b8 * 20 + b4 * 10 + b2 * 5 + b1 * 3 + s (b the lane's bits; lo
// of coefficient k is value k, hi value 39 + k), the padding (the 40th of
// step 2's input, the 6th of step 5's) never a value.
__device__ __forceinline__ void ip_element(const int32_t (&x)[bp::FE_L],
                                           const int32_t (&y)[bp::FE_L],
                                           int lane, int32_t (&acc)[3]) {
  int32_t c[bp::FE_NC];
#pragma unroll
  for (int k = 0; k < bp::FE_NC; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < bp::FE_L; ++i) {
#pragma unroll
    for (int j = 0; j < bp::FE_L; ++j) c[i + j] += x[i] * y[j];
  }
  const bool up = lane & 16;
  int32_t s1[40], s2[20], s3[10], s4[6], s5[3];
#pragma unroll
  for (int k = 0; k < bp::FE_NC; ++k) {
    const int32_t lo = c[k] & bp::FE_MASK, hi = c[k] >> bp::FE_W;
    s1[k] = (up ? hi : lo) +
            __shfl_xor_sync(0xffffffffu, up ? lo : hi, 16);
  }
  s1[39] = 0;
  ip_halve<20>(s1, s2, 8, lane & 8);
  ip_halve<10>(s2, s3, 4, lane & 4);
  ip_halve<5>(s3, s4, 2, lane & 2);
  s4[5] = 0;
  ip_halve<3>(s4, s5, 1, lane & 1);
#pragma unroll
  for (int s = 0; s < 3; ++s) acc[s] += s5[s];
}

// Block (column c, row) of 256 * S threads sums the elements of the
// column's tiles t = c, c + 128, .. < tiles (at most 4 at n <= 2^17; S = 2
// from 129 tiles on, so that each thread takes at most two): thread x
// takes element t * 256 + x % 256 of the tiles t = c + 128 * (x / 256 + S
// i).  The block then holds its column's whole sums, so it splits hi there
// and writes the column's 41 terms: its lo sums at k, the low 13 bits of
// its hi sums at k + 1, the rest at k + 2 (the split of the column's sum,
// as the Pallas glue splits a partial column).  The row's last block to
// finish (a ticket taken with atomicAdd after a fence, as CUDA's
// threadFenceReduction sample does) runs the combine and sets the ticket
// back to zero, so tickets [rows] is zero before every launch on a stream
// whose launches have all ended (the wrapper keeps one array a stream).
template <int S>
__global__ void __launch_bounds__(kIpLanes * S, 2 / S)
fe_inner_product_kernel(const int32_t* __restrict__ a,
                        const int32_t* __restrict__ b,
                        int32_t* __restrict__ out,
                        int32_t* __restrict__ terms,
                        int32_t* __restrict__ tickets, int64_t n,
                        int tiles) {
  __shared__ int32_t red[kIpWarps * S][kIpSums];
  __shared__ int32_t col[kIpSums];
  const int x = static_cast<int>(threadIdx.x);
  const int lane = x & (kWarp - 1);
  const int c = static_cast<int>(blockIdx.x);
  const int64_t row = blockIdx.y;
  const int columns = static_cast<int>(gridDim.x);
  int32_t acc[3] = {0, 0, 0};
  // t is the same across a warp, so every lane takes part in the shuffles
  for (int t = c + kIpColumns * (x / kIpLanes); t < tiles;
       t += kIpColumns * S) {
    const int64_t e = static_cast<int64_t>(t) * kIpLanes + x % kIpLanes;
    int32_t xr[bp::FE_L], yr[bp::FE_L];
#pragma unroll
    for (int i = 0; i < bp::FE_L; ++i) xr[i] = yr[i] = 0;
    if (e < n) {
      ip_row(a + (row * n + e) * bp::FE_L, xr);
      ip_row(b + (row * n + e) * bp::FE_L, yr);
    }
    ip_element(xr, yr, lane, acc);
  }
  const int r4 = (lane & 1) * 3;
  const int r1 = (lane & 8 ? 20 : 0) + (lane & 4 ? 10 : 0) +
                 (lane & 2 ? 5 : 0) + r4;
  const int at = (lane & 16 ? bp::FE_NC : 0) + r1;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (r4 + s < 5 && r1 + s < bp::FE_NC) red[x / kWarp][at + s] = acc[s];
  }
  __syncthreads();
  if (x < kIpSums) {
    int32_t s = 0;
#pragma unroll
    for (int w = 0; w < kIpWarps * S; ++w) s += red[w][x];
    col[x] = s;
  }
  __syncthreads();
  int32_t* row_terms = terms + row * columns * kIpTerms;
  if (x < kIpTerms) {
    int32_t t = x < bp::FE_NC ? col[x] : 0;
    if (x >= 1 && x <= bp::FE_NC) t += col[bp::FE_NC + x - 1] & bp::FE_MASK;
    if (x >= 2) t += col[bp::FE_NC + x - 2] >> bp::FE_W;
    row_terms[c * kIpTerms + x] = t;
  }
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (x == 0) last = atomicAdd(tickets + row, 1) == columns - 1;
  __syncthreads();
  if (last) {
    ip_combine_row<kIpLanes * S / 64>(row_terms, columns,
                                      out + row * bp::FE_L);
    if (x == 0) tickets[row] = 0;
  }
}

}  // namespace

// a, b: base pointers and row strides in int32 (0 = broadcast); out [n, 20].
extern "C" int bp_fe_mul(const int32_t* a, int64_t sa, const int32_t* b,
                         int64_t sb, int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  fe_mul_kernel<<<blocks_for(n, kMulThreads), kMulThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, sa, b, sb, out, n);
  return static_cast<int>(cudaGetLastError());
}

// a: base pointer and row stride in int32 (0 = broadcast); out [n, 20].
extern "C" int bp_fe_sq(const int32_t* a, int64_t sa, int32_t* out, int64_t n,
                        void* stream) {
  if (n <= 0) return 0;
  fe_sq_kernel<<<blocks_for(n, kMulThreads), kMulThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, sa, out, n);
  return static_cast<int>(cudaGetLastError());
}

// a, out [n, 20]; lanes the group width G (config.chain_lanes).
extern "C" int bp_fe_pow2523(const int32_t* a, int32_t* out, int64_t n,
                             int64_t lanes, void* stream) {
  return launch_chain<false>(a, out, n, lanes, stream);
}

extern "C" int bp_fe_invert(const int32_t* a, int32_t* out, int64_t n,
                            int64_t lanes, void* stream) {
  return launch_chain<true>(a, out, n, lanes, stream);
}

extern "C" int bp_fe_add(const int32_t* a, const int32_t* b, int32_t* out,
                         int64_t n, void* stream) {
  if (n <= 0) return 0;
  fe_add3_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_fe_sub(const int32_t* a, const int32_t* b, int32_t* out,
                         int64_t n, void* stream) {
  if (n <= 0) return 0;
  fe_sub3_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_fe_mul_chain(const int32_t* a, const int32_t* b,
                               int32_t* out, int64_t n, int64_t reps,
                               void* stream) {
  if (n <= 0) return 0;
  fe_mul_chain_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, b, out, n,
                                                             reps);
  return static_cast<int>(cudaGetLastError());
}

// a, b [rows, n, 20] contiguous with 16-byte-aligned rows; out [rows, 20];
// scratch [rows, min(128, tiles), 41] (written before it is read); tickets
// [rows] zero, left zero.
extern "C" int bp_fe_inner_product_batched(const int32_t* a, const int32_t* b,
                                           int32_t* out, int32_t* scratch,
                                           int32_t* tickets, int64_t rows,
                                           int64_t n, void* stream) {
  if (rows <= 0) return 0;
  if (rows > kIpMaxRows || n < 0 || n > kIpMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = n > 0 ? static_cast<int>((n + kIpLanes - 1) / kIpLanes)
                          : 1;
  const dim3 grid(tiles < kIpColumns ? tiles : kIpColumns,
                  static_cast<unsigned int>(rows));
  if (tiles > kIpColumns) {
    fe_inner_product_kernel<2><<<grid, 2 * kIpLanes, 0, s>>>(
        a, b, out, scratch, tickets, n, tiles);
  } else {
    fe_inner_product_kernel<1><<<grid, kIpLanes, 0, s>>>(
        a, b, out, scratch, tickets, n, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// The single inner product: the same launch on one row.
extern "C" int bp_fe_inner_product(const int32_t* a, const int32_t* b,
                                   int32_t* out, int32_t* scratch,
                                   int32_t* tickets, int64_t n,
                                   void* stream) {
  return bp_fe_inner_product_batched(a, b, out, scratch, tickets, 1, n,
                                     stream);
}
