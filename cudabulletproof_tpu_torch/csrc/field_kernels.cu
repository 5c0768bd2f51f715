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
//                      (bp_fe_inner_product_batched)
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
// fe_inner_product computes the Pallas kernels' partial sums of <a, b>:
// for [B, n, 20] operands, zero-padded to tiles of 256 elements, a
// [B, 39, 256] int32 block where tile t adds the sums over its elements of
// lo = c_k & MASK into column t % 128 and of hi = c_k >> 13 into column
// 128 + t % 128 (c_k the element's k-th convolution coefficient, < 2^31).
// The split is per element and before any sum, and the partition into
// columns is the Pallas grid's, so the torch glue after it (the column
// combine and the fold, ops/field.py::ip_combine) gives the JAX package's
// limbs.  Design: a block of 256 threads is one tile of one batch row (grid
// (tiles, B): the Pallas grid's sequential tile axis becomes parallel
// blocks); each thread forms its element's 39 coefficients in registers
// (400 IMADs), splits them, and the block reduces the 78 values with warp
// shuffles and then shared memory; 78 threads add the tile's sums into the
// partial with integer atomicAdd (the wrapper zeroes it).  Integer sums are
// exact, so the result is the same in every run whatever the order.  What
// bounds it: 160 bytes read an element against 400 IMADs, so at the
// card's rates memory traffic (3.1 us at 2^16 elements) over the multiplies
// (1.6 us); the 390 shuffles a thread and the launch come on top.
// Bounds: a coefficient < 20 * 8799^2 < 2^31; a tile's lo sum < 2^21 and hi
// sum < 2^26; at n <= 2^17 (the wrapper's limit) a column takes at most 4
// tiles, < 2^28.
//
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

constexpr int kIpLanes = 256;     // elements a tile (one block)
constexpr int kIpColumns = 128;   // partial columns; tile t -> t % 128
constexpr int kIpWarps = kIpLanes / 32;

__global__ void __launch_bounds__(kIpLanes)
fe_inner_product_kernel(const int32_t* __restrict__ a,
                        const int32_t* __restrict__ b,
                        int32_t* __restrict__ partial, int64_t n) {
  __shared__ int32_t red[kIpWarps][2 * bp::FE_NC];
  const int64_t row = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t e = tile * kIpLanes + threadIdx.x;
  int32_t c[bp::FE_NC];
#pragma unroll
  for (int k = 0; k < bp::FE_NC; ++k) c[k] = 0;
  if (e < n) {
    const bp::fe x = bp::fe_load(a + (row * n + e) * bp::FE_L);
    const bp::fe y = bp::fe_load(b + (row * n + e) * bp::FE_L);
#pragma unroll
    for (int i = 0; i < bp::FE_L; ++i) {
#pragma unroll
      for (int j = 0; j < bp::FE_L; ++j) c[i + j] += x.v[i] * y.v[j];
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < bp::FE_NC; ++k) {
    int32_t lo = c[k] & bp::FE_MASK;
    int32_t hi = c[k] >> bp::FE_W;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo += __shfl_down_sync(0xffffffffu, lo, off);
      hi += __shfl_down_sync(0xffffffffu, hi, off);
    }
    if (lane == 0) {
      red[warp][k] = lo;
      red[warp][bp::FE_NC + k] = hi;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * bp::FE_NC) {
    const int k = threadIdx.x;
    int32_t s = 0;
#pragma unroll
    for (int w = 0; w < kIpWarps; ++w) s += red[w][k];
    const bool is_hi = k >= bp::FE_NC;
    const int coeff = is_hi ? k - bp::FE_NC : k;
    const int col = static_cast<int>(tile % kIpColumns) +
                    (is_hi ? kIpColumns : 0);
    atomicAdd(partial + (row * bp::FE_NC + coeff) * (2 * kIpColumns) + col,
              s);
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

// partial [B, 39, 256] must hold zeros; a, b are [B, n, 20].
extern "C" int bp_fe_inner_product_batched(const int32_t* a, const int32_t* b,
                                           int32_t* partial, int64_t rows,
                                           int64_t n, void* stream) {
  if (rows <= 0) return 0;
  const int64_t tiles = n > 0 ? (n + kIpLanes - 1) / kIpLanes : 1;
  const dim3 grid(static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(rows));
  fe_inner_product_kernel<<<grid, kIpLanes, 0,
                            static_cast<cudaStream_t>(stream)>>>(a, b,
                                                                  partial, n);
  return static_cast<int>(cudaGetLastError());
}

// The single inner product: the same kernel on one batch row.
extern "C" int bp_fe_inner_product(const int32_t* a, const int32_t* b,
                                   int32_t* partial, int64_t n, void* stream) {
  return bp_fe_inner_product_batched(a, b, partial, 1, n, stream);
}
