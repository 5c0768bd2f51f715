// Radix-2^16 field kernels of the port, one thread per field element.
//
//   r16_mul_kernel        replaces cudabulletproof_tpu/ops/radix16.py::_mul16_kernel
//   r16_sq_kernel         replaces radix16.py::_sq16_kernel
//   r16_mul_chain_kernel  replaces the kernel `kern` of radix16.py::mul_chain
//
// Representation (the JAX package's, so every output equals the plain torch
// twin in ops/radix16.py limb for limb): 16 int32 limbs of 16 bits,
// little-endian, [n, 16] row-major, weakly normalized (each limb <= 2^16 +
// 38); 2^256 = 38 (mod p).
//
// Arithmetic: the reference's _conv16, step for step.  The TPU has no
// 32x32 -> hi multiply and a 16x16-bit product overflows int32, so b is
// split into 8-bit halves and the convolution summed in two banks, A = a x
// b_lo and B = a x b_hi (2 x 256 IMADs); c = A + 2^8 B is recombined into
// 32 coefficients t_k = A_k + ((B_k & 0xFF) << 8) + (B_{k-1} >> 8); t_16..31
// fold x38 into limbs 0..15 (low 16 bits) and 1..15 (the rest); the double
// wrap 38 (t_31 >> 16) 38 goes into limb 0; three relax passes, the carry
// out of limb 15 re-entering limb 0 times 38.  Hopper does have a 32x32 ->
// 64 multiply, but using it would change the limbs; that is a later
// change.  Bounds (radix16.py:104-111, 137-138): for limbs <= 2^16 + 38,
// A_k <= 16 (2^16 + 38) 255 < 2^28.1, B_k <= 16 (2^16 + 38) 256 < 2^28.1,
// t_k < 2^29, every accumulator < 2^30, so signed int32 never overflows
// (which would be undefined) and every shift acts on a non-negative value.
// A limb above the bound is outside the contract.
//
// What bounds them on Hopper: integer multiplies.  A multiply is 512 limb
// products, 31 fold products, the double wrap (2) and 3 relax carries x38:
// 548 IMADs against 192 bytes (mul) or 128 bytes (sq) of traffic per
// element, so at the card's 16.7 T IMAD/s and 3.35 TB/s one multiply per
// launch is bound by the bytes and the chain (reps multiplies per load) by
// the multiplies.  The design keeps an element's 16 limbs, b's two 8-bit
// halves and the 62 bank coefficients in registers (fully unrolled loops,
// static indices) and touches memory once per operand.  The chain splits b
// once and keeps it in registers across its `reps` multiplies, a runtime
// loop; the Pallas kernel's [16, 256] lane tile and the sublane roll its
// relaxation needs have no meaning here.
//
// C interface: each entry takes device pointers, the count n (and reps),
// and a cudaStream_t (PyTorch's current stream), launches without
// synchronizing and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int R16_L = 16;                   // limbs
constexpr int R16_NC = 2 * R16_L - 1;       // coefficients of a bank
constexpr int32_t R16_MASK = 0xFFFF;
constexpr int32_t R16_FOLD = 38;            // 2^256 mod p

struct r16 {
  int32_t v[R16_L];
};

// b = lo + 2^8 hi, lo < 2^8 and hi <= 256 for a weak limb.
struct r16_halves {
  int32_t lo[R16_L], hi[R16_L];
};

__device__ __forceinline__ r16 r16_load(const int32_t* __restrict__ p) {
  r16 r;
#pragma unroll
  for (int i = 0; i < R16_L; ++i) r.v[i] = p[i];
  return r;
}

__device__ __forceinline__ void r16_store(int32_t* __restrict__ p,
                                          const r16& a) {
#pragma unroll
  for (int i = 0; i < R16_L; ++i) p[i] = a.v[i];
}

__device__ __forceinline__ r16_halves r16_split(const r16& b) {
  r16_halves h;
#pragma unroll
  for (int i = 0; i < R16_L; ++i) {
    h.lo[i] = b.v[i] & 0xFF;
    h.hi[i] = b.v[i] >> 8;
  }
  return h;
}

// a * b mod p, b given by its halves: _conv16.
__device__ __forceinline__ r16 r16_mul(const r16& a, const r16_halves& b) {
  int32_t A[R16_NC], B[R16_NC];
#pragma unroll
  for (int k = 0; k < R16_NC; ++k) {
    A[k] = 0;
    B[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < R16_L; ++i) {
#pragma unroll
    for (int j = 0; j < R16_L; ++j) {
      A[i + j] += a.v[i] * b.lo[j];
      B[i + j] += a.v[i] * b.hi[j];
    }
  }
  // c = A + 2^8 B as 32 coefficients that stay below 2^29
  int32_t t[2 * R16_L];
#pragma unroll
  for (int k = 0; k < 2 * R16_L; ++k) {
    t[k] = (k < R16_NC ? A[k] + ((B[k] & 0xFF) << 8) : 0)
           + (k > 0 ? B[k - 1] >> 8 : 0);
  }
  // t_{16+k} has weight 38 * 2^(16k): its low 16 bits into limb k, the
  // rest into limb k+1; t_31's rest wraps a second time, into limb 0
  r16 r;
#pragma unroll
  for (int k = 0; k < R16_L; ++k) {
    r.v[k] = t[k] + R16_FOLD * (t[R16_L + k] & R16_MASK)
             + (k > 0 ? R16_FOLD * (t[R16_L + k - 1] >> 16) : 0);
  }
  r.v[0] += R16_FOLD * (t[2 * R16_L - 1] >> 16) * R16_FOLD;
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    int32_t c[R16_L];
#pragma unroll
    for (int i = 0; i < R16_L; ++i) c[i] = r.v[i] >> 16;
    r.v[0] = (r.v[0] & R16_MASK) + c[R16_L - 1] * R16_FOLD;
#pragma unroll
    for (int i = 1; i < R16_L; ++i) r.v[i] = (r.v[i] & R16_MASK) + c[i - 1];
  }
  return r;
}

__global__ void r16_mul_kernel(const int32_t* __restrict__ a,
                               const int32_t* __restrict__ b,
                               int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  r16_store(out + i * R16_L, r16_mul(r16_load(a + i * R16_L),
                                     r16_split(r16_load(b + i * R16_L))));
}

__global__ void r16_sq_kernel(const int32_t* __restrict__ a,
                              int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const r16 x = r16_load(a + i * R16_L);
  r16_store(out + i * R16_L, r16_mul(x, r16_split(x)));
}

__global__ void r16_mul_chain_kernel(const int32_t* __restrict__ a,
                                     const int32_t* __restrict__ b,
                                     int32_t* __restrict__ out, int64_t n,
                                     int64_t reps) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const r16_halves y = r16_split(r16_load(b + i * R16_L));
  r16 x = r16_load(a + i * R16_L);
#pragma unroll 1
  for (int64_t r = 0; r < reps; ++r) x = r16_mul(x, y);
  r16_store(out + i * R16_L, x);
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int bp_r16_mul(const int32_t* a, const int32_t* b, int32_t* out,
                          int64_t n, void* stream) {
  if (n <= 0) return 0;
  r16_mul_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_r16_sq(const int32_t* a, int32_t* out, int64_t n,
                         void* stream) {
  if (n <= 0) return 0;
  r16_sq_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_r16_mul_chain(const int32_t* a, const int32_t* b,
                                int32_t* out, int64_t n, int64_t reps,
                                void* stream) {
  if (n <= 0) return 0;
  r16_mul_chain_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, b, out, n,
                                                              reps);
  return static_cast<int>(cudaGetLastError());
}
