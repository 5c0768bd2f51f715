// Field kernels of the port, one thread per field element.
//
//   fe_mul_kernel      replaces cudabulletproof_tpu/ops/pallas_field.py::_mul_kernel
//   fe_sq_kernel       replaces pallas_field.py::_sq_kernel
//   fe_pow2523_kernel  replaces pallas_field.py::_pow2523_kernel
//   fe_invert_kernel   replaces pallas_field.py::_invert_kernel
//   fe_add3_kernel     replaces pallas_field.py::_add_kernel
//   fe_sub3_kernel     replaces pallas_field.py::_sub_kernel
//
// Layout: rows of 20 int32 limbs, [n, 20] row-major, as the port's public
// functions hold them (the Pallas kernels transposed to [20, n] tiles to put
// the batch on the TPU's lanes).  A warp's loads are therefore strided by
// 80 bytes; a [20, n] layout is left for a later change, since these
// kernels are compute-bound (see fe25519.cuh).
//
// What bounds them on Hopper: fe_mul / fe_sq are 400 / 210 IMADs against
// 240 / 160 bytes of traffic per element, so integer-multiply throughput,
// or launch latency at the verify path's small batches (17 to 272
// elements).  fe_pow2523 (251 squarings + 11 multiplies) and fe_invert
// (254 squarings + 11 multiplies) run the whole Fermat chain on
// register-resident limbs: ~265 field ops per element and 160 bytes of
// traffic, so they are IMAD-bound, and no memory traffic between the ops,
// which is what the Pallas kernels' VMEM-resident chain bought on the TPU.
// Both share fe_pow_chain_250 (fe25519.cuh), as the Pallas kernels share
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
// C interface: each entry takes device pointers, the count n and a
// cudaStream_t (PyTorch's current stream), launches without synchronizing
// and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void fe_mul_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  bp::fe_store(out + i * bp::FE_L,
               bp::fe_mul(bp::fe_load(a + i * bp::FE_L),
                          bp::fe_load(b + i * bp::FE_L)));
}

__global__ void fe_sq_kernel(const int32_t* __restrict__ a,
                             int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  bp::fe_store(out + i * bp::FE_L, bp::fe_sq(bp::fe_load(a + i * bp::FE_L)));
}

__global__ void fe_pow2523_kernel(const int32_t* __restrict__ a,
                                  int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  bp::fe_store(out + i * bp::FE_L,
               bp::fe_pow2523(bp::fe_load(a + i * bp::FE_L)));
}

__global__ void fe_invert_kernel(const int32_t* __restrict__ a,
                                 int32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  bp::fe_store(out + i * bp::FE_L,
               bp::fe_invert(bp::fe_load(a + i * bp::FE_L)));
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

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int bp_fe_mul(const int32_t* a, const int32_t* b, int32_t* out,
                         int64_t n, void* stream) {
  if (n <= 0) return 0;
  fe_mul_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_fe_sq(const int32_t* a, int32_t* out, int64_t n,
                        void* stream) {
  if (n <= 0) return 0;
  fe_sq_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_fe_pow2523(const int32_t* a, int32_t* out, int64_t n,
                             void* stream) {
  if (n <= 0) return 0;
  fe_pow2523_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bp_fe_invert(const int32_t* a, int32_t* out, int64_t n,
                            void* stream) {
  if (n <= 0) return 0;
  fe_invert_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, out, n);
  return static_cast<int>(cudaGetLastError());
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
