// The add-rate microbenchmark kernel of the port.
//
//   ge_add_chain_kernel
//       replaces benchmarks/bench_addrate.py::chain_kernel (:100)
//
// No proof path runs it.  It measures what the group law costs when
// nothing but registers is touched; its output equals its plain twin in
// ops/micro.py (micro.chain_plain) limb for limb.  Its sibling, the
// accumulator window of the same scripts' family, is in
// micro_window_kernels.cu: a separate source, so that nvcc builds the two
// sets of template instantiations in parallel.
//
// ge_add_chain.  One thread per lane: from acc = p, K times acc <- acc + p
// (op add) or acc <- 2 acc (op dbl), with the script's field ops whose
// carry-relaxation passes are template arguments: (mul_passes, add_passes)
// in {(5,2), (4,2), (3,1), (1,1), (0,0)}, the pairs the script's sweep
// runs.  The point p, 2d and acc stay in registers; K is a runtime
// argument (the JAX script compiles it in).  With fewer passes than the
// proven three the limbs outgrow int32; the JAX package wraps, and signed
// overflow is undefined in CUDA, so every limb product and sum runs in
// uint32_t and only the carry shift >> 13 acts on the signed value (an
// arithmetic shift, as jnp's >> on int32).  The timing-only pairs then
// still give the JAX limbs.  Bound: integer multiplies, 9 x (400 + 38 +
// mul_passes) IMADs an add, 4 x (210 + 38 + p) + 4 x (400 + 38 + p) a
// doubling, against 640 B of traffic a lane for the whole chain.  At the
// script's 256-2048 lanes the launch is 2-16 blocks of 128 threads on a
// 132-SM card: the sweep measures the occupancy the TPU's lane widths
// give here, and the kernel keeps that shape on purpose.
//
// C interface: each entry takes device pointers, counts and a
// cudaStream_t (PyTorch's current stream), launches without synchronizing
// and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

using bp::fe;
using bp::ge;
using bp::FE_L;

constexpr int kRow = 4 * FE_L;
constexpr int kChainThreads = 128;
constexpr uint32_t kMask = bp::FE_MASK;
constexpr uint32_t kFold = bp::FE_FOLD;

// --- field ops modulo 2^32 with tunable passes (bench_addrate.make_ops) ----
__device__ __forceinline__ int32_t sar13(uint32_t v) {
  return static_cast<int32_t>(v) >> bp::FE_W;
}

// coefficients -> limbs: _fold_wide (coefficient 20 + j adds 608 x its low
// 13 bits to limb j and 608 x the signed rest to limb j + 1), then `MP`
// relaxations
template <int MP>
__device__ __forceinline__ fe mc_fold(const uint32_t (&c)[bp::FE_NC]) {
  uint32_t acc[FE_L];
#pragma unroll
  for (int i = 0; i < FE_L; ++i) acc[i] = c[i];
#pragma unroll
  for (int j = 0; j < FE_L - 1; ++j) {
    acc[j] += kFold * (c[FE_L + j] & kMask);
    acc[j + 1] += kFold * static_cast<uint32_t>(sar13(c[FE_L + j]));
  }
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) r.v[i] = static_cast<int32_t>(acc[i]);
  bp::fe_relax<MP>(r);
  return r;
}

template <int MP>
__device__ __forceinline__ fe mc_mul(const fe& a, const fe& b) {
  uint32_t c[bp::FE_NC];
#pragma unroll
  for (int k = 0; k < bp::FE_NC; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) {
#pragma unroll
    for (int j = 0; j < FE_L; ++j)
      c[i + j] += static_cast<uint32_t>(a.v[i]) * static_cast<uint32_t>(b.v[j]);
  }
  return mc_fold<MP>(c);
}

// the script's symmetric square: a_i^2 plus a_i * 2a_j for j > i
template <int MP>
__device__ __forceinline__ fe mc_sq(const fe& a) {
  uint32_t c[bp::FE_NC];
  uint32_t a2[FE_L];
#pragma unroll
  for (int k = 0; k < bp::FE_NC; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) a2[i] = 2u * static_cast<uint32_t>(a.v[i]);
#pragma unroll
  for (int i = 0; i < FE_L; ++i) {
    const uint32_t ai = static_cast<uint32_t>(a.v[i]);
    c[2 * i] += ai * ai;
#pragma unroll
    for (int j = i + 1; j < FE_L; ++j) c[i + j] += ai * a2[j];
  }
  return mc_fold<MP>(c);
}

template <int AP>
__device__ __forceinline__ fe mc_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i)
    r.v[i] = static_cast<int32_t>(static_cast<uint32_t>(a.v[i]) +
                                  static_cast<uint32_t>(b.v[i]));
  bp::fe_relax<AP>(r);
  return r;
}

template <int AP>
__device__ __forceinline__ fe mc_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) {
    const uint32_t k = i == 0 ? bp::FE_KNEG0 : bp::FE_KNEG;
    r.v[i] = static_cast<int32_t>(static_cast<uint32_t>(a.v[i]) +
                                  (k - static_cast<uint32_t>(b.v[i])));
  }
  bp::fe_relax<AP>(r);
  return r;
}

// the script's padd / pdbl (bench_addrate.py:66-98), op for op
template <int MP, int AP>
__device__ __noinline__ ge mc_padd(const ge& p, const ge& q) {
  const fe a = mc_mul<MP>(mc_sub<AP>(p.y, p.x), mc_sub<AP>(q.y, q.x));
  const fe b = mc_mul<MP>(mc_add<AP>(p.y, p.x), mc_add<AP>(q.y, q.x));
  const fe c = mc_mul<MP>(mc_mul<MP>(p.t, bp::fe_d2()), q.t);
  const fe zz = mc_mul<MP>(p.z, q.z);
  const fe d = mc_add<AP>(zz, zz);
  return ge{mc_mul<MP>(mc_sub<AP>(b, a), mc_sub<AP>(d, c)),
            mc_mul<MP>(mc_add<AP>(d, c), mc_add<AP>(b, a)),
            mc_mul<MP>(mc_sub<AP>(d, c), mc_add<AP>(d, c)),
            mc_mul<MP>(mc_sub<AP>(b, a), mc_add<AP>(b, a))};
}

template <int MP, int AP>
__device__ __noinline__ ge mc_pdbl(const ge& p) {
  const fe xx = mc_sq<MP>(p.x);
  const fe yy = mc_sq<MP>(p.y);
  fe zz2 = mc_sq<MP>(p.z);
#pragma unroll
  for (int i = 0; i < FE_L; ++i)
    zz2.v[i] = static_cast<int32_t>(2u * static_cast<uint32_t>(zz2.v[i]));
  bp::fe_relax<AP>(zz2);
  const fe xy2 = mc_sub<AP>(mc_sq<MP>(mc_add<AP>(p.x, p.y)),
                            mc_add<AP>(xx, yy));
  const fe yp = mc_add<AP>(yy, xx);
  const fe zp = mc_sub<AP>(yy, xx);
  const fe tp = mc_sub<AP>(zz2, zp);
  return ge{mc_mul<MP>(xy2, tp), mc_mul<MP>(yp, zp), mc_mul<MP>(zp, tp),
            mc_mul<MP>(xy2, yp)};
}

template <int OP, int MP, int AP>
__global__ void ge_add_chain_kernel(const int32_t* __restrict__ p,
                                    int32_t* __restrict__ out, int64_t n,
                                    int64_t k) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const ge p0 = bp::ge_load(p + i * kRow);
  ge acc = p0;
#pragma unroll 1
  for (int64_t s = 0; s < k; ++s)
    acc = OP == 0 ? mc_padd<MP, AP>(acc, p0) : mc_pdbl<MP, AP>(acc);
  bp::ge_store(out + i * kRow, acc);
}

template <int OP, int MP, int AP>
cudaError_t launch_chain(const int32_t* p, int32_t* out, int64_t n, int64_t k,
                         cudaStream_t st) {
  const auto blocks =
      static_cast<unsigned int>((n + kChainThreads - 1) / kChainThreads);
  ge_add_chain_kernel<OP, MP, AP><<<blocks, kChainThreads, 0, st>>>(p, out, n,
                                                                    k);
  return cudaGetLastError();
}

template <int OP>
cudaError_t chain_for_passes(int64_t pair, const int32_t* p, int32_t* out,
                             int64_t n, int64_t k, cudaStream_t st) {
  switch (pair) {           // ops/micro.py PASS_PAIRS, in order
    case 0: return launch_chain<OP, 5, 2>(p, out, n, k, st);
    case 1: return launch_chain<OP, 4, 2>(p, out, n, k, st);
    case 2: return launch_chain<OP, 3, 1>(p, out, n, k, st);
    case 3: return launch_chain<OP, 1, 1>(p, out, n, k, st);
    case 4: return launch_chain<OP, 0, 0>(p, out, n, k, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bp_ge_add_chain(const int32_t* p, int32_t* out, int64_t n,
                               int64_t k, int64_t op, int64_t pair,
                               void* stream) {
  if (n <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (op) {             // ops/micro.py CHAIN_OPS, in order
    case 0: err = chain_for_passes<0>(pair, p, out, n, k, st); break;
    case 1: err = chain_for_passes<1>(pair, p, out, n, k, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
