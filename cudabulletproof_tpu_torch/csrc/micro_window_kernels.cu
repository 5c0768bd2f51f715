// The accumulator-window microbenchmark kernels of the port.
//
//   ge_accum_window_kernel + ge_halve_kernel
//       replace benchmarks/_accum_micro.py::kernel (:30) and
//       benchmarks/_repro_accum3.py::kernel (:22)
//
// No proof path runs them.  They measure what the bucket select of the
// accumulator costs in its variants; the output equals the plain twin in
// ops/micro.py (micro.accum_window_plain) limb for limb.
//
// ge_accum_window.  A window pass of the signed-digit bucket accumulator,
// one thread per (window, lane); the TPU's sequential grid axis j, which
// carries the VMEM scratch sacc[nb, 80, lanes] from step to step, is a loop
// inside the thread.  A lane's nb buckets (320 B each; 9 at w = 4, 17 at
// w = 5) do not fit in registers.  They live in shared memory when the
// block's 64 lanes fit it (64 x 9 x 320 B = 184 KB at w = 4, nb <= 11),
// else in device memory ([nw, nb, 80, lanes], lane-minor so a warp's
// accesses coalesce); the wrapper picks by nb.  Per step the digit d picks bucket |d| (row swap
// of the operand for d < 0) and the Pallas _madd adds the point:
//   full     indexes bucket |d| directly (bucket 1 when |d| < 2), the
//            GPU's natural form, and writes one bucket back;
//   cached   a predicated select reading every bucket, then a write-back
//            of every bucket, the data flow the TPU needs without
//            dynamic indexing;
//   tree     a log-depth select of the buckets (limb by limb), then the
//            same write-back;
//   and the other variants of the scripts (ops/micro.py lists them).
// Then the suffix fold suf += b[k], tot += suf for k = nb-1 .. 1 (the
// Pallas _padd), and the halving tree over the lanes, lane i with lane
// i + half: kernel 2, one block a window, in place in a device-memory
// copy of the lanes' totals [nw, 80, lanes] (a window's 1024 lanes span 16
// blocks of kernel 1).  The output is lane 0 [nw, 80], or every lane
// [nw, lanes, 80] for nofold and sufonly.  Bound: integer multiplies, one
// mixed add (7 x 441 IMADs) a nonzero digit, 2 (nb - 1) unified adds a
// lane for the fold and lanes - 1 for the tree, per window.
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
constexpr int kWinThreads = 64;       // ops/cuda_micro.py WINDOW_THREADS
constexpr int kHalveThreads = 256;
constexpr int kMaxNb = 17;            // ops/cuda_micro.py MAX_NB

// --- the window -----------------------------------------------------------
// what a step does and how the window ends (ops/micro.py VARIANTS)
enum Step { S_FULL, S_NOSEL, S_NOADD, S_CACHED, S_TREE, S_NOSTEP, S_NOSIGN,
            S_PADD };
enum End { E_HALVE, E_NOFOLD, E_HALVONLY, E_SUFONLY };

// limb k (0..79) of a point; k is a constant after unrolling
__device__ __forceinline__ int32_t& limb(ge& g, int k) {
  fe& f = k < FE_L ? g.x : k < 2 * FE_L ? g.y : k < 3 * FE_L ? g.z : g.t;
  return f.v[k % FE_L];
}

// a point whose limb k sits at p[k * s]
__device__ __forceinline__ ge ld_strided(const int32_t* p, int64_t s) {
  ge g;
#pragma unroll
  for (int k = 0; k < kRow; ++k) limb(g, k) = p[k * s];
  return g;
}

__device__ __forceinline__ void st_strided(int32_t* p, int64_t s, ge g) {
#pragma unroll
  for (int k = 0; k < kRow; ++k) p[k * s] = limb(g, k);
}

template <int STEP, int END>
__global__ void ge_accum_window_kernel(const int32_t* __restrict__ pt,
                                       const int32_t* __restrict__ dg,
                                       int32_t* __restrict__ out,
                                       int32_t* buckets, int32_t* totals,
                                       int64_t steps, int64_t unroll,
                                       int64_t lanes, int nb, int shared) {
  extern __shared__ int32_t smem[];
  const int64_t win = blockIdx.y;
  const int64_t lane = blockIdx.x * static_cast<int64_t>(kWinThreads) +
                       threadIdx.x;
  if (lane >= lanes) return;
  // bucket b, limb k at bk[(b * 80 + k) * s]
  int32_t* bk;
  int64_t s;
  if (shared) {
    bk = smem + threadIdx.x;
    s = kWinThreads;
  } else {
    bk = buckets + win * nb * kRow * lanes + lane;
    s = lanes;
  }
  const int64_t bs = kRow * s;          // stride of one bucket
#pragma unroll 1
  for (int b = 0; b < nb; ++b) st_strided(bk + b * bs, s, bp::ge_identity());

  if (STEP != S_NOSTEP) {
#pragma unroll 1
    for (int64_t j = 0; j < steps; ++j) {
#pragma unroll 1
      for (int64_t u = 0; u < unroll; ++u) {
        const int d = dg[((win * steps + j) * unroll + u) * lanes + lane];
        const int32_t* q = pt + ((j * unroll + u) * lanes + lane) * kRow;
        int m;
        fe ypx, ymx, td2;
        if (STEP == S_NOSIGN) {
          m = d;
          ypx = bp::fe_load(q);
          ymx = bp::fe_load(q + FE_L);
          td2 = bp::fe_load(q + 2 * FE_L);
        } else {
          const bool neg = d < 0;
          m = neg ? -d : d;
          ypx = bp::fe_load(q + (neg ? FE_L : 0));
          ymx = bp::fe_load(q + (neg ? 0 : FE_L));
          td2 = bp::fe_load(q + (neg ? 3 * FE_L : 2 * FE_L));
        }
        if (STEP == S_NOSEL) {
          st_strided(bk + bs, s,
                     bp::ge_madd(ld_strided(bk + bs, s), ypx, ymx, td2));
          continue;
        }
        ge sel;
        if (STEP == S_CACHED) {
#pragma unroll
          for (int k = 0; k < kRow; ++k) {
            int32_t v = bk[bs + k * s];
#pragma unroll 1
            for (int b = 2; b < nb; ++b) {
              const int32_t vb = bk[b * bs + k * s];
              v = m == b ? vb : v;
            }
            limb(sel, k) = v;
          }
        } else if (STEP == S_TREE) {
          // the buckets 1 .. nb-1 as a list, halved by the bits of m - 1;
          // an odd tail moves up a level as it is
          const int mm = m - 1;
#pragma unroll
          for (int k = 0; k < kRow; ++k) {
            int32_t lv[kMaxNb - 1];
#pragma unroll
            for (int i = 0; i < kMaxNb - 1; ++i)
              lv[i] = i < nb - 1 ? bk[(i + 1) * bs + k * s] : 0;
            int cnt = nb - 1, bit = 1;
#pragma unroll
            for (int level = 0; level < 4; ++level) {
              if (cnt > 1) {
#pragma unroll
                for (int i = 0; i < (kMaxNb - 1) / 2; ++i) {
                  if (2 * i + 1 < cnt)
                    lv[i] = (mm & bit) == 0 ? lv[2 * i] : lv[2 * i + 1];
                  else if (2 * i < cnt)
                    lv[i] = lv[2 * i];
                }
                cnt = (cnt + 1) / 2;
                bit <<= 1;
              }
            }
            limb(sel, k) = lv[0];
          }
        } else {
          const int src = m >= 2 && m < nb ? m : 1;
          sel = ld_strided(bk + src * bs, s);
        }
        ge added;
        if (STEP == S_NOADD)
          added = sel;
        else if (STEP == S_PADD)
          added = bp::ge_padd(sel, ge{ypx, ymx, td2, td2});
        else
          added = bp::ge_madd(sel, ypx, ymx, td2);
        if (STEP == S_CACHED || STEP == S_TREE) {
#pragma unroll 1
          for (int b = 1; b < nb; ++b) {
            const bool hit = m == b;
#pragma unroll
            for (int k = 0; k < kRow; ++k) {
              int32_t* cell = bk + b * bs + k * s;
              *cell = hit ? limb(added, k) : *cell;
            }
          }
        } else if (m >= 1 && m < nb) {
          st_strided(bk + m * bs, s, added);
        }
      }
    }
  }

  ge total;
  if (END == E_NOFOLD || END == E_HALVONLY) {
    total = ld_strided(bk + bs, s);
  } else {
    ge suf = bp::ge_identity(), tot = bp::ge_identity();
#pragma unroll 1
    for (int b = nb - 1; b >= 1; --b) {
      suf = bp::ge_padd(suf, ld_strided(bk + b * bs, s));
      tot = bp::ge_padd(tot, suf);
    }
    total = tot;
  }
  if (END == E_NOFOLD || END == E_SUFONLY)
    bp::ge_store(out + (win * lanes + lane) * kRow, total);
  else
    st_strided(totals + win * kRow * lanes + lane, lanes, total);
}

// the halving tree of one window's lane totals [80, lanes], in place: at
// each level lane i < half takes lane i + half (an odd last lane drops out);
// lane 0 goes to out[win]
__global__ void ge_halve_kernel(int32_t* totals, int32_t* __restrict__ out,
                                int64_t lanes) {
  int32_t* t = totals + blockIdx.x * kRow * lanes;
#pragma unroll 1
  for (int64_t m = lanes; m > 1; m /= 2) {
    const int64_t half = m / 2;
#pragma unroll 1
    for (int64_t i = threadIdx.x; i < half; i += blockDim.x)
      st_strided(t + i, lanes,
                 bp::ge_padd(ld_strided(t + i, lanes),
                             ld_strided(t + i + half, lanes)));
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    ge r = ld_strided(t, lanes);
    bp::ge_store(out + blockIdx.x * kRow, r);
  }
}

template <int STEP, int END>
cudaError_t launch_window(const int32_t* pt, const int32_t* dg, int32_t* out,
                          int32_t* buckets, int32_t* totals, int64_t nw,
                          int64_t steps, int64_t unroll, int64_t lanes,
                          int nb, int shared, cudaStream_t st) {
  auto kern = ge_accum_window_kernel<STEP, END>;
  const size_t smem =
      shared ? static_cast<size_t>(kWinThreads) * nb * kRow * sizeof(int32_t)
             : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>((lanes + kWinThreads - 1) /
                                            kWinThreads),
                  static_cast<unsigned int>(nw));
  kern<<<grid, kWinThreads, smem, st>>>(pt, dg, out, buckets, totals, steps,
                                        unroll, lanes, nb, shared);
  err = cudaGetLastError();
  if (err != cudaSuccess || END == E_NOFOLD || END == E_SUFONLY) return err;
  ge_halve_kernel<<<static_cast<unsigned int>(nw), kHalveThreads, 0, st>>>(
      totals, out, lanes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bp_ge_accum_window(const int32_t* pt, const int32_t* dg,
                                  int32_t* out, int32_t* buckets,
                                  int32_t* totals, int64_t nw, int64_t steps,
                                  int64_t unroll, int64_t lanes, int64_t nb,
                                  int64_t variant, int64_t shared,
                                  void* stream) {
  if (nw <= 0 || lanes <= 0) return 0;
  if (nb < 2 || nb > kMaxNb || nw > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int inb = static_cast<int>(nb), ish = shared ? 1 : 0;
#define BP_WINDOW(S, E) \
  launch_window<S, E>(pt, dg, out, buckets, totals, nw, steps, unroll, lanes, \
                      inb, ish, st)
  cudaError_t err;
  switch (variant) {        // ops/micro.py VARIANTS, in order
    case 0: err = BP_WINDOW(S_FULL, E_HALVE); break;       // full
    case 1: err = BP_WINDOW(S_NOSEL, E_HALVE); break;      // nosel
    case 2: err = BP_WINDOW(S_NOADD, E_HALVE); break;      // noadd
    case 3: err = BP_WINDOW(S_CACHED, E_HALVE); break;     // cached
    case 4: err = BP_WINDOW(S_TREE, E_HALVE); break;       // tree
    case 5: err = BP_WINDOW(S_FULL, E_HALVE); break;       // init_loop
    case 6: err = BP_WINDOW(S_NOSTEP, E_HALVE); break;     // nostep
    case 7: err = BP_WINDOW(S_NOSIGN, E_HALVE); break;     // nosign
    case 8: err = BP_WINDOW(S_PADD, E_HALVE); break;       // padd
    case 9: err = BP_WINDOW(S_FULL, E_NOFOLD); break;      // nofold
    case 10: err = BP_WINDOW(S_FULL, E_HALVONLY); break;   // halvonly
    case 11: err = BP_WINDOW(S_FULL, E_HALVE); break;      // fori
    case 12: err = BP_WINDOW(S_FULL, E_SUFONLY); break;    // sufonly
    default: err = cudaErrorInvalidValue;
  }
#undef BP_WINDOW
  return static_cast<int>(err);
}
