// fe25519 / ge25519 device routines shared by the port's CUDA kernels.
//
// Replaces the in-kernel arithmetic of the JAX package's Pallas kernels:
//   fe_mul   <- cudabulletproof_tpu/ops/pallas_field.py::_conv_fold
//   fe_sq    <- pallas_field.py::_conv_sq
//   ge_padd  <- cudabulletproof_tpu/ops/pallas_curve.py::_padd
//   ge_pdbl  <- pallas_curve.py::_pdbl
//   ge_madd  <- pallas_curve.py::_madd
//
// Representation (unchanged from the JAX package, so every kernel output
// equals its plain torch twin limb for limb): a field element is 20 int32
// limbs of 13 bits, little-endian, weakly normalized (each limb <= 8799 =
// 2^13 + 608).  A point is x|y|z|t, 80 int32, extended twisted-Edwards
// coordinates (a = -1).
//
// What bounds these routines on Hopper: integer multiplies.  fe_mul is a
// 20x20 schoolbook convolution (400 IMADs) plus a 19-coefficient fold and 3
// carry-relaxation passes; fe_sq the symmetric half (210 IMADs).  Every
// coefficient stays below 20 * 8799^2 = 1.55e9 < 2^31 (1.63e9 for the
// squaring's doubled cross terms), so 32-bit IMAD is exact; the fold adds
// at most 608 * 2^18, still < 2^31.  Against 160-240 bytes moved per element
// the work is compute-bound, so the design keeps each element's limbs and
// the 39 coefficients in registers (one thread per element, fully unrolled
// loops with static indices) and touches memory once per operand.  The
// relaxation is the parallel form t <- (t & MASK) + roll(t >> 13) (the carry
// out of limb 19 re-enters limb 0 times 608 = 2^260 mod p), exactly the
// Pallas kernels' op order; three passes suffice (the JAX package's
// tests/test_bounds.py proves the count).
//
// The point routines are __noinline__: the ladder calls them ~300 times per
// point, and inlining 9 (or 8) unrolled field multiplies at every call site
// would make the kernels large and slow to compile for no gain in a
// compute-bound loop.
#pragma once

#include <cstdint>

namespace bp {

constexpr int FE_L = 20;                  // limbs
constexpr int FE_W = 13;                  // bits per limb
constexpr int32_t FE_MASK = (1 << FE_W) - 1;
constexpr int32_t FE_FOLD = 608;          // 2^260 mod p
constexpr int FE_NC = 2 * FE_L - 1;       // convolution coefficients
// K = 2*(2^260 - 1) - 1214, a multiple of p whose limbs all exceed 2^13, so
// K - b is non-negative limb-wise for any weakly normalized b.
constexpr int32_t FE_KNEG0 = 2 * FE_MASK - 1214;
constexpr int32_t FE_KNEG = 2 * FE_MASK;

struct fe {
  int32_t v[FE_L];
};

struct ge {
  fe x, y, z, t;
};

// 2d, d = -121665/121666 the curve constant, as 13-bit limbs (checked
// against utils/oracle.py::D2 by tests/test_torch_curve.py).
__device__ __forceinline__ fe fe_d2() {
  return fe{{4441, 5527, 1289, 3383, 3773, 6315, 2574, 4944, 20, 7, 5196,
             7655, 3886, 1856, 7270, 8092, 5855, 3810, 438, 72}};
}

__device__ __forceinline__ fe fe_load(const int32_t* __restrict__ p) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) r.v[i] = p[i];
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* __restrict__ p, const fe& a) {
#pragma unroll
  for (int i = 0; i < FE_L; ++i) p[i] = a.v[i];
}

// PASSES rounds of parallel carry relaxation (value preserved mod p).
template <int PASSES>
__device__ __forceinline__ void fe_relax(fe& t) {
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    int32_t c[FE_L];
#pragma unroll
    for (int i = 0; i < FE_L; ++i) c[i] = t.v[i] >> FE_W;
    t.v[0] = (t.v[0] & FE_MASK) + c[FE_L - 1] * FE_FOLD;
#pragma unroll
    for (int i = 1; i < FE_L; ++i) t.v[i] = (t.v[i] & FE_MASK) + c[i - 1];
  }
}

// [39] coefficients -> weak limbs: coefficient 20+j folds x608 into limb j
// (its low 13 bits) and limb j+1 (the rest), then 3 relax passes.
__device__ __forceinline__ fe fe_fold_relax(const int32_t (&c)[FE_NC]) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) r.v[i] = c[i];
#pragma unroll
  for (int j = 0; j < FE_L - 1; ++j) {
    r.v[j] += FE_FOLD * (c[FE_L + j] & FE_MASK);
    r.v[j + 1] += FE_FOLD * (c[FE_L + j] >> FE_W);
  }
  fe_relax<3>(r);
  return r;
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  int32_t c[FE_NC];
#pragma unroll
  for (int k = 0; k < FE_NC; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) {
#pragma unroll
    for (int j = 0; j < FE_L; ++j) c[i + j] += a.v[i] * b.v[j];
  }
  return fe_fold_relax(c);
}

// Symmetric convolution: the diagonal a_i^2 plus a_i * 2a_j for j > i.
__device__ __forceinline__ fe fe_sq(const fe& a) {
  int32_t c[FE_NC];
  int32_t a2[FE_L];
#pragma unroll
  for (int k = 0; k < FE_NC; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) a2[i] = a.v[i] + a.v[i];
#pragma unroll
  for (int i = 0; i < FE_L; ++i) {
    c[2 * i] += a.v[i] * a.v[i];
#pragma unroll
    for (int j = i + 1; j < FE_L; ++j) c[i + j] += a.v[i] * a2[j];
  }
  return fe_fold_relax(c);
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) r.v[i] = a.v[i] + b.v[i];
  fe_relax<2>(r);
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
  r.v[0] = a.v[0] + (FE_KNEG0 - b.v[0]);
#pragma unroll
  for (int i = 1; i < FE_L; ++i) r.v[i] = a.v[i] + (FE_KNEG - b.v[i]);
  fe_relax<2>(r);
  return r;
}

// a^(2^n); a runtime loop, so the chain's long squaring runs stay small.
__device__ __forceinline__ fe fe_sqn(fe a, int n) {
#pragma unroll 1
  for (int k = 0; k < n; ++k) a = fe_sq(a);
  return a;
}

// Shared prefix of the Fermat ladders (pallas_field.py::_pow_chain_250_block):
// returns z^(2^250 - 1) and sets z11 = z^11.
__device__ __forceinline__ fe fe_pow_chain_250(const fe& z, fe& z11) {
  fe z2 = fe_sq(z);
  fe z8 = fe_sqn(z2, 2);
  fe z9 = fe_mul(z, z8);
  z11 = fe_mul(z2, z9);
  fe z22 = fe_sq(z11);
  fe z_5_0 = fe_mul(z9, z22);
  fe z_10_0 = fe_mul(fe_sqn(z_5_0, 5), z_5_0);
  fe z_20_0 = fe_mul(fe_sqn(z_10_0, 10), z_10_0);
  fe z_40_0 = fe_mul(fe_sqn(z_20_0, 20), z_20_0);
  fe z_50_0 = fe_mul(fe_sqn(z_40_0, 10), z_10_0);
  fe z_100_0 = fe_mul(fe_sqn(z_50_0, 50), z_50_0);
  fe z_200_0 = fe_mul(fe_sqn(z_100_0, 100), z_100_0);
  return fe_mul(fe_sqn(z_200_0, 50), z_50_0);
}

// z^(2^252 - 3): the chain, then 2 squarings and a multiply by z (the
// _pow2523_kernel body).
__device__ __forceinline__ fe fe_pow2523(const fe& z) {
  fe z11;
  const fe z_250_0 = fe_pow_chain_250(z, z11);
  return fe_mul(fe_sqn(z_250_0, 2), z);
}

// z^(p - 2) = z^(2^255 - 21): the chain, then 5 squarings and a multiply by
// z^11 (the _invert_kernel body).  Zero maps to zero.
__device__ __forceinline__ fe fe_invert(const fe& z) {
  fe z11;
  const fe z_250_0 = fe_pow_chain_250(z, z11);
  return fe_mul(fe_sqn(z_250_0, 5), z11);
}

__device__ __forceinline__ ge ge_load(const int32_t* __restrict__ p) {
  return ge{fe_load(p), fe_load(p + FE_L), fe_load(p + 2 * FE_L),
            fe_load(p + 3 * FE_L)};
}

__device__ __forceinline__ void ge_store(int32_t* __restrict__ p, const ge& a) {
  fe_store(p, a.x);
  fe_store(p + FE_L, a.y);
  fe_store(p + 2 * FE_L, a.z);
  fe_store(p + 3 * FE_L, a.t);
}

__device__ __forceinline__ ge ge_identity() {
  ge r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) {
    r.x.v[i] = 0;
    r.y.v[i] = i == 0;
    r.z.v[i] = i == 0;
    r.t.v[i] = 0;
  }
  return r;
}

// Unified extended add, add-2008-hwcd-3 with a = -1 (9 multiplies), in the
// op order of pallas_curve.py::_padd and curve.py::add_xla.  Reads both
// operands before it writes, so the result may overwrite either.
static __device__ __noinline__ ge ge_padd(const ge& p, const ge& q) {
  const fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const fe c = fe_mul(fe_mul(p.t, fe_d2()), q.t);
  const fe zz = fe_mul(p.z, q.z);
  const fe d = fe_add(zz, zz);
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// Dedicated doubling (4 squarings + 4 multiplies; t is not read), in the op
// order of pallas_curve.py::_pdbl.
static __device__ __noinline__ ge ge_pdbl(const ge& p) {
  const fe xx = fe_sq(p.x);
  const fe yy = fe_sq(p.y);
  fe zz2 = fe_sq(p.z);
#pragma unroll
  for (int i = 0; i < FE_L; ++i) zz2.v[i] *= 2;
  fe_relax<2>(zz2);
  const fe xy2 = fe_sub(fe_sq(fe_add(p.x, p.y)), fe_add(xx, yy));   // 2xy
  const fe yp = fe_add(yy, xx);
  const fe zp = fe_sub(yy, xx);
  const fe tp = fe_sub(zz2, zp);
  return ge{fe_mul(xy2, tp), fe_mul(yp, zp), fe_mul(zp, tp), fe_mul(xy2, yp)};
}

// Mixed add of an extended accumulator and a precomputed Z = 1 point given
// as (y2+x2, y2-x2, 2d*t2): add-2008-hwcd-3 with zz = z1 * 1 and d2*t2
// folded in, 7 multiplies.  The op order of pallas_curve.py::_madd.
static __device__ __noinline__ ge ge_madd(const ge& p, const fe& ypx2,
                                          const fe& ymx2, const fe& td2) {
  const fe a = fe_mul(fe_sub(p.y, p.x), ymx2);
  const fe b = fe_mul(fe_add(p.y, p.x), ypx2);
  const fe c = fe_mul(p.t, td2);
  const fe d = fe_add(p.z, p.z);
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// ---------------------------------------------------------------------------
// The four-lane group law (ge_ladder_win, ge_bucket_accum).
//
// A point occupies four consecutive lanes of a warp: lane c (0..3) of the
// group holds coordinate c (x, y, z, t), 20 limbs in registers.  Each
// routine runs its field products in stages, one product a lane, and moves
// operands between stages with __shfl_sync of width 4 under the mask of the
// group's own four lanes (so groups of one warp may branch apart, as the
// accumulator's digit-0 skip does).  Every field add, sub, relax and
// multiply has the operands and op order of ge_padd / ge_pdbl / ge_madd
// above, so the output limbs are theirs bit for bit; a + b and a - b of one
// stage run as one fe_addsub with the sign picked per lane.
//
// Stages (M a field multiply, S a squaring; the rest adds and shuffles):
//   ge4_pdbl  S: x^2 | y^2 | z^2 (then 2z^2) | (x+y)^2;
//             yy - xx on lane 0, xx + yy on lane 1;
//             M: 2xy*tp | yp*zp | zp*tp | 2xy*yp            (2 deep, was 8)
//   ge4_padd  M: (y1-x1)(y2-x2) | (y1+x1)(y2+x2) | z1 z2 (then 2 z1 z2) |
//                t1 2d, then * t2 on lane 3 alone;
//             M: e f | g h | f g | e h                         (3 deep, was 9)
//   ge4_madd  M: (y1-x1) ymx2 | (y1+x1) ypx2 | 2 z1 (an add) | t1 td2;
//             M: e f | g h | f g | e h                         (2 deep, was 7)
//
// What bounds them: the IMAD issue of one warp.  A warp instruction still
// does 32 lanes' work, now a product of each of 8 points rather than a
// whole add of each of 32, so a point's chain is 3-4 times shorter while
// the card runs 4 times as many warps for the same points: the gain is
// latency where the kernels fill few schedulers (the ladder's 147-1024
// points, the combine's Horner chain), at the price of the adds that every
// lane of a group repeats and 120-160 shuffles a point operation.
//
// These are __forceinline__: each takes and returns one coordinate (80 B),
// where the one-thread routines above pass 320-byte points by reference.

// This lane's place in its group: c the coordinate, mask the group's lanes.
struct lane4 {
  int c;
  unsigned mask;
};

__device__ __forceinline__ lane4 lane4_here() {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  return lane4{lane & 3, 0xFu << (lane & 28)};
}

// Coordinate c of the identity (0, 1, 1, 0).
__device__ __forceinline__ fe ge4_identity(const lane4& g) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) r.v[i] = (i == 0) && (g.c == 1 || g.c == 2);
  return r;
}

// Lane `src` (0..3) of this lane's group's copy of a.
__device__ __forceinline__ fe fe_shfl(const lane4& g, const fe& a, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) r.v[i] = __shfl_sync(g.mask, a.v[i], src, 4);
  return r;
}

// a where pick, else b.
__device__ __forceinline__ fe fe_sel(bool pick, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_L; ++i) r.v[i] = pick ? a.v[i] : b.v[i];
  return r;
}

// fe_sub(a, b) where neg, else fe_add(a, b): the same limbs.
__device__ __forceinline__ fe fe_addsub(const fe& a, const fe& b, bool neg) {
  fe r;
  r.v[0] = a.v[0] + (neg ? FE_KNEG0 - b.v[0] : b.v[0]);
#pragma unroll
  for (int i = 1; i < FE_L; ++i) r.v[i] = a.v[i] + (neg ? FE_KNEG - b.v[i] : b.v[i]);
  fe_relax<2>(r);
  return r;
}

// The last stage of ge_padd and ge_madd: lanes 0..3 hold a, b, d, c; with
// e = b - a, f = d - c, g = d + c, h = b + a, returns lane c's coordinate of
// (e f, g h, f g, e h).
__device__ __forceinline__ fe ge4_finish(const lane4& g, const fe& r) {
  const int k = g.c;
  const bool x_ba = k == 0 || k == 3;        // first factor from (b, a)
  const bool y_ba = (k & 1) != 0;            // second factor from (b, a)
  const fe x1 = fe_shfl(g, r, x_ba ? 1 : 2);
  const fe x2 = fe_shfl(g, r, x_ba ? 0 : 3);
  const fe y1 = fe_shfl(g, r, y_ba ? 1 : 2);
  const fe y2 = fe_shfl(g, r, y_ba ? 0 : 3);
  return fe_mul(fe_addsub(x1, x2, k != 1), fe_addsub(y1, y2, k == 0));
}

// ge_padd(p, q) on four lanes: p, q this lane's coordinates of the operands.
// The first product runs on all four lanes at once (operands picked per
// lane), the second of c on lane 3 alone.
__device__ __forceinline__ fe ge4_padd(const lane4& g, const fe& p,
                                       const fe& q) {
  const int k = g.c;
  const fe py = fe_shfl(g, p, 1), px = fe_shfl(g, p, 0);
  const fe qy = fe_shfl(g, q, 1), qx = fe_shfl(g, q, 0);
  const fe u = fe_sel(k < 2, fe_addsub(py, px, k == 0), p);
  const fe v = fe_sel(k < 2, fe_addsub(qy, qx, k == 0),
                      k == 2 ? q : fe_d2());
  fe r = fe_mul(u, v);                       // a | b | zz | t1 2d
  if (k == 3) r = fe_mul(r, q);              // c
  else if (k == 2) r = fe_add(r, r);         // d
  return ge4_finish(g, r);
}

// ge_pdbl(p) on four lanes (t is not read).
__device__ __forceinline__ fe ge4_pdbl(const lane4& g, const fe& p) {
  const int k = g.c;
  const fe px = fe_shfl(g, p, 0), py = fe_shfl(g, p, 1);
  fe r = fe_sq(fe_sel(k == 3, fe_add(px, py), p));  // xx | yy | zz | (x+y)^2
  if (k == 2) {                               // zz2
#pragma unroll
    for (int i = 0; i < FE_L; ++i) r.v[i] *= 2;
    fe_relax<2>(r);
  }
  // lane 0 zp = yy - xx, lane 1 yp = xx + yy (= yy + xx limb for limb)
  const fe o = fe_shfl(g, r, k ^ 1);
  if (k < 2) r = fe_addsub(o, r, k == 0);
  // lanes: zp | yp | zz2 | (x+y)^2; xy2 = (x+y)^2 - yp, tp = zz2 - zp
  const bool x_diff = k == 0 || k == 3;      // first factor xy2
  const bool y_diff = k == 0 || k == 2;      // second factor tp
  const fe x1 = fe_shfl(g, r, x_diff ? 3 : (k == 1 ? 1 : 0));
  const fe x2 = fe_shfl(g, r, 1);
  const fe y1 = fe_shfl(g, r, y_diff ? 2 : (k == 1 ? 0 : 1));
  const fe y2 = fe_shfl(g, r, 0);
  return fe_mul(fe_sel(x_diff, fe_sub(x1, x2), x1),
                fe_sel(y_diff, fe_sub(y1, y2), y1));
}

// ge_madd on four lanes: p this lane's coordinate of the accumulator, q its
// operand: ymx2 on lane 0, ypx2 on lane 1, td2 on lane 3 (lane 2's product
// is discarded for d = 2 z1).
__device__ __forceinline__ fe ge4_madd(const lane4& g, const fe& p,
                                       const fe& q) {
  const int k = g.c;
  const fe py = fe_shfl(g, p, 1), px = fe_shfl(g, p, 0);
  fe r = fe_mul(fe_sel(k < 2, fe_addsub(py, px, k == 0), p), q);  // a | b | - | c
  if (k == 2) r = fe_add(p, p);                                  // d
  return ge4_finish(g, r);
}

}  // namespace bp
