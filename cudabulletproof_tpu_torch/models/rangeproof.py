"""Range proofs of the host-transcript protocol: prover and exact
verifiers, the port's ``cudabulletproof_tpu/models/rangeproof.py``
(``pedersen_commit`` :73, ``compute_delta`` :79, ``prove`` :103, ``verify``
:261, ``prove_fast`` :337, ``verify_fast`` :360, ``verify_deterministic``
:378), with its data types and challenge domains, which ``models/fused.py``
and ``utils/serialization.py`` share.

The Fiat-Shamir transcript (``models/transcript.py``, ``hashlib``) and the
mod-l vector algebra run on the host as Python ints; every group operation
is a device MSM (``ops/msm.py``: ``msm_ints``, ``msm_ints_multi``) on the
device of the generators.  Given the same generators and randomness, the
prover writes the JAX package's proof byte for byte.

Randomness is explicit: ``prove`` and ``verify`` take ``rand``, a callable
returning an int in [0, l), by default ``scalars.sc_random`` (``secrets``).
The prover draws sL[0..n), sR[0..n), alpha, rho, then tau1, tau2, in the
JAX package's order; ``verify`` draws its two combination weights r1, r2.

The verifiers:
  * ``verify``: both checks of ``verify_deterministic`` merged into one MSM
    by a random linear combination (soundness error 1/l), the proof points
    decompressed and refused if of small order, the result times 8;
  * ``verify_deterministic``: check 1, the polynomial identity
    (t_hat - delta) g + taux h - z^2 V - x T1 - x^2 T2 = 0, and check 2,
    the merged P reconstruction and one-shot inner-product check, each an
    MSM times 8 against the identity;
  * ``verify_fast`` / ``prove_fast``: proofs of n <= 64 bits
    (``config.NATIVE_VERIFY_MAX_BITS`` for the prover) go to the native C++
    library (``utils/native.py``), the rest to ``verify`` / ``prove``.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..ops import curve as C, field as F, msm as M
from ..utils import debug, scalars as S
from . import ipa
from .generators import Generators, get_generators
from .ipa import IPA_DOMAIN, InnerProductProof  # noqa: F401 (re-exported)
from .transcript import Transcript

# Challenge domains (the reference's bulletproof_challenge.cu:24-77, plus Q)
DOMAIN_Y = b"BulletproofYChal"
DOMAIN_Z = b"BulletproofZChal"
DOMAIN_X = b"BulletproofXChal"
DOMAIN_Q = b"BulletproofQChal"


@dataclass
class RangeProof:
    n: int               # range bit-length
    V: bytes             # value commitment (compressed)
    A: bytes
    S: bytes
    T1: bytes
    T2: bytes
    taux: int
    mu: int
    t_hat: int
    ip: InnerProductProof


class ProveError(ValueError):
    """The prover refuses its input (a value out of range, an n that is not
    a power of two)."""


def validate_range_input(value: int, n: int) -> bool:
    return 0 <= value < (1 << n)


def pedersen_commit(value: int, blinding: int, gens: Generators) -> C.GE:
    """V = value g + blinding h."""
    return M.msm_ints(M.concat_ge(gens.g, gens.h),
                      [value % S.ELL, blinding % S.ELL])


def compute_delta(y: int, z: int, n: int) -> int:
    """delta(y, z) = (z - z^2) <1, y^n> - z^3 <1, 2^n>  (mod l)."""
    sum_y = 0
    acc = 1
    for _ in range(n):
        sum_y += acc
        acc = acc * y % S.ELL
    sum_2 = (1 << n) - 1
    z2 = z * z % S.ELL
    z3 = z2 * z % S.ELL
    return ((z - z2) * sum_y - z3 * sum_2) % S.ELL


def _compress(p: C.GE) -> bytes:
    return bytes(C.to_bytes(p).cpu().tolist())


def _base_transcript(n: int) -> Transcript:
    t = Transcript(b"tpu-bulletproofs/range")
    t.append(b"n", n.to_bytes(4, "little"))
    return t


def _vectors(gens: Generators, n: int):
    return (C.GE(*(c[:n] for c in gens.G)), C.GE(*(c[:n] for c in gens.H)))


def prove(value: int, blinding: int, n: int, gens: Generators | None = None,
          *, rand: Callable[[], int] | None = None,
          device="cuda") -> RangeProof:
    """A proof that `value` lies in [0, 2^n), committed as value g +
    blinding h.  Runs on `gens.device`, else on `device` (the card unless
    the caller asks for the CPU).  rand: the source of the 2n + 4 nonces
    (default ``scalars.sc_random``).  Raises ProveError for a value out of
    range or an n that is not a power of two."""
    if not validate_range_input(value, n):
        raise ProveError(f"value out of range [0, 2^{n})")
    if n < 1 or n & (n - 1) != 0:
        raise ProveError("n must be a power of two")
    draw = rand or S.sc_random
    gens = gens or get_generators(n, device)
    if gens.n < n:
        raise ValueError(f"{gens.n} generators cannot serve n={n}")
    G, H = _vectors(gens, n)

    tr = _base_transcript(n)
    debug.banner("PROOF GENERATION STEPS")

    V, = M.msm_ints_multi(M.concat_ge(gens.g, gens.h),
                          [[value % S.ELL, blinding % S.ELL]])
    debug.trace_point("V", V)

    # bit decomposition: aL[i] = bit i of value; aR = aL - 1
    aL = [(value >> i) & 1 for i in range(n)]
    aR = [(x - 1) % S.ELL for x in aL]
    sL = [draw() for _ in range(n)]
    sR = [draw() for _ in range(n)]
    alpha, rho = draw(), draw()

    # A = alpha h + <aL, G> + <aR, H> ; S = rho h + <sL, G> + <sR, H>
    A, S_b = M.msm_ints_multi(M.concat_ge(gens.h, G, H),
                              [[alpha] + aL + aR, [rho] + sL + sR])

    tr.append_point(b"V", V)
    tr.append_point(b"A", A)
    tr.append_point(b"S", S_b)
    y = tr.challenge(DOMAIN_Y)
    z = tr.challenge(DOMAIN_Z)
    debug.trace_point("A", A)
    debug.trace_point("S", S_b)
    debug.trace_scalar("y", y)
    debug.trace_scalar("z", z)

    y_n = S.vec_powers(y, n)
    two_n = S.vec_powers(2, n)
    z2 = z * z % S.ELL

    # l(X) = (aL - z 1) + sL X ; r(X) = y^n o (aR + z 1 + sR X) + z^2 2^n
    l0 = [(x - z) % S.ELL for x in aL]
    l1 = sL
    r0 = [(yi * ((x + z) % S.ELL) + z2 * ti) % S.ELL
          for yi, x, ti in zip(y_n, aR, two_n)]
    r1 = [(yi * si) % S.ELL for yi, si in zip(y_n, sR)]

    # t(X) = t0 + t1 X + t2 X^2
    t0 = S.vec_inner(l0, r0)
    t2 = S.vec_inner(l1, r1)
    t1 = (S.vec_inner(S.vec_add(l0, l1), S.vec_add(r0, r1)) - t0 - t2) % S.ELL

    tau1, tau2 = draw(), draw()
    T1, T2 = M.msm_ints_multi(M.concat_ge(gens.g, gens.h),
                              [[t1, tau1 % S.ELL], [t2, tau2 % S.ELL]])

    tr.append_point(b"T1", T1)
    tr.append_point(b"T2", T2)
    x = tr.challenge(DOMAIN_X)
    debug.trace_scalar("x", x)

    l_vec = [(a + b * x) % S.ELL for a, b in zip(l0, l1)]
    r_vec = [(a + b * x) % S.ELL for a, b in zip(r0, r1)]
    t_hat = S.vec_inner(l_vec, r_vec)
    x2 = x * x % S.ELL
    taux = (tau2 * x2 + tau1 * x + z2 * blinding) % S.ELL
    mu = (alpha + rho * x) % S.ELL

    tr.append_scalar(b"taux", taux)
    tr.append_scalar(b"mu", mu)
    tr.append_scalar(b"t", t_hat)
    w = tr.challenge(DOMAIN_Q)
    debug.trace_scalar("t_hat", t_hat)
    debug.trace_scalar("taux", taux)
    debug.trace_scalar("mu", mu)

    # the IPA over (G, H') with H'_i = y^-i H_i and Q = w g, both implicit
    y_inv_pows = S.vec_powers(S.sc_inv(y), n)
    ip = ipa.prove(G, H, gens.g, l_vec, r_vec, tr, q_weight=w,
                   h_weights=y_inv_pows)
    return RangeProof(n=n, V=V, A=A, S=S_b, T1=T1, T2=T2, taux=taux, mu=mu,
                      t_hat=t_hat, ip=ip)


def structure_ok(proof: RangeProof) -> bool:
    """The proof's shape: n a power of two, log2(n) rounds, 32-byte points
    (the generators' count is the caller's check)."""
    n = proof.n
    if n < 1 or n & (n - 1) != 0 or proof.ip.n != n:
        return False
    if len(proof.ip.L) != len(proof.ip.R) or (1 << len(proof.ip.L)) != n:
        return False
    return all(len(b) == 32 for b in [proof.V, proof.A, proof.S, proof.T1,
                                      proof.T2, *proof.ip.L, *proof.ip.R])


def _challenges(proof: RangeProof):
    """The transcript after the scalars, and y, z, x, w."""
    tr = _base_transcript(proof.n)
    tr.append_point(b"V", proof.V)
    tr.append_point(b"A", proof.A)
    tr.append_point(b"S", proof.S)
    y = tr.challenge(DOMAIN_Y)
    z = tr.challenge(DOMAIN_Z)
    tr.append_point(b"T1", proof.T1)
    tr.append_point(b"T2", proof.T2)
    x = tr.challenge(DOMAIN_X)
    tr.append_scalar(b"taux", proof.taux)
    tr.append_scalar(b"mu", proof.mu)
    tr.append_scalar(b"t", proof.t_hat)
    w = tr.challenge(DOMAIN_Q)
    return tr, y, z, x, w


def _fused_verify(pts_bytes: torch.Tensor, scalars: torch.Tensor,
                  gens: Generators, n: int) -> bool:
    """The verifier's device part (the JAX package's ``_fused_verify_fn``
    :223): decompress the 5 + 2k proof points and refuse small-order ones,
    one MSM over [G(n), H(n), g, h, V, A, S, T1, T2, L(k), R(k)] padded to
    a power of two, times 8, against the identity."""
    pts, valid = C.from_bytes(pts_bytes)
    valid = valid & ~C.is_small_order(pts)
    G, H = _vectors(gens, n)
    bases = M.concat_ge(G, H, gens.g, gens.h, pts)
    bases, scalars = M._pad_pow2(bases, scalars)
    res = C.mul8(M.msm_auto(bases, scalars))
    return bool(valid.all() & C.is_identity(res))


def _weight(draw: Callable[[], int]) -> int:
    """A combination weight in [1, l) from a draw in [0, l)."""
    return draw() % (S.ELL - 1) + 1


def verify(proof: RangeProof, gens: Generators | None = None, *,
           rand: Callable[[], int] | None = None, device="cuda") -> bool:
    """Both checks of ``verify_deterministic`` merged into one MSM by the
    weights r1, r2 (drawn from `rand`, default ``scalars.sc_random``), on
    `gens.device`, else on `device`."""
    n = proof.n
    if not structure_ok(proof):
        return False
    gens = gens or get_generators(n, device)
    if gens.n < n:
        return False
    draw = rand or S.sc_random

    debug.banner("PROOF VERIFICATION (fused)")
    tr, y, z, x, w = _challenges(proof)
    debug.trace_scalar("y", y)
    debug.trace_scalar("z", z)
    debug.trace_scalar("x", x)
    us = ipa.challenges_from_transcript(proof.ip, tr)
    s, s_inv = ipa.fold_scalars(us, n)

    z2 = z * z % S.ELL
    x2 = x * x % S.ELL
    delta = compute_delta(y, z, n)
    t_hat = proof.t_hat % S.ELL
    a, b = proof.ip.a % S.ELL, proof.ip.b % S.ELL
    y_inv_pows = S.vec_powers(S.sc_inv(y), n)
    two_n = S.vec_powers(2, n)

    r1, r2 = _weight(draw), _weight(draw)

    g_sc = [r2 * ((a * si + z) % S.ELL) % S.ELL for si in s]
    h_sc = [r2 * ((b * sii % S.ELL * yi - z - z2 * ti % S.ELL * yi)
                  % S.ELL) % S.ELL
            for sii, yi, ti in zip(s_inv, y_inv_pows, two_n)]
    sc_g = (r1 * ((t_hat - delta) % S.ELL)
            + r2 * ((a * b - t_hat) % S.ELL * w)) % S.ELL
    sc_h = (r1 * proof.taux + r2 * proof.mu) % S.ELL
    sc_v = (S.ELL - r1 * z2 % S.ELL) % S.ELL
    sc_a = (S.ELL - r2) % S.ELL
    sc_s = (S.ELL - r2 * x % S.ELL) % S.ELL
    sc_t1 = (S.ELL - r1 * x % S.ELL) % S.ELL
    sc_t2 = (S.ELL - r1 * x2 % S.ELL) % S.ELL
    l_sc = [(S.ELL - r2 * (u * u % S.ELL) % S.ELL) % S.ELL for u in us]
    r_sc = [(S.ELL - r2 * pow(S.sc_inv(u), 2, S.ELL) % S.ELL) % S.ELL
            for u in us]

    dev = gens.device
    scalars = F.from_ints(
        g_sc + h_sc + [sc_g, sc_h, sc_v, sc_a, sc_s, sc_t1, sc_t2]
        + l_sc + r_sc, dev)
    blobs = [proof.V, proof.A, proof.S, proof.T1, proof.T2,
             *proof.ip.L, *proof.ip.R]
    raw = np.frombuffer(b"".join(blobs), dtype=np.uint8).reshape(-1, 32)
    return _fused_verify(torch.from_numpy(raw.copy()).to(dev), scalars, gens,
                         n)


def prove_fast(value: int, blinding: int, n: int,
               gens: Generators | None = None, *,
               rand: Callable[[], int] | None = None,
               device="cuda") -> RangeProof:
    """Proofs of n <= ``config.NATIVE_VERIFY_MAX_BITS`` bits from the native
    C++ prover (the same wire format, transcript and generators), the rest
    from ``prove``."""
    from ..utils import native, serialization
    if n <= config.NATIVE_VERIFY_MAX_BITS and native.available():
        if not validate_range_input(value, n):
            raise ProveError(f"value out of range [0, 2^{n})")
        blob = native.prove_range(value, blinding % S.ELL, n)
        if blob:
            return serialization.deserialize_range_proof(blob)
    return prove(value, blinding, n, gens, rand=rand, device=device)


def verify_fast(proof: RangeProof, gens: Generators | None = None, *,
                rand: Callable[[], int] | None = None,
                device="cuda") -> bool:
    """Proofs of n <= 64 bits to the native C++ verifier (host-scale work:
    a small single proof costs more in launches than in arithmetic), the
    rest to ``verify``."""
    from ..utils import native, serialization
    if proof.n <= 64 and native.available():
        return native.verify_range(serialization.serialize_range_proof(proof))
    return verify(proof, gens, rand=rand, device=device)


def verify_deterministic(proof: RangeProof, gens: Generators | None = None,
                         *, device="cuda") -> bool:
    """Verify with exact algebra: check 1 (polynomial identity)

        (t_hat - delta) g + taux h - z^2 V - x T1 - x^2 T2 == 0

    and check 2 (merged P reconstruction and one-shot IPA)

        sum (a s_i + z) G_i
      + sum (b s_i^-1 y^-i - z - z^2 2^i y^-i) H_i
      + (ab - t_hat) w g + mu h - A - x S - sum (u_j^2 L_j + u_j^-2 R_j) == 0,

    each an MSM times 8 (cofactored), on `gens.device`, else on `device`."""
    n = proof.n
    if not structure_ok(proof):
        return False
    gens = gens or get_generators(n, device)
    if gens.n < n:
        return False
    dev = gens.device
    G, H = _vectors(gens, n)

    pts, ok = ipa.decompress_proof_points(
        [proof.V, proof.A, proof.S, proof.T1, proof.T2], dev)
    if not ok:
        return False
    V_pt, A_pt, S_pt, T1_pt, T2_pt = (C.GE(*(c[i] for c in pts))
                                      for i in range(5))

    tr, y, z, x, w = _challenges(proof)
    z2 = z * z % S.ELL
    x2 = x * x % S.ELL
    delta = compute_delta(y, z, n)
    t_hat = proof.t_hat % S.ELL

    # check 1: the polynomial identity
    sc1 = [(t_hat - delta) % S.ELL, proof.taux % S.ELL,
           (S.ELL - z2) % S.ELL, (S.ELL - x) % S.ELL, (S.ELL - x2) % S.ELL]
    res1 = M.msm_ints(M.concat_ge(gens.g, gens.h, V_pt, T1_pt, T2_pt), sc1)
    if not bool(C.is_identity(C.mul8(res1))):
        return False

    # check 2: merged P + one-shot IPA; a b = t_hat is enforced by the
    # (ab - t_hat) w g term
    us = ipa.challenges_from_transcript(proof.ip, tr)
    s, s_inv = ipa.fold_scalars(us, n)
    a, b = proof.ip.a % S.ELL, proof.ip.b % S.ELL
    y_inv_pows = S.vec_powers(S.sc_inv(y), n)
    two_n = S.vec_powers(2, n)

    g_sc = [(a * si + z) % S.ELL for si in s]
    h_sc = [(b * sii % S.ELL * yi - z - z2 * ti % S.ELL * yi) % S.ELL
            for sii, yi, ti in zip(s_inv, y_inv_pows, two_n)]
    gq_sc = (a * b - t_hat) % S.ELL * w % S.ELL
    h_single = proof.mu % S.ELL
    a_sc = S.ELL - 1
    s_sc = (S.ELL - x) % S.ELL
    l_sc = [(S.ELL - u * u % S.ELL) % S.ELL for u in us]
    r_sc = [(S.ELL - pow(S.sc_inv(u), 2, S.ELL)) % S.ELL for u in us]

    bases = M.concat_ge(G, H, gens.g, gens.h, A_pt, S_pt)
    sc2 = g_sc + h_sc + [gq_sc, h_single, a_sc, s_sc]
    if proof.ip.L:
        L_pts, okl = ipa.decompress_proof_points(proof.ip.L, dev)
        R_pts, okr = ipa.decompress_proof_points(proof.ip.R, dev)
        if not (okl and okr):
            return False
        bases = M.concat_ge(bases, L_pts, R_pts)
        sc2 = sc2 + l_sc + r_sc
    res2 = M.msm_ints(bases, sc2)
    return bool(C.is_identity(C.mul8(res2)))
