"""Aggregated range proofs (m values, one proof) and batched verification
of single proofs, the port's ``cudabulletproof_tpu/models/aggregate.py``
(``AggregatedRangeProof`` :33, ``_base_transcript`` :47, ``prove`` :54,
``_delta_agg`` :138, ``_final_msm`` :156, ``verify`` :166,
``batch_verify`` :262).

The host-transcript protocol of ``models/rangeproof.py`` over N = n m
generators: the m values' bits share one inner-product argument, so the
proof grows by the m commitments V_j and log2(m) rounds.  The transcript and
the mod-l algebra are Python ints; every group operation is a device MSM
(``msm.msm_ints_multi`` for the prover, one ``msm.msm_ints`` for each
verifier) on the device of the generators.  Given the same generators and
randomness, ``prove`` writes the JAX package's proof byte for byte.

Randomness is explicit, as in ``rangeproof``: ``prove`` takes ``rand`` for
sL[0..N), sR[0..N), alpha, rho, then tau1, tau2 (the JAX package's draw
order); ``verify`` draws its weights r1, r2 and ``batch_verify`` a pair for
each proof, each ``rand() mod (l - 1) + 1``.  ``mesh`` (the sharded MSM)
is not ported yet: any value but None raises NotImplementedError.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from ..ops import curve as C, msm as M
from ..utils import scalars as S
from . import ipa
from .generators import Generators, get_generators
from .rangeproof import (DOMAIN_Q, DOMAIN_X, DOMAIN_Y, DOMAIN_Z, ProveError,
                         _base_transcript as _single_transcript, _vectors,
                         _weight, compute_delta, structure_ok,
                         validate_range_input)
from .transcript import Transcript


@dataclass
class AggregatedRangeProof:
    n: int                # bits per value
    m: int                # number of values
    V: list               # m compressed commitments
    A: bytes
    S: bytes
    T1: bytes
    T2: bytes
    taux: int
    mu: int
    t_hat: int
    ip: ipa.InnerProductProof


def _base_transcript(n: int, m: int) -> Transcript:
    t = Transcript(b"tpu-bulletproofs/range-agg")
    t.append(b"n", n.to_bytes(4, "little"))
    t.append(b"m", m.to_bytes(4, "little"))
    return t


def prove(values, blindings, n: int, gens: Generators | None = None, *,
          rand: Callable[[], int] | None = None,
          device="cuda") -> AggregatedRangeProof:
    """One proof that every value lies in [0, 2^n), each committed as
    value g + blinding h.  m = len(values) must be a power of two.  Runs on
    `gens.device`, else on `device`; rand: the source of the 2 n m + 4
    nonces (default ``scalars.sc_random``)."""
    m = len(values)
    if len(blindings) != m:
        raise ValueError(f"{m} values, {len(blindings)} blindings")
    if m < 1 or m & (m - 1) != 0:
        raise ProveError("m must be a power of two")
    if n < 1 or n & (n - 1) != 0:
        raise ProveError("n must be a power of two")
    for v in values:
        if not validate_range_input(v, n):
            raise ProveError(f"value out of range [0, 2^{n})")
    draw = rand or S.sc_random
    N = n * m
    gens = gens or get_generators(N, device)
    if gens.n < N:
        raise ValueError(f"{gens.n} generators cannot serve n m = {N}")
    G, H = _vectors(gens, N)

    tr = _base_transcript(n, m)
    # all m value commitments in one multi-MSM
    V_list = M.msm_ints_multi(
        M.concat_ge(gens.g, gens.h),
        [[v % S.ELL, gamma % S.ELL] for v, gamma in zip(values, blindings)])
    for vb in V_list:
        tr.append_point(b"V", vb)

    aL = []
    for v in values:
        aL.extend((v >> i) & 1 for i in range(n))
    aR = [(x - 1) % S.ELL for x in aL]
    sL = [draw() for _ in range(N)]
    sR = [draw() for _ in range(N)]
    alpha, rho = draw(), draw()

    A_b, S_b = M.msm_ints_multi(M.concat_ge(gens.h, G, H),
                                [[alpha] + aL + aR, [rho] + sL + sR])
    tr.append_point(b"A", A_b)
    tr.append_point(b"S", S_b)
    y = tr.challenge(DOMAIN_Y)
    z = tr.challenge(DOMAIN_Z)

    y_N = S.vec_powers(y, N)
    z2 = z * z % S.ELL
    z_pows = S.vec_powers(z, m)           # z^j
    # r0[i] = y^i (aR_i + z) + z^(2+j(i)) 2^(i mod n)
    l0 = [(x - z) % S.ELL for x in aL]
    l1 = sL
    r0, r1 = [], []
    for i in range(N):
        zz = z2 * z_pows[i // n] % S.ELL
        r0.append((y_N[i] * ((aR[i] + z) % S.ELL) + zz * (1 << (i % n)))
                  % S.ELL)
        r1.append(y_N[i] * sR[i] % S.ELL)

    t0 = S.vec_inner(l0, r0)
    t2 = S.vec_inner(l1, r1)
    t1 = (S.vec_inner(S.vec_add(l0, l1), S.vec_add(r0, r1)) - t0 - t2) % S.ELL

    tau1, tau2 = draw(), draw()
    T1_b, T2_b = M.msm_ints_multi(M.concat_ge(gens.g, gens.h),
                                  [[t1, tau1], [t2, tau2]])
    tr.append_point(b"T1", T1_b)
    tr.append_point(b"T2", T2_b)
    x = tr.challenge(DOMAIN_X)
    x2 = x * x % S.ELL

    l_vec = [(a + b * x) % S.ELL for a, b in zip(l0, l1)]
    r_vec = [(a + b * x) % S.ELL for a, b in zip(r0, r1)]
    t_hat = S.vec_inner(l_vec, r_vec)
    taux = (tau2 * x2 + tau1 * x
            + sum(z2 * zj % S.ELL * g for zj, g in zip(z_pows, blindings))
            ) % S.ELL
    mu = (alpha + rho * x) % S.ELL

    tr.append_scalar(b"taux", taux)
    tr.append_scalar(b"mu", mu)
    tr.append_scalar(b"t", t_hat)
    w = tr.challenge(DOMAIN_Q)

    y_inv_pows = S.vec_powers(S.sc_inv(y), N)
    ip = ipa.prove(G, H, gens.g, l_vec, r_vec, tr, q_weight=w,
                   h_weights=y_inv_pows)
    return AggregatedRangeProof(n=n, m=m, V=V_list, A=A_b, S=S_b, T1=T1_b,
                                T2=T2_b, taux=taux, mu=mu, t_hat=t_hat, ip=ip)


def _delta_agg(y: int, z: int, n: int, m: int) -> int:
    """(z - z^2) <1, y^(n m)> - sum_j z^(j+3) <1, 2^n>  (mod l)."""
    sum_y = 0
    acc = 1
    for _ in range(n * m):
        sum_y += acc
        acc = acc * y % S.ELL
    sum_2 = (1 << n) - 1
    z2 = z * z % S.ELL
    total = (z - z2) * sum_y % S.ELL
    zj = z2 * z % S.ELL
    for _ in range(m):
        total = (total - zj * sum_2) % S.ELL
        zj = zj * z % S.ELL
    return total % S.ELL


def _final_msm(bases: C.GE, sc: list, mesh) -> C.GE:
    """The verification MSM; a device mesh (the sharded MSM) is not ported
    yet."""
    if mesh is not None:
        raise NotImplementedError("the sharded verification MSM (mesh=) is "
                                  "not in the port yet")
    return M.msm_ints(bases, sc)


def verify(proof: AggregatedRangeProof, gens: Generators | None = None, *,
           mesh=None, rand: Callable[[], int] | None = None,
           device="cuda") -> bool:
    """Both checks of the aggregated proof merged into one MSM by the
    weights r1, r2 (from `rand`), after one batched decompression that
    refuses invalid and small-order points; cofactored.  On `gens.device`,
    else on `device`."""
    n, m = proof.n, proof.m
    if n < 1 or m < 1 or n & (n - 1) != 0 or m & (m - 1) != 0:
        return False
    N = n * m
    if proof.ip.n != N or (1 << len(proof.ip.L)) != N \
            or len(proof.ip.R) != len(proof.ip.L):
        return False
    gens = gens or get_generators(N, device)
    if gens.n < N or len(proof.V) != m:
        return False
    blobs = (list(proof.V) + [proof.A, proof.S, proof.T1, proof.T2]
             + list(proof.ip.L) + list(proof.ip.R))
    if any(len(b) != 32 for b in blobs):
        return False
    draw = rand or S.sc_random
    G, H = _vectors(gens, N)

    k = len(proof.ip.L)
    pts, ok = ipa.decompress_proof_points(blobs, gens.device)
    if not ok:
        return False

    def rows(lo, hi):
        return C.GE(*(c[lo:hi] for c in pts))

    V_pts = rows(0, m)
    A_pt, S_pt, T1_pt, T2_pt = (rows(m + i, m + i + 1) for i in range(4))
    L_pts, R_pts = rows(m + 4, m + 4 + k), rows(m + 4 + k, m + 4 + 2 * k)

    tr = _base_transcript(n, m)
    for vb in proof.V:
        tr.append_point(b"V", vb)
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

    z2 = z * z % S.ELL
    x2 = x * x % S.ELL
    z_pows = S.vec_powers(z, m)
    delta = _delta_agg(y, z, n, m)
    t_hat = proof.t_hat % S.ELL

    # random weights merging check 1 (the polynomial identity) and check 2
    # (P reconstruction and the one-shot inner-product check)
    r1, r2 = _weight(draw), _weight(draw)

    us = ipa.challenges_from_transcript(proof.ip, tr)
    s, s_inv = ipa.fold_scalars(us, N)
    a, b = proof.ip.a % S.ELL, proof.ip.b % S.ELL
    y_inv_pows = S.vec_powers(S.sc_inv(y), N)

    g_sc = [r2 * ((a * si + z) % S.ELL) % S.ELL for si in s]
    h_sc = []
    for i in range(N):
        zz = z2 * z_pows[i // n] % S.ELL
        coeff = (b * s_inv[i] % S.ELL * y_inv_pows[i]
                 - z - zz * (1 << (i % n)) % S.ELL * y_inv_pows[i]) % S.ELL
        h_sc.append(r2 * coeff % S.ELL)
    sc_g = (r1 * ((t_hat - delta) % S.ELL)
            + r2 * ((a * b - t_hat) % S.ELL * w % S.ELL)) % S.ELL
    sc_h = (r1 * proof.taux + r2 * proof.mu) % S.ELL
    sc_v = [(S.ELL - r1 * (z2 * zj % S.ELL) % S.ELL) % S.ELL for zj in z_pows]
    sc = (g_sc + h_sc + [sc_g, sc_h]
          + sc_v
          + [(S.ELL - r1 * x % S.ELL) % S.ELL,
             (S.ELL - r1 * x2 % S.ELL) % S.ELL,
             (S.ELL - r2) % S.ELL,
             (S.ELL - r2 * x % S.ELL) % S.ELL]
          + [(S.ELL - r2 * (u * u % S.ELL) % S.ELL) % S.ELL for u in us]
          + [(S.ELL - r2 * pow(S.sc_inv(u), 2, S.ELL) % S.ELL) % S.ELL
             for u in us])
    bases = M.concat_ge(G, H, gens.g, gens.h, V_pts, T1_pt, T2_pt,
                        A_pt, S_pt, L_pts, R_pts)
    res = _final_msm(bases, sc, mesh)
    return bool(C.is_identity(C.mul8(res)))       # cofactored check


def batch_verify(proofs: list, gens: Generators | None = None, *,
                 mesh=None, rand: Callable[[], int] | None = None,
                 device="cuda") -> bool:
    """Verify k single range proofs of one n with one random-linear-
    combination MSM (a pair of weights per proof, from `rand`); one batched
    decompression for every point of every proof.  Sound: a cheating proof
    passes with probability about 2/l."""
    if not proofs:
        return True
    n = proofs[0].n
    if any(p.n != n or not structure_ok(p) for p in proofs):
        return False
    gens = gens or get_generators(n, device)
    if gens.n < n:
        return False
    draw = rand or S.sc_random
    G, H = _vectors(gens, n)

    k = n.bit_length() - 1
    blobs = []
    for proof in proofs:
        blobs += [proof.V, proof.A, proof.S, proof.T1, proof.T2]
        blobs += list(proof.ip.L) + list(proof.ip.R)
    all_pts, ok = ipa.decompress_proof_points(blobs, gens.device)
    if not ok:
        return False
    stride = 5 + 2 * k

    g_acc = [0] * n
    h_acc = [0] * n
    g_single = 0
    h_single = 0
    extra_idx = []      # rows of all_pts, in MSM base order
    extra_sc = []

    for pi, proof in enumerate(proofs):
        base = pi * stride
        tr = _single_transcript(n)
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
        us = ipa.challenges_from_transcript(proof.ip, tr)
        s, s_inv = ipa.fold_scalars(us, n)
        a, b = proof.ip.a % S.ELL, proof.ip.b % S.ELL
        z2 = z * z % S.ELL
        x2 = x * x % S.ELL
        delta = compute_delta(y, z, n)
        t_hat = proof.t_hat % S.ELL
        y_inv_pows = S.vec_powers(S.sc_inv(y), n)
        two_n = S.vec_powers(2, n)

        r1 = _weight(draw)      # weight of check 1
        r2 = _weight(draw)      # weight of check 2

        # check 1 (V = base + 0, A + 1, S + 2, T1 + 3, T2 + 4)
        g_single = (g_single + r1 * ((t_hat - delta) % S.ELL)) % S.ELL
        h_single = (h_single + r1 * proof.taux) % S.ELL
        extra_idx.extend([base + 0, base + 3, base + 4])
        extra_sc.extend([(S.ELL - r1 * z2 % S.ELL) % S.ELL,
                         (S.ELL - r1 * x % S.ELL) % S.ELL,
                         (S.ELL - r1 * x2 % S.ELL) % S.ELL])

        # check 2
        for i in range(n):
            g_acc[i] = (g_acc[i] + r2 * ((a * s[i] + z) % S.ELL)) % S.ELL
            coeff = (b * s_inv[i] % S.ELL * y_inv_pows[i]
                     - z - z2 * two_n[i] % S.ELL * y_inv_pows[i]) % S.ELL
            h_acc[i] = (h_acc[i] + r2 * coeff) % S.ELL
        g_single = (g_single + r2 * ((a * b - t_hat) % S.ELL * w % S.ELL)
                    ) % S.ELL
        h_single = (h_single + r2 * proof.mu) % S.ELL
        extra_idx.extend([base + 1, base + 2])
        extra_sc.extend([(S.ELL - r2) % S.ELL,
                         (S.ELL - r2 * x % S.ELL) % S.ELL])
        for j, u in enumerate(us):
            extra_idx.append(base + 5 + j)
            extra_sc.append((S.ELL - r2 * (u * u % S.ELL) % S.ELL) % S.ELL)
            extra_idx.append(base + 5 + k + j)
            extra_sc.append((S.ELL - r2 * pow(S.sc_inv(u), 2, S.ELL) % S.ELL)
                            % S.ELL)

    # one gather puts every per-proof point in MSM base order
    idx = torch.tensor(extra_idx, device=gens.device)
    stacked = C.GE(*(c[idx] for c in all_pts))
    bases = M.concat_ge(G, H, gens.g, gens.h, stacked)
    sc = g_acc + h_acc + [g_single, h_single] + extra_sc
    res = _final_msm(bases, sc, mesh)
    return bool(C.is_identity(C.mul8(res)))       # cofactored check
