"""The inner-product argument of the host-transcript protocol: prover and
one-shot verifier, the port's ``cudabulletproof_tpu/models/ipa.py``
(``prove`` :50, ``challenges_from_transcript`` :102, ``fold_scalars`` :112,
``decompress_proof_points`` :129, ``verify`` :149).

Statement: P = <a, G> + <b, H'> + q_weight <a, b> Q with H'_i =
h_weights[i] H_i (the range proof passes y^-i).  The prover folds the
generators symbolically: each original G_k, H_k keeps an (owner, weight)
pair on the host, so every round's L and R is one MSM pair over the
original bases (``msm.msm_ints_multi``) and no folded generator is ever
made.  The verifier expands s_i = prod_j u_j^(+-1) and checks one
(2n + 2 log n + 2)-base MSM, times the cofactor 8, against the identity.
Scalars are Python ints mod l; the MSMs run on the device of the bases.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve as C, msm as M
from ..utils import oracle, scalars as S
from .transcript import Transcript

IPA_DOMAIN = b"InnerProductChal"


@dataclass
class InnerProductProof:
    n: int
    L: list          # list[bytes], compressed points, len = log2(n)
    R: list
    a: int
    b: int


def prove(G: C.GE, H: C.GE, Q: C.GE, a, b, transcript: Transcript,
          q_weight: int = 1, h_weights=None) -> InnerProductProof:
    """a, b: Python ints (mod l) of a power-of-two length n; G, H: GE [n];
    Q: one GE (unbatched)."""
    n = len(a)
    if n < 1 or n & (n - 1) != 0:
        raise ValueError(f"the vectors' length {n} is not a power of two")
    a, b = [x % S.ELL for x in a], [x % S.ELL for x in b]
    wG = [1] * n                         # weight of original G_k
    wH = list(h_weights) if h_weights is not None else [1] * n
    own = list(range(n))                 # current folded index of original k
    bases = M.concat_ge(G, H, Q)         # the same for every round
    m = n
    L_out, R_out = [], []
    while m > 1:
        h = m // 2
        a_L, a_R = a[:h], a[h:]
        b_L, b_R = b[:h], b[h:]
        c_L = S.vec_inner(a_L, b_R)
        c_R = S.vec_inner(a_R, b_L)
        # L = <a_L, Gcur_R> + <b_R, Hcur_L> + c_L q_weight Q, R the mirror
        gl = [a_L[own[k] - h] * wG[k] % S.ELL if own[k] >= h else 0
              for k in range(n)]
        hl = [b_R[own[k]] * wH[k] % S.ELL if own[k] < h else 0
              for k in range(n)]
        gr = [a_R[own[k]] * wG[k] % S.ELL if own[k] < h else 0
              for k in range(n)]
        hr = [b_L[own[k] - h] * wH[k] % S.ELL if own[k] >= h else 0
              for k in range(n)]
        L_b, R_b = M.msm_ints_multi(
            bases, [gl + hl + [c_L * q_weight % S.ELL],
                    gr + hr + [c_R * q_weight % S.ELL]])
        transcript.append_point(b"ipL", L_b)
        transcript.append_point(b"ipR", R_b)
        u = transcript.challenge(IPA_DOMAIN)
        u_inv = S.sc_inv(u)
        a = [(u * x + u_inv * y) % S.ELL for x, y in zip(a_L, a_R)]
        b = [(u_inv * x + u * y) % S.ELL for x, y in zip(b_L, b_R)]
        # G' = u^-1 G_L + u G_R ; H' = u H_L + u^-1 H_R, as weights
        for k in range(n):
            if own[k] < h:
                wG[k] = wG[k] * u_inv % S.ELL
                wH[k] = wH[k] * u % S.ELL
            else:
                wG[k] = wG[k] * u % S.ELL
                wH[k] = wH[k] * u_inv % S.ELL
                own[k] -= h
        L_out.append(L_b)
        R_out.append(R_b)
        m = h
    return InnerProductProof(n=1 << len(L_out), L=L_out, R=R_out, a=a[0],
                             b=b[0])


def challenges_from_transcript(proof: InnerProductProof,
                               transcript: Transcript) -> list:
    """The per-round challenges u_j, re-derived (verifier side)."""
    us = []
    for L_b, R_b in zip(proof.L, proof.R):
        transcript.append_point(b"ipL", L_b)
        transcript.append_point(b"ipR", R_b)
        us.append(transcript.challenge(IPA_DOMAIN))
    return us


def fold_scalars(us, n: int):
    """s_i = prod_j u_j^(+1 if bit (log n - 1 - j) of i else -1); returns
    (s, s_inv)."""
    k = len(us)
    if n != 1 << k:
        raise ValueError(f"{k} challenges cannot fold {n} scalars")
    us_inv = [S.sc_inv(u) for u in us]
    s = []
    for i in range(n):
        acc = 1
        for j in range(k):
            bit = (i >> (k - 1 - j)) & 1
            acc = acc * (us[j] if bit else us_inv[j]) % S.ELL
        s.append(acc)
    # n - 1 - i complements every bit of i, so s_(n-1-i) = 1 / s_i
    return s, list(reversed(s))


def decompress_proof_points(blobs, device="cuda"):
    """list[bytes] -> (GE [k], all valid and none of small order); an empty
    list gives (None, True).  Padded to a power of two of at least 8 with
    the base point's encoding, as the JAX package pads to keep its compiled
    shapes few."""
    if not blobs:
        return None, True
    n = len(blobs)
    m = 8
    while m < n:
        m *= 2
    pad = oracle.BASE.compress()
    raw = np.frombuffer(b"".join(list(blobs) + [pad] * (m - n)),
                        dtype=np.uint8).reshape(m, 32)
    pts, ok = C.from_bytes(torch.from_numpy(raw.copy()).to(device))
    ok = ok & ~C.is_small_order(pts)
    return C.GE(*(c[:n] for c in pts)), bool(ok[:n].all())


def verify(G: C.GE, H: C.GE, Q: C.GE, P: C.GE, proof: InnerProductProof,
           transcript: Transcript, q_weight: int = 1, h_weights=None) -> bool:
    """One-shot verification, exact point equality (cofactored), on the
    device of G.  Undersized generators and malformed points give False."""
    n = proof.n
    if len(proof.L) != len(proof.R) or (1 << len(proof.L)) != n:
        return False
    if G.x.shape[0] < n or H.x.shape[0] < n:
        return False
    if any(len(blob) != 32 for blob in [*proof.L, *proof.R]):
        return False
    G = C.GE(*(c[:n] for c in G))
    H = C.GE(*(c[:n] for c in H))
    us = challenges_from_transcript(proof, transcript)
    s, s_inv = fold_scalars(us, n)
    a, b = proof.a % S.ELL, proof.b % S.ELL
    wH = list(h_weights) if h_weights is not None else [1] * n
    g_sc = [a * si % S.ELL for si in s]
    h_sc = [b * sii % S.ELL * wi % S.ELL for sii, wi in zip(s_inv, wH)]
    q_sc = a * b % S.ELL * q_weight % S.ELL
    l_sc = [(S.ELL - u * u % S.ELL) % S.ELL for u in us]
    r_sc = [(S.ELL - pow(S.sc_inv(u), 2, S.ELL)) % S.ELL for u in us]
    dev = G.x.device
    L_pts, okl = decompress_proof_points(proof.L, dev)
    R_pts, okr = decompress_proof_points(proof.R, dev)
    if not (okl and okr):
        return False
    if L_pts is not None:
        bases = M.concat_ge(G, H, Q, P, L_pts, R_pts)
        sc = g_sc + h_sc + [q_sc, S.ELL - 1] + l_sc + r_sc
    else:
        bases = M.concat_ge(G, H, Q, P)
        sc = g_sc + h_sc + [q_sc, S.ELL - 1]
    res = M.msm_ints(bases, sc)
    return bool(C.is_identity(C.mul8(res)))
