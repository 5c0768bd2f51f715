"""Range proofs as one pass of tensor ops each: ``prove`` (random inputs in,
proof bytes out) and ``verify`` / ``batch_verify`` (proof bytes in, one bool
out), every challenge derived on the device.

The prover is ``cudabulletproof_tpu/models/fused.py``'s (``prove`` :404,
``_prove_fn`` :315, ``_ipa_prove_scan`` :257, ``_ipa_scan_tables`` :218,
``_ipa_masks`` :200, ``_msm_compressed`` :149): the commitments V, A, S, T1,
T2 and the inner-product rounds' L, R as MSMs on the ladder
(``curve.scalarmult``, whose ladder ``config.LADDER_WINDOW`` picks), the
transcript and the mod-l algebra as tensor ops.  Given the same generators,
bits and randomness ``scp`` it writes the JAX package's blob byte for byte.
The IPA rounds keep the JAX package's fixed-length vectors and gather
tables, so every round has the same shapes; its ``lax.scan`` is a Python
loop.

The verifier is the verify half of the same file (``verify`` :623,
``batch_verify`` :645 with merged=True, ``_verify_parts_fn`` :451,
``_msm_point`` :177, ``_fused_msm_min`` :112, ``_pippenger_rows`` :124),
with ``vmap`` replaced by an explicit leading batch axis.  Per proof:
decompress the 5 + 2k proof points and reject small-order ones, re-run
the SHA-256 transcript, and build the random-linear-combination scalars
over the bases [G(n) | H(n) | g h V A S T1 T2 | L(k) | R(k)]; then one
multi-scalar multiplication (MSM) must give the identity after the
cofactor 8.  A merged batch sums the scalars of the shared generators over
the proofs and concatenates the proof-point rows, so B proofs cost one
(2n+2 + B(5+2k))-base MSM.  Sound because each proof draws fresh nonzero
weights (r1, r2) from ``secrets``.

Prover and verifier alike, an MSM is the per-point ladder plus a tree of
adds below ``_fused_msm_min()`` bases and a bucket MSM (``ops/pippenger.py``)
from that size up, the JAX package's routes (``_msm_point`` :177,
``_fused_msm_min`` :112, ``_pippenger_rows`` :124): the signed-bucket
accumulator from ``config.FUSED_ACCUM_MIN`` bases, or with
``config.MSM_ACCUM_KERNEL`` off the sort-plus-scan ``msm_pippenger`` from
``config.FUSED_PIPPENGER_MIN``.  At n = 64 a merged batch of B proofs has
130 + 17 B bases, so from B = 113 it takes the accumulator, or from B = 957
the sort-plus-scan; the prover's MSMs have at most 2n + 1 = 129 bases.
"""
from __future__ import annotations

import functools
import secrets

import numpy as np
import torch

from .. import config
from ..ops import (curve as C, field as F, msm as M, pippenger,
                   scalar_field as SC)
from ..ops.consts import on_device
from ..utils.oracle import ELL
from ..utils.scalars import sc_random
from .device_transcript import DeviceTranscript
from .generators import Generators, get_generators
from .rangeproof import (DOMAIN_Q, DOMAIN_X, DOMAIN_Y, DOMAIN_Z, IPA_DOMAIN,
                         InnerProductProof, ProveError, RangeProof,
                         structure_ok, validate_range_input)


def _unpack_gens(gp: torch.Tensor, n: int):
    """[2n+2, 80] packed generators -> (G [n], H [n], g, h)."""
    return (C.unflatten(gp[:n]), C.unflatten(gp[n:2 * n]),
            C.unflatten(gp[2 * n]), C.unflatten(gp[2 * n + 1]))


def _fused_msm_min() -> int:
    """Base count from which a fused MSM leaves the ladder for a bucket MSM
    (the JAX package's ``_fused_msm_min``): ``config.FUSED_ACCUM_MIN`` with
    the accumulator on, else ``config.FUSED_PIPPENGER_MIN``."""
    return (config.FUSED_ACCUM_MIN if config.MSM_ACCUM_KERNEL
            else config.FUSED_PIPPENGER_MIN)


def _pippenger_rows(points: C.GE, fl: torch.Tensor) -> C.GE:
    """B bucket MSMs: points GE [m] (shared) or [B, m] (per row), fl
    [B, m, 20] field-limb scalars -> GE [B].  Each row is padded to a power
    of two (identity points, zero scalars); then the accumulator (its plan
    ``config.accum_plan`` is one of a few padded sizes) or, with
    ``config.MSM_ACCUM_KERNEL`` off, ``msm_pippenger`` at
    ``config.msm_window_for`` of the padded size."""
    per_row = points.x.dim() == 3
    accum = config.MSM_ACCUM_KERNEL
    outs = []
    for b in range(fl.shape[0]):
        row = C.GE(*(c[b] for c in points)) if per_row else points
        pts_p, fl_p = M._pad_pow2(row, fl[b])
        if accum:
            outs.append(pippenger.msm_accum(pts_p, fl_p))
        else:
            outs.append(pippenger.msm_pippenger(
                pts_p, fl_p, w=config.msm_window_for(fl_p.shape[0])))
    return C.GE(*(torch.stack([o[i] for o in outs]) for i in range(4)))


def _msm_point(points: C.GE, sc: torch.Tensor) -> C.GE:
    """One MSM: points GE [m], sc [m, SL] scalar limbs -> one point.

    From ``_fused_msm_min()`` bases a bucket MSM (``_pippenger_rows``: the
    accumulator, or with it off the sort-plus-scan); below it the ladder
    route, ``curve.scalarmult`` (on the card always its kernel, ge_ladder_win or
    ge_ladder_bin as ``config.LADDER_WINDOW`` says, which is what the JAX
    package's ``_ladder`` :86 ensures there) and a tree of adds."""
    fl = SC.to_field_limbs(sc)
    if fl.shape[0] >= _fused_msm_min():
        return C.GE(*(c[0] for c in _pippenger_rows(points, fl[None])))
    return C.tree_reduce(C.scalarmult(points, fl))


def _scan_mul(init: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Left fold of SC.mul over the rows' dim -3: rows [..., k, m, SL]."""
    for j in range(rows.shape[-3]):
        init = SC.mul(init, rows[..., j, :, :])
    return init


def _msm_compressed(points: C.GE, sc: torch.Tensor) -> torch.Tensor:
    """B MSMs, compressed: points GE [m] (shared) or [B, m] (per row), sc
    [B, m, SL] scalar limbs -> uint8 [B, 32], one batch inversion for the B
    results.  Below ``_fused_msm_min()`` bases the ladder (one
    ``curve.scalarmult`` over [B, m]) and a tree of adds per row; from it
    a bucket MSM (``_pippenger_rows``)."""
    fl = SC.to_field_limbs(sc)                       # [B, m, 20]
    if sc.shape[1] >= _fused_msm_min():
        return C.to_bytes_batch(_pippenger_rows(points, fl))
    acc = C.scalarmult(points, fl)                   # GE [B, m]
    return C.to_bytes_batch(C.tree_reduce(C.GE(*(c.transpose(0, 1)
                                                 for c in acc))))


@functools.lru_cache(maxsize=None)
def _parts_consts(n: int):
    """Host constants of the n-bit verifier: 2^i mod l [n, SL], 2^n - 1
    [SL], and the fold-scalar bit table [k, n] (bit k-1-j of i)."""
    k = n.bit_length() - 1
    two_n = np.stack([SC._int_to_limbs(pow(2, i, ELL), SC.SL)
                      for i in range(n)])
    sum_2 = SC._int_to_limbs(((1 << n) - 1) % ELL, SC.SL)
    bit_tab = np.zeros((k, n), dtype=bool)
    for j in range(k):
        bit_tab[j] = (np.arange(n) >> (k - 1 - j)) & 1
    return two_n, sum_2, bit_tab


def _verify_parts(blobs: torch.Tensor, rnd: torch.Tensor, gp: torch.Tensor,
                  n: int):
    """The verifier minus the final MSM, for B proofs at once.

    blobs: uint8 [B, (npts+5)*32] = [V A S T1 T2 L(k) R(k) | taux mu t_hat
    a b], npts = 5 + 2k; rnd: [B, 2, SL] nonzero weights (r1, r2); gp: packed
    generators [2n+2, 80] (read by the caller's MSM only).  Returns (valid
    [B] bool, scalars [B, 2n+2+npts, SL], decompressed points GE [B, npts]),
    equal to the JAX package's ``_verify_parts_fn(n)`` per proof."""
    k = n.bit_length() - 1
    npts = 5 + 2 * k
    dev = blobs.device
    B = blobs.shape[0]
    two_n, sum_2, bit_tab = (on_device(a, dev) for a in _parts_consts(n))
    pts_bytes = blobs[:, :npts * 32].reshape(B, npts, 32)
    sc5 = SC.from_bytes(blobs[:, npts * 32:].reshape(B, 5, 32))
    taux, mu, t_hat, a_sc, b_sc = sc5.unbind(1)
    r1, r2 = rnd.unbind(1)
    pts, valid = C.from_bytes(pts_bytes)
    valid = valid & ~C.is_small_order(pts)

    tr = DeviceTranscript(b"tpu-bulletproofs/range", batch=(B,), device=dev)
    tr.append(b"n", n.to_bytes(4, "little"))
    tr.append_point(b"V", pts_bytes[:, 0])
    tr.append_point(b"A", pts_bytes[:, 1])
    tr.append_point(b"S", pts_bytes[:, 2])
    y = tr.challenge(DOMAIN_Y)
    z = tr.challenge(DOMAIN_Z)
    tr.append_point(b"T1", pts_bytes[:, 3])
    tr.append_point(b"T2", pts_bytes[:, 4])
    x = tr.challenge(DOMAIN_X)
    tr.append_scalar(b"taux", taux)
    tr.append_scalar(b"mu", mu)
    tr.append_scalar(b"t", t_hat)
    w = tr.challenge(DOMAIN_Q)
    us, us_inv = tr.ipa_challenges(pts_bytes[:, 5:5 + k],
                                   pts_bytes[:, 5 + k:5 + 2 * k], IPA_DOMAIN)

    # fold scalars s_i = prod_j u_j^{+-1}; s_inv = reversed(s)
    pick = torch.where(bit_tab[:, :, None], us[:, :, None, :],
                       us_inv[:, :, None, :])               # [B, k, n, SL]
    s = _scan_mul(SC.ones((B, n), dev), pick)
    s_inv = s.flip(-2)

    z2 = SC.sq(z)
    x2 = SC.sq(x)
    y_n = SC.powers(y, n)
    y_inv_pows = SC.powers(SC.invert(y), n)
    # delta = (z - z^2) <1, y^n> - z^3 <1, 2^n>
    delta = SC.sub(SC.mul(SC.sub(z, z2), SC.sum_mod(y_n, dim=1)),
                   SC.mul(SC.mul(z2, z), sum_2))

    g_sc = SC.mul(SC.add(SC.mul(a_sc[:, None], s), z[:, None]), r2[:, None])
    h_in = SC.sub(SC.mul(SC.mul(b_sc[:, None], s_inv), y_inv_pows),
                  SC.add(z[:, None], SC.mul(SC.mul(z2[:, None], two_n),
                                            y_inv_pows)))
    h_sc = SC.mul(h_in, r2[:, None])
    sc_g = SC.add(SC.mul(r1, SC.sub(t_hat, delta)),
                  SC.mul(r2, SC.mul(SC.sub(SC.mul(a_sc, b_sc), t_hat), w)))
    sc_h = SC.add(SC.mul(r1, taux), SC.mul(r2, mu))
    sc_v = SC.neg(SC.mul(r1, z2))
    sc_a = SC.neg(r2)
    sc_s = SC.neg(SC.mul(r2, x))
    sc_t1 = SC.neg(SC.mul(r1, x))
    sc_t2 = SC.neg(SC.mul(r1, x2))
    uu = torch.cat([us, us_inv], dim=1)                     # [B, 2k, SL]
    lr_sc = SC.neg(SC.mul(r2[:, None], SC.sq(uu)))

    scalars = torch.cat(
        [g_sc, h_sc,
         torch.stack([sc_g, sc_h, sc_v, sc_a, sc_s, sc_t1, sc_t2], dim=1),
         lr_sc], dim=1)
    return valid.all(dim=1), scalars, pts


def _assemble_bases(gp: torch.Tensor, n: int, pts: C.GE) -> C.GE:
    """[G(n) | H(n) | g | h | proof points] in the _verify_parts layout; the
    proof points of a batch are concatenated in proof order."""
    flat = C.GE(*(c.reshape(-1, F.L) for c in pts))
    return M.concat_ge(*_unpack_gens(gp, n), flat)


def _verify_each(blobs: torch.Tensor, rnd: torch.Tensor, gp: torch.Tensor,
                 n: int) -> torch.Tensor:
    """blobs uint8 [B, (npts+5)*32], rnd [B, 2, SL] -> bool [B]: each
    proof's verdict on its own MSM (the JAX package's ``_verify_fn`` body,
    vmapped over the proofs by ``_batch_verify_fn``)."""
    valid, scalars, pts = _verify_parts(blobs, rnd, gp, n)
    res = [C.is_identity(C.mul8(_msm_point(
        _assemble_bases(gp, n, C.GE(*(c[i] for c in pts))), scalars[i])))
        for i in range(blobs.shape[0])]
    return valid & torch.stack(res)


def _verify_one(blob: torch.Tensor, rnd: torch.Tensor, gp: torch.Tensor,
                n: int) -> torch.Tensor:
    """blob uint8 [(npts+5)*32], rnd [2, SL] -> bool tensor."""
    return _verify_each(blob[None], rnd[None], gp, n)[0]


def _batch_verify_merged(blobs: torch.Tensor, rnd: torch.Tensor,
                         gp: torch.Tensor, n: int) -> torch.Tensor:
    """B proofs -> ONE (2n+2 + B*npts)-base MSM."""
    valid, sc, pts = _verify_parts(blobs, rnd, gp, n)
    shared = SC.sum_mod(sc[:, :2 * n + 2], dim=0)          # [2n+2, SL]
    per = sc[:, 2 * n + 2:].reshape(-1, SC.SL)              # [B*npts, SL]
    scal = torch.cat([shared, per])
    res = C.mul8(_msm_point(_assemble_bases(gp, n, pts), scal))
    return valid.all() & C.is_identity(res)


# --- the prover --------------------------------------------------------------
def _ipa_masks(n: int):
    """Per-round fold bookkeeping of the n-element IPA: after round j the
    original index k sits at folded position k mod (n >> j), and its
    high/low side is bit log2(n)-1-j of k.  Per round (h, hi, idx_a, idx_bR,
    idx_bL), as numpy arrays."""
    k = np.arange(n)
    rounds = []
    m = n
    while m > 1:
        h = m // 2
        own = k % m
        hi = own >= h                                # [n] bool
        idx_a = np.where(hi, own - h, own)           # index into a_L / a_R
        idx_bR = np.where(hi, 0, own)                # b_R gather (lo side)
        idx_bL = np.where(hi, own - h, 0)            # b_L gather (hi side)
        rounds.append((h, hi, idx_a, idx_bR, idx_bL))
        m = h
    return rounds


@functools.lru_cache(maxsize=None)
def _ipa_scan_tables(n: int):
    """The rounds' gather tables stacked over the rounds (numpy, [k, ...]),
    for a_vec / b_vec kept at the fixed length n (active prefix, zero
    tail): every round then has the same shapes, and its L / R MSM is
    [2, n+1].  None for n < 2 (no rounds)."""
    rounds = _ipa_masks(n)
    if not rounds:
        return None
    cols = {key: [] for key in ("hi", "act", "shift", "tA_L", "tB_R",
                                "tA_R", "tB_L", "hi_idx", "lo_idx",
                                "bidx")}
    i = np.arange(n)
    for (hsz, hi_mask, idx_a, idx_bR, idx_bL) in rounds:
        hi_idx = np.where(hi_mask)[0]
        lo_idx = np.where(~hi_mask)[0]
        cols["hi"].append(hi_mask)
        cols["act"].append(i < hsz)
        cols["shift"].append(np.where(i < hsz, i + hsz, 0))
        # composed into the full a_vec / b_vec: a_L[j] = a_vec[j],
        # a_R[j] = a_vec[hsz + j], b likewise
        cols["tA_L"].append(idx_a[hi_idx])
        cols["tB_R"].append(hsz + idx_bR[lo_idx])
        cols["tA_R"].append(hsz + idx_a[lo_idx])
        cols["tB_L"].append(idx_bL[hi_idx])
        cols["hi_idx"].append(hi_idx)
        cols["lo_idx"].append(lo_idx)
        cols["bidx"].append(np.stack([
            np.concatenate([hi_idx, n + lo_idx, [2 * n]]),
            np.concatenate([lo_idx, n + hi_idx, [2 * n]])]))
    return {key: np.stack(v) for key, v in cols.items()}


def _ipa_prove_scan(tr: DeviceTranscript, a_vec, b_vec, wG, wH, w, bases,
                    n: int):
    """The prover's IPA rounds over the bases [G | H | g] (with Q = w g
    implicit and the H weights wH): per round the cross terms c_L, c_R,
    the L / R commitment pair as one [2, n+1] MSM, the challenge u, and the
    folds.  a_vec, b_vec [n, SL] fixed length.  Returns (a_vec, b_vec,
    uint8 [2k, 32] = L(k) R(k))."""
    tabs = _ipa_scan_tables(n)
    dev = a_vec.device
    if tabs is None:
        return a_vec, b_vec, torch.zeros((0, 32), dtype=torch.uint8,
                                         device=dev)
    t = {key: on_device(v, dev) for key, v in tabs.items()}
    Ls, Rs = [], []
    for j in range(t["hi"].shape[0]):
        act = t["act"][j][:, None]
        aLf = torch.where(act, a_vec, 0)
        aRf = torch.where(act, a_vec[t["shift"][j]], 0)
        bLf = torch.where(act, b_vec, 0)
        bRf = torch.where(act, b_vec[t["shift"][j]], 0)
        c_L = SC.inner(aLf, bRf)
        c_R = SC.inner(aRf, bLf)
        hi_idx, lo_idx = t["hi_idx"][j], t["lo_idx"][j]
        scL = torch.cat([SC.mul(a_vec[t["tA_L"][j]], wG[hi_idx]),
                         SC.mul(b_vec[t["tB_R"][j]], wH[lo_idx]),
                         SC.mul(c_L, w)[None]])
        scR = torch.cat([SC.mul(a_vec[t["tA_R"][j]], wG[lo_idx]),
                         SC.mul(b_vec[t["tB_L"][j]], wH[hi_idx]),
                         SC.mul(c_R, w)[None]])
        bases_lr = C.GE(*(c[t["bidx"][j]] for c in bases))   # [2, n+1]
        lr = _msm_compressed(bases_lr, torch.stack([scL, scR]))
        tr.append_point(b"ipL", lr[0])
        tr.append_point(b"ipR", lr[1])
        u = tr.challenge(IPA_DOMAIN)
        u_inv = SC.invert(u)
        a_vec = torch.where(act, SC.add(SC.mul(aLf, u), SC.mul(aRf, u_inv)), 0)
        b_vec = torch.where(act, SC.add(SC.mul(bLf, u_inv), SC.mul(bRf, u)), 0)
        hi_m = t["hi"][j][:, None]
        wG = torch.where(hi_m, SC.mul(wG, u), SC.mul(wG, u_inv))
        wH = torch.where(hi_m, SC.mul(wH, u_inv), SC.mul(wH, u))
        Ls.append(lr[0])
        Rs.append(lr[1])
    return a_vec, b_vec, torch.stack(Ls + Rs)


def _prove(gp: torch.Tensor, aL_bits: torch.Tensor, scp: torch.Tensor,
           n: int) -> torch.Tensor:
    """The n-bit prover, the body of the JAX package's ``_prove_fn(n)``.

    gp: packed generators [2n+2, 80]; aL_bits: [n] int32, the value's bits;
    scp: [2n+6, SL] = [value, blinding, alpha, rho, tau1, tau2, sL(n),
    sR(n)].  Returns uint8 [5 + 2k + 5, 32] = V A S T1 T2 | L(k) R(k) |
    taux mu t_hat a b.  Static shapes and no host sync."""
    dev = gp.device
    G, H, g, h = _unpack_gens(gp, n)
    value_sc, blinding, alpha, rho, tau1, tau2 = scp[:6].unbind(0)
    sL, sR = scp[6:6 + n], scp[6 + n:6 + 2 * n]
    tr = DeviceTranscript(b"tpu-bulletproofs/range", device=dev)
    tr.append(b"n", n.to_bytes(4, "little"))

    # aL in scalar-limb form; aR = aL - 1 (mod l)
    aL = SC.zeros((n,), dev)
    aL[:, 0] = aL_bits
    aR = SC.sub(aL, SC.ones((n,), dev))

    # V = value g + blinding h; A = alpha h + <aL, G> + <aR, H>;
    # S = rho h + <sL, G> + <sR, H>
    gh = M.concat_ge(g, h)
    v_b = _msm_compressed(gh, torch.stack([value_sc, blinding])[None])[0]
    as_b = _msm_compressed(M.concat_ge(h, G, H), torch.stack([
        torch.cat([alpha[None], aL, aR]), torch.cat([rho[None], sL, sR])]))
    tr.append_point(b"V", v_b)
    tr.append_point(b"A", as_b[0])
    tr.append_point(b"S", as_b[1])
    y = tr.challenge(DOMAIN_Y)
    z = tr.challenge(DOMAIN_Z)

    two_n = on_device(_parts_consts(n)[0], dev)
    y_n = SC.powers(y, n)
    z2 = SC.sq(z)
    l0 = SC.sub(aL, z[None])
    l1 = sL
    r0 = SC.add(SC.mul(y_n, SC.add(aR, z[None])), SC.mul(two_n, z2[None]))
    r1 = SC.mul(y_n, sR)
    t0 = SC.inner(l0, r0)
    t2 = SC.inner(l1, r1)
    t1 = SC.sub(SC.inner(SC.add(l0, l1), SC.add(r0, r1)), SC.add(t0, t2))

    t_b = _msm_compressed(gh, torch.stack([torch.stack([t1, tau1]),
                                           torch.stack([t2, tau2])]))
    tr.append_point(b"T1", t_b[0])
    tr.append_point(b"T2", t_b[1])
    x = tr.challenge(DOMAIN_X)

    l_vec = SC.add(l0, SC.mul(l1, x[None]))
    r_vec = SC.add(r0, SC.mul(r1, x[None]))
    t_hat = SC.inner(l_vec, r_vec)
    taux = SC.add(SC.add(SC.mul(tau2, SC.sq(x)), SC.mul(tau1, x)),
                  SC.mul(z2, blinding))
    mu = SC.add(alpha, SC.mul(rho, x))
    tr.append_scalar(b"taux", taux)
    tr.append_scalar(b"mu", mu)
    tr.append_scalar(b"t", t_hat)
    w = tr.challenge(DOMAIN_Q)

    # the IPA over (G, H' = y^-i H) with Q = w g implicit
    wH = SC.powers(SC.invert(y), n)
    wG = SC.ones((n,), dev)
    a_vec, b_vec, lr = _ipa_prove_scan(tr, l_vec, r_vec, wG, wH, w,
                                       M.concat_ge(G, H, g), n)
    scalars = SC.to_bytes(torch.stack([taux, mu, t_hat, a_vec[0], b_vec[0]]))
    return torch.cat([v_b[None], as_b, t_b, lr, scalars])


def prove(value: int, blinding: int, n: int, gens: Generators | None = None,
          device="cuda") -> RangeProof:
    """Prove value in [0, 2^n) under the commitment value g + blinding h.
    Runs on `gens.device`, else on `device` (the card unless the caller
    asks for the CPU); the nonces and blinding vectors come from
    ``secrets``.  Raises ProveError for a value out of range or an n that is
    not a power of two."""
    if not validate_range_input(value, n):
        raise ProveError(f"value out of range [0, 2^{n})")
    if n < 1 or n & (n - 1) != 0:
        raise ProveError("n must be a power of two")
    gens = gens or get_generators(n, device)
    dev = gens.device
    aL_bits = torch.tensor([(value >> i) & 1 for i in range(n)],
                           dtype=torch.int32, device=dev)
    scp = SC.from_ints([value, blinding % ELL]
                       + [sc_random() for _ in range(4 + 2 * n)], dev)
    return _blob_proof(_prove(gens.pack(n), aL_bits, scp, n).cpu().numpy(),
                       n)


def _blob_proof(blob: np.ndarray, n: int) -> RangeProof:
    """The prover's uint8 [5 + 2k + 5, 32] blob as a RangeProof."""
    k = n.bit_length() - 1
    rows = [bytes(r) for r in blob]
    taux, mu, t_hat, a, b = (int.from_bytes(r, "little")
                             for r in rows[5 + 2 * k:])
    return RangeProof(n=n, V=rows[0], A=rows[1], S=rows[2], T1=rows[3],
                      T2=rows[4], taux=taux, mu=mu, t_hat=t_hat,
                      ip=InnerProductProof(n=n, L=rows[5:5 + k],
                                           R=rows[5 + k:5 + 2 * k], a=a, b=b))


# --- the verifier ------------------------------------------------------------
def _proof_blob(proof: RangeProof) -> np.ndarray:
    """uint8: point bytes then canonical scalar bytes."""
    parts = [proof.V, proof.A, proof.S, proof.T1, proof.T2] + \
        list(proof.ip.L) + list(proof.ip.R) + \
        [(v % ELL).to_bytes(32, "little") for v in
         (proof.taux, proof.mu, proof.t_hat, proof.ip.a, proof.ip.b)]
    return np.frombuffer(b"".join(bytes(b) for b in parts), dtype=np.uint8)


def _rlc_weights(rnd, count: int, device) -> torch.Tensor:
    """[count, 2, SL] random-linear-combination weights: from `rnd` (two
    nonzero ints mod l per proof, in proof order) or fresh from `secrets`."""
    if rnd is None:
        ints = [secrets.randbelow(ELL - 1) + 1 for _ in range(2 * count)]
    else:
        ints = [int(r) for r in rnd]
        if len(ints) != 2 * count or any(r % ELL == 0 for r in ints):
            raise ValueError(f"rnd needs {2 * count} nonzero weights mod l")
    return SC.from_ints(ints, device).reshape(count, 2, SC.SL)


def verify(proof: RangeProof, gens: Generators | None = None, rnd=None,
           device="cuda") -> bool:
    """Verify one range proof.  The work runs on `gens.device`, else on
    `device` (the card unless the caller asks for the CPU); rnd: optional
    explicit weights (r1, r2), else `secrets`."""
    if not (structure_ok(proof)
            and (gens is None or gens.n >= proof.n)):
        return False
    gens = gens or get_generators(proof.n, device)
    blob = torch.from_numpy(_proof_blob(proof).copy()).to(gens.device)
    weights = _rlc_weights(rnd, 1, gens.device)[0]
    return bool(_verify_one(blob, weights, gens.pack(proof.n), proof.n))


def batch_verify(proofs, gens: Generators | None = None, merged: bool = True,
                 rnd=None, device="cuda") -> bool:
    """Verify same-size proofs (each keeps its own challenge stream and
    weights), on `gens.device`, else on `device`.  merged=True (default):
    ONE merged MSM for the batch; merged=False: each proof its own MSM, the
    AND of the verdicts (the JAX package's vmapped verifier).  rnd:
    optional 2 weights per proof."""
    if not proofs:
        return True
    n = proofs[0].n
    gens_n = gens.n if gens is not None else n
    if gens_n < n or any(p.n != n or not structure_ok(p) for p in proofs):
        return False
    gens = gens or get_generators(n, device)
    blobs = torch.from_numpy(np.stack([_proof_blob(p) for p in proofs]))
    blobs = blobs.to(gens.device)
    weights = _rlc_weights(rnd, len(proofs), gens.device)
    if not merged:
        return bool(_verify_each(blobs, weights, gens.pack(n), n).all())
    return bool(_batch_verify_merged(blobs, weights, gens.pack(n), n))
