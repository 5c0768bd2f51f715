"""Multi-scalar multiplication routed by size, the counterpart of
``cudabulletproof_tpu/ops/msm.py`` (``_pad_pow2`` :40, ``msm_windowed``
:54, ``msm_auto`` :84, ``msm_ints`` :142, ``msm_multi_compressed`` :156,
``msm_ints_multi`` :180, ``concat_ge`` :199).

``msm_auto`` takes the JAX package's TPU routes: up to
``config.MSM_LADDER_MAX`` points the windowed ladder plus the tile reduction
(the ge_ladder_win and ge_reduce kernels), below
``config.MSM_PIPPENGER_MIN`` Straus over the ge_add / ge_double kernels,
from it a bucket MSM.  With ``config.MSM_ACCUM_KERNEL`` on (the default)
that is the signed-bucket accumulator (``pippenger.msm_accum``), chunked
above ``config.MSM_ACCUM_CHUNK`` points; with it off the sort-plus-scan
``pippenger.msm_pippenger`` at ``config.msm_window_for(n)`` bits, chunked
above ``config.MSM_CHUNK`` points at the chunk's window.  Chunk results are
folded by ``curve.tree_reduce``.  It runs on the device of its inputs: the
kernels on CUDA tensors, their plain twins on CPU tensors.

``msm_ints`` and ``msm_ints_multi`` are the host-transcript protocol's
MSMs: Python-int scalars mod l, identity points and zero scalars padded to
a power of two of at least 64 (the JAX package's ``pad_min``, which keeps
its compiled shapes few; here it keeps the launch shapes the same).
``msm_ints_multi`` runs B MSMs over shared bases as one ``[B, m]`` ladder
(``curve.scalarmult``), a halving tree of adds and one batch compression.
"""
from __future__ import annotations

import torch

from .. import config
from . import curve as C, field as F, pippenger


def _pad_pow2(points: C.GE, scalars: torch.Tensor, pad_min: int = 1):
    """Identity points and zero scalars up to a power of two >= pad_min."""
    n = scalars.shape[0]
    m = max(1, pad_min)
    while m < n:
        m *= 2
    if m == n:
        return points, scalars
    pad_p = C.identity((m - n,), scalars.device)
    points = C.GE(*(torch.cat([a, b]) for a, b in zip(points, pad_p)))
    pad_s = torch.zeros((m - n, F.L), dtype=F.DTYPE, device=scalars.device)
    return points, torch.cat([scalars, pad_s])


def msm_windowed(points: C.GE, scalars: torch.Tensor,
                 w: int = config.STRAUS_WINDOW) -> C.GE:
    """Straus: per-point tables T[d] = d P_i (2^w - 1 batched adds), then
    acc = 2^w acc + sum_i T[digit_i, i] over the windows from the top."""
    n = points.x.shape[0]
    dev = scalars.device
    tab = [C.identity((n,), dev)]
    for _ in range(1, 1 << w):
        tab.append(C.add(tab[-1], points))
    table = torch.stack([C.flatten(t) for t in tab])        # [2^w, n, 80]
    digits = pippenger.extract_digits(scalars, w).long()    # [nw, n]
    lane = torch.arange(n, device=dev)
    acc = C.identity((), dev)
    for dig in digits.flip(0):
        for _ in range(w):
            acc = C.double(acc)
        acc = C.add(acc, C.tree_reduce(C.unflatten(table[dig, lane])))
    return acc


def _chunked(points: C.GE, scalars: torch.Tensor, ck: int, msm) -> C.GE:
    """msm over chunks of ck points (the last padded to ck), the chunk
    results folded by ``curve.tree_reduce``."""
    n = scalars.shape[0]
    parts = []
    for off in range(0, n, ck):
        end = min(off + ck, n)
        p = C.GE(*(c[off:end] for c in points))
        s = scalars[off:end]
        if end - off < ck:
            p, s = _pad_pow2(p, s, pad_min=ck)
        parts.append(msm(p, s))
    return C.tree_reduce(C.GE(*(torch.stack([pt[i] for pt in parts])
                                for i in range(4))))


def msm_auto(points: C.GE, scalars: torch.Tensor) -> C.GE:
    """sum_i scalars[i] * points[i], routed by size (and
    ``config.MSM_ACCUM_KERNEL``, read at call time).  points: GE [n];
    scalars: int32 [n, 20] radix-2^13 limbs (< 2^253).  Returns one GE."""
    n = scalars.shape[0]
    if n <= config.MSM_LADDER_MAX:
        return C.tree_reduce_tiles(C.scalarmult(points, scalars))
    if n < config.MSM_PIPPENGER_MIN:
        return msm_windowed(points, scalars)
    if config.MSM_ACCUM_KERNEL:
        if n <= config.MSM_ACCUM_CHUNK:
            return pippenger.msm_accum(points, scalars)
        return _chunked(points, scalars, config.MSM_ACCUM_CHUNK,
                        pippenger.msm_accum)
    if n <= config.MSM_CHUNK:
        return pippenger.msm_pippenger(points, scalars,
                                       w=config.msm_window_for(n))
    w = config.msm_window_for(config.MSM_CHUNK)
    return _chunked(points, scalars, config.MSM_CHUNK,
                    lambda p, s: pippenger.msm_pippenger(p, s, w=w))


def concat_ge(*parts: C.GE) -> C.GE:
    """Concatenate GE groups along the batch axis (an unbatched point counts
    as one row): builds MSM bases."""
    return C.GE(*(torch.cat([p[i] if p[i].dim() == 2 else p[i][None]
                             for p in parts]) for i in range(4)))


def _scalar_limbs(scalars, device) -> torch.Tensor:
    """Python-int scalars -> [m, 20] limbs.  Each is taken mod p, as the
    JAX package does, and must then be below 2^253: the protocol passes
    scalars mod l, and the ladders of the JAX package read 253 bits."""
    vals = [s % F.P for s in scalars]
    if any(v >> 253 for v in vals):
        raise ValueError("an MSM scalar is 2^253 or more (pass scalars mod l)")
    return F.from_ints(vals, device)


def msm_ints(points: C.GE, scalars, pad_min: int = 64) -> C.GE:
    """sum_i scalars[i] * points[i] for Python-int scalars (mod l), padded to
    a power of two >= pad_min, on the device of the points.  Returns one GE."""
    if points.x.shape[0] != len(scalars):
        raise ValueError(f"{points.x.shape[0]} points, {len(scalars)} scalars")
    p, s = _pad_pow2(points, _scalar_limbs(scalars, points.x.device), pad_min)
    return msm_auto(p, s)


def msm_multi_compressed(points: C.GE, scalars: torch.Tensor) -> torch.Tensor:
    """B MSMs over the same bases, compressed: points GE [m] (m a power of
    two), scalars [B, m, 20] -> uint8 [B, 32].  One ladder over [B, m]
    (ge_ladder_win or ge_ladder_bin on the card), log2(m) halvings of the
    low half plus the high half (ge_add), one batch inversion for the B
    results."""
    B, m = scalars.shape[0], scalars.shape[1]
    pb = C.GE(*(c.expand(B, m, F.L) for c in points))
    acc = C.scalarmult(pb, scalars)                       # GE [B, m]
    while m > 1:
        half = m // 2
        acc = C.add(C.GE(*(c[:, :half] for c in acc)),
                    C.GE(*(c[:, half:m] for c in acc)))
        m = half
    return C.to_bytes_batch(C.GE(*(c[:, 0] for c in acc)))


def msm_ints_multi(points: C.GE, scalar_lists, pad_min: int = 64) -> list:
    """k Python-int scalar lists over shared bases -> k compressed points
    (bytes), with one copy to the host."""
    m = points.x.shape[0]
    if any(len(sl) != m for sl in scalar_lists):
        raise ValueError(f"every scalar list needs {m} scalars")
    sc = torch.stack([_scalar_limbs(sl, points.x.device)
                      for sl in scalar_lists])                  # [k, m, 20]
    pts, _ = _pad_pow2(points, sc[0], pad_min)
    sc = torch.nn.functional.pad(sc, (0, 0, 0, pts.x.shape[0] - m))
    out = msm_multi_compressed(pts, sc).cpu().numpy()
    return [bytes(row.tolist()) for row in out]
