"""Plain twins of the JAX package's diagnostic microbenchmark kernels, in
the port's row layout, and their dispatch.

    chain         <- benchmarks/bench_addrate.py::chain_kernel (:100)
    accum_window  <- benchmarks/_accum_micro.py::kernel (:30) and
                     benchmarks/_repro_accum3.py::kernel (:22)

No proof path runs them: they measure the group law's rate and the cost of
the bucket select.  On a CUDA tensor each runs its hand-written kernel
(``ops/cuda_micro.py``: ge_add_chain, ge_accum_window), on a CPU tensor its
twin (``chain_plain``, ``accum_window_plain``).

**The chain** (``bench_addrate.make_ops`` :44-98).  Its field ops take
tunable carry-relaxation passes: ``fmul`` is the Pallas ``_conv`` and
``_fold_wide`` followed by ``mul_passes`` relaxations, ``fsq`` the script's
symmetric square, ``fadd`` / ``fsub`` (``a + (K - b)``) ``add_passes``
relaxations; ``padd_p`` and ``pdbl_p`` the group law on [..., 80] rows in
the script's op order, ``zz2 = relax(fsq(z) * 2, add_passes)``.  With fewer
passes than the proven three, limbs outgrow int32 and the JAX package
wraps them; so the twins do every limb product and sum modulo 2^32 (in
int64, wrapped back to int32) and only the carry shift acts on the signed
value, as ``>>`` on int32 does.  The timing-only pairs then still equal the
JAX limbs.  The symmetric square equals ``fmul(a, a)`` modulo 2^32 (its
doubled cross terms are the same sums), so ``fsq`` is that.

**The window** (the union of both scripts' variants).  A window of the
signed-digit bucket accumulator: per window ``nb`` buckets from the
identity; for each step j and unroll slot u the digit d picks bucket |d|
and adds the point ``pt[j, u]`` (y+x | y-x | 2dt | -2dt, the sign a row
swap) with the mixed add (``pippenger.madd_plain``, the Pallas ``_madd``);
then the suffix fold ``suf += b[k]; tot += suf`` for k = nb - 1 .. 1
(``curve.add_plain``, the Pallas ``_padd``) and the halving tree over the
lanes, lane i with lane i + half, the odd lane dropped as the script's
``total[:, :half] + total[:, half:m]`` drops it.  Point limbs are not
canonical, so that order is kept.  Variants:

    full      the step above (the select picks b[|d|], b[1] when |d| < 2)
    nosel     every slot adds into b[1]
    noadd     the select and write-back without the add
    cached    full with a select across every bucket (same limbs)
    tree      full with a log-depth select (same limbs)
    init_loop full; the scripts' bucket init as a loop (same limbs)
    fori      full; the fold as a fori_loop (same limbs)
    nostep    no step: the buckets stay the identity
    nosign    the digit is used as it is (a negative one picks no bucket)
    padd      the unified add of (y+x, y-x, 2dt, 2dt) as a point
    nofold    the output is b[1] of every lane
    halvonly  the halving tree over b[1], no fold
    sufonly   the output is the fold's total of every lane

``pt`` is [steps, unroll, lanes, 80], ``dg`` [nw, steps, unroll, lanes];
the result is [nw, 80] (lane 0 of the JAX output; its other lanes are zero
padding), or [nw, lanes, 80] for ``nofold`` and ``sufonly``, whose JAX
output keeps every lane.  ``rows_from_lanes`` / ``lanes_from_rows`` convert
the JAX ``[..., 80, lanes]`` blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_micro, curve as C, field as F, pippenger as PP
from .consts import on_device
from .cuda_micro import (ACCUM_VARIANTS, CHAIN_OPS, LANE_VARIANTS,  # noqa: F401
                         PASS_PAIRS, REPRO_VARIANTS, ROW, VARIANTS,
                         check_chain_args, check_window_args)

L = F.L
_U32 = 1 << 32


def nb_for(w: int) -> int:
    """Buckets of a w-bit signed window, 0 .. 2^(w-1)."""
    return (1 << (w - 1)) + 1


# --- layout -------------------------------------------------------------------
def rows_from_lanes(block) -> torch.Tensor:
    """JAX [..., 80, lanes] block -> port [..., lanes, 80] rows."""
    t = torch.as_tensor(np.asarray(block)) if not isinstance(
        block, torch.Tensor) else block
    return t.transpose(-1, -2).contiguous()


def lanes_from_rows(rows: torch.Tensor) -> np.ndarray:
    """Port [..., lanes, 80] rows -> JAX [..., 80, lanes] block."""
    return rows.transpose(-1, -2).contiguous().cpu().numpy()


def window_from_jax(out, variant: str) -> torch.Tensor:
    """The JAX window output [nw, 80, lanes] in the port's form: lane 0
    [nw, 80], or every lane [nw, lanes, 80] for the lane variants."""
    rows = rows_from_lanes(out)
    return rows if variant in LANE_VARIANTS else rows[:, 0].contiguous()


# --- field ops with tunable passes, modulo 2^32 -----------------------------
def _wrap(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement)."""
    return (((t + (1 << 31)) % _U32) - (1 << 31)).to(torch.int32)


def relax(t: torch.Tensor, passes: int) -> torch.Tensor:
    """`passes` parallel relaxations (``pallas_field._carry_relax``); exact
    in int32 for any int32 limbs (a carry is below 2^18 in size)."""
    return F._relax(t, passes)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 39 coefficients of the 20x20 limb convolution, each product and
    each sum modulo 2^32, as int64 values of int32 range."""
    prod = _wrap(a.long().unsqueeze(-1) * b.long().unsqueeze(-2)).long()
    batch = prod.shape[:-2]
    skew = torch.nn.functional.pad(prod, (0, L)).reshape(*batch, L * 2 * L)
    skew = skew[..., : L * (2 * L - 1)].reshape(*batch, L, 2 * L - 1)
    return _wrap(skew.sum(dim=-2)).long()


def _fold_wide(c: torch.Tensor) -> torch.Tensor:
    """``_fold_wide``: coefficient 20 + j adds 608 x its low 13 bits to limb
    j and 608 x the rest (a signed shift) to limb j + 1, modulo 2^32."""
    top, main = c[..., L:], c[..., :L]
    pad = torch.nn.functional.pad
    acc = (main + pad(F.FOLD * (top & F.MASK), (0, 1))
           + pad(F.FOLD * (top >> F.W), (1, 0)))
    return _wrap(acc)


def fmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    return relax(_fold_wide(_conv(a, b)), passes)


def fsq(a: torch.Tensor, passes: int) -> torch.Tensor:
    """The script's symmetric square: the same coefficients modulo 2^32 as
    the full product."""
    return fmul(a, a, passes)


def fadd(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    return relax(_wrap(a.long() + b.long()), passes)


def fsub(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    k = on_device(F._K_NEG, b.device).long()
    return relax(_wrap(a.long() + (k - b.long())), passes)


def padd_p(p: torch.Tensor, q: torch.Tensor, mp: int, ap: int) -> torch.Tensor:
    """The script's ``padd`` on [..., 80] rows (add-2008-hwcd-3, a = -1)."""
    x1, y1, z1, t1 = p.split(L, dim=-1)
    x2, y2, z2, t2 = q.split(L, dim=-1)
    d2 = on_device(C._D2_LIMBS, p.device)
    a = fmul(fsub(y1, x1, ap), fsub(y2, x2, ap), mp)
    b = fmul(fadd(y1, x1, ap), fadd(y2, x2, ap), mp)
    c = fmul(fmul(t1, d2, mp), t2, mp)
    zz = fmul(z1, z2, mp)
    d = fadd(zz, zz, ap)
    return torch.cat([fmul(fsub(b, a, ap), fsub(d, c, ap), mp),
                      fmul(fadd(d, c, ap), fadd(b, a, ap), mp),
                      fmul(fsub(d, c, ap), fadd(d, c, ap), mp),
                      fmul(fsub(b, a, ap), fadd(b, a, ap), mp)], dim=-1)


def pdbl_p(p: torch.Tensor, mp: int, ap: int) -> torch.Tensor:
    """The script's ``pdbl`` on [..., 80] rows (t is not read)."""
    x, y, z, _ = p.split(L, dim=-1)
    xx = fsq(x, mp)
    yy = fsq(y, mp)
    zz2 = relax(_wrap(fsq(z, mp).long() * 2), ap)
    xy2 = fsub(fsq(fadd(x, y, ap), mp), fadd(xx, yy, ap), ap)
    yp = fadd(yy, xx, ap)
    zp = fsub(yy, xx, ap)
    tp = fsub(zz2, zp, ap)
    return torch.cat([fmul(xy2, tp, mp), fmul(yp, zp, mp), fmul(zp, tp, mp),
                      fmul(xy2, yp, mp)], dim=-1)


def chain_plain(p: torch.Tensor, op: str, k: int, mul_passes: int = 5,
                add_passes: int = 2) -> torch.Tensor:
    """Plain twin of ge_add_chain: from acc = p, `k` times acc <- acc + p
    (op ``add``) or acc <- 2 acc (``dbl``); p [..., 80]."""
    check_chain_args(op, mul_passes, add_passes)
    acc = p
    for _ in range(k):
        acc = (padd_p(acc, p, mul_passes, add_passes) if op == "add"
               else pdbl_p(acc, mul_passes, add_passes))
    return acc.clone() if k == 0 else acc


def chain(p: torch.Tensor, op: str, k: int, mul_passes: int = 5,
          add_passes: int = 2) -> torch.Tensor:
    """`k` chained adds of p (or doublings) per row, one launch on the
    card."""
    if p.device.type == "cpu":
        return chain_plain(p, op, k, mul_passes, add_passes)
    return cuda_micro.chain(p, op, k, mul_passes, add_passes)


# --- the window -------------------------------------------------------------
def _ge(rows: torch.Tensor) -> C.GE:
    return C.GE(*rows.split(L, dim=-1))


def accum_window_plain(pt: torch.Tensor, dg: torch.Tensor, variant: str,
                       nb: int) -> torch.Tensor:
    """Plain twin of ge_accum_window (see the module docstring)."""
    check_window_args(pt, dg, variant, nb)
    nw, steps, unroll, lanes = dg.shape
    dev = pt.device
    ident = C.flatten(C.identity((nw, lanes), dev))
    sacc = ident.unsqueeze(1).expand(nw, nb, lanes, ROW).clone()
    bucket = torch.arange(nb, device=dev).view(1, nb, 1)
    for j in range(steps if variant != "nostep" else 0):
        for u in range(unroll):
            d = dg[:, j, u].long()                          # [nw, lanes]
            q = pt[j, u].expand(nw, lanes, ROW)
            if variant == "nosign":
                m = d
                ypx, ymx, td2 = q[..., :L], q[..., L:2 * L], q[..., 2 * L:3 * L]
            else:
                neg = (d < 0).unsqueeze(-1)
                m = d.abs()
                ypx = torch.where(neg, q[..., L:2 * L], q[..., :L])
                ymx = torch.where(neg, q[..., :L], q[..., L:2 * L])
                td2 = torch.where(neg, q[..., 3 * L:], q[..., 2 * L:3 * L])
            if variant == "nosel":
                sacc[:, 1] = C.flatten(PP.madd_plain(_ge(sacc[:, 1]), ypx,
                                                     ymx, td2))
                continue
            src = torch.where((m >= 2) & (m < nb), m, torch.ones_like(m))
            sel = torch.gather(sacc, 1, src.view(nw, 1, lanes, 1).expand(
                nw, 1, lanes, ROW)).squeeze(1)
            if variant == "noadd":
                added = sel
            elif variant == "padd":
                added = C.flatten(C.add_plain(_ge(sel),
                                              C.GE(ypx, ymx, td2, td2)))
            else:
                added = C.flatten(PP.madd_plain(_ge(sel), ypx, ymx, td2))
            hit = (m.unsqueeze(1) == bucket) & (bucket >= 1)
            sacc = torch.where(hit.unsqueeze(-1), added.unsqueeze(1), sacc)
    if variant == "nofold":
        return sacc[:, 1].contiguous()
    if variant == "halvonly":
        total = sacc[:, 1]
    else:
        suf = tot = ident
        for b in range(nb - 1, 0, -1):
            suf = C.flatten(C.add_plain(_ge(suf), _ge(sacc[:, b])))
            tot = C.flatten(C.add_plain(_ge(tot), _ge(suf)))
        total = tot
    if variant == "sufonly":
        return total.contiguous()
    m = lanes
    while m > 1:
        half = m // 2
        total = C.flatten(C.add_plain(_ge(total[:, :half]),
                                      _ge(total[:, half:2 * half])))
        m = half
    return total[:, 0].contiguous()


def accum_window(pt: torch.Tensor, dg: torch.Tensor, variant: str,
                 nb: int) -> torch.Tensor:
    """One window pass of every digit row, one launch on the card."""
    if pt.device.type == "cpu" and dg.device.type == "cpu":
        return accum_window_plain(pt, dg, variant, nb)
    return cuda_micro.accum_window(pt, dg, variant, nb)
