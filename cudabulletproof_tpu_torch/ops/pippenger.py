"""The bucket-method MSMs (Pippenger) in PyTorch: the signed-bucket
accumulator and the sort-plus-scan ``msm_pippenger``.

Counterpart of ``cudabulletproof_tpu/ops/pippenger.py``.

The accumulator route (``num_windows`` :37, ``extract_digits`` :41,
``extract_digits_signed`` :56, ``madd_precomp`` :80, ``_msm_accum`` :412,
``msm_accum`` :454).  The digits and the precomputed operands are made as
the JAX package makes them; the bucket pass, the weighted fold, the window
sums and the Horner combine run in the hand-written ge_bucket_accum kernel
on the card (``csrc/accum_kernels.cu``) and in its plain twin
``bucket_accum_plain`` on the CPU.  The twin follows the kernel's fixed
summation order, so the two agree limb for limb; the JAX kernel sums in
its own order, so against it the results agree as points.

The sort-plus-scan route (``_seg_combine`` :126, ``_bucket_suffix_fold``
:256, ``_bucket_window_chunked`` :282, ``_digit_order`` :360,
``_bucket_window`` :373, ``_horner_windows`` :400, ``msm_pippenger`` :472;
``_unflat`` :250 is ``curve.unflatten``).  Per w-bit window: group the
points by digit (a stable ``torch.argsort``, or under
``config.MSM_PALLAS_SORT`` the counting sort ``sort.grouping_order``), scan
each digit's run with the curve add (the ge_seg_scan kernel: lane l scans
the sorted points [l * depth, (l + 1) * depth), then a carry across lanes,
applied at each lane's first segment tail), scatter the run totals into
the bucket table, and fold sum_b b * S_b (the ge_bucket_fold kernel); then
Horner over the windows.  Both kernels' plain twins, ``seg_scan_plain``
and ``bucket_fold_plain``, take the Pallas functions' layouts and op order
(``pallas_curve.seg_scan`` :281, ``bucket_fold`` :417, with
``_lane_scan_incl`` :344), so kernel, twin and Pallas kernel agree limb for
limb.  The JAX package runs the Pallas kernels only on the TPU; the port
always runs them (the kernel on a CUDA tensor, the twin on a CPU one),
whatever the device, as its ``MSM_PALLAS_SCAN`` would on the TPU.  An MSM
too small to chunk (n < 2 lanes, or n not a multiple of the lanes) scans
unchunked, by log-depth halving over ``curve.add``, the JAX package's
``associative_scan`` route; its limbs differ from the JAX package's, its
points do not.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from . import cuda_curve, curve as C, field as F, sort
from .consts import on_device

SC_BITS = 253


def num_windows(w: int) -> int:
    return -(-SC_BITS // w)


def extract_digits(scalars: torch.Tensor, w: int) -> torch.Tensor:
    """[n, 20] 13-bit limbs -> [num_windows(w), n] w-bit digits (int32),
    least significant window first."""
    if not 1 <= w <= F.W:
        raise ValueError(f"window width {w} outside 1..{F.W}")
    start = np.arange(num_windows(w)) * w
    i0 = start // F.W
    off = (start % F.W).astype(np.int32)
    dev = scalars.device
    sp = torch.nn.functional.pad(scalars, (0, 1))     # limb 20 reads as 0
    lo = sp[:, torch.from_numpy(i0).to(dev)] >> torch.from_numpy(off).to(dev)
    hi = sp[:, torch.from_numpy(i0 + 1).to(dev)] << torch.from_numpy(
        F.W - off).to(dev)
    return ((lo | hi) & ((1 << w) - 1)).T.contiguous()


def extract_digits_signed(scalars: torch.Tensor, w: int) -> torch.Tensor:
    """[n, 20] limbs -> [nw', n] SIGNED digits in [-2^(w-1), 2^(w-1)], least
    significant window first, with sum_j d_j 2^(w j) equal to the scalar: a
    digit above 2^(w-1) borrows 2^w from the next window.  When w * nw < 254
    the last carry may be nonzero for scalars near 2^253, and is appended as
    one extra 0/1 row."""
    raw = extract_digits(scalars, w)
    half, full = 1 << (w - 1), 1 << w
    carry = torch.zeros_like(raw[0])
    rows = []
    for d in raw:
        d = d + carry
        carry = (d > half).to(d.dtype)
        rows.append(d - carry * full)
    if w * num_windows(w) < 254:
        rows.append(carry)
    return torch.stack(rows)


def madd_precomp(points: C.GE) -> torch.Tensor:
    """GE [n] -> [n, 80] mixed-add operands (y+x | y-x | 2d*t | -2d*t) with
    Z normalized to 1 by one batch inversion: the kernel's add takes 7
    multiplies instead of 9, and negating an operand is a row swap."""
    aff = C.normalize_batch(points)
    td2 = F.mul(aff.t, on_device(C._D2_LIMBS, aff.t.device))
    return torch.cat([F.add(aff.y, aff.x), F.sub(aff.y, aff.x), td2,
                      F.neg(td2)], dim=-1)


def madd_plain(p: C.GE, ypx2: torch.Tensor, ymx2: torch.Tensor,
               td2: torch.Tensor) -> C.GE:
    """The kernel's mixed add (``ge_madd``, the op order of the JAX
    package's ``pallas_curve._madd``): extended p plus a Z = 1 operand."""
    a = F.mul_plain(F.sub(p.y, p.x), ymx2)
    b = F.mul_plain(F.add(p.y, p.x), ypx2)
    c = F.mul_plain(p.t, td2)
    d = F.add(p.z, p.z)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return C.GE(F.mul_plain(e, f), F.mul_plain(g, h), F.mul_plain(f, g),
                F.mul_plain(e, h))


def bucket_accum_plain(pre: torch.Tensor, dg: torch.Tensor, w: int,
                       threads: int, slices: int) -> torch.Tensor:
    """Plain twin of the ge_bucket_accum kernel: pre [n, 80], dg [nw, n]
    -> [80], in the kernel's order.  Lane (j, k) is unit k = slice *
    threads + t of window j (a unit: the four lanes that hold a point in
    the kernel); it owns points k, k + K, ... (K = threads * slices) and
    2^(w-1) buckets from the identity, folds them from the top (suf += S_b;
    tot += suf), the block's lanes are halved (lane t + half into lane t),
    each window's block partials summed in slice order, and the windows
    combined by Horner from the most significant."""
    L4 = 4 * F.L
    nb = 1 << (w - 1)
    nw, n = dg.shape
    k = threads * slices
    dev = pre.device
    bucket = C.flatten(C.identity((nw, k, nb), dev))         # [nw, K, nb, 80]
    win = torch.arange(nw, device=dev)[:, None].expand(nw, k)
    lane = torch.arange(k, device=dev)[None].expand(nw, k)
    for first in range(0, n, k):
        idx = first + torch.arange(k, device=dev)
        valid = idx < n
        idx = idx.clamp(max=n - 1)
        d = dg[:, idx] * valid                               # [nw, K]
        neg = (d < 0)[..., None]
        q = pre[idx][None]                                   # [1, K, 80]
        ypx = torch.where(neg, q[..., F.L:2 * F.L], q[..., :F.L])
        ymx = torch.where(neg, q[..., :F.L], q[..., F.L:2 * F.L])
        td2 = torch.where(neg, q[..., 3 * F.L:], q[..., 2 * F.L:3 * F.L])
        m = d.abs()
        b = (m - 1).clamp(min=0)
        cur = bucket[win, lane, b]                           # [nw, K, 80]
        new = C.flatten(madd_plain(C.unflatten(cur), ypx, ymx, td2))
        bucket[win, lane, b] = torch.where((m > 0)[..., None], new, cur)
    suf = tot = C.identity((nw, k), dev)
    for b in range(nb - 1, -1, -1):
        suf = C.add_plain(suf, C.unflatten(bucket[:, :, b]))
        tot = C.add_plain(tot, suf)
    part = C.flatten(tot).reshape(nw, slices, threads, L4)
    m = threads
    while m > 1:
        half = m // 2
        part = C.flatten(C.add_plain(C.unflatten(part[:, :, :half]),
                                     C.unflatten(part[:, :, half:m])))
        m = half
    part = C.unflatten(part[:, :, 0])                        # [nw, slices]
    wsum = C.GE(*(c[:, 0] for c in part))
    for s in range(1, slices):
        wsum = C.add_plain(wsum, C.GE(*(c[:, s] for c in part)))
    acc = C.identity((), dev)
    for j in range(nw - 1, -1, -1):
        for _ in range(w):
            acc = C.double_plain(acc)
        acc = C.add_plain(acc, C.GE(*(c[j] for c in wsum)))
    return C.flatten(acc)


def bucket_accum(pre: torch.Tensor, dg: torch.Tensor, w: int, threads: int,
                 slices: int) -> torch.Tensor:
    """The bucket pass and combine: the ge_bucket_accum kernel on a CUDA
    tensor, its plain twin on a CPU tensor."""
    if pre.device.type == "cpu" and dg.device.type == "cpu":
        return bucket_accum_plain(pre, dg, w, threads, slices)
    return cuda_curve.bucket_accum(pre, dg, w, threads, slices)


def msm_accum(points: C.GE, scalars: torch.Tensor, w: int | None = None,
              threads: int | None = None,
              slices: int | None = None) -> C.GE:
    """sum_i scalars[i] * points[i] by the signed-bucket accumulator.

    points: GE [n]; scalars: [n, 20] radix-2^13 limbs (< 2^253).  Zero
    scalars (the padding of ``msm._pad_pow2``) give all-zero digits and
    touch no bucket.  The window and block shape come from
    ``config.accum_plan`` unless given."""
    pw, pt, ps = config.accum_plan(scalars.shape[0], w)
    dg = extract_digits_signed(scalars, pw)
    pre = madd_precomp(points)
    return C.unflatten(bucket_accum(pre, dg, pw, threads or pt,
                                    slices or ps))


# --- sort-plus-scan (msm_pippenger) ------------------------------------------
def _seg_combine(left, right):
    """Segmented-scan monoid over (point, head flag) pairs: the right point
    where it starts a segment, else the sum."""
    pv, pf = left
    qv, qf = right
    return C.select(qf, qv, C.add(pv, qv)), pf | qf


def _lane_scan_incl(v: C.GE, seg_flags: torch.Tensor | None = None):
    """Hillis-Steele inclusive scan across the lanes of GE [lanes]
    (``pallas_curve._lane_scan_incl``): stage s = 1, 2, 4, ... adds lane l -
    s into lane l >= s; segmented by int32 seg_flags [lanes], only where
    lane l's flag is 0, and the flag becomes max(f[l], f[l - s]).  Returns
    (v, flags)."""
    lanes = v.x.shape[0]
    lane = torch.arange(lanes, device=v.x.device)
    f = seg_flags
    s = 1
    while s < lanes:
        merged = C.add_plain(C.GE(*(torch.roll(c, s, 0) for c in v)), v)
        if f is None:
            v = C.select(lane >= s, merged, v)
        else:
            v = C.select((lane >= s) & (f == 0), merged, v)
            f = torch.where(lane >= s, torch.maximum(f, torch.roll(f, s, 0)),
                            f)
        s *= 2
    return v, f


def _exclusive(v: C.GE) -> C.GE:
    """GE [lanes] shifted one lane up, the identity in lane 0."""
    return C.GE(*(torch.cat([i[None], c[:-1]]) for i, c in
                  zip(C.identity((), v.x.device), v)))


def seg_scan_plain(pt: torch.Tensor, ht: torch.Tensor):
    """Plain twin of the ge_seg_scan kernel, in the layout of the JAX
    package's ``pallas_curve.seg_scan``: pt [depth, 80, lanes] points (lane
    l, step j = sorted element l * depth + j), ht [depth, 1, lanes] int32
    head flags -> ([depth, 80, lanes] values, [80, lanes] carries).  Each
    lane scans its chunk (acc = head ? row : acc + row, so a lane whose
    first element starts no segment holds chunk-local partials); the carry
    of lane l is the segmented scan of the lanes' last values, shifted by
    one lane."""
    depth, _, lanes = pt.shape
    rows = C.unflatten(pt.transpose(1, 2))                 # GE [depth, lanes]
    h = ht[:, 0, :]
    acc = C.identity((lanes,), pt.device)
    hh = torch.zeros((lanes,), dtype=torch.int32, device=pt.device)
    outs = []
    for j in range(depth):
        row = C.GE(*(c[j] for c in rows))
        acc = C.select(h[j] > 0, row, C.add_plain(acc, row))
        outs.append(C.flatten(acc))
        hh = torch.maximum(hh, h[j])
    total, _ = _lane_scan_incl(acc, hh)
    carry = C.flatten(_exclusive(total))
    return torch.stack(outs).transpose(1, 2).contiguous(), carry.T.contiguous()


def seg_scan(pt: torch.Tensor, ht: torch.Tensor):
    """The segmented scan: the ge_seg_scan kernel on CUDA tensors, its
    plain twin on CPU ones."""
    if pt.device.type == "cpu" and ht.device.type == "cpu":
        return seg_scan_plain(pt, ht)
    return cuda_curve.seg_scan(pt, ht)


def bucket_fold_plain(body: torch.Tensor, lanes: int = 128) -> torch.Tensor:
    """Plain twin of the ge_bucket_fold kernel (``pallas_curve.bucket_fold``):
    body [m, 80] in descending bucket order -> [80], the sum of its prefix
    sums.  The rows are identity-padded at the front to depth * lanes
    (``cuda_curve.fold_depth``), element (j, l) = padded[l * depth + j];
    per lane s += row, w += s; the lanes' s scanned across lanes, the
    exclusive carry doubled log2(depth) times and added to w; then the lanes
    halved, lane l + half into lane l."""
    m = body.shape[0]
    depth = cuda_curve.fold_depth(m, lanes)
    pad = C.flatten(C.identity((depth * lanes - m,), body.device))
    rows = C.unflatten(torch.cat([pad, body]).reshape(lanes, depth, 4 * F.L)
                       .transpose(0, 1))                   # GE [depth, lanes]
    s = w = C.identity((lanes,), body.device)
    for j in range(depth):
        s = C.add_plain(s, C.GE(*(c[j] for c in rows)))
        w = C.add_plain(w, s)
    carry = _exclusive(_lane_scan_incl(s)[0])
    k = depth
    while k > 1:
        carry = C.double_plain(carry)
        k //= 2
    r = C.add_plain(w, carry)
    k = lanes
    while k > 1:
        half = k // 2
        r = C.add_plain(C.GE(*(c[:half] for c in r)),
                        C.GE(*(c[half:k] for c in r)))
        k = half
    return C.flatten(r)[0]


def bucket_fold(body: torch.Tensor, lanes: int = 128) -> torch.Tensor:
    """The bucket fold: the ge_bucket_fold kernel on a CUDA tensor, its
    plain twin on a CPU one."""
    if body.device.type == "cpu":
        return bucket_fold_plain(body, lanes)
    return cuda_curve.bucket_fold(body, lanes)


def _bucket_suffix_fold(buckets: C.GE, nb: int) -> C.GE:
    """sum_b b * S_b over buckets 1..nb-1 of GE [nb + 1]: the table in
    descending order through the bucket fold, in the device's layout
    (``config.fold_lanes``)."""
    body = C.flatten(buckets)[1:nb].flip(0)
    return C.unflatten(bucket_fold(body, config.fold_lanes(body.device)))


def _heads(d_sorted: torch.Tensor) -> torch.Tensor:
    """True where a run of equal sorted digits starts."""
    first = torch.ones((1,), dtype=torch.bool, device=d_sorted.device)
    return torch.cat([first, d_sorted[1:] != d_sorted[:-1]])


def _tails(head: torch.Tensor) -> torch.Tensor:
    """True where a run ends: before each run start, and at the end."""
    return torch.cat([head[1:], head.new_ones((1,))])


def _fold_tails(rows: torch.Tensor, digits: torch.Tensor, tail: torch.Tensor,
                nb: int) -> C.GE:
    """Scatter the scan values rows [..., 80] at the run tails into a table
    of nb + 1 buckets by their digits (every other row to the discard slot
    nb, which the fold never reads) and fold it."""
    idx = torch.where(tail, digits, nb).long()
    buckets = C.flatten(C.identity((nb + 1,), rows.device))
    buckets[idx.reshape(-1)] = rows.reshape(-1, 4 * F.L)
    return _bucket_suffix_fold(C.unflatten(buckets), nb)


def _bucket_window_chunked(flat: torch.Tensor, digits: torch.Tensor,
                           order: torch.Tensor, w: int) -> C.GE:
    """One window in the chunk layout: one gather of the sorted [n, 80]
    rows into the scan's [depth, 80, lanes] layout, the segmented scan,
    the carry added at each lane's first segment tail where the lane's
    leading run continues one from an earlier lane, and the segment tails
    scattered into the bucket table and folded."""
    n = digits.shape[0]
    nb = 1 << w
    lanes = min(config.MSM_SCAN_LANES, n)
    depth = n // lanes
    d_sorted = digits[order]
    head = _heads(d_sorted)
    order_c = order.reshape(lanes, depth).T                # [depth, lanes]
    ht = head.reshape(lanes, depth).T[:, None, :].to(torch.int32)
    outs_t, carry_t = seg_scan(flat[order_c].transpose(1, 2), ht)
    vals = outs_t.transpose(1, 2).contiguous()             # [depth, lanes, 80]
    carry = C.unflatten(carry_t.T)

    headfirst = head.reshape(lanes, depth)[:, 0]
    tmat = _tails(head).reshape(lanes, depth)
    first_tail = tmat.to(torch.int32).argmax(dim=1)        # first True, or 0
    lane_ids = torch.arange(lanes, device=flat.device)
    apply = (lane_ids > 0) & ~headfirst & tmat.any(dim=1)
    tgt = C.unflatten(vals[first_tail, lane_ids])
    vals[first_tail, lane_ids] = C.flatten(
        C.select(apply, C.add(tgt, carry), tgt))
    return _fold_tails(vals, d_sorted.reshape(lanes, depth).T, tmat.T, nb)


def _digit_order(digits: torch.Tensor, w: int) -> torch.Tensor:
    """The permutation grouping a window's points by digit: the counting
    sort under ``config.MSM_PALLAS_SORT`` where n is a multiple of 1024 (the
    JAX package's rule), else a stable argsort; the same permutation."""
    if config.MSM_PALLAS_SORT and digits.shape[0] % sort.BLOCK == 0:
        return sort.grouping_order(digits, w,
                                   config.MSM_PALLAS_SORT_BITS).long()
    return torch.argsort(digits, stable=True)


def _bucket_window(flat: torch.Tensor, digits: torch.Tensor, w: int) -> C.GE:
    """One window's weighted bucket sum sum_b b * S_b; `flat` is the
    window-invariant [n, 80] point table.  Chunked when n is a multiple of
    the lanes and at least two lanes deep, else an unchunked segmented scan
    by log-depth halving over ``curve.add``."""
    n = digits.shape[0]
    nb = 1 << w
    order = _digit_order(digits, w)
    lanes = min(config.MSM_SCAN_LANES, n)
    if n % lanes == 0 and n >= 2 * lanes:
        return _bucket_window_chunked(flat, digits, order, w)
    d_sorted = digits[order]
    vals = C.unflatten(flat[order])
    head = flags = _heads(d_sorted)
    s = 1
    while s < n:                           # Hillis-Steele over _seg_combine
        mv, mf = _seg_combine((C.GE(*(c[:-s] for c in vals)), flags[:-s]),
                              (C.GE(*(c[s:] for c in vals)), flags[s:]))
        vals = C.GE(*(torch.cat([c[:s], m]) for c, m in zip(vals, mv)))
        flags = torch.cat([flags[:s], mf])
        s *= 2
    return _fold_tails(C.flatten(vals), d_sorted, _tails(head), nb)


def _horner_windows(window_sums: C.GE, nw: int, w: int) -> C.GE:
    """acc = 2^w acc + W_j over the window sums GE [nw], most significant
    first."""
    acc = C.identity((), window_sums.x.device)
    for j in range(nw - 1, -1, -1):
        for _ in range(w):
            acc = C.double(acc)
        acc = C.add(acc, C.GE(*(c[j] for c in window_sums)))
    return acc


def msm_pippenger(points: C.GE, scalars: torch.Tensor, w: int = 8) -> C.GE:
    """sum_i scalars[i] * points[i] by the sort-plus-scan bucket method at
    window width `w` (always honored; the route to the accumulator lives in
    ``msm.msm_auto`` and the fused MSMs, keyed on config.MSM_ACCUM_KERNEL).

    points: GE [n]; scalars: [n, 20] radix-2^13 limbs (< 2^253)."""
    digits = extract_digits(scalars, w)                   # [nw, n]
    flat = C.flatten(points)                              # window-invariant
    sums = torch.stack([C.flatten(_bucket_window(flat, d, w))
                        for d in digits])
    return _horner_windows(C.unflatten(sums), num_windows(w), w)
