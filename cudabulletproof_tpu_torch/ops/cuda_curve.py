"""Wrappers of the hand-written CUDA point kernels (csrc/curve_kernels.cu).

    ge_add         <- cudabulletproof_tpu/ops/pallas_curve.py::_add_kernel
    ge_double      <- pallas_curve.py::_double_kernel
    ge_ladder_win  <- pallas_curve.py::_ladder_win_kernel
    ge_ladder_bin  <- pallas_curve.py::_ladder_kernel
    ge_reduce      <- pallas_curve.py::_reduce_kernel
    ge_bucket_accum <- pallas_curve.py::_bucket_accum_kernel (two kernels:
                       the bucket pass and the window/Horner combine)
    ge_seg_scan    <- pallas_curve.py::_seg_scan_kernel (csrc/scan_kernels.cu;
                      two kernels: the per-lane scan and the cross-lane carry)
    ge_bucket_fold <- pallas_curve.py::_bucket_fold_kernel (scan_kernels.cu;
                      two kernels: the per-lane prefixes and the finish)

Each wrapper broadcasts the batch dims of its CUDA int32 operands, packs a
``GE`` into contiguous ``[n, 80]`` rows (x|y|z|t), launches on PyTorch's
current stream into an output made with ``torch.empty``, and unpacks the
result to the batch shape.  It raises on anything the kernel does not take;
there is no fallback.  The plain twins live in ``ops/curve.py``
(``add_plain``, ``double_plain``, ``scalarmult_plain``,
``scalarmult_bin_plain``, ``reduce_tiles_plain``)
and ``ops/pippenger.py`` (``bucket_accum_plain``, ``seg_scan_plain``,
``bucket_fold_plain``).

Results are (x, y, z, t) tuples; ``ops/curve.py`` wraps them in its ``GE``.
``launches`` counts kernel launches per kernel, one per launch and nowhere
else.
"""
from __future__ import annotations

import torch

from ..utils import build
from .cuda_field import flat_operands

L = 20
launches = {"ge_add": 0, "ge_double": 0, "ge_ladder_win": 0,
            "ge_ladder_bin": 0, "ge_reduce": 0, "ge_bucket_accum": 0,
            "ge_seg_scan": 0, "ge_bucket_fold": 0}
REDUCE_TILE = 256            # points a ge_reduce block sums (csrc kReduceTile)


def _rows(*pts) -> tuple:
    """GE operands -> (batch shape, contiguous [n, 80] rows per operand)."""
    coords = [c for p in pts for c in p]
    batch, flats = flat_operands(L, *coords)
    rows = [torch.cat(flats[i:i + 4], dim=1) for i in range(0, len(flats), 4)]
    return batch, rows


def _run(name: str, batch, *args) -> tuple:
    out = torch.empty((args[0].shape[0], 4 * L), dtype=torch.int32,
                      device=args[0].device)
    n = out.shape[0]
    if n:
        with torch.cuda.device(out.device):
            build.launch(f"bp_{name}", *args, out, n)
        launches[name] += 1
    return tuple(c.reshape(*batch, L) for c in out.split(L, dim=1))


def add(p, q):
    batch, (a, b) = _rows(p, q)
    return _run("ge_add", batch, a, b)


def double(p):
    batch, (a,) = _rows(p)
    return _run("ge_double", batch, a)


def _ladder(name: str, p, s: torch.Tensor):
    batch, flats = flat_operands(L, *p, s)
    rows = torch.cat(flats[:4], dim=1)
    return _run(name, batch, rows, flats[4])


def ladder(p, s: torch.Tensor):
    """p GE [...] times s [..., 20] scalar limbs in [0, 2^13): the 4-bit
    fixed-window ladder."""
    return _ladder("ge_ladder_win", p, s)


def ladder_bin(p, s: torch.Tensor):
    """p GE [...] times s [..., 20] scalar limbs in [0, 2^13): the binary
    double-and-add ladder."""
    return _ladder("ge_ladder_bin", p, s)


def reduce_tiles(p):
    """GE [n] -> [ceil(n / 256), 80] rows: one partial sum per tile of 256
    points (identity-padded), by the ge_reduce kernel."""
    batch, (rows,) = _rows(p)
    if len(batch) != 1:
        raise ValueError(f"reduce_tiles takes GE [n], got batch {tuple(batch)}")
    n = rows.shape[0]
    out = torch.empty((-(-n // REDUCE_TILE), 4 * L), dtype=torch.int32,
                      device=rows.device)
    if n:
        with torch.cuda.device(out.device):
            build.launch("bp_ge_reduce", rows, out, n)
        launches["ge_reduce"] += 1
    return out


def bucket_accum(pre: torch.Tensor, dg: torch.Tensor, w: int, threads: int,
                 slices: int) -> torch.Tensor:
    """The accumulator MSM: pre [n, 80] mixed-add operands, dg [nw, n]
    signed digits (int32, least significant window first) -> [80], the
    finished sum.  `threads` units a block (a power of two in 32..256; a
    unit is the four lanes that hold a point) and `slices` blocks a
    window."""
    (pre,) = flat_operands(4 * L, pre)[1]
    if dg.device != pre.device or dg.dtype != torch.int32 or dg.dim() != 2 \
            or dg.shape[1] != pre.shape[0]:
        raise ValueError(f"digits {dg.dtype} {tuple(dg.shape)} on {dg.device} "
                         f"do not match operands [{pre.shape[0]}, 80] on "
                         f"{pre.device}")
    if not 4 <= w <= 8:
        raise ValueError(f"the accumulator kernel takes w in 4..8, not {w}")
    if threads not in (32, 64, 128, 256) or slices < 1:
        raise ValueError(f"block shape ({threads} threads, {slices} slices)")
    dg = dg.contiguous()
    nw, n = dg.shape
    if n == 0:
        raise ValueError("the accumulator kernel needs at least one point")
    part = torch.empty((nw, slices, 4 * L), dtype=torch.int32,
                       device=pre.device)
    out = torch.empty((4 * L,), dtype=torch.int32, device=pre.device)
    with torch.cuda.device(out.device):
        build.launch("bp_ge_bucket_accum", pre, dg, part, out, n, nw, w,
                     threads, slices)
    launches["ge_bucket_accum"] += 1
    return out


def _int32_cuda(name: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """t as a contiguous CUDA int32 tensor of `shape`, or raise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}, needs a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} of dtype {t.dtype}, needs int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} of shape {tuple(t.shape)}, needs "
                         f"{tuple(shape)}")
    return t.contiguous()


def seg_scan(pt: torch.Tensor, ht: torch.Tensor):
    """The segmented scan of the chunked bucket pipeline: pt [depth, 80,
    lanes] int32 points (lane l, step j = sorted element l * depth + j), ht
    [depth, 1, lanes] int32 head flags -> ([depth, 80, lanes] chunk-local
    scan values, [80, lanes] cross-lane carries), the layout of the JAX
    package's ``pallas_curve.seg_scan``."""
    if pt.dim() != 3 or pt.shape[1] != 4 * L:
        raise ValueError(f"points of shape {tuple(pt.shape)}, needs "
                         "[depth, 80, lanes]")
    depth, _, lanes = pt.shape
    pt = _int32_cuda("points", pt, (depth, 4 * L, lanes))
    ht = _int32_cuda("head flags", ht, (depth, 1, lanes))
    if ht.device != pt.device:
        raise ValueError(f"operands on {pt.device} and {ht.device}")
    if not (depth and lanes):
        raise ValueError("the scan needs depth and lanes >= 1")
    dev = pt.device
    out = torch.empty_like(pt)
    carry = torch.empty((4 * L, lanes), dtype=torch.int32, device=dev)
    buf = torch.empty((2, lanes, 4 * L), dtype=torch.int32, device=dev)
    flags = torch.empty((2, lanes), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        build.launch("bp_ge_seg_scan", pt, ht, out, carry, buf, flags, depth,
                     lanes)
    launches["ge_seg_scan"] += 1
    return out, carry


def fold_depth(m: int, lanes: int) -> int:
    """Steps of the bucket fold over m rows in `lanes` lanes: ceil(m /
    lanes) rounded up to a power of two (the carry is scaled by doublings),
    as the JAX package's ``pallas_curve.bucket_fold``."""
    depth = -(-m // lanes)
    while depth & (depth - 1):
        depth += 1
    return depth


def bucket_fold(body: torch.Tensor, lanes: int = 128) -> torch.Tensor:
    """sum over the prefixes of body [m, 80] (a bucket table in descending
    bucket order), identity-padded at the front to fold_depth(m, lanes) *
    lanes rows: sum_b b * S_b.  `lanes` a power of two.  Returns [80]."""
    if body.dim() != 2 or body.shape[0] == 0:
        raise ValueError(f"bucket table of shape {tuple(body.shape)}, needs "
                         "[m >= 1, 80]")
    if lanes < 1 or lanes & (lanes - 1):
        raise ValueError(f"the fold takes a power of two of lanes, not "
                         f"{lanes}")
    m = body.shape[0]
    body = _int32_cuda("bucket table", body, (m, 4 * L))
    dev = body.device
    depth = fold_depth(m, lanes)
    buf = torch.empty((2, lanes, 4 * L), dtype=torch.int32, device=dev)
    wacc = torch.empty((lanes, 4 * L), dtype=torch.int32, device=dev)
    out = torch.empty((4 * L,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        build.launch("bp_ge_bucket_fold", body, buf, wacc, out, m, depth,
                     lanes)
    launches["ge_bucket_fold"] += 1
    return out
