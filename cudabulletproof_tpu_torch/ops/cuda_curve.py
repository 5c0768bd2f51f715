"""Wrappers of the hand-written CUDA point kernels (csrc/curve_kernels.cu).

    ge_add         <- cudabulletproof_tpu/ops/pallas_curve.py::_add_kernel
    ge_double      <- pallas_curve.py::_double_kernel
    ge_ladder_win  <- pallas_curve.py::_ladder_win_kernel
    ge_ladder_bin  <- pallas_curve.py::_ladder_kernel
    ge_reduce      <- pallas_curve.py::_reduce_kernel
    ge_bucket_accum <- pallas_curve.py::_bucket_accum_kernel (two kernels:
                       the bucket pass and the window/Horner combine)

Each wrapper broadcasts the batch dims of its CUDA int32 operands, packs a
``GE`` into contiguous ``[n, 80]`` rows (x|y|z|t), launches on PyTorch's
current stream into an output made with ``torch.empty``, and unpacks the
result to the batch shape.  It raises on anything the kernel does not take;
there is no fallback.  The plain twins live in ``ops/curve.py``
(``add_plain``, ``double_plain``, ``scalarmult_plain``,
``scalarmult_bin_plain``, ``reduce_tiles_plain``)
and ``ops/pippenger.py`` (``bucket_accum_plain``).

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
            "ge_ladder_bin": 0, "ge_reduce": 0, "ge_bucket_accum": 0}
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
    finished sum.  `threads` a block (a power of two in 32..256) and
    `slices` blocks a window."""
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
