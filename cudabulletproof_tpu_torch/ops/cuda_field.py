"""Wrappers of the hand-written CUDA field kernels (csrc/field_kernels.cu).

    fe_mul      <- cudabulletproof_tpu/ops/pallas_field.py::_mul_kernel
    fe_sq       <- pallas_field.py::_sq_kernel
    fe_pow2523  <- pallas_field.py::_pow2523_kernel
    fe_invert   <- pallas_field.py::_invert_kernel
    fe_add      <- pallas_field.py::_add_kernel (a + b, three relax rounds)
    fe_sub      <- pallas_field.py::_sub_kernel (a + (K - b), three rounds)
    fe_inner_product          <- pallas_field.py::_inner_product_kernel
    fe_inner_product_batched  <- pallas_field.py::_inner_product_batched_kernel
    fe_mul_chain  <- benchmarks/bench_radix16.py::chain13's kernel ``kern``
                     (``reps`` dependent fe_mul in one launch)

Each wrapper takes CUDA int32 tensors of 20-limb field elements whose batch
dims broadcast, expands them to one shape, makes them contiguous and flat
``[n, 20]``, launches on PyTorch's current stream into an output made with
``torch.empty``, and restores the batch shape.  ``inner_product_partial``
takes ``[B, n, 20]`` operands and returns the kernels' ``[B, 39, 256]``
partial sums (zeroed with ``torch.zeros`` before the launch), which
``field.ip_combine`` turns into limbs.  It raises on anything the
kernel does not take; there is no fallback.  The plain twins live in
``ops/field.py`` (``mul_plain``, ``sq_plain``, ``pow2523_plain``,
``invert_plain``, ``add3_plain``, ``sub3_plain``, ``ip_partial_plain``,
``mul_chain_plain``).

``launches`` counts kernel launches per kernel, one per launch and nowhere
else, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import torch

from ..utils import build

L = 20
launches = {"fe_mul": 0, "fe_sq": 0, "fe_pow2523": 0, "fe_invert": 0,
            "fe_add": 0, "fe_sub": 0, "fe_inner_product": 0,
            "fe_inner_product_batched": 0, "fe_mul_chain": 0}
IP_COEFFS = 2 * L - 1      # convolution coefficients
IP_WIDTH = 256             # lo columns 0..127, hi columns 128..255
MAX_ROWS = 65535           # the grid's y extent


def flat_operands(width: int, *ts: torch.Tensor):
    """Check CUDA int32 operands of row width `width` on one device;
    broadcast their batch dims and flatten to contiguous [n, width].
    Returns (batch shape, flat tensors)."""
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel operand on {t.device}, needs a CUDA tensor")
        if t.device != dev:
            raise ValueError(f"kernel operands on {dev} and {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operand of dtype {t.dtype}, needs int32")
        if t.dim() < 1 or t.shape[-1] != width:
            raise ValueError(f"kernel operand of shape {tuple(t.shape)}, "
                             f"needs [..., {width}]")
    batch = torch.broadcast_shapes(*(t.shape[:-1] for t in ts))
    flats = [t.expand(*batch, width).reshape(-1, width).contiguous()
             for t in ts]
    return batch, flats


def launch_rows(counts: dict, name: str, width: int, *ts: torch.Tensor,
                extra=()) -> torch.Tensor:
    """Launch ``bp_<name>(*flat operands, out, n, *extra, stream)`` on rows
    of `width` limbs and count it in `counts`; returns out in the
    operands' batch shape (no launch for n = 0)."""
    batch, flats = flat_operands(width, *ts)
    out = torch.empty_like(flats[0])
    n = out.shape[0]
    if n:
        with torch.cuda.device(out.device):
            build.launch(f"bp_{name}", *flats, out, n, *extra)
        counts[name] += 1
    return out.reshape(*batch, width)


def _run(name: str, *ts: torch.Tensor, extra=()) -> torch.Tensor:
    return launch_rows(launches, name, L, *ts, extra=extra)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _run("fe_mul", a, b)


def sq(a: torch.Tensor) -> torch.Tensor:
    return _run("fe_sq", a)


def pow2523(a: torch.Tensor) -> torch.Tensor:
    return _run("fe_pow2523", a)


def invert(a: torch.Tensor) -> torch.Tensor:
    return _run("fe_invert", a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _run("fe_add", a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _run("fe_sub", a, b)


def mul_chain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """x <- x*b, `reps` times from x = a, in one launch (reps <= 0 copies
    a)."""
    return _run("fe_mul_chain", a, b, extra=(int(reps),))


def inner_product_partial(a: torch.Tensor, b: torch.Tensor,
                          batched: bool) -> torch.Tensor:
    """The fe_inner_product kernels' partial [B, 39, 256] of a, b
    [B, n, 20]: ``bp_fe_inner_product`` (counted as fe_inner_product) for
    B = 1 when not `batched`, else ``bp_fe_inner_product_batched``."""
    _, (fa, fb) = flat_operands(L, a, b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"inner product of {tuple(a.shape)} and "
                         f"{tuple(b.shape)}: needs two [B, n, {L}]")
    rows, n = a.shape[0], a.shape[1]
    if not batched and rows != 1:
        raise ValueError(f"fe_inner_product takes one row, not {rows}")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} inner products in one launch: at most "
                         f"{MAX_ROWS}")
    partial = torch.zeros((rows, IP_COEFFS, IP_WIDTH), dtype=torch.int32,
                          device=a.device)
    if rows:
        name = "fe_inner_product_batched" if batched else "fe_inner_product"
        with torch.cuda.device(a.device):
            if batched:
                build.launch(f"bp_{name}", fa, fb, partial, rows, n)
            else:
                build.launch(f"bp_{name}", fa, fb, partial, n)
        launches[name] += 1
    return partial
