"""Wrappers of the hand-written CUDA radix-2^16 kernels
(csrc/radix16_kernels.cu).

    r16_mul        <- cudabulletproof_tpu/ops/radix16.py::_mul16_kernel
    r16_sq         <- radix16.py::_sq16_kernel
    r16_mul_chain  <- the kernel ``kern`` of radix16.py::mul_chain

Each wrapper takes CUDA int32 tensors of 16-limb field elements whose batch
dims broadcast, expands them to one shape, makes them contiguous and flat
``[n, 16]``, launches on PyTorch's current stream into an output made with
``torch.empty`` and restores the batch shape.  It raises on anything the
kernel does not take; there is no fallback.  The limbs must be weak (each
in [0, 2^16 + 38]): the kernels' int32 arithmetic is exact only there, and
the wrappers do not read the values.  The plain twins live in
``ops/radix16.py`` (``mul_plain``, ``sq_plain``, ``mul_chain_plain``).

``launches`` counts kernel launches per kernel, one per launch and nowhere
else.
"""
from __future__ import annotations

import torch

from .cuda_field import launch_rows

L16 = 16
launches = {"r16_mul": 0, "r16_sq": 0, "r16_mul_chain": 0}


def _run(name: str, *ts: torch.Tensor, extra=()) -> torch.Tensor:
    return launch_rows(launches, name, L16, *ts, extra=extra)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _run("r16_mul", a, b)


def sq(a: torch.Tensor) -> torch.Tensor:
    return _run("r16_sq", a)


def mul_chain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """x <- x*b, `reps` times from x = a, in one launch (reps <= 0 copies
    a)."""
    return _run("r16_mul_chain", a, b, extra=(int(reps),))
