"""Host-side scalar (mod l) helpers of the host-transcript protocol, the
port's copy of ``cudabulletproof_tpu/utils/scalars.py``.

The protocol's scalar side (powers of challenges, the vector polynomials
l(x) and r(x), inner products over Z_l) touches a few thousand 253-bit
integers per proof, one after another: host work on Python ints.  The group
operations run on the device (``ops/msm.py``).
"""
from __future__ import annotations

import secrets

from .oracle import ELL

__all__ = [
    "ELL", "sc_add", "sc_sub", "sc_mul", "sc_inv", "sc_random",
    "vec_add", "vec_sub", "vec_scalar_mul", "vec_hadamard", "vec_inner",
    "vec_powers", "sc_to_bytes", "sc_from_bytes",
]


def sc_add(a: int, b: int) -> int:
    return (a + b) % ELL


def sc_sub(a: int, b: int) -> int:
    return (a - b) % ELL


def sc_mul(a: int, b: int) -> int:
    return (a * b) % ELL


def sc_inv(a: int) -> int:
    return pow(a, ELL - 2, ELL)


def sc_random() -> int:
    """A uniform scalar in [0, l) from ``secrets`` (the provers' blinding
    factors and nonces; no torch generator draws key material)."""
    return secrets.randbits(512) % ELL


def vec_add(a, b):
    return [(x + y) % ELL for x, y in zip(a, b, strict=True)]


def vec_sub(a, b):
    return [(x - y) % ELL for x, y in zip(a, b, strict=True)]


def vec_scalar_mul(a, s: int):
    return [(x * s) % ELL for x in a]


def vec_hadamard(a, b):
    return [(x * y) % ELL for x, y in zip(a, b, strict=True)]


def vec_inner(a, b) -> int:
    """<a, b> mod l."""
    return sum(x * y for x, y in zip(a, b, strict=True)) % ELL


def vec_powers(base: int, n: int):
    """[1, base, base^2, ..., base^(n-1)] mod l."""
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % ELL
    return out


def sc_to_bytes(x: int) -> bytes:
    return (x % ELL).to_bytes(32, "little")


def sc_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little") % ELL
