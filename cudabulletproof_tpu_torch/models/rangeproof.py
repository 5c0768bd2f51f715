"""Range-proof data types and constants, without JAX.

The same fields as ``cudabulletproof_tpu/models/rangeproof.py::RangeProof``
and ``models/ipa.py::InnerProductProof``, and the same challenge domains, so
the wire format and transcripts match the JAX package's and the native
library's byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass

# Challenge domains (the reference's bulletproof_challenge.cu:24-77, plus Q)
DOMAIN_Y = b"BulletproofYChal"
DOMAIN_Z = b"BulletproofZChal"
DOMAIN_X = b"BulletproofXChal"
DOMAIN_Q = b"BulletproofQChal"
IPA_DOMAIN = b"InnerProductChal"


@dataclass
class InnerProductProof:
    n: int
    L: list          # list[bytes], compressed points, len = log2(n)
    R: list
    a: int
    b: int


@dataclass
class RangeProof:
    n: int               # range bit-length
    V: bytes             # value commitment (compressed)
    A: bytes
    S: bytes
    T1: bytes
    T2: bytes
    taux: int
    mu: int
    t_hat: int
    ip: InnerProductProof


class ProveError(ValueError):
    """The prover refuses its input (a value out of range, an n that is not
    a power of two)."""


def validate_range_input(value: int, n: int) -> bool:
    return 0 <= value < (1 << n)
