"""The host Fiat-Shamir transcript, the port's copy of
``cudabulletproof_tpu/models/transcript.py`` (``challenge`` :21,
``Transcript`` :32): SHA-256 in ``hashlib``, byte for byte the same.

A challenge is SHA-256(domain || data) with the top bit of byte 31 cleared,
reduced mod l (0 becomes 1, so every challenge is invertible).  The rolling
state is state' = SHA-256(state || label || data).
"""
from __future__ import annotations

import hashlib

from ..utils.scalars import ELL


def challenge(domain: bytes, data: bytes) -> int:
    """SHA-256(domain || data), top bit cleared, reduced mod l."""
    h = hashlib.sha256(domain + data).digest()
    v = int.from_bytes(h, "little") & ((1 << 255) - 1)
    v %= ELL
    if v == 0:   # negligible probability; challenges must be invertible
        v = 1
    return v


class Transcript:
    """Rolling transcript of compressed points and scalars."""

    def __init__(self, label: bytes = b"tpu-bulletproofs"):
        self.state = hashlib.sha256(label).digest()

    def append(self, label: bytes, data: bytes) -> None:
        self.state = hashlib.sha256(self.state + label + data).digest()

    def append_point(self, label: bytes, compressed: bytes) -> None:
        if len(compressed) != 32:
            raise ValueError("a compressed point is 32 bytes")
        self.append(label, compressed)

    def append_scalar(self, label: bytes, s: int) -> None:
        self.append(label, (s % ELL).to_bytes(32, "little"))

    def challenge(self, domain: bytes) -> int:
        c = challenge(domain, self.state)
        self.append(b"chal", domain + c.to_bytes(32, "little"))
        return c
