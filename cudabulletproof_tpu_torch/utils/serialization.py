"""Range-proof wire format, the same bytes as the JAX package's
``utils/serialization.py`` and ``native/bulletproof.cpp::serialize``:

    u32 n (range bits, LE)
    V A S T1 T2                    5 x 32 bytes (compressed points)
    taux mu t_hat                  3 x 32 bytes (scalars, LE)
    u32 k (= log2 n)
    k x (L_j, R_j)                 2k x 32 bytes
    a b                            2 x 32 bytes

and the aggregated proof (``serialize_aggregated_proof`` :80,
``deserialize_aggregated_proof`` :99 of the JAX package;
native/bulletproof.cpp::serialize_agg):

    u32 n | u32 m
    m x V_j                        32 bytes each
    A S T1 T2                      4 x 32 bytes
    taux mu t_hat                  3 x 32 bytes
    u32 k (= log2(n m))
    k x (L_j, R_j)                 2k x 32 bytes
    a b                            2 x 32 bytes
"""
from __future__ import annotations

import struct

from ..models.aggregate import AggregatedRangeProof
from ..models.rangeproof import InnerProductProof, RangeProof
from .oracle import ELL


def _body(out: bytearray, p, points) -> bytes:
    """Append the points, taux | mu | t_hat, the rounds and a | b."""
    for blob in points:
        if len(blob) != 32:
            raise ValueError("a compressed point is 32 bytes")
        out += blob
    for s in [p.taux, p.mu, p.t_hat]:
        out += (s % ELL).to_bytes(32, "little")
    out += struct.pack("<I", len(p.ip.L))
    for l_b, r_b in zip(p.ip.L, p.ip.R):
        out += l_b + r_b
    out += (p.ip.a % ELL).to_bytes(32, "little")
    out += (p.ip.b % ELL).to_bytes(32, "little")
    return bytes(out)


def serialize_range_proof(p: RangeProof) -> bytes:
    return _body(bytearray(struct.pack("<I", p.n)), p,
                 [p.V, p.A, p.S, p.T1, p.T2])


def serialize_aggregated_proof(p: AggregatedRangeProof) -> bytes:
    if len(p.V) != p.m:
        raise ValueError(f"{len(p.V)} commitments for m = {p.m}")
    return _body(bytearray(struct.pack("<II", p.n, p.m)), p,
                 [*p.V, p.A, p.S, p.T1, p.T2])


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.off = data, 0

    def take(self, k: int) -> bytes:
        if self.off + k > len(self.data):
            raise ValueError("truncated proof")
        blob = self.data[self.off:self.off + k]
        self.off += k
        return blob

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def tail(self):
        """taux, mu, t_hat and the inner-product proof, to the end."""
        taux, mu, t_hat = (int.from_bytes(self.take(32), "little")
                           for _ in range(3))
        k = self.u32()
        if k > 32:
            raise ValueError("bad round count")
        L, R = [], []
        for _ in range(k):
            L.append(self.take(32))
            R.append(self.take(32))
        a = int.from_bytes(self.take(32), "little")
        b = int.from_bytes(self.take(32), "little")
        if self.off != len(self.data):
            raise ValueError("trailing bytes")
        ip = InnerProductProof(n=(1 << k) if k else 1, L=L, R=R, a=a, b=b)
        return taux, mu, t_hat, ip


def deserialize_range_proof(data: bytes) -> RangeProof:
    r = _Reader(data)
    n = r.u32()
    pts = [r.take(32) for _ in range(5)]
    taux, mu, t_hat, ip = r.tail()
    return RangeProof(n=n, V=pts[0], A=pts[1], S=pts[2], T1=pts[3],
                      T2=pts[4], taux=taux, mu=mu, t_hat=t_hat, ip=ip)


def deserialize_aggregated_proof(data: bytes) -> AggregatedRangeProof:
    r = _Reader(data)
    n, m = r.u32(), r.u32()
    if m > 1 << 20:
        raise ValueError("bad aggregation count")
    V = [r.take(32) for _ in range(m)]
    pts = [r.take(32) for _ in range(4)]
    taux, mu, t_hat, ip = r.tail()
    return AggregatedRangeProof(n=n, m=m, V=V, A=pts[0], S=pts[1],
                                T1=pts[2], T2=pts[3], taux=taux, mu=mu,
                                t_hat=t_hat, ip=ip)
