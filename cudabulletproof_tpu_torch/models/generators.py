"""Generators of the range proof as one packed tensor per device.

The same points as ``cudabulletproof_tpu/models/generators.py``
(``oracle.hash_to_point``: try-and-increment hash to the curve, cofactor
cleared), kept in the fused verifier's packed layout ``[2n+2, 80]`` int32:
rows G[0..n) | H[0..n) | g | h, each x|y|z|t as 20 radix-2^13 limbs.
The JAX package's fields (``g``, ``h``, ``G``, ``H`` as ``curve.GE`` and
their oracle copies ``g_pt``, ``h_pt``, ``G_pts``, ``H_pts``) are read-only
views of that one table.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve as C, field as F
from ..utils import oracle


@dataclass(frozen=True)
class Generators:
    n: int
    table: torch.Tensor          # [2n+2, 80]: G | H | g | h

    @property
    def device(self) -> torch.device:
        return self.table.device

    def pack(self, n: int) -> torch.Tensor:
        """[2n+2, 80] table for n-bit proofs (G[:n] | H[:n] | g | h)."""
        if n > self.n:
            raise ValueError(f"{self.n} generators cannot serve n={n}")
        N = self.n
        if n == N:
            return self.table
        t = self.table
        return torch.cat([t[:n], t[N:N + n], t[2 * N:2 * N + 2]])

    @property
    def G(self) -> C.GE:
        """The n vector generators G as GE [n] (views of the table)."""
        return C.unflatten(self.table[:self.n])

    @property
    def H(self) -> C.GE:
        return C.unflatten(self.table[self.n:2 * self.n])

    @property
    def g(self) -> C.GE:
        """The value generator g, unbatched."""
        return C.unflatten(self.table[2 * self.n])

    @property
    def h(self) -> C.GE:
        """The blinding generator h, unbatched."""
        return C.unflatten(self.table[2 * self.n + 1])

    @functools.cached_property
    def _points(self) -> list:
        return C.to_oracle(C.unflatten(self.table))

    @property
    def G_pts(self) -> tuple:
        """G as python-int oracle points, read from the table."""
        return tuple(self._points[:self.n])

    @property
    def H_pts(self) -> tuple:
        return tuple(self._points[self.n:2 * self.n])

    @property
    def g_pt(self) -> oracle.Point:
        return self._points[2 * self.n]

    @property
    def h_pt(self) -> oracle.Point:
        return self._points[2 * self.n + 1]


def _row(p: oracle.Point) -> list:
    return [v for c in (p.X, p.Y, p.Z, p.T) for v in F._int_limbs(c)]


@functools.lru_cache(maxsize=None)
def _oracle_table(n: int) -> np.ndarray:
    pts = ([oracle.hash_to_point(b"/G", i) for i in range(n)]
           + [oracle.hash_to_point(b"/H", i) for i in range(n)]
           + [oracle.hash_to_point(b"/g", 0), oracle.hash_to_point(b"/h", 0)])
    table = np.array([_row(p) for p in pts], dtype=np.int32)
    table.setflags(write=False)
    return table


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _cached(n: int, device: torch.device) -> Generators:
    return Generators(n, torch.from_numpy(_oracle_table(n).copy()).to(device))


def get_generators(n: int, device="cuda") -> Generators:
    """The n-bit generators on `device` (the card unless the caller asks for
    the CPU), built once per (n, device)."""
    return _cached(n, _normalize(device))


def from_jax_pack(pack: np.ndarray, n: int, device="cuda") -> Generators:
    """The JAX package's packed generators
    (``np.asarray(fused._gens_pack(gens, n))``, [2n+2, 80] int32) as the
    port's ``Generators``: the same table in the same layout."""
    pack = np.asarray(pack)
    if pack.shape != (2 * n + 2, 4 * F.L) or pack.dtype != np.int32:
        raise ValueError(f"expected int32 [{2 * n + 2}, 80], got "
                         f"{pack.dtype} {pack.shape}")
    return Generators(n, torch.from_numpy(pack.copy()).to(device))
