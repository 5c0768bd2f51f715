"""ge25519 in PyTorch: batched twisted-Edwards (a = -1) points in extended
coordinates, the counterpart of ``cudabulletproof_tpu/ops/curve.py``.

A batch of points is a ``GE`` of four int32 ``[..., 20]`` limb tensors
(X:Y:Z:T, T = XY/Z).  ``add``, ``double`` and ``scalarmult`` run their
hand-written CUDA kernel (``ops/cuda_curve.py``) on CUDA tensors and their
plain torch twin (``add_plain``, ``double_plain``, ``scalarmult_plain``) on CPU
tensors.  The twins follow the Pallas kernels' op order -- ``_padd`` (the same
as the JAX package's ``add_xla``), the dedicated doubling ``_pdbl``, the
windowed ladder ``_ladder_win_kernel`` and the binary ladder
``_ladder_kernel`` (``scalarmult_bin_plain``, twin of ge_ladder_bin) -- so
kernel and twin agree limb for limb.  ``config.LADDER_WINDOW`` picks the
ladder at call time.  (The JAX package's CPU ``double`` is
``add_xla(p, p)``, whose limbs differ from ``_pdbl``'s; the point is the
same.)  ``tree_reduce_tiles`` sums tiles of 256 points with the ge_reduce
kernel (twin ``reduce_tiles_plain``, the ``_reduce_kernel`` order).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..utils import oracle
from . import cuda_curve
from . import field as F
from .consts import on_device


class GE(NamedTuple):
    """Extended-coordinate point(s); each field an int32 tensor [..., 20]."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[:-1]


_D_LIMBS = np.array(F._int_limbs(oracle.D), dtype=np.int32)
_D2_LIMBS = np.array(F._int_limbs(oracle.D2), dtype=np.int32)
_SQRT_M1_LIMBS = np.array(F._int_limbs(oracle.SQRT_M1), dtype=np.int32)


def _on_cpu(*pts: GE) -> bool:
    return all(p.x.device.type == "cpu" for p in pts)


# --- construction and host conversion ----------------------------------------
def identity(shape=(), device="cpu") -> GE:
    return GE(F.zeros(shape, device), F.ones(shape, device),
              F.ones(shape, device), F.zeros(shape, device))


def from_oracle(points, device="cpu") -> GE:
    """list[oracle.Point] -> GE [n] (unbatched for one point, as in the JAX
    package)."""
    cols = [F.from_ints([getattr(p, c) for p in points], device)
            for c in "XYZT"]
    if len(points) == 1:
        cols = [c[0] for c in cols]
    return GE(*cols)


def to_oracle(p: GE) -> list:
    """GE [n] (or unbatched) -> list[oracle.Point]."""
    cols = [F.to_ints(c.reshape(-1, F.L)) for c in p]
    return [oracle.Point(*(v[i] % F.P for v in cols))
            for i in range(len(cols[0]))]


def base_point(shape=(), device="cpu") -> GE:
    b = from_oracle([oracle.BASE], device)
    return broadcast(b, shape)


def broadcast(p: GE, shape) -> GE:
    return GE(*(c.expand(*shape, F.L) for c in p))


def flatten(p: GE) -> torch.Tensor:
    """GE [...] -> [..., 80] (x|y|z|t)."""
    return torch.cat(list(p), dim=-1)


def unflatten(a: torch.Tensor) -> GE:
    return GE(*a.split(F.L, dim=-1))


# --- group law ---------------------------------------------------------------
def add_plain(p: GE, q: GE) -> GE:
    """Plain twin of the ge_add kernel: unified add-2008-hwcd-3 (a = -1)."""
    d2 = on_device(_D2_LIMBS, p.x.device)
    a = F.mul_plain(F.sub(p.y, p.x), F.sub(q.y, q.x))
    b = F.mul_plain(F.add(p.y, p.x), F.add(q.y, q.x))
    c = F.mul_plain(F.mul_plain(p.t, d2), q.t)
    zz = F.mul_plain(p.z, q.z)
    d = F.add(zz, zz)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return GE(F.mul_plain(e, f), F.mul_plain(g, h), F.mul_plain(f, g),
              F.mul_plain(e, h))


def double_plain(p: GE) -> GE:
    """Plain twin of the ge_double kernel: dedicated doubling, 4S + 4M."""
    xx = F.sq_plain(p.x)
    yy = F.sq_plain(p.y)
    zz2 = F._relax(F.sq_plain(p.z) * 2, 2)
    xy2 = F.sub(F.sq_plain(F.add(p.x, p.y)), F.add(xx, yy))     # 2xy
    yp = F.add(yy, xx)
    zp = F.sub(yy, xx)
    tp = F.sub(zz2, zp)
    return GE(F.mul_plain(xy2, tp), F.mul_plain(yp, zp), F.mul_plain(zp, tp),
              F.mul_plain(xy2, yp))


def add(p: GE, q: GE) -> GE:
    """Unified extended add; valid for doubling and identity operands."""
    if _on_cpu(p, q):
        return add_plain(p, q)
    return GE(*cuda_curve.add(p, q))


def double(p: GE) -> GE:
    if _on_cpu(p):
        return double_plain(p)
    return GE(*cuda_curve.double(p))


def neg(p: GE) -> GE:
    return GE(F.neg(p.x), p.y, p.z, F.neg(p.t))


def sub(p: GE, q: GE) -> GE:
    return add(p, neg(q))


def select(cond: torch.Tensor, a: GE, b: GE) -> GE:
    """Elementwise (over batch dims) cond ? a : b."""
    c = cond.bool().unsqueeze(-1)
    return GE(*(torch.where(c, ca, cb) for ca, cb in zip(a, b)))


# --- scalar multiplication ---------------------------------------------------
SCALAR_BITS = F.L * F.W                 # 260 bits of 20 13-bit limbs
WINDOWS = SCALAR_BITS // 4              # 65 four-bit windows
# window w (0 = most significant) reads value bits 256-4w .. 259-4w: limb
# k = lo // 13 shifted right by off = lo % 13, OR'd with limb k+1 shifted
# left by 13 - off (bits above 3 are masked off)
_WIN_LO = 256 - 4 * np.arange(WINDOWS)
_WIN_K = (_WIN_LO // F.W).astype(np.int64)
_WIN_K1 = _WIN_K + 1
_WIN_OFF = (_WIN_LO % F.W).astype(np.int32)
_WIN_SHL = (F.W - _WIN_OFF).astype(np.int32)


def ladder_digits(s: torch.Tensor) -> torch.Tensor:
    """[n, 20] scalar limbs -> [n, 65] 4-bit window digits, most significant
    window first (the kernel's ladder_digit; equal to the TPU ladder's
    shifted-register digits for limbs in [0, 2^13))."""
    dev = s.device
    sp = torch.nn.functional.pad(s, (0, 1))
    bits = (sp[:, on_device(_WIN_K, dev)] >> on_device(_WIN_OFF, dev)) | (
        sp[:, on_device(_WIN_K1, dev)] << on_device(_WIN_SHL, dev))
    return (bits & 15).long()


def scalarmult_plain(p: GE, s: torch.Tensor) -> GE:
    """Plain twin of the ge_ladder_win kernel: p [n] times s [n, 20] (scalar
    limbs in [0, 2^13)), fixed 4-bit windows over a 16-entry table."""
    n = s.shape[0]
    tab = [identity((n,), s.device), p]
    for j in range(2, 16):
        tab.append(double_plain(tab[j // 2]) if j % 2 == 0
                   else add_plain(tab[j - 1], p))
    table = torch.stack([flatten(t) for t in tab])          # [16, n, 80]
    digits = ladder_digits(s)
    rows = torch.arange(n, device=s.device)
    acc = tab[0]
    for w in range(WINDOWS):
        for _ in range(4):
            acc = double_plain(acc)
        acc = add_plain(acc, unflatten(table[digits[:, w], rows]))
    return acc


def scalarmult_bin_plain(p: GE, s: torch.Tensor) -> GE:
    """Plain twin of the ge_ladder_bin kernel: p [n] times s [n, 20] (scalar
    limbs in [0, 2^13)), binary double-and-add over the 260 bits, most
    significant first (bit 12 of limb 19 down to bit 0 of limb 0).  A step
    doubles with the unified add, as the Pallas ``_ladder_kernel`` does (not
    the dedicated doubling), adds p, and keeps the sum where the bit is 1."""
    acc = identity(s.shape[:-1], s.device)
    for k in range(SCALAR_BITS - 1, -1, -1):
        bit = (s[:, k // F.W] >> (k % F.W)) & 1
        acc = add_plain(acc, acc)
        acc = select(bit, add_plain(acc, p), acc)
    return acc


def scalarmult(p: GE, s: torch.Tensor) -> GE:
    """Batched scalar multiplication: p [...] times s [..., 20] (scalars <
    2^253 as 13-bit limbs, as ``scalar_field.to_field_limbs`` gives them);
    batch dims broadcast.  The ladder is ``config.LADDER_WINDOW``'s: 4 the
    fixed-window one (ge_ladder_win), 0 the binary one (ge_ladder_bin)."""
    window = config.LADDER_WINDOW
    if window not in (4, 0):
        raise ValueError(f"config.LADDER_WINDOW is {window!r}; the ladders "
                         "are 4 (fixed window) and 0 (binary)")
    batch = torch.broadcast_shapes(p.batch_shape, s.shape[:-1])
    if not (_on_cpu(p) and s.device.type == "cpu"):
        kernel = cuda_curve.ladder if window == 4 else cuda_curve.ladder_bin
        return GE(*kernel(p, s))
    plain = scalarmult_plain if window == 4 else scalarmult_bin_plain
    flat = GE(*(c.expand(*batch, F.L).reshape(-1, F.L) for c in p))
    out = plain(flat, s.expand(*batch, F.L).reshape(-1, F.L))
    return GE(*(c.reshape(*batch, F.L) for c in out))


# --- normalization and compression -------------------------------------------
def normalize(p: GE) -> GE:
    """Z -> 1 by a field inversion (one per point)."""
    zi = F.invert(p.z)
    x = F.mul(p.x, zi)
    y = F.mul(p.y, zi)
    return GE(x, y, F.ones(p.batch_shape, p.x.device), F.mul(x, y))


def normalize_batch(p: GE) -> GE:
    """normalize for GE [n] with ONE inversion (``F.batch_invert``)."""
    if len(p.batch_shape) != 1:
        raise ValueError(f"normalize_batch takes GE [n], got "
                         f"{tuple(p.batch_shape)}")
    zi = F.batch_invert(p.z)
    x = F.mul(p.x, zi)
    y = F.mul(p.y, zi)
    return GE(x, y, F.ones(p.batch_shape, p.x.device), F.mul(x, y))


def _compress(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Affine (x, y) -> 32-byte LE y with the sign of x in bit 255."""
    sign = (F.canonical(x)[..., 0] & 1).to(torch.uint8)
    yb = F.to_bytes(y)
    yb[..., 31] |= sign << 7
    return yb


def to_bytes(p: GE) -> torch.Tensor:
    """Compress: uint8 [..., 32], one inversion per point."""
    zi = F.invert(p.z)
    return _compress(F.mul(p.x, zi), F.mul(p.y, zi))


def to_bytes_batch(p: GE) -> torch.Tensor:
    """Compress GE [n] with ONE inversion: uint8 [n, 32]."""
    zi = F.batch_invert(p.z)
    return _compress(F.mul(p.x, zi), F.mul(p.y, zi))


# --- decompression -----------------------------------------------------------
def _select_fe(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(cond.unsqueeze(-1), a, b)


def from_bytes(b: torch.Tensor):
    """Decompress uint8 [..., 32]; returns (GE, valid).  valid is false for
    a y that is not canonical (>= p), a y with no square root, and x = 0
    with the sign bit set."""
    dev = b.device
    sign = (b[..., 31] >> 7).to(F.DTYPE)
    yb = b.clone()
    yb[..., 31] &= 0x7F
    y = F.from_bytes(yb)
    one = F.ones(y.shape[:-1], dev)
    y2 = F.sq(y)
    u = F.sub(y2, one)                                          # y^2 - 1
    v = F.add(F.mul(on_device(_D_LIMBS, dev), y2), one)         # d y^2 + 1
    v3 = F.mul(F.sq(v), v)
    v7 = F.mul(F.sq(v3), v)
    x = F.mul(F.mul(u, v3), F.pow2523(F.mul(u, v7)))
    vx2 = F.mul(v, F.sq(x))
    ok_direct = F.eq(vx2, u)
    ok_flip = F.eq(vx2, F.neg(u))
    x = _select_fe(ok_direct, x, F.mul(x, on_device(_SQRT_M1_LIMBS, dev)))
    valid = ok_direct | ok_flip
    valid = valid & torch.all(F.canonical(y) == y, dim=-1)
    valid = valid & ~(F.is_zero(x) & (sign == 1))
    x = _select_fe((F.canonical(x)[..., 0] & 1) == sign, x, F.neg(x))
    return GE(x, y, one, F.mul(x, y)), valid


# --- predicates and reductions -----------------------------------------------
def is_identity(p: GE) -> torch.Tensor:
    """X == 0 and Y == Z."""
    return F.is_zero(p.x) & F.eq(p.y, p.z)


def eq(p: GE, q: GE) -> torch.Tensor:
    """Exact projective equality over the batch dims (the JAX package's
    ``curve.eq`` :326): X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    ex = F.eq(F.mul(p.x, q.z), F.mul(q.x, p.z))
    ey = F.eq(F.mul(p.y, q.z), F.mul(q.y, p.z))
    return ex & ey


def mul8(p: GE) -> GE:
    """[8]P by three doublings (cofactor clearing)."""
    return double(double(double(p)))


def is_small_order(p: GE) -> torch.Tensor:
    """True where P lies in the 8-torsion subgroup (the identity included)."""
    return is_identity(mul8(p))


def tree_reduce(p: GE) -> GE:
    """Sum points GE [n, ...] over dim 0: identity-pad to a power of two,
    then halve with batched adds (log2 n launches of the add kernel on the
    card), the low half plus the high half."""
    n = p.x.shape[0]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = identity((m - n, *p.batch_shape[1:]), p.x.device)
        p = GE(*(torch.cat([c, pc]) for c, pc in zip(p, pad)))
    while m > 1:
        half = m // 2
        p = add(GE(*(c[:half] for c in p)), GE(*(c[half:] for c in p)))
        m = half
    return GE(*(c[0] for c in p))


REDUCE_TILE = cuda_curve.REDUCE_TILE         # pallas_field.LANES


def reduce_tiles_plain(p: GE) -> torch.Tensor:
    """Plain twin of the ge_reduce kernel: GE [n] -> [ceil(n / 256), 80],
    each tile of 256 points (identity past n) halved 8 times, lane i + half
    added into lane i."""
    rows = flatten(p)
    n = rows.shape[0]
    nt = -(-n // REDUCE_TILE)
    pad = flatten(identity((nt * REDUCE_TILE - n,), rows.device))
    t = torch.cat([rows, pad]).reshape(nt, REDUCE_TILE, 4 * F.L)
    m = REDUCE_TILE
    while m > 1:
        half = m // 2
        t = flatten(add_plain(unflatten(t[:, :half]), unflatten(t[:, half:m])))
        m = half
    return t[:, 0]


def tree_reduce_tiles(p: GE) -> GE:
    """Sum GE [n] (n >= 1): one partial per tile of 256 points (the ge_reduce
    kernel on the card), then ``tree_reduce`` of the partials, as the JAX
    package's ``pallas_curve.tree_reduce``."""
    if p.x.dim() != 2 or p.x.shape[0] == 0:
        raise ValueError(f"tree_reduce_tiles takes GE [n >= 1], got "
                         f"{tuple(p.x.shape)}")
    parts = unflatten(reduce_tiles_plain(p) if _on_cpu(p)
                      else cuda_curve.reduce_tiles(p))
    if parts.x.shape[0] == 1:
        return GE(*(c[0] for c in parts))
    return tree_reduce(parts)
