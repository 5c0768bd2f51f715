"""Batched scalar arithmetic mod l (the group order) in plain PyTorch.

l = 2^252 + delta, delta ~ 2^124.4.  Counterpart of
``cudabulletproof_tpu/ops/scalar_field.py``, which computes it in XLA with no
Pallas kernel; here it is plain torch on either device.  Same representation
and op sequence, so the limbs agree with the JAX package's: int32 ``[..., 22]``
of 12-bit limbs, little-endian, weakly normalized (each limb <= 2^13 - 1; the
value may be >= l).  Radix 2^12 puts the 2^252 fold boundary on a limb edge,
so reduction is limb-aligned: x = lo + 2^252 hi == lo - delta*hi (mod l),
evaluated all-positive as lo + (K - delta*hi) with K a multiple of l whose
digits dominate the subtrahend.  Every partial product and sum stays below
2^31 (asserted on host ints at import).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as tnf

from ..utils.oracle import ELL
from . import field as F
from .consts import on_device

SW = 12                      # bits per limb
SMASK = (1 << SW) - 1
SL = 22                      # limbs per scalar (264-bit capacity)
DELTA = ELL - (1 << 252)
DTYPE = torch.int32
WEAK = (1 << 13) - 1         # weak per-limb bound

_DELTA_NL = -(-DELTA.bit_length() // SW)            # 11 limbs
assert _DELTA_NL == 11


def _int_to_limbs(x: int, nl: int) -> np.ndarray:
    assert 0 <= x < (1 << (SW * nl)), (x.bit_length(), nl)
    return np.array([(x >> (SW * i)) & SMASK for i in range(nl)],
                    dtype=np.int32)


_DELTA_LIMBS = _int_to_limbs(DELTA, _DELTA_NL)


def _dominating_multiple(dom_max: int, need: int, nk: int) -> np.ndarray:
    """Digits (length nk, radix 2^12, each in [0, 2^15)) of a multiple of l
    whose digits 0..need-1 all exceed dom_max, so K - t is limb-wise
    non-negative for any t with limbs <= dom_max in 0..need-1."""
    B = sum((dom_max + 1) << (SW * i) for i in range(need))
    k = -(-max(B, ELL) // ELL) * ELL
    assert k < (1 << (SW * nk)), "nk too small for the dominating multiple"
    digits = np.array([(k >> (SW * i)) & SMASK for i in range(nk)],
                      dtype=np.int64)
    for i in range(need):
        while digits[i] <= dom_max:
            digits[i] += 1 << SW
            digits[i + 1] -= 1
    for i in range(nk - 1):                      # resolve borrow cascades
        while digits[i] < 0:
            digits[i] += 1 << SW
            digits[i + 1] -= 1
    assert digits[nk - 1] >= 0
    assert all(0 <= d < (1 << 15) for d in digits)
    assert all(digits[i] > dom_max for i in range(need))
    assert sum(int(d) << (SW * i) for i, d in enumerate(digits)) == k
    assert k % ELL == 0
    return digits.astype(np.int32)


# --- construction and host conversion ----------------------------------------
def from_int(x: int, shape=(), device="cpu") -> torch.Tensor:
    arr = torch.from_numpy(_int_to_limbs(x % ELL, SL)).to(device)
    return arr.expand(tuple(shape) + (SL,))


def from_ints(xs, device="cpu") -> torch.Tensor:
    out = np.zeros((len(xs), SL), dtype=np.int32)
    for j, x in enumerate(xs):
        out[j] = _int_to_limbs(x % ELL, SL)
    return torch.from_numpy(out).to(device)


def to_ints(a: torch.Tensor) -> list:
    """[..., SL] limbs -> python ints (NOT reduced mod l), flattened."""
    arr = a.detach().cpu().numpy().reshape(-1, SL)
    return [sum(int(v) << (SW * i) for i, v in enumerate(row)) for row in arr]


def zeros(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (SL,), dtype=DTYPE, device=device)


def ones(shape=(), device="cpu") -> torch.Tensor:
    out = zeros(shape, device)
    out[..., 0] = 1
    return out


# --- carry relaxation --------------------------------------------------------
def _relax_open(t: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry relaxation without wraparound (callers' value bounds
    keep every carry inside the top limb)."""
    for _ in range(passes):
        t = (t & SMASK) + tnf.pad((t >> SW)[..., :-1], (1, 0))
    return t


def _pad_last(t: torch.Tensor, extra: int) -> torch.Tensor:
    return tnf.pad(t, (0, extra))


assert SL * WEAK * WEAK < (1 << 31)


class _FoldPlan:
    """Static plan for folding an nl-limb weak value (nl > 21) at 2^252."""
    __slots__ = ("nl", "k_digits", "out")

    def __init__(self, nl: int):
        assert nl > 21
        nh = nl - 21
        nt = _DELTA_NL + nh - 1 + 1      # conv limbs + 1 relax headroom limb
        assert min(_DELTA_NL, nh) * WEAK * WEAK < (1 << 31)
        nk = max(nt + 1, SL + 1)
        digits = _dominating_multiple(1 << 13, nt, nk)
        while len(digits) > nt and digits[-1] == 0:  # trim so folds SHRINK
            digits = digits[:-1]
        self.k_digits = digits
        kval = sum(int(d) << (SW * i) for i, d in enumerate(digits))
        lo_max = sum(WEAK << (SW * i) for i in range(21))
        out = max(21, len(digits))
        while lo_max + kval >= (1 << (SW * out)):
            out += 1
        self.out = out
        self.nl = nl


@functools.lru_cache(maxsize=None)
def _fold_plan(nl: int) -> _FoldPlan:
    return _FoldPlan(nl)


def _fold_once(x: torch.Tensor) -> torch.Tensor:
    """One 2^252-boundary fold: [..., nl] weak -> [..., plan.out] weak."""
    plan = _fold_plan(x.shape[-1])
    lo, hi = x[..., :21], x[..., 21:]
    t = F.limb_conv(hi, on_device(_DELTA_LIMBS, x.device))
    t = _relax_open(_pad_last(t, 1), 3)              # limbs <= 4096
    k = on_device(plan.k_digits, x.device)
    y = k - _pad_last(t, len(plan.k_digits) - t.shape[-1])
    y = _pad_last(y, plan.out - y.shape[-1])
    y = y + _pad_last(lo, plan.out - 21)             # limbs < 2^16
    return _relax_open(y, 3)


def reduce_limbs(x: torch.Tensor) -> torch.Tensor:
    """Fold an arbitrary-width weak limb array down to SL limbs (mod l)."""
    while x.shape[-1] > SL:
        nxt = _fold_once(x)
        assert nxt.shape[-1] < x.shape[-1], "fold failed to shrink"
        x = nxt
    if x.shape[-1] < SL:
        x = _pad_last(x, SL - x.shape[-1])
    return x


for _nl in (23, 24, 25, 28, 36, 45, 47):    # the fold chain terminates
    _w = _nl
    for _ in range(8):
        if _w <= SL:
            break
        _w = _fold_plan(_w).out
    assert _w <= SL, (_nl, _w)


# --- ring ops ----------------------------------------------------------------
def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return reduce_limbs(_relax_open(_pad_last(a + b, 2), 2))


_KSUB = _dominating_multiple(WEAK, SL, SL + 2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(*batch, SL)
    b = b.expand(*batch, SL)
    y = on_device(_KSUB, b.device) - _pad_last(b, len(_KSUB) - SL)
    y = y + _pad_last(a, len(_KSUB) - SL)
    return reduce_limbs(_relax_open(_pad_last(y, 1), 3))


def neg(b: torch.Tensor) -> torch.Tensor:
    return sub(zeros(b.shape[:-1], b.device), b)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook convolution + limb-aligned folds; all int32-exact."""
    acc = F.limb_conv(a, b)                          # [..., 43]
    acc = _relax_open(_pad_last(acc, 2), 3)          # [..., 45]
    return reduce_limbs(acc)


def sq(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def sum_mod(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum of scalars along `dim` (a batch dim, not the limb dim) mod l."""
    n = x.shape[dim]
    assert n * WEAK < (1 << 31)
    s = x.sum(dim=dim, dtype=DTYPE)
    extra = -(-(n.bit_length() + 2) // SW) + 2
    return reduce_limbs(_relax_open(_pad_last(s, extra), 3))


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> mod l over dim 0: a batched ``mul``, then ``sum_mod``."""
    return sum_mod(mul(a, b), dim=0)


# --- canonical form and comparisons ------------------------------------------
_ELL_COMP = _int_to_limbs((1 << (SW * SL)) - ELL, SL)   # 2^264 - l


def _carry_seq(t: torch.Tensor):
    """Sequential full carry pass; returns (limbs, carry out of the top)."""
    limbs = t.unbind(-1)
    out = []
    c = torch.zeros_like(limbs[0])
    for i in range(SL):
        v = limbs[i] + c
        out.append(v & SMASK)
        c = v >> SW
    return torch.stack(out, dim=-1), c


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Fully reduce weak limbs to [0, l)."""
    x = reduce_limbs(_fold_once(_pad_last(a, 1)))
    x = reduce_limbs(_fold_once(_pad_last(x, 1)))
    x, _ = _carry_seq(x)
    comp = on_device(_ELL_COMP, a.device)
    for _ in range(2):
        u, c = _carry_seq(x + comp)                  # carry == 1 <=> x >= l
        x = torch.where((c > 0).unsqueeze(-1), u, x)
    return x


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=-1)


# --- serialization (32-byte little-endian, canonical) ------------------------
# byte j = bits 8j..8j+7: limb i0 = 8j // 12 shifted right by off = 8j % 12,
# OR'd with limb i0+1 shifted left by 12 - off
_TB_I0 = np.array([(8 * j) // SW for j in range(32)], dtype=np.int64)
_TB_I1 = _TB_I0 + 1
_TB_OFF = np.array([(8 * j) % SW for j in range(32)], dtype=np.int32)
_TB_SHL = (SW - _TB_OFF).astype(np.int32)
# limb i = bits 12i..12i+11: byte j0 = 12i // 8 (off = 12i % 8 in {0, 4}),
# OR'd with byte j0+1 shifted left by 8 - off
_FB_J0 = np.array([(SW * i) // 8 for i in range(SL)], dtype=np.int64)
_FB_J1 = _FB_J0 + 1
_FB_OFF = np.array([(SW * i) % 8 for i in range(SL)], dtype=np.int32)
_FB_SHL = (8 - _FB_OFF).astype(np.int32)


def to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Canonical 32-byte LE encoding, uint8 [..., 32] (the transcript's
    scalar format)."""
    dev = a.device
    ap = _pad_last(canonical(a), 1)
    v = (ap[..., on_device(_TB_I0, dev)] >> on_device(_TB_OFF, dev)) | (
        ap[..., on_device(_TB_I1, dev)] << on_device(_TB_SHL, dev))
    return (v & 0xFF).to(torch.uint8)


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """32-byte LE (any 256-bit value) -> weak limbs, NOT reduced mod l."""
    dev = b.device
    bp = _pad_last(b.to(DTYPE), 1)
    v = (bp[..., on_device(_FB_J0, dev)] >> on_device(_FB_OFF, dev)) | (
        bp[..., on_device(_FB_J1, dev)] << on_device(_FB_SHL, dev))
    return v & SMASK


# --- inversion and powers ----------------------------------------------------
_EXP_BITS = [(ELL - 2) >> i & 1 for i in range((ELL - 2).bit_length())][::-1]


def invert(x: torch.Tensor) -> torch.Tensor:
    """x^(l-2) mod l, MSB-first square-and-multiply over the 253 constant
    exponent bits (a multiply only where the bit is set)."""
    acc = ones(x.shape[:-1], x.device)
    for bit in _EXP_BITS:
        acc = sq(acc)
        if bit:
            acc = mul(acc, x)
    return acc


def powers(base: torch.Tensor, n: int) -> torch.Tensor:
    """[1, base, ..., base^(n-1)] along a new dim -2: base [..., SL] ->
    [..., n, SL], by log-doubling."""
    out = ones(base.shape[:-1] + (1,), base.device)
    k = 1
    cur = base                                       # base^(2^j) after j steps
    while k < n:
        take = min(k, n - k)
        out = torch.cat([out, mul(out[..., :take, :], cur.unsqueeze(-2))],
                        dim=-2)
        cur = sq(cur)
        k += take
    return out


def to_field_limbs(a: torch.Tensor) -> torch.Tensor:
    """Scalar limbs (22 x 12 bits, mod l) -> the MSM's 20 x 13-bit field
    limbs, through the canonical byte form."""
    return F.from_bytes(to_bytes(a))
