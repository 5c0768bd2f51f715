"""The radix-2^16 field representation in PyTorch, the counterpart of
``cudabulletproof_tpu/ops/radix16.py`` (an experiment on the limb layout;
no proof path uses it).

A field element is an int32 tensor ``[..., 16]`` of 16-bit limbs,
little-endian, weakly normalized: every limb in ``[0, BOUND16]`` with
``BOUND16 = 2^16 + 38``; the value may be >= p.  2^256 = 38 (mod p) is the
wrap factor.

The multiply keeps the reference's arithmetic step by step (``_conv16``),
so kernel, twin and reference agree limb for limb.  A 16x16-bit limb
product does not fit int32, so ``b`` is split into 8-bit halves
(``b = b_lo + 2^8 b_hi``) and the convolution is summed in two banks,
``A = a * b_lo`` and ``B = a * b_hi`` (31 coefficients each, 2 x 256 limb
products); ``A + 2^8 B`` is recombined into 32 coefficients
(``A_k + ((B_k & 0xFF) << 8) + (B_{k-1} >> 8)``); coefficients 16..31 fold
x38 into limbs 0..15 (their low 16 bits) and 1..15 (the rest); the double
wrap ``38 * (t_31 >> 16) * 38`` goes into limb 0; three relax passes whose
carry out of limb 15 re-enters limb 0 times 38.  For limbs up to
``BOUND16`` every intermediate stays below 2^31 (the reference's bounds,
``radix16.py:104-111, 137-138``), so int32 is exact; a wider limb is
outside the contract and may wrap.

Dispatch: ``mul``, ``sq`` and ``mul_chain`` run their CUDA kernel
(``ops/cuda_radix16.py``: r16_mul, r16_sq, r16_mul_chain) on a CUDA tensor
and their plain torch twin (``mul_plain``, ``sq_plain``,
``mul_chain_plain``) on a CPU tensor.  ``from_radix13``, ``to_int`` and
``from_int`` are plain on either device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from . import cuda_radix16
from .consts import on_device
from .field import DTYPE, L as L13, _on_cpu, limb_conv

L16 = 16
W16 = 16
MASK16 = (1 << 16) - 1
FOLD16 = 38                        # 2^256 mod p
BOUND16 = (1 << 16) + FOLD16       # the weak-normal limb bound (inclusive)
P_INT = (1 << 255) - 19

_ROLL_MULT16 = np.ones((L16,), dtype=np.int32)
_ROLL_MULT16[0] = FOLD16


# --- host conversions (exact, Python ints) ----------------------------------
def to_int(limbs) -> int:
    """[16] limbs -> Python int mod p."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    return sum(int(c) << (W16 * i)
               for i, c in enumerate(np.asarray(limbs).reshape(-1))) % P_INT


def from_int(v: int) -> np.ndarray:
    """Python int -> [16] canonical int32 limbs (numpy, as the reference)."""
    v %= P_INT
    return np.array([(v >> (W16 * i)) & MASK16 for i in range(L16)],
                    dtype=np.int32)


def _relax16(t: torch.Tensor, passes: int) -> torch.Tensor:
    """t <- (t & MASK16) + roll(t >> 16), the carry out of limb 15
    re-entering limb 0 times 38 (``_carry_relax16``)."""
    m = on_device(_ROLL_MULT16, t.device)
    for _ in range(passes):
        t = (t & MASK16) + torch.roll(t >> W16, 1, dims=-1) * m
    return t


def from_radix13(a: torch.Tensor) -> torch.Tensor:
    """[..., 20] radix-2^13 limbs -> [..., 16] radix-2^16 limbs, exact for
    weak-normal input (limbs up to 8799, so values above 2^255): each 13-bit
    limb lands in at most two 16-bit limbs, bits from 2^256 up collect in a
    17th limb that folds x38 into limb 0, then two relax passes."""
    out = torch.zeros(a.shape[:-1] + (L16 + 1,), dtype=DTYPE, device=a.device)
    for i in range(L13):
        j, off = divmod(13 * i, 16)
        x = a[..., i]
        out[..., j] += (x << off) & MASK16
        if off:
            out[..., j + 1] += x >> (16 - off)
    out, top = out[..., :L16], out[..., L16]
    out = out + tnf.pad((top * FOLD16)[..., None], (0, L16 - 1))
    return _relax16(out, 2)


# --- the multiply -------------------------------------------------------------
def _conv16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 16] x [..., 16] -> [..., 16] weak limbs, ``_conv16``'s steps."""
    A = limb_conv(a, b & 0xFF)                                # [..., 31]
    B = limb_conv(a, b >> 8)                                  # [..., 31]
    t = (tnf.pad(A, (0, 1)) + tnf.pad((B & 0xFF) << 8, (0, 1))
         + tnf.pad(B >> 8, (1, 0)))                           # [..., 32]
    main, top = t[..., :L16], t[..., L16:]
    acc = (main + FOLD16 * (top & MASK16)
           + tnf.pad(FOLD16 * (top >> W16), (1, 0))[..., :L16])
    wrap = FOLD16 * (t[..., 2 * L16 - 1] >> W16) * FOLD16
    acc = acc + tnf.pad(wrap[..., None], (0, L16 - 1))
    return _relax16(acc, 3)


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of the r16_mul kernel: a*b mod p, weak limbs."""
    return _conv16(a, b)


def sq_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain twin of the r16_sq kernel: ``_conv16(a, a)``, the same
    products as the multiply (the banks are not symmetric)."""
    return _conv16(a, a)


def mul_chain_plain(a: torch.Tensor, b: torch.Tensor,
                    reps: int) -> torch.Tensor:
    """Plain twin of the r16_mul_chain kernel: x <- x*b, `reps` times from
    x = a (reps <= 0 gives a, as the reference's fori_loop)."""
    x = torch.broadcast_tensors(a, b)[0].clone()
    for _ in range(reps):
        x = _conv16(x, b)
    return x


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b mod p on [..., 16] weak limbs; batch dims broadcast."""
    if _on_cpu(a, b):
        return mul_plain(a, b)
    return cuda_radix16.mul(a, b)


def sq(a: torch.Tensor) -> torch.Tensor:
    """a^2 mod p on [..., 16] weak limbs."""
    if _on_cpu(a):
        return sq_plain(a)
    return cuda_radix16.sq(a)


def mul_chain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """`reps` dependent multiplies x <- x*b from x = a, one kernel launch on
    the card (the reference's ``mul_chain``, the A/B shape of
    ``benchmarks/bench_radix16.py``)."""
    if _on_cpu(a, b):
        return mul_chain_plain(a, b, reps)
    return cuda_radix16.mul_chain(a, b, reps)
