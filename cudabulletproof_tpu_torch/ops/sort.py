"""The counting sort that groups an MSM window's points by digit, the
counterpart of ``cudabulletproof_tpu/ops/pallas_sort.py`` (``_pass_rank``
:75, ``_to_blocks`` :112, ``_plan_passes`` :117, ``grouping_order`` :126).

LSD passes of at most 8 bits.  A pass counts each key value per (sublane s,
lane l) slot of the keys' block layout ``[nblk, 8, 128]`` (the sort_hist
kernel on the card, ``hist_plain`` on the CPU), takes the exclusive prefix
of the counts flattened in (value, s, l) order as each slot's first rank of
each value (torch), and hands each key its rank (sort_rank, ``rank_plain``).
Ranks are stable in (s, l, block t) traversal order, so element positions
between passes follow the JAX package's convention p(t, s, l) = (s * 128 +
l) * nblk + t: ranks are positions in it, the scatter uses them as linear
indices, and the next pass's block layout is a reshape and a transpose.
The result is the same permutation as a stable argsort of the digits,
integer for integer.
"""
from __future__ import annotations

import torch

from . import cuda_sort

SUB, LN = cuda_sort.SUB, cuda_sort.LN
BLOCK = SUB * LN                        # 1024 keys a block


def hist_plain(keys: torch.Tensor, radix: int) -> torch.Tensor:
    """Plain twin of sort_hist: keys [nblk, 8, 128] -> counts [radix, 8,
    128] int32; a key outside [0, radix) is not counted."""
    slot = torch.arange(BLOCK, device=keys.device)
    k = keys.reshape(-1, BLOCK).long()
    valid = (k >= 0) & (k < radix)
    idx = (k * BLOCK + slot)[valid]
    counts = torch.bincount(idx, minlength=radix * BLOCK)
    return counts.to(torch.int32).reshape(radix, SUB, LN)


def rank_plain(keys: torch.Tensor, base: torch.Tensor,
               radix: int) -> torch.Tensor:
    """Plain twin of sort_rank: keys [nblk, 8, 128], base [radix, 8, 128]
    -> rank [nblk, 8, 128] int32, base[key, s, l] plus the number of equal
    keys in earlier blocks of the slot; 0 for a key outside [0, radix)."""
    k = keys.long()
    valid = (k >= 0) & (k < radix)
    kc = k.clamp(0, radix - 1)
    onehot = (kc[..., None] == torch.arange(radix, device=keys.device)) \
        & valid[..., None]                              # [nblk, 8, 128, radix]
    before = onehot.to(torch.int32).cumsum(0) - onehot.to(torch.int32)
    seen = torch.take_along_dim(before, kc[..., None], dim=-1)[..., 0]
    first = torch.take_along_dim(base.permute(1, 2, 0)[None],
                                 kc[..., None], dim=-1)[..., 0]
    return torch.where(valid, first + seen, 0).to(torch.int32)


def hist(keys: torch.Tensor, radix: int) -> torch.Tensor:
    """The sort_hist kernel on a CUDA tensor, its plain twin on a CPU one."""
    if keys.device.type == "cpu":
        return hist_plain(keys, radix)
    return cuda_sort.hist(keys, radix)


def rank(keys: torch.Tensor, base: torch.Tensor, radix: int) -> torch.Tensor:
    """The sort_rank kernel on CUDA tensors, its plain twin on CPU ones."""
    if keys.device.type == "cpu" and base.device.type == "cpu":
        return rank_plain(keys, base, radix)
    return cuda_sort.rank(keys, base, radix)


def _pass_rank(keys_blk: torch.Tensor, radix: int) -> torch.Tensor:
    """keys_blk [nblk, 8, 128] (values < radix) -> rank [nblk, 8, 128]:
    each key's final position among equal keys, grouped ascending, stable in
    (s, l, t) traversal order."""
    counts = hist(keys_blk, radix)
    flat = counts.reshape(-1)
    base = (torch.cumsum(flat, 0) - flat).reshape(radix, SUB, LN)
    return rank(keys_blk, base.to(torch.int32), radix)


def _to_blocks(lin: torch.Tensor, nblk: int) -> torch.Tensor:
    """Linear positions p = (s * 128 + l) * nblk + t -> [nblk, 8, 128]."""
    return lin.reshape(SUB, LN, nblk).permute(2, 0, 1)


def _plan_passes(w: int, pass_bits: int) -> list:
    """(shift, bits) of each LSD pass over w-bit digits."""
    out = []
    done = 0
    while done < w:
        out.append((done, min(pass_bits, w - done)))
        done += out[-1][1]
    return out


def grouping_order(digits: torch.Tensor, w: int,
                   pass_bits: int = 7) -> torch.Tensor:
    """Permutation `order` (int32 [n]) such that digits[order] is grouped by
    value ascending, stable: digits int32 [n], values < 2^w, n a multiple
    of 1024; LSD passes of `pass_bits` (1..8) bits, each one sort_hist, one
    sort_rank and one [n] scatter."""
    n = digits.shape[0]
    if n % BLOCK:
        raise ValueError(f"grouping_order takes a multiple of {BLOCK} keys, "
                         f"not {n}")
    if not 1 <= pass_bits <= 8:
        raise ValueError(f"pass_bits {pass_bits} outside 1..8")
    nblk = n // BLOCK
    dev = digits.device
    order = _to_blocks(torch.arange(n, dtype=torch.int32, device=dev), nblk)
    for shift, bits in _plan_passes(w, pass_bits):
        keys = (digits[order.long()] >> shift) & ((1 << bits) - 1)
        rank = _pass_rank(keys, 1 << bits)
        lin = torch.zeros((n,), dtype=torch.int32, device=dev)
        lin[rank.reshape(-1).long()] = order.reshape(-1)
        order = _to_blocks(lin, nblk)
    return order.permute(1, 2, 0).reshape(-1)
