"""Wrappers of the hand-written CUDA counting-sort kernels
(csrc/scan_kernels.cu).

    sort_hist  <- cudabulletproof_tpu/ops/pallas_sort.py::_hist_kernel
    sort_rank  <- pallas_sort.py::_rank_kernel

Keys are one LSD pass's digits in ``ops/sort.py``'s block layout
``[nblk, 8, 128]`` (int32, values below radix <= 256).  Each kernel runs 32
blocks, each owning 32 of the 1024 (sublane, lane) slots with its counters
in shared memory (the design is in the source's header); a call is one
``torch.empty`` (the output) and one launch.  Each wrapper checks its CUDA
int32 operands, launches on PyTorch's current stream and raises on
anything the kernels do not take; there is no fallback.  The plain twins are ``sort.hist_plain`` and
``sort.rank_plain``.  ``launches`` counts kernel launches, one per launch
and nowhere else.
"""
from __future__ import annotations

import torch

from ..utils import build

SUB, LN = 8, 128                   # a block of keys: 8 sublanes x 128 lanes
launches = {"sort_hist": 0, "sort_rank": 0}


def _keys(keys: torch.Tensor, radix: int) -> torch.Tensor:
    if keys.device.type != "cuda":
        raise ValueError(f"keys on {keys.device}, need a CUDA tensor")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys of dtype {keys.dtype}, need int32")
    if keys.dim() != 3 or tuple(keys.shape[1:]) != (SUB, LN):
        raise ValueError(f"keys of shape {tuple(keys.shape)}, need "
                         f"[nblk, {SUB}, {LN}]")
    if not 1 <= radix <= 256:
        raise ValueError(f"radix {radix} outside 1..256")
    return keys.contiguous()


def hist(keys: torch.Tensor, radix: int) -> torch.Tensor:
    """keys [nblk, 8, 128] -> counts [radix, 8, 128]: per (sublane, lane)
    slot, how many of its nblk keys equal each value."""
    keys = _keys(keys, radix)
    counts = torch.empty((radix, SUB, LN), dtype=torch.int32,
                         device=keys.device)
    build.launch("bp_sort_hist", keys.device, keys, counts, keys.shape[0],
                 radix)
    launches["sort_hist"] += 1
    return counts


def rank(keys: torch.Tensor, base: torch.Tensor, radix: int) -> torch.Tensor:
    """keys [nblk, 8, 128], base [radix, 8, 128] (each slot's first rank of
    each value) -> rank [nblk, 8, 128]: base plus the count of equal keys
    before it in its slot's block order."""
    keys = _keys(keys, radix)
    if base.device != keys.device or base.dtype != torch.int32 or \
            tuple(base.shape) != (radix, SUB, LN):
        raise ValueError(f"bases {base.dtype} {tuple(base.shape)} on "
                         f"{base.device}, need int32 [{radix}, {SUB}, {LN}] "
                         f"on {keys.device}")
    base = base.contiguous()
    out = torch.empty_like(keys)
    build.launch("bp_sort_rank", keys.device, keys, base, out, keys.shape[0],
                 radix)
    launches["sort_rank"] += 1
    return out
