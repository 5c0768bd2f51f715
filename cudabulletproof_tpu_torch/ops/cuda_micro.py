"""Wrappers of the hand-written CUDA microbenchmark kernels
(csrc/micro_kernels.cu, csrc/micro_window_kernels.cu).

    ge_add_chain     <- benchmarks/bench_addrate.py::chain_kernel (:100)
    ge_accum_window  <- benchmarks/_accum_micro.py::kernel (:30) and
                        benchmarks/_repro_accum3.py::kernel (:22)

``chain`` takes CUDA int32 point rows [..., 80], makes them contiguous and
flat, launches on PyTorch's current stream into an output made with
``torch.empty`` and restores the batch shape.  ``accum_window`` takes
``pt`` [steps, unroll, lanes, 80] and ``dg`` [nw, steps, unroll, lanes]
and returns [nw, 80] (or [nw, lanes, 80] for the lane variants); its
scratch (the buckets when they live in device memory, the lanes' totals
for the halving tree) is made with ``torch.empty``.  Both raise on anything
the kernels do not take; there is no fallback.  The plain twins live in
``ops/micro.py`` (``chain_plain``, ``accum_window_plain``), which takes
the op, pass-pair and variant encoding (the kernels' switch indices) and
the argument checks from here.

The window keeps its buckets in shared memory while a block's 64 lanes of
them fit (w <= 4), else in device memory (``uses_shared``).

``launches`` counts one per wrapper call that launched (the window's
halving tree is a second kernel of the same call).
"""
from __future__ import annotations

import torch

from ..utils import build
from .cuda_field import launch_rows

ROW = 80
launches = {"ge_add_chain": 0, "ge_accum_window": 0}
WINDOW_THREADS = 64                  # lanes of one window block
MAX_NB = 17                          # buckets the tree select holds (w <= 5)
SMEM_LIMIT = 232_448                 # bytes of shared memory a block may take
# the kernels' template indices: (mul_passes, add_passes) of
# bench_addrate's __main__ sweep, the chain ops, the window variants
PASS_PAIRS = ((5, 2), (4, 2), (3, 1), (1, 1), (0, 0))
CHAIN_OPS = ("add", "dbl")
ACCUM_VARIANTS = ("full", "nosel", "noadd", "cached", "tree")
REPRO_VARIANTS = ("full", "init_loop", "nostep", "nosign", "padd", "nofold",
                  "halvonly", "fori", "sufonly")
VARIANTS = ACCUM_VARIANTS + REPRO_VARIANTS[1:]
LANE_VARIANTS = ("nofold", "sufonly")      # outputs that keep every lane


def check_chain_args(op: str, mul_passes: int, add_passes: int) -> None:
    if op not in CHAIN_OPS:
        raise ValueError(f"chain op {op!r}: the JAX script's 'mul' branch "
                         "returns its input unchanged; use add or dbl")
    if (mul_passes, add_passes) not in PASS_PAIRS:
        raise ValueError(f"passes ({mul_passes}, {add_passes}) not among "
                         f"{PASS_PAIRS}")


def check_window_args(pt: torch.Tensor, dg: torch.Tensor, variant: str,
                      nb: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"window variant {variant!r} not among {VARIANTS}")
    if nb < 2:
        raise ValueError(f"{nb} buckets: needs at least 2")
    if dg.dim() != 4 or pt.dim() != 4 or pt.shape[-1] != ROW \
            or tuple(pt.shape[:3]) != (dg.shape[1], dg.shape[2], dg.shape[3]):
        raise ValueError(f"pt {tuple(pt.shape)} and dg {tuple(dg.shape)}: "
                         "needs [steps, unroll, lanes, 80] and "
                         "[nw, steps, unroll, lanes]")


def chain(p: torch.Tensor, op: str, k: int, mul_passes: int,
          add_passes: int) -> torch.Tensor:
    check_chain_args(op, mul_passes, add_passes)
    if k < 0:
        raise ValueError(f"chain of {k} ops")
    return launch_rows(launches, "ge_add_chain", ROW, p,
                       extra=(int(k), CHAIN_OPS.index(op),
                              PASS_PAIRS.index((mul_passes, add_passes))))


def window_smem_bytes(nb: int) -> int:
    """Shared memory of one window block holding its lanes' buckets."""
    return WINDOW_THREADS * nb * ROW * 4


def uses_shared(nb: int) -> bool:
    """Where the buckets live: shared memory when they fit one block,
    else device memory."""
    return window_smem_bytes(nb) <= SMEM_LIMIT


def accum_window(pt: torch.Tensor, dg: torch.Tensor, variant: str,
                 nb: int) -> torch.Tensor:
    check_window_args(pt, dg, variant, nb)
    if nb > MAX_NB:
        raise ValueError(f"{nb} buckets: the kernel holds at most {MAX_NB}")
    shared = uses_shared(nb)
    for t in (pt, dg):
        if t.device.type != "cuda":
            raise ValueError(f"kernel operand on {t.device}, needs a CUDA "
                             "tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operand of dtype {t.dtype}, needs int32")
    if pt.device != dg.device:
        raise ValueError(f"pt on {pt.device}, dg on {dg.device}")
    nw, steps, unroll, lanes = dg.shape
    pt, dg = pt.contiguous(), dg.contiguous()
    dev = pt.device
    lane_out = variant in LANE_VARIANTS
    out = torch.empty((nw, lanes, ROW) if lane_out else (nw, ROW),
                      dtype=torch.int32, device=dev)
    buckets = torch.empty((0 if shared else nw * nb * ROW * lanes,),
                          dtype=torch.int32, device=dev)
    totals = torch.empty((0 if lane_out else nw * ROW * lanes,),
                         dtype=torch.int32, device=dev)
    if nw and lanes:
        build.launch("bp_ge_accum_window", dev, pt, dg, out, buckets,
                     totals, nw, steps, unroll, lanes, nb,
                     VARIANTS.index(variant), int(shared))
        launches["ge_accum_window"] += 1
    return out
