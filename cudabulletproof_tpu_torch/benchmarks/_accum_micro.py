"""One accumulator-MSM window pass with pieces of the step disabled: the
counterpart of ``benchmarks/_accum_micro.py``.

    python -m cudabulletproof_tpu_torch.benchmarks._accum_micro \\
        <variant>[,<variant>...] [w lanes unroll] [--n N]

Variants: full nosel noadd cached tree (``ops/micro.py`` says what each
does); a comma-separated list runs each in turn in one process.  Defaults
and inputs are the JAX script's: full, w = 4 (nb = 2^(w-1) + 1 buckets),
1024 lanes, unroll 4, n = 2^16 points, nw = 65 windows, steps = n /
(lanes * unroll); the points ``pt`` [steps, unroll, lanes, 80] have limbs
3 / 1 / 5 at rows 0 / L / 2L, the digits [nw, steps, unroll, lanes] come
from ``numpy.random.default_rng(0)`` in [-(nb - 1), nb - 1].  One call of
``micro.accum_window`` (the ge_accum_window kernel on the card) runs every
window; it keeps the buckets in shared memory when a block's lanes of
them fit (w <= 4), else in device memory.

On the card the kernel's output must first equal its plain twin's limb
for limb (a mismatch raises: the exit code is nonzero; the JAX script
catches every exception and prints FAILED).  The time is the median of
``--reps`` (5) calls after a warm-up, by CUDA events on the card and the
host clock on the CPU (BP_PLATFORM=cpu: the plain twin, no device metric).

Prints the JAX script's line per variant: ``VARIANT <v> w=<w>
lanes=<lanes> u=<unroll>: <ms> ms total (<nw> win)  <ms> ms/window  <us>
us/slot``, with three or four decimals where the JAX script prints one
or two.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import micro as MC
from .bench_addrate import median_ms

NW = 65


def inputs(w: int, lanes: int, unroll: int, n: int, dev: torch.device):
    """The JAX script's pt and digits in the port's layout."""
    nb = MC.nb_for(w)
    steps = n // (lanes * unroll)
    pt = torch.zeros((steps, unroll, lanes, MC.ROW), dtype=torch.int32)
    pt[..., 0], pt[..., MC.L], pt[..., 2 * MC.L] = 3, 1, 5
    rng = np.random.default_rng(0)
    dg = rng.integers(-(nb - 1), nb, (NW, steps, unroll, lanes))
    return pt.to(dev), torch.from_numpy(dg.astype(np.int32)).to(dev)


def main(argv=None) -> int:
    from ..cli import device
    ap = argparse.ArgumentParser(prog="_accum_micro",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("variant", nargs="?", default="full")
    ap.add_argument("w", nargs="?", type=int, default=4)
    ap.add_argument("lanes", nargs="?", type=int, default=1024)
    ap.add_argument("unroll", nargs="?", type=int, default=4)
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    variants = args.variant.split(",")
    for v in variants:
        if v not in MC.ACCUM_VARIANTS:
            raise ValueError(f"variant {v!r} not among {MC.ACCUM_VARIANTS}")
    dev = device()
    w, lanes, unroll = args.w, args.lanes, args.unroll
    nb = MC.nb_for(w)
    pt, dg = inputs(w, lanes, unroll, args.n, dev)
    steps = pt.shape[0]
    if steps < 1:
        raise ValueError(f"n = {args.n} gives no step of {lanes} x {unroll}")
    for v in variants:
        def call(v=v):
            return MC.accum_window(pt, dg, v, nb)
        if dev.type == "cuda":
            want = MC.accum_window_plain(pt, dg, v, nb)
            if not torch.equal(call(), want):
                raise AssertionError(f"VARIANT {v}: kernel != plain twin")
        ms = median_ms(call, args.reps, dev)
        slot_us = ms * 1e3 / (NW * steps * unroll)
        print(f"VARIANT {v} w={w} lanes={lanes} u={unroll}: {ms:.3f} ms "
              f"total ({NW} win)  {ms / NW:.4f} ms/window  "
              f"{slot_us:.3f} us/slot", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
