"""The window kernel's variants, each stripping one piece of the step or
the fold, run once and checked: the counterpart of
``benchmarks/_repro_accum3.py`` (which bisected a TPU compiler crash).

    python -m cudabulletproof_tpu_torch.benchmarks._repro_accum3 \\
        <variant>[,<variant>...]

Variants: full init_loop nostep nosign padd nofold halvonly fori sufonly
(``ops/micro.py`` says what each does); a comma-separated list runs each
in turn in one process.  Shapes and inputs are the JAX script's: nw = 2
windows, 4 steps, unroll 1, 1024 lanes, nb = 9 buckets; the points ``pt``
[steps, unroll, lanes, 80] have limb 1 at rows L and 2L, every digit is 0.
One call of ``micro.accum_window`` (the ge_accum_window kernel on the
card) runs both windows; on the card its output must equal its plain
twin's limb for limb, and a mismatch or a failed launch raises, so the
exit code is nonzero (the JAX script catches every exception and prints
FAILED).  Runs on the card, or on the CPU under BP_PLATFORM=cpu (the plain
twin).

Prints the JAX script's line per variant, ``VARIANT <v> OK (2, 80,
1024)``: the shape of the JAX kernel's output block, of which the port
returns lane 0 ([nw, 80]), or every lane ([nw, lanes, 80]) for nofold and
sufonly.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..ops import micro as MC

NW, STEPS, UNROLL, LANES, NB = 2, 4, 1, 1024, 9


def inputs(dev: torch.device):
    pt = torch.zeros((STEPS, UNROLL, LANES, MC.ROW), dtype=torch.int32)
    pt[..., MC.L], pt[..., 2 * MC.L] = 1, 1
    dg = torch.zeros((NW, STEPS, UNROLL, LANES), dtype=torch.int32)
    return pt.to(dev), dg.to(dev)


def main(argv=None) -> int:
    from ..cli import device
    ap = argparse.ArgumentParser(prog="_repro_accum3",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("variant", nargs="?", default="full")
    args = ap.parse_args(argv)
    variants = args.variant.split(",")
    for v in variants:
        if v not in MC.REPRO_VARIANTS:
            raise ValueError(f"variant {v!r} not among {MC.REPRO_VARIANTS}")
    dev = device()
    pt, dg = inputs(dev)
    for v in variants:
        out = MC.accum_window(pt, dg, v, NB)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            if not torch.equal(out, MC.accum_window_plain(pt, dg, v, NB)):
                raise AssertionError(f"VARIANT {v}: kernel != plain twin")
        print("VARIANT", v, "OK", (NW, MC.ROW, LANES), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
