"""A/B of the radix-2^16 field multiply against the radix-2^13 one, the
counterpart of ``benchmarks/bench_radix16.py``:

    python -m cudabulletproof_tpu_torch.benchmarks.bench_radix16 [n] [reps]

Both sides run the same work: a chain of `reps` dependent multiplies
x <- x*b on n elements in one kernel launch (``radix16.mul_chain``, the
r16_mul_chain kernel; ``field.mul_chain``, the fe_mul_chain kernel), so
the launch cost cancels and the time is the multiplies'.  Before any
timing both chains run at reps = 3 on 4 values and must equal Python-int
products (a failed check raises, so the exit code is nonzero).  Defaults
and inputs are the JAX script's: n = 2^16, reps = 64,
``np.random.default_rng(7)``.  Each time is the median of 9 calls after a
warm-up, the host clock stopped after a device sync.  Runs on the card, or
on the CPU under BP_PLATFORM=cpu (the plain twins: no device metric).

Prints the JAX script's three lines: the correctness line, then
``radix13 20-limb mul: <ms> ms <rate> G mul/s`` and ``radix16 16-limb mul:
<ms> ms <rate> G mul/s (<ratio>x radix13)``; ms with four decimals (the JAX
script prints two).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import field as F, radix16 as R
from .bench_msm import timeit

GATE_REPS = 3


def check_chains(dev: torch.device, av: list, bv: list) -> None:
    """Both chains at reps = 3 on the values av, bv against Python ints;
    raises on a wrong value."""
    a16 = torch.from_numpy(np.stack([R.from_int(v) for v in av])).to(dev)
    b16 = torch.from_numpy(np.stack([R.from_int(v) for v in bv])).to(dev)
    got16 = R.mul_chain(a16, b16, GATE_REPS).cpu()
    got13 = F.to_ints(F.mul_chain(F.from_ints(av, dev), F.from_ints(bv, dev),
                                  GATE_REPS))
    for k in range(len(av)):
        want = av[k]
        for _ in range(GATE_REPS):
            want = want * bv[k] % R.P_INT
        if R.to_int(got16[k]) != want:
            raise AssertionError(f"radix16 chain wrong at {k}")
        if got13[k] % R.P_INT != want:
            raise AssertionError(f"radix13 chain wrong at {k}")


def main(argv=None) -> int:
    from ..cli import device
    ap = argparse.ArgumentParser(prog="bench_radix16",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1 << 16)
    ap.add_argument("reps", nargs="?", type=int, default=64)
    args = ap.parse_args(argv)
    n, reps = args.n, args.reps

    dev = device()
    rng = np.random.default_rng(7)
    av = [int(rng.integers(0, 1 << 62)) | (1 << 200) for _ in range(4)]
    bv = [int(rng.integers(0, 1 << 62)) | (1 << 150) for _ in range(4)]
    check_chains(dev, av, bv)
    print(f"correctness ok (chained muls vs oracle); n={n} reps={reps} "
          f"backend={dev.type}", flush=True)

    def draw(bits, width):
        return torch.from_numpy(rng.integers(0, 1 << bits, (n, width),
                                             dtype=np.int32)).to(dev)
    A16, B16 = draw(16, R.L16), draw(16, R.L16)
    A13, B13 = draw(13, F.L), draw(13, F.L)
    t16 = timeit(R.mul_chain, A16, B16, reps, iters=9, device=dev)
    t13 = timeit(F.mul_chain, A13, B13, reps, iters=9, device=dev)
    r16 = n * reps / t16 / 1e9
    r13 = n * reps / t13 / 1e9
    print(f"radix13 20-limb mul: {t13 * 1e3:8.4f} ms  {r13:6.2f} G mul/s",
          flush=True)
    print(f"radix16 16-limb mul: {t16 * 1e3:8.4f} ms  {r16:6.2f} G mul/s  "
          f"({r16 / r13:.2f}x radix13)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
