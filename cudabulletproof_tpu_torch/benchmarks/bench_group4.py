"""The two kernels on the four-lane group law, timed on the card:
``ge_ladder_win`` at the verify path's 147 and 402 points and at
``config.MSM_LADDER_MAX`` (1024), ``ge_bucket_accum`` at the sizes of
``config.MSM_ACCUM_PLAN`` (2^12 and 2^13, the merged batches of 128 and 256
proofs; 2^16, ``msm_auto``'s chunk) with its combine kernel's share.

    python -m cudabulletproof_tpu_torch.benchmarks.bench_group4 [--reps N]
    python -m cudabulletproof_tpu_torch.benchmarks.bench_group4 --against DIR

Inputs come from a fixed numpy seed: weak-limb point rows (limbs in [0,
8799]) and scalars mod l, the accumulator's digits by
``pippenger.extract_digits_signed`` at the plan's window.  Every output must
equal its plain twin limb for limb (a wrong one raises).  A kernel's time
is the CUDA-event time of a run of ``--reps`` (20) launches after a
warm-up, divided by the count; the combine's share is its device time per
launch over such a run, as ``torch.profiler`` records it by kernel name.
The bound is the work's int32 multiply-adds over the card's IMAD rate
(``utils/profiling.py``).

``--against DIR`` (the root of another checkout of the repo, such as an
older commit unpacked with ``git archive``) builds DIR's ``csrc`` into a
second library and runs every shape in turns: DIR, this checkout, this
checkout, DIR, each output equal to the other library's; then the wall
times (host clock, median of 3 a turn) of host prove at n = 64 and
``msm_auto`` at 2^16 and 2^20 in the same turns.

Prints the card's ``name, power.limit`` first, then one line a shape and
library: ``<kernel> n=<n> <shape> [<library>] <ms> ms ... bound <ms> ms``.
"""
from __future__ import annotations

import argparse
import contextlib
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import config
from ..models import rangeproof as RP
from ..models.generators import get_generators
from ..ops import (cuda_curve, curve as C, field as F, msm as M,
                   pippenger as PP)
from ..utils import build, oracle
from ..utils.profiling import (FE_BYTES, IMAD_ADD, IMAD_DBL, IMAD_MADD,
                               PT_BYTES, bound, imad_per_s, smi)

SEED = 20261018
LADDER_SIZES = (147, 402, config.MSM_LADDER_MAX)
# the ladder's group operations a point: 7 table doublings and 65 x 4,
# 7 table adds and 65 window adds
LADDER_DBL, LADDER_ADD = 267, 72
DOWNSTREAM_MSM = (1 << 16, 1 << 20)
PROVE_BITS = 64


def ladder_work(n: int) -> tuple:
    """(IMADs, bytes) of the window ladder over n points: each point and
    scalar read once, each result written once."""
    return (n * (LADDER_DBL * IMAD_DBL + LADDER_ADD * IMAD_ADD),
            n * (2 * PT_BYTES + FE_BYTES))


def accum_work(dg: torch.Tensor, n: int, w: int) -> tuple:
    """(IMADs, bytes) the accumulator needs on these digits: one mixed add
    per nonzero digit, one weighted fold of 2^(w-1) buckets per window
    (2 adds a bucket) and the Horner combine; each operand row and digit
    read once, the result written once."""
    nw = dg.shape[0]
    nonzero = int((dg != 0).sum())
    imads = (nonzero * IMAD_MADD + nw * 2 * (1 << (w - 1)) * IMAD_ADD
             + nw * (w * IMAD_DBL + IMAD_ADD))
    return imads, n * PT_BYTES + dg.numel() * 4 + PT_BYTES


def run_ms(fn, reps: int) -> float:
    """CUDA-event ms of `reps` calls in a row, after a warm-up, over reps."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(fn, reps: int) -> dict:
    """Device ms a launch of each kernel name over `reps` calls of fn, as
    the profiler records them (its raw events, not ``prof.events()``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns()
    return {k: v / 1e6 / reps for k, v in by_name.items()}


def wall_ms(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def using(lib):
    """Every kernel wrapper launches from `lib` inside the block."""
    old = build._lib
    build._lib = lib
    try:
        yield
    finally:
        build._lib = old


def cases(dev):
    """(kernel, n, shape label, call, plain call, IMADs, bytes)."""
    rng = np.random.default_rng(SEED)

    def rows(n):
        return torch.from_numpy(rng.integers(0, F.BOUND + 1, size=(n, 80),
                                             dtype=np.int32)).to(dev)

    def scalars(n):
        return F.from_ints([int.from_bytes(rng.bytes(32), "little")
                            % oracle.ELL for _ in range(n)], dev)

    out = []
    for n in LADDER_SIZES:
        p, s = C.unflatten(rows(n)), scalars(n)
        out.append(("ge_ladder_win", n, "",
                    lambda p=p, s=s: C.flatten(C.GE(*cuda_curve.ladder(
                        p, s))),
                    lambda p=p, s=s: C.flatten(C.scalarmult_plain(p, s)),
                    *ladder_work(n)))
    for n in sorted(config.MSM_ACCUM_PLAN):
        w, threads, slices = config.accum_plan(n)
        pre = rows(n)
        dg = PP.extract_digits_signed(scalars(n), w)
        out.append(("ge_bucket_accum", n, f"(w, threads, slices)="
                    f"({w}, {threads}, {slices})",
                    lambda pre=pre, dg=dg, w=w, t=threads, s=slices:
                        cuda_curve.bucket_accum(pre, dg, w, t, s),
                    lambda pre=pre, dg=dg, w=w, t=threads, s=slices:
                        PP.bucket_accum_plain(pre, dg, w, t, s),
                    *accum_work(dg, n, w)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--against", type=Path, default=None,
                    help="root of another checkout: A/B its kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_group4: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"), flush=True)
    rate = imad_per_s()[0]
    libs = [("this", build.lib())]
    if args.against is not None:
        other = build.load(build.build(
            args.against / "cudabulletproof_tpu_torch" / "csrc"))
        libs = [(str(args.against), other), libs[0]]
    turns = libs + libs[::-1] if len(libs) == 2 else libs
    for name, n, shape, kern, plain, imads, nbytes in cases(dev):
        want = plain()
        times = {label: [] for label, _ in libs}
        split = {}
        for label, lib in turns:
            with using(lib):
                got = kern()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} n={n} [{label}] != plain")
                times[label].append(run_ms(kern, args.reps))
                if name == "ge_bucket_accum" and label not in split:
                    split[label] = device_ms_by_kernel(kern, args.reps)
        bound_ms, by = bound(imads, nbytes, rate)
        for label, _ in libs:
            ms = " ".join(f"{t:.4f}" for t in times[label])
            extra = ""
            if label in split:
                parts = {k: v for k, v in split[label].items()
                         if re.search(r"ge_bucket_[a-z]+_kernel", k)}
                extra = "; device ms a launch: " + ", ".join(
                    f"{re.search(r'ge_bucket_[a-z]+_kernel', k).group(0)} "
                    f"{v:.4f}" for k, v in sorted(parts.items()))
            print(f"{name} n={n} {shape} [{label}] {ms} ms{extra}; bound "
                  f"{bound_ms:.4f} ms ({by})", flush=True)
    if args.against is None:
        return 0
    gens = get_generators(PROVE_BITS, dev)
    rng = np.random.default_rng(SEED + 1)
    big = max(DOWNSTREAM_MSM)
    pts = C.unflatten(torch.from_numpy(rng.integers(
        0, F.BOUND + 1, size=(big, 80), dtype=np.int32)).to(dev))
    sc = F.from_ints([int.from_bytes(rng.bytes(32), "little") % oracle.ELL
                      for _ in range(big)], dev)
    down = [(f"host prove n={PROVE_BITS}",
             lambda: RP.prove((1 << PROVE_BITS) - 1, 0x5EED, PROVE_BITS,
                              gens))]
    for n in DOWNSTREAM_MSM:
        down.append((f"msm_auto n={n}",
                     lambda n=n: M.msm_auto(C.GE(*(c[:n] for c in pts)),
                                            sc[:n])))
    for label, fn in down:
        times = {lab: [] for lab, _ in libs}
        for lab, lib in turns:
            with using(lib):
                fn()
                times[lab].append(wall_ms(fn))
        for lab, _ in libs:
            print(f"wall {label} [{lab}] "
                  + " ".join(f"{t:.2f}" for t in times[lab]) + " ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
