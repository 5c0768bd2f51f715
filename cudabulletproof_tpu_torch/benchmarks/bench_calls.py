"""The calls of the port's kernels that read their operands in place,
timed on the card: ``ge_add`` at 402 points (the MSM of a merged batch of
16 proofs) and ``ge_double`` at 402 on the coordinate views of an earlier
kernel's output and at one point ``[20]`` (the Straus and Horner
accumulators'), and ``fe_mul`` at 272 elements (the batch of 16's
decompression) on contiguous rows and against a broadcast constant, and
at 10,000 (the CLI's microbenchmark); each size beside one ``torch.add``
of two ``[n, 20]`` tensors, a host floor measured the same way (it does
not compute the field product); ``fe_sq`` at 272 on contiguous rows (the
only layout the paths hand it); the tile reduction ``ge_reduce`` at 256,
1024 and 4096 points on the coordinate views of an ``[n, 80]`` output (one
tile, ``msm_auto``'s largest ladder route, the kernel table's).  Then a wrapper that shares
only the launch path with them, ``fe_add`` [10,000]; and the
binary ladder ``ge_ladder_bin`` at the verify path's 147 and 402 points
and at 1024 (``bench_group4`` times it too, but loads another checkout's
library into this one's wrappers, which a checkout of another C interface
cannot serve); and the Fermat chains, each at the width its checkout's
wrapper picks: ``fe_invert`` on one element (``batch_invert``'s total, a
point's ``to_bytes``) and at 4096, ``fe_pow2523`` at 17, 272 and 17,408
(the decompression of one verify, of a merged batch of 16 and of 1024
proofs); and the public inner products, ``field.inner_product`` at 2^16
(the bench's) and ``field.inner_product_batched`` at [16, 4096], whose
device time of every kernel a call and kernels a call hold their glue
beside the kernel; and the counting sort at one window's 2^16 keys,
``sort_hist`` and ``sort_rank`` at radix 128 and ``sort.grouping_order``
of w = 13 digits in 7-bit passes, each beside a stable ``torch.argsort``
of the same keys.  Then the
walls downstream of them: ``cli.main(["--benchmark"])`` (489 ``ge_add``
and 854 ``fe_mul`` launches), host prove (and verify) at n = 64,
``msm_auto`` at 2^10 (the ladder route: ``ge_ladder_win``, ``ge_reduce``
on 4 tiles, 2 ``ge_add``) and 2^11 (the Straus route over ``ge_add`` / ``ge_double``) and at 2^20 with
``config.MSM_ACCUM_KERNEL`` off (the sort-plus-scan route, 4,160
``ge_double`` launches), ``msm_pippenger`` at 2^16 (w = 13) grouping by
``torch.argsort`` and under ``config.MSM_PALLAS_SORT`` (the two sort
kernels, 2 passes a window), one fused verify, and the fused prover at n = 64
under ``config.LADDER_WINDOW`` = 0 (``ge_ladder_bin``) on fixed
randomness.

    python -m cudabulletproof_tpu_torch.benchmarks.bench_calls
    python -m cudabulletproof_tpu_torch.benchmarks.bench_calls --against DIR

A kernel case gives: a call (the median CUDA-event time of one call, of
7), a launch in a run of 100 (CUDA events around 100 calls in a row, over
100), the kernel's own device time a launch and the device time of every
kernel of a call (``torch.profiler`` over that run, by kernel name), and
the allocations a call (``torch.cuda.memory_stats``).  Every output must
equal its plain twin limb for limb.  A wall is the median host-clock time
of calls that end in a device synchronisation.

``--against DIR`` (the root of another checkout, such as the parent commit
unpacked with ``git archive``) runs these measurements in turns -- DIR,
this checkout, this checkout, DIR -- each in a process of its own started
at that checkout's root, so each runs its own wrappers and its own kernel
library (their C entries may take other arguments), while the measuring
code is this file's in every turn (so it imports nothing of the package
but the functions it times).  Each output must be the same in every turn
(a digest of the kernels' limbs and of the MSM's compressed point; every
verdict true).

Prints the card's ``name, power.limit`` first, then one line a case (and
library, in turns).  Exits nonzero without a card or on a wrong value.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261019
ROOT = Path(__file__).resolve().parents[2]
RUN = 100                  # launches in a timed run
PROFILE_TRIES = 3
CALL_REPS = 7
N_BITS = 64
MSM_LADDER = 1 << 10
MSM_STRAUS = 1 << 11
MSM_SCAN = 1 << 20
LADDER_BIN_SIZES = (147, 402, 1024)
REDUCE_SIZES = (256, 1024, 4096)
# the inner products: the bench's 2^16 (--benchmark) and [B, n] batched
IP_SIZE = 1 << 16
IP_BATCHED = (16, 4096)
# the counting sort: one window's keys at 2^16 (w = 13 digits, 7-bit
# passes: config.MSM_PALLAS_SORT_BITS)
SORT_KEYS = 1 << 16
SORT_WINDOW = 13
SORT_BITS = 7
CHAIN_CASES = (("fe_invert", 1), ("fe_invert", 4096), ("fe_pow2523", 17),
               ("fe_pow2523", 272), ("fe_pow2523", 17 * 1024))
# wall cases: label -> repetitions (median)
WALL_REPS = {"cli.main(['--benchmark'])": 1, f"host prove n={N_BITS}": 5,
             f"msm_auto n={MSM_LADDER}": 5,
             f"msm_auto n={MSM_STRAUS}": 3,
             f"msm_auto n={MSM_SCAN} accum off": 1,
             f"msm_pippenger n={SORT_KEYS} argsort": 5,
             f"msm_pippenger n={SORT_KEYS} MSM_PALLAS_SORT": 5,
             f"fused.verify n={N_BITS}": 3,
             f"fused prove n={N_BITS} LADDER_WINDOW=0": 1}
# runs a script file as __main__ with the checkout of the current directory
# first on sys.path
BOOT = ("import runpy, sys; sys.argv = sys.argv[1:]; "
        "runpy.run_path(sys.argv[0], run_name='__main__')")


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def run_ms(fn, reps: int) -> float:
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


def call_ms(fn, reps: int = CALL_REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int) -> tuple:
    """(device ms a launch of the kernels named `kernel`, device ms of
    every kernel a call, kernels a call, runs profiled) over `reps` calls,
    from the profiler's raw event records ('' matches every kernel).  The
    profiler now and then records none of a run's kernels: such a run is
    profiled again, up to PROFILE_TRIES times, and the runs it took are
    reported (kernels a call below the case's count show records dropped
    from a run that was kept)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        own_ns = own = all_ns = count = 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            count += 1
            all_ns += e.duration_ns()
            if kernel in e.name():
                own += 1
                own_ns += e.duration_ns()
        if own:
            return (own_ns / 1e6 / own, all_ns / 1e6 / reps, count / reps,
                    tries)
    raise AssertionError(f"the profiler saw no {kernel!r} kernel in "
                         f"{PROFILE_TRIES} runs")


def allocations(fn) -> int:
    """Device allocations of one call (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - before


def kernel_cases(dev) -> list:
    """(label, kernel name, call, plain call) of the cases, the torch.add
    floor of each size after its kernel's case."""
    from cudabulletproof_tpu_torch.ops import cuda_curve, cuda_field
    from cudabulletproof_tpu_torch.ops import curve as C, field as F
    from cudabulletproof_tpu_torch.utils import oracle
    rng = np.random.default_rng(SEED)

    def rows(n, width):
        return torch.from_numpy(rng.integers(
            0, F.BOUND + 1, size=(n, width), dtype=np.int32)).to(dev)

    def floor(n):
        a, b = rows(n, F.L), rows(n, F.L)
        return (f"torch.add [{n}, 20]", "", lambda: torch.add(a, b),
                lambda: a + b)

    cases = []
    p, q = C.unflatten(rows(402, 4 * F.L)), C.unflatten(rows(402, 4 * F.L))
    one = C.unflatten(rows(1, 4 * F.L)[0])                  # a point [20]
    cases += [("ge_add [402] coordinate views", "ge_add_kernel",
               lambda: cuda_curve.add(p, q), lambda: C.add_plain(p, q)),
              ("ge_double [402] coordinate views", "ge_double_kernel",
               lambda: cuda_curve.double(p), lambda: C.double_plain(p)),
              ("ge_double [1] one point [20]", "ge_double_kernel",
               lambda: cuda_curve.double(one), lambda: C.double_plain(one)),
              floor(402)]
    a, b = rows(272, F.L), rows(272, F.L)
    d2 = F.from_int(oracle.D2, device=dev)
    cases += [("fe_mul [272] contiguous", "fe_mul_kernel",
               lambda: cuda_field.mul(a, b), lambda: F.mul_plain(a, b)),
              ("fe_mul [272] x broadcast [20]", "fe_mul_kernel",
               lambda: cuda_field.mul(a, d2), lambda: F.mul_plain(a, d2)),
              floor(272)]
    a4, b4 = rows(10_000, F.L), rows(10_000, F.L)
    cases += [("fe_mul [10000] contiguous", "fe_mul_kernel",
               lambda: cuda_field.mul(a4, b4), lambda: F.mul_plain(a4, b4)),
              floor(10_000)]
    cases.append(("fe_sq [272] contiguous", "fe_sq_kernel",
                  lambda: cuda_field.sq(a), lambda: F.sq_plain(a)))
    for n in REDUCE_SIZES:
        pts = C.unflatten(rows(n, 4 * F.L))
        cases.append((f"ge_reduce [{n}] coordinate views", "ge_reduce_kernel",
                      lambda p=pts: cuda_curve.reduce_tiles(p),
                      lambda p=pts: C.reduce_tiles_plain(p)))
    # a wrapper that keeps its packing and shares only the launch path
    cases.append(("fe_add [10000] contiguous", "fe_add3_kernel",
                  lambda: cuda_field.add(a4, b4),
                  lambda: F.add3_plain(a4, b4)))
    for name, n in CHAIN_CASES:
        x = rows(n, F.L)
        fn, plain = ((cuda_field.invert, F.invert_plain) if name == "fe_invert"
                     else (cuda_field.pow2523, F.pow2523_plain))
        cases.append((f"{name} [{n}] contiguous", f"{name}_kernel",
                      lambda fn=fn, x=x: fn(x), lambda p=plain, x=x: p(x)))
    for n in LADDER_BIN_SIZES:
        base = C.unflatten(rows(n, 4 * F.L))
        k = torch.from_numpy(rng.integers(0, 1 << F.W, size=(n, F.L),
                                          dtype=np.int32)).to(dev)
        cases.append((f"ge_ladder_bin [{n}] rows", "ge_ladder_bin_kernel",
                      lambda b=base, k=k: cuda_curve.ladder_bin(b, k),
                      lambda b=base, k=k: C.scalarmult_bin_plain(b, k)))
    # the public functions (a parent's checks and glue count in the device
    # time of every kernel of a call and in the kernels a call)
    x, y = rows(IP_SIZE, F.L), rows(IP_SIZE, F.L)
    cases.append((f"fe_inner_product [{IP_SIZE}] field.inner_product",
                   "fe_inner_product_kernel", lambda: F.inner_product(x, y),
                   lambda: F.inner_product_plain(x, y)))
    rb, n = IP_BATCHED
    xb, yb = (rows(rb * n, F.L).reshape(rb, n, F.L) for _ in "xy")
    cases.append((f"fe_inner_product_batched [{rb} x {n}] "
                  "field.inner_product_batched", "fe_inner_product_kernel",
                  lambda: F.inner_product_batched(xb, yb),
                  lambda: F.inner_product_batched_plain(xb, yb)))
    return cases + sort_cases(dev, rng)


def sort_cases(dev, rng) -> list:
    """The counting sort at one window's 2^16 keys: sort_hist and sort_rank
    at radix 128 (the 7-bit pass), sort.grouping_order of w = 13 digits in
    7-bit passes (the kernels and the torch glue between them; its device
    time a launch is that of a sort kernel), each beside a stable
    torch.argsort of the same keys."""
    from cudabulletproof_tpu_torch.ops import cuda_sort, sort as SO
    n, radix = SORT_KEYS, 1 << SORT_BITS
    kb = torch.from_numpy(rng.integers(0, radix, size=n, dtype=np.int32)
                          .reshape(-1, SO.SUB, SO.LN)).to(dev)
    flat = SO.hist_plain(kb, radix).reshape(-1)
    base = (torch.cumsum(flat, 0) - flat).to(torch.int32).reshape(
        radix, SO.SUB, SO.LN)
    keys = kb.permute(1, 2, 0).reshape(-1)              # traversal order
    d = torch.from_numpy(rng.integers(0, 1 << SORT_WINDOW, size=n,
                                      dtype=np.int32)).to(dev)

    def argsort(x):
        return (f"torch.argsort [{n}] stable", "",
                lambda: torch.argsort(x, stable=True),
                lambda: torch.sort(x, stable=True)[1])

    return [(f"sort_hist [{n}, radix {radix}]", "sort_hist_kernel",
             lambda: cuda_sort.hist(kb, radix),
             lambda: SO.hist_plain(kb, radix)),
            (f"sort_rank [{n}, radix {radix}]", "sort_rank_kernel",
             lambda: cuda_sort.rank(kb, base, radix),
             lambda: SO.rank_plain(kb, base, radix)),
            argsort(keys),
            (f"sort.grouping_order [{n}, w {SORT_WINDOW}]", "sort_",
             lambda: SO.grouping_order(d, SORT_WINDOW, SORT_BITS),
             lambda: torch.argsort(d, stable=True).to(torch.int32)),
            argsort(d)]


def joined(out) -> torch.Tensor:
    """A result as one tensor: points' (x, y, z, t) as [..., 80] rows."""
    return torch.cat(list(out), dim=-1) if isinstance(out, tuple) else out


def measure_kernels(dev) -> list:
    out = []
    for label, kernel, fn, plain in kernel_cases(dev):
        got = joined(fn())
        torch.cuda.synchronize()
        if not torch.equal(got, joined(plain())):
            raise AssertionError(f"{label}: kernel != plain")
        own, every, per_call, tries = device_ms(fn, kernel, RUN)
        out.append({"case": label, "call_ms": call_ms(fn),
                    "run_ms": run_ms(fn, RUN), "device_ms": own,
                    "device_all_ms": every, "kernels_a_call": per_call,
                    "profile_runs": tries, "allocations": allocations(fn), "digest": digest(got)})
    return out


def wall_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure_walls(dev) -> list:
    from cudabulletproof_tpu_torch import cli, config
    from cudabulletproof_tpu_torch.models import fused, rangeproof as RP
    from cudabulletproof_tpu_torch.models.generators import get_generators
    from cudabulletproof_tpu_torch.ops import cuda_curve, cuda_field
    from cudabulletproof_tpu_torch.ops import curve as C, field as F
    from cudabulletproof_tpu_torch.ops import msm as M, pippenger as PP
    from cudabulletproof_tpu_torch.ops import scalar_field as SC
    from cudabulletproof_tpu_torch.utils import oracle
    rng = np.random.default_rng(SEED + 1)
    gens = get_generators(N_BITS, dev)
    idx = torch.arange(1, MSM_STRAUS + 1, dtype=torch.int32, device=dev)
    mult = torch.zeros((MSM_STRAUS, F.L), dtype=torch.int32, device=dev)
    mult[:, 0] = idx & F.MASK
    mult[:, 1] = idx >> F.W
    pts = C.scalarmult(C.base_point((MSM_STRAUS,), dev), mult)
    sc = F.from_ints([int.from_bytes(rng.bytes(32), "little") % oracle.ELL
                      for _ in range(MSM_STRAUS)], dev)
    # 2^20 points (the 2^11 repeated) and scalars below 2^252 from limbs
    big_pts = C.GE(*(c.repeat(MSM_SCAN // MSM_STRAUS, 1) for c in pts))
    limbs = rng.integers(0, 1 << F.W, size=(MSM_SCAN, F.L), dtype=np.int32)
    limbs[:, -1] >>= F.W - 5
    big_sc = torch.from_numpy(limbs).to(dev)
    proof = RP.prove((1 << N_BITS) - 1, 0x5EED, N_BITS, gens)
    small = C.GE(*(c[:MSM_LADDER] for c in pts))
    # the fused prover's inputs: the value's bits, then the value, the
    # blinding and 4 + 2n nonces, fixed so that every turn writes one blob
    value = (1 << N_BITS) - 1
    bits = torch.ones(N_BITS, dtype=torch.int32, device=dev)
    scp = SC.from_ints([value, 0x5EED] + [
        int.from_bytes(rng.bytes(32), "little") % oracle.ELL
        for _ in range(4 + 2 * N_BITS)], dev)
    table = gens.pack(N_BITS)

    def accum_off():
        config.MSM_ACCUM_KERNEL = False
        try:
            return C.to_bytes(M.msm_auto(big_pts, big_sc))
        finally:
            config.MSM_ACCUM_KERNEL = True

    def pippenger(pallas_sort: bool):
        config.MSM_PALLAS_SORT = pallas_sort
        try:
            return C.to_bytes(PP.msm_pippenger(
                C.GE(*(c[:SORT_KEYS] for c in big_pts)), big_sc[:SORT_KEYS],
                w=SORT_WINDOW))
        finally:
            config.MSM_PALLAS_SORT = False

    def prove_bin():
        config.LADDER_WINDOW = 0
        try:
            return fused._prove(table, bits, scp, N_BITS)
        finally:
            config.LADDER_WINDOW = 4

    def bench():
        before = (cuda_curve.launches["ge_add"], cuda_field.launches["fe_mul"])
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--benchmark"])
        bench.launches = (cuda_curve.launches["ge_add"] - before[0],
                          cuda_field.launches["fe_mul"] - before[1])
        return rc == 0

    fns = {"cli.main(['--benchmark'])": bench,
           f"host prove n={N_BITS}": lambda: RP.verify(RP.prove(
               (1 << N_BITS) - 1, 0x5EED, N_BITS, gens), gens),
           f"msm_auto n={MSM_LADDER}": lambda: C.to_bytes(M.msm_auto(
               small, sc[:MSM_LADDER])),
           f"msm_auto n={MSM_STRAUS}": lambda: C.to_bytes(M.msm_auto(pts,
                                                                     sc)),
           f"msm_auto n={MSM_SCAN} accum off": accum_off,
           f"msm_pippenger n={SORT_KEYS} argsort": lambda: pippenger(False),
           f"msm_pippenger n={SORT_KEYS} MSM_PALLAS_SORT":
               lambda: pippenger(True),
           f"fused.verify n={N_BITS}": lambda: fused.verify(proof, gens),
           f"fused prove n={N_BITS} LADDER_WINDOW=0": prove_bin}
    out = []
    for label, fn in fns.items():
        got = fn()
        if isinstance(got, torch.Tensor):
            got = digest(got)
        elif not bool(got):
            raise AssertionError(f"{label}: {got}")
        else:
            got = True
        if label.startswith("host prove"):       # time the prover alone
            fn = lambda: RP.prove((1 << N_BITS) - 1, 0x5EED, N_BITS, gens)
        rec = {"wall": label, "ms": wall_ms(fn, WALL_REPS[label]),
               "digest": str(got)}
        if fn is bench:
            rec["ge_add_fe_mul_launches"] = list(bench.launches)
        out.append(rec)
    return out


def measure() -> list:
    dev = torch.device("cuda", 0)
    return measure_kernels(dev) + measure_walls(dev)


def line(rec: dict) -> str:
    if "wall" in rec:
        extra = (f", ge_add / fe_mul launches {rec['ge_add_fe_mul_launches']}"
                 if "ge_add_fe_mul_launches" in rec else "")
        return f"wall {rec['wall']}: {rec['ms']:.2f} ms{extra}"
    return (f"{rec['case']}: {rec['call_ms']:.4f} ms a call, "
            f"{rec['run_ms']:.4f} ms a launch over {RUN}, device "
            f"{rec['device_ms']:.4f} ms a launch (every kernel "
            f"{rec['device_all_ms']:.4f} ms, {rec['kernels_a_call']:g} "
            f"a call; profiled {rec['profile_runs']}x), "
            f"{rec['allocations']} allocations a call")


def key(rec: dict) -> str:
    return rec.get("case") or f"wall {rec['wall']}"


def child_records(root: Path) -> list:
    """This script's records, measured in a process started at `root`
    (that checkout's package and kernels)."""
    out = subprocess.run(
        [sys.executable, "-c", BOOT, str(Path(__file__).resolve()), "--child"],
        cwd=root, env=dict(os.environ, BP_PLATFORM="cuda"),
        capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"the measurement at {root} exited "
                           f"{out.returncode}:\n{out.stderr[-4000:]}")
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]


def against(other: Path) -> None:
    """In turns: other, this, this, other; one line a case and checkout
    with both turns' numbers."""
    labels = [(str(other), other), ("this", ROOT)]
    got = {lab: [] for lab, _ in labels}
    for lab, root in labels + labels[::-1]:
        t0 = time.perf_counter()
        got[lab].append(child_records(root))
        print(f"turn [{lab}] in {time.perf_counter() - t0:.1f} s", flush=True)
    first = got["this"][0]
    for i, rec in enumerate(first):
        seen = {r[i]["digest"] for runs in got.values() for r in runs}
        if len(seen) != 1 or any(key(r[i]) != key(rec) for runs in
                                 got.values() for r in runs):
            raise AssertionError(f"{key(rec)}: the turns disagree ({seen})")
        fields = (["ms"] if "wall" in rec else
                  ["call_ms", "run_ms", "device_ms", "device_all_ms",
                   "kernels_a_call", "allocations"])
        for lab, _ in labels:
            runs = [r[i] for r in got[lab]]
            vals = "; ".join(f"{f} " + " ".join(f"{r[f]:.4f}" for r in runs)
                             for f in fields)
            if "wall" not in rec:     # an older checkout profiles once
                vals += "; profile_runs " + " ".join(
                    str(r.get("profile_runs", 1)) for r in runs)
            print(f"ab {key(rec)} [{lab}] {vals}", flush=True)
    print("ab: every output the same in every turn", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="root of another checkout: its calls in turns")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_calls: needs a CUDA device", file=sys.stderr)
        return 1
    if args.child:
        for rec in measure():
            print(json.dumps(rec), flush=True)
        return 0
    from cudabulletproof_tpu_torch.utils.profiling import smi
    print(smi("name,power.limit"), flush=True)
    if args.against is not None:
        against(args.against.resolve())
        return 0
    for rec in measure():
        print(line(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
