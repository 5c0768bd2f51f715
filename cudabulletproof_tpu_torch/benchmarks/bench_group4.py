"""The kernels on the four-lane group law, timed on the card:
``ge_ladder_win`` and ``ge_ladder_bin`` at the verify path's 147 and 402
points and at ``config.MSM_LADDER_MAX`` (1024), ``ge_bucket_accum`` at the
sizes of ``config.MSM_ACCUM_PLAN`` (2^12 and 2^13, the merged batches of
128 and 256 proofs; 2^16, ``msm_auto``'s chunk), and the sort-plus-scan
MSM's
``ge_seg_scan`` at [depth 64 x 1024 lanes] and [32 x 1024] (a window of
2^16 points at w = 13, of the merged batch of 1024 proofs at w = 11) and
``ge_bucket_fold`` at 8191 and 2047 rows (the same windows' tables), and
the tile reduction ``ge_reduce`` at 256, 1024 and 4096 points (one tile,
``msm_auto``'s largest ladder route, the kernel table's), each with its
device time a call by kernel name.

    python -m cudabulletproof_tpu_torch.benchmarks.bench_group4 [--reps N]
    python -m cudabulletproof_tpu_torch.benchmarks.bench_group4 --against DIR
    python -m cudabulletproof_tpu_torch.benchmarks.bench_group4 --sweep

Inputs come from a fixed numpy seed: weak-limb point rows (limbs in [0,
8799]) and scalars mod l, the accumulator's digits by
``pippenger.extract_digits_signed`` at the plan's window, the scan's head
flags from sorted random digits; the fold's tables are curve points ((i+1)
B, the identity and the 8-torsion points among them), so that tables
folded in different layouts give the same point.  Every output must equal
its plain twin at the same layout limb for limb (a wrong one raises).  A
kernel's time is the CUDA-event time of a run of ``--reps`` (20) calls
after a warm-up, divided by the count; the device time is the kernels'
time a call over such a run, as ``torch.profiler`` records it by kernel
name.  The bound is the work's int32 multiply-adds over the card's IMAD
rate or its bytes over the HBM rate (``utils/profiling.py``), whichever is
larger.  The fold runs at 128 lanes (the JAX package's layout) and at
``config.MSM_FOLD_LANES_CUDA`` (the card path's).

``--against DIR`` (the root of another checkout of the repo, such as an
older commit unpacked with ``git archive``) builds DIR's ``csrc`` into a
second library and runs every shape in turns: DIR, this checkout, this
checkout, DIR, each output equal to the other library's (limb for limb at
the same layout, as compressed points where the layouts differ: DIR's
kernels run the JAX package's 128 fold lanes); then
the wall times (host clock, median of 3 a turn) of host prove at n = 64,
``msm_auto`` at 2^16 and 2^20, and ``msm_auto`` at 2^16 and 2^20 with
``config.MSM_ACCUM_KERNEL`` off, in the same turns, on curve points, each
result equal to the other library's as a compressed point.  DIR's library
is loaded into this checkout's wrappers, so its C interface must be this
checkout's (``build.ABI``; ``build.load`` refuses another): a checkout of
another interface is compared by ``bench_calls --against``, which runs
each checkout's own package.

``--sweep`` times this checkout's scan and fold at other layouts (the scan
of 2^16 points in SWEEP_SCAN_LANES lanes, of 2^15 in all but the last; the
fold's tables in SWEEP_FOLD_LANES lanes), each equal to its twin; then the
Fermat chains ``fe_invert`` and ``fe_pow2523`` at every group width
(``config.CHAIN_WIDTHS``) and the counts the paths run
(SWEEP_CHAIN_COUNTS), each equal to its twin: where
``config.CHAIN_LANES_CUDA`` comes from.

Prints the card's ``name, power.limit`` first, then one line a shape and
library: ``<kernel> n=<n> <shape> [<library>] <ms> ms ... bound <ms> ms``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
from ..ops import (cuda_curve, cuda_field, curve as C, field as F,
                   msm as M, pippenger as PP)
from ..utils import build, oracle
from ..utils.profiling import (FE_BYTES, IMAD_ADD, IMAD_DBL, IMAD_MADD,
                               IMAD_MUL, IMAD_SQ, PT_BYTES, bound,
                               imad_per_s, smi)

SEED = 20261018
LADDER_SIZES = (147, 402, config.MSM_LADDER_MAX)
# the ladder's group operations a point: 7 table doublings and 65 x 4,
# 7 table adds and 65 window adds; the binary ladder's, 2 unified adds a
# bit of the 260-bit scalar
LADDER_DBL, LADDER_ADD = 267, 72
LADDER_BIN_ADD = 2 * C.SCALAR_BITS
DOWNSTREAM_MSM = (1 << 16, 1 << 20)
PROVE_BITS = 64
# the sort-plus-scan kernels: [depth, lanes] and the digit count of the
# scan's windows, the fold's rows (2^w - 1), the JAX package's layouts
SCAN_SHAPES = ((64, 1024, 1 << 13), (32, 1024, 1 << 11))
FOLD_ROWS = (8191, 2047)
JAX_FOLD_LANES = 128
SWEEP_SCAN_LANES = (1024, 2048, 4096, 8192)
SWEEP_FOLD_LANES = (128, 256, 512, 1024, 2048, 4096)
# the Fermat chains' counts on the paths: one element (batch_invert's
# total, one point's to_bytes), the decompression of one verify and of
# merged batches of 16, 128, 256 and 1024 proofs (17 points a proof)
SWEEP_CHAIN_COUNTS = (1, 17, 272, 2176, 4352, 17408)
# the chains' squarings before their 11 multiplies
CHAIN_SQUARINGS = {"fe_invert": 254, "fe_pow2523": 251}
# the tile reduction: one tile, msm_auto's largest ladder route (4 tiles),
# the kernel table's 4096
REDUCE_SIZES = (256, 1024, 4096)


def ladder_work(n: int) -> tuple:
    """(IMADs, bytes) of the window ladder over n points: each point and
    scalar read once, each result written once."""
    return (n * (LADDER_DBL * IMAD_DBL + LADDER_ADD * IMAD_ADD),
            n * (2 * PT_BYTES + FE_BYTES))


def ladder_bin_work(n: int) -> tuple:
    """(IMADs, bytes) of the binary ladder over n points: each point and
    scalar read once, each result written once."""
    return n * LADDER_BIN_ADD * IMAD_ADD, n * (2 * PT_BYTES + FE_BYTES)


def reduce_work(n: int) -> tuple:
    """(IMADs, bytes) of the tile sums of n points: n - tiles unified adds
    (the identity padding adds nothing that the data needs), each point
    read once and each partial written once."""
    tiles = -(-n // C.REDUCE_TILE)
    return (n - tiles) * IMAD_ADD, (n + tiles) * PT_BYTES


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


def scan_work(heads: np.ndarray, depth: int, lanes: int) -> tuple:
    """(IMADs, bytes) of the segmented scan on these heads (sorted order):
    one unified add per element that starts no segment, and one per lane of
    each cross-lane stage that merges (its run flag still 0); the points and
    flags read once, the values and carries written once."""
    h = heads.reshape(lanes, depth)
    adds = int((~h).sum())
    f = h.any(axis=1)
    lane = np.arange(lanes)
    s = 1
    while s < lanes:
        adds += int(((lane >= s) & ~f).sum())
        f = np.where(lane >= s, f | np.roll(f, s), f)
        s *= 2
    return (adds * IMAD_ADD,
            depth * lanes * (2 * PT_BYTES + 4) + lanes * PT_BYTES)


def fold_work(m: int, lanes: int) -> tuple:
    """(IMADs, bytes) of the bucket fold of m rows in `lanes` lanes: two
    adds a padded row, the cross-lane scan, the carry's log2(depth)
    doublings a lane, one add a lane and the halving; the rows read once,
    one point written."""
    depth = cuda_curve.fold_depth(m, lanes)
    stages = sum(lanes - s for s in (1 << k for k in range(21))
                 if s < lanes)
    adds = 2 * depth * lanes + stages + lanes + lanes - 1
    dbls = (depth.bit_length() - 1) * lanes
    return adds * IMAD_ADD + dbls * IMAD_DBL, (m + 1) * PT_BYTES


def chain_work(kernel: str, n: int) -> tuple:
    """(IMADs, bytes) of a Fermat chain over n elements: its squarings at
    fe_sq's and its 11 multiplies at fe_mul's count; each element read
    once and written once."""
    return (n * (CHAIN_SQUARINGS[kernel] * IMAD_SQ + 11 * IMAD_MUL),
            2 * n * FE_BYTES)


def sorted_heads(rng, n: int, values: int) -> np.ndarray:
    """The run starts of n sorted random digits below `values`."""
    d = np.sort(rng.integers(0, values, size=n))
    return np.concatenate([[True], d[1:] != d[:-1]])


def scan_operands(rng, dev, heads: np.ndarray, depth: int, lanes: int):
    """Weak-limb points [depth, 80, lanes] and the head flags [depth, 1,
    lanes] of `heads` (in sorted order: element (j, l) is sorted element
    l * depth + j)."""
    rows = rng.integers(0, F.BOUND + 1, size=(depth * lanes, 80),
                        dtype=np.int32)
    pt = rows.reshape(lanes, depth, 80).transpose(1, 2, 0)
    ht = heads.reshape(lanes, depth).T[:, None, :].astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(pt)).to(dev),
            torch.from_numpy(np.ascontiguousarray(ht)).to(dev))


def curve_points(n: int, dev) -> torch.Tensor:
    """[n, 80] rows of the points (i+1) B by the ladder kernel, with the
    identity and the 8-torsion points in place of the first rows."""
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    mult = torch.zeros((n, F.L), dtype=torch.int32, device=dev)
    mult[:, 0] = idx & F.MASK
    mult[:, 1] = idx >> F.W
    rows = C.flatten(C.scalarmult(C.base_point((n,), dev), mult))
    edge = [oracle.IDENTITY] + oracle.small_order_points()
    k = min(n, len(edge))
    rows[:k] = C.flatten(C.from_oracle(edge[:k], dev))
    return rows


def compressed(row: torch.Tensor) -> bytes:
    return bytes(C.to_bytes(C.unflatten(row)).cpu().tolist())


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
    """Kernel name -> (device ms a launch, launches a call) over `reps`
    calls of fn, as the profiler records them (its raw events, not
    ``prof.events()``; it may miss a run's first launches, so the time is
    taken a launch)."""
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
            ns, k = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), k + 1)
    return {name: (ns / 1e6 / k, k / reps)
            for name, (ns, k) in by_name.items()}


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


@dataclasses.dataclass
class Case:
    """A kernel at one size: ``at(layout)`` gives (shape label, call, plain
    call, IMADs, bytes) at a layout (lanes; None for kernels without one);
    ``layouts`` is (this checkout's, the other checkout's)."""
    kernel: str
    n: int
    at: object
    layouts: tuple = (None, None)


def fixed(*entry):
    """``Case.at`` of a kernel whose layout is fixed: `entry` at any."""
    return lambda _layout: entry


def cases(dev):
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
        out.append(Case("ge_ladder_win", n, fixed(
            "", lambda p=p, s=s: C.flatten(C.GE(*cuda_curve.ladder(p, s))),
            lambda p=p, s=s: C.flatten(C.scalarmult_plain(p, s)),
            *ladder_work(n))))
        out.append(Case("ge_ladder_bin", n, fixed(
            "", lambda p=p, s=s: C.flatten(C.GE(*cuda_curve.ladder_bin(p, s))),
            lambda p=p, s=s: C.flatten(C.scalarmult_bin_plain(p, s)),
            *ladder_bin_work(n))))
    for n in sorted(config.MSM_ACCUM_PLAN):
        w, threads, slices = config.accum_plan(n)
        pre = rows(n)
        dg = PP.extract_digits_signed(scalars(n), w)
        out.append(Case("ge_bucket_accum", n, fixed(
            f"(w, threads, slices)=({w}, {threads}, {slices})",
            lambda pre=pre, dg=dg, w=w, t=threads, s=slices:
                cuda_curve.bucket_accum(pre, dg, w, t, s),
            lambda pre=pre, dg=dg, w=w, t=threads, s=slices:
                PP.bucket_accum_plain(pre, dg, w, t, s),
            *accum_work(dg, n, w))))
    for depth, lanes, values in SCAN_SHAPES:
        out.append(scan_case(rng, dev, depth * lanes, values, lanes))
    for m in FOLD_ROWS:
        body = curve_points(m, dev)
        out.append(fold_case(body, JAX_FOLD_LANES, JAX_FOLD_LANES))
        if config.MSM_FOLD_LANES_CUDA != JAX_FOLD_LANES:
            out.append(fold_case(body, config.MSM_FOLD_LANES_CUDA,
                                 JAX_FOLD_LANES))
    for n in REDUCE_SIZES:
        p = C.unflatten(rows(n))
        out.append(Case("ge_reduce", n, fixed(
            "", lambda p=p: cuda_curve.reduce_tiles(p),
            lambda p=p: C.reduce_tiles_plain(p), *reduce_work(n))))
    return out


def scan_case(rng, dev, n: int, values: int, lanes: int) -> Case:
    """The segmented scan of n sorted elements (digits below `values`) in
    `lanes` lanes, at the same layout in both checkouts."""
    depth = n // lanes
    heads = sorted_heads(rng, n, values)
    pt, ht = scan_operands(rng, dev, heads, depth, lanes)

    def joined(scan):
        values, carries = scan(pt, ht)
        return torch.cat([values.reshape(-1), carries.reshape(-1)])
    return Case("ge_seg_scan", n, fixed(
        f"[{depth} x {lanes}]", lambda: joined(cuda_curve.seg_scan),
        lambda: joined(PP.seg_scan_plain), *scan_work(heads, depth, lanes)),
        (lanes, lanes))


def fold_case(body: torch.Tensor, lanes: int, other: int) -> Case:
    """The bucket fold of `body` in `lanes` lanes here, `other` in the
    other checkout."""
    def at(layout):
        return (f"[lanes {layout}]",
                lambda: cuda_curve.bucket_fold(body, layout),
                lambda: PP.bucket_fold_plain(body, layout),
                *fold_work(body.shape[0], layout))
    return Case("ge_bucket_fold", body.shape[0], at, (lanes, other))


def sweep_cases(dev):
    """This checkout's scan and fold at the SWEEP layouts."""
    rng = np.random.default_rng(SEED + 2)
    out = []
    for (depth, lanes, values), sizes in zip(
            SCAN_SHAPES, (SWEEP_SCAN_LANES, SWEEP_SCAN_LANES[:-1])):
        out += [scan_case(rng, dev, depth * lanes, values, ln)
                for ln in sizes]
    for m in FOLD_ROWS:
        body = curve_points(m, dev)
        out += [fold_case(body, ln, ln) for ln in SWEEP_FOLD_LANES]
    return out


def chain_cases(dev):
    """fe_invert and fe_pow2523 at every width and SWEEP_CHAIN_COUNTS on
    weak-limb rows (the twin run once a kernel and count)."""
    rng = np.random.default_rng(SEED + 3)
    kernels = {"fe_invert": (cuda_field.invert, F.invert_plain),
               "fe_pow2523": (cuda_field.pow2523, F.pow2523_plain)}
    out = []
    for kernel, (fn, plain) in kernels.items():
        for n in SWEEP_CHAIN_COUNTS:
            a = torch.from_numpy(rng.integers(
                0, F.BOUND + 1, size=(n, F.L), dtype=np.int32)).to(dev)
            want = plain(a)
            out += [Case(kernel, n, fixed(
                f"[lanes {g}]", lambda a=a, g=g, fn=fn: fn(a, g),
                lambda want=want: want, *chain_work(kernel, n)))
                for g in config.CHAIN_WIDTHS]
    return out


def kernel_names(split: dict) -> str:
    """'; device ms a launch: <kernel> <ms> x <launches a call>, ...' of the
    port's kernels in a device_ms_by_kernel result (template instances of
    one kernel summed)."""
    parts = {}
    for name, (ms, k) in split.items():
        m = re.search(r"(ge|sort|fe)_[a-z0-9_]+_kernel", name)
        if m:
            total, n = parts.get(m.group(0), (0.0, 0.0))
            parts[m.group(0)] = (total + ms * k, n + k)
    return "; device ms a launch: " + ", ".join(
        f"{k} {t / n:.4f} x {n:g}" for k, (t, n) in sorted(parts.items()))


def run_case(case: Case, libs, turns, reps: int, rate) -> None:
    """Every turn of one case: its output checked against the twin at its
    layout (and, across layouts, the other library's as a point), timed,
    and its device time split by kernel; one line a library."""
    layout = dict(zip((lab for lab, _ in libs[::-1]), case.layouts))
    runs, times, split, outs = {}, {}, {}, {}
    for label, lib in turns:
        lay = layout[label]
        if lay not in runs:
            shape, kern, plain, imads, nbytes = case.at(lay)
            runs[lay] = (shape, kern, imads, nbytes, plain())
        shape, kern, imads, nbytes, want = runs[lay]
        with using(lib):
            got = kern()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{case.kernel} n={case.n} {shape} "
                                     f"[{label}] != plain")
            times.setdefault(label, []).append(run_ms(kern, reps))
            if label not in split:
                split[label] = device_ms_by_kernel(kern, reps)
        outs[label] = got
    if len(set(case.layouts)) > 1 and len(outs) == 2:
        a, b = outs.values()
        if compressed(a) != compressed(b):
            raise AssertionError(f"{case.kernel} n={case.n}: the layouts "
                                 f"{case.layouts} give different points")
    for label, _ in libs:
        shape, _, imads, nbytes, _ = runs[layout[label]]
        bound_ms, by = bound(imads, nbytes, rate)
        ms = " ".join(f"{t:.4f}" for t in times[label])
        print(f"{case.kernel} n={case.n} {shape} [{label}] {ms} ms"
              f"{kernel_names(split[label])}; bound {bound_ms:.4f} ms "
              f"({by})", flush=True)


@contextlib.contextmanager
def jax_layouts():
    """The sort-plus-scan MSM folds in the JAX package's layout on the card
    inside the block (as an older checkout's kernels were built for)."""
    old = config.MSM_FOLD_LANES_CUDA
    config.MSM_FOLD_LANES_CUDA = JAX_FOLD_LANES
    try:
        yield
    finally:
        config.MSM_FOLD_LANES_CUDA = old


@contextlib.contextmanager
def accum(on: bool):
    old = config.MSM_ACCUM_KERNEL
    config.MSM_ACCUM_KERNEL = on
    try:
        yield
    finally:
        config.MSM_ACCUM_KERNEL = old


def downstream(dev, libs, turns) -> None:
    """Host prove and msm_auto (with and without the accumulator) wall
    times in turns; every MSM equal across libraries and routes."""
    gens = get_generators(PROVE_BITS, dev)
    rng = np.random.default_rng(SEED + 1)
    big = max(DOWNSTREAM_MSM)
    small = min(DOWNSTREAM_MSM)
    pts = C.unflatten(curve_points(small, dev).repeat(big // small, 1))
    sc = F.from_ints([int.from_bytes(rng.bytes(32), "little") % oracle.ELL
                      for _ in range(big)], dev)
    down = [(f"host prove n={PROVE_BITS}", True,
             lambda: RP.prove((1 << PROVE_BITS) - 1, 0x5EED, PROVE_BITS,
                              gens))]
    for on in (True, False):
        for n in DOWNSTREAM_MSM:
            down.append((f"msm_auto n={n}" + ("" if on else " accum off"),
                         on, lambda n=n: C.flatten(M.msm_auto(
                             C.GE(*(c[:n] for c in pts)), sc[:n]))))
    other = libs[0][0] if len(libs) == 2 else None
    points = {}
    for label, on, fn in down:
        times = {lab: [] for lab, _ in libs}
        for lab, lib in turns:
            lay = jax_layouts() if lab == other else contextlib.nullcontext()
            with using(lib), accum(on), lay:
                out = fn()
                times[lab].append(wall_ms(fn))
            if label.startswith("msm_auto"):
                key = label.split()[1]
                got = compressed(out)
                if points.setdefault(key, got) != got:
                    raise AssertionError(f"{label} [{lab}]: another point")
        for lab, _ in libs:
            print(f"wall {label} [{lab}] "
                  + " ".join(f"{t:.2f}" for t in times[lab]) + " ms",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--against", type=Path, default=None,
                    help="root of another checkout: A/B its kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="the scan and fold at other layouts, the Fermat "
                    "chains at every width")
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
    for case in cases(dev):
        run_case(case, libs, turns, args.reps, rate)
    if args.sweep:
        for case in sweep_cases(dev):
            print("sweep ", end="")
            run_case(case, libs[-1:], libs[-1:], args.reps, rate)
        for case in chain_cases(dev):
            print("sweep ", end="")
            run_case(case, libs[-1:], libs[-1:], args.reps, rate)
    if args.against is not None:
        downstream(dev, libs, turns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
