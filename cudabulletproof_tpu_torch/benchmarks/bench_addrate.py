"""The point-add rate with nothing but registers touched: the counterpart of
``benchmarks/bench_addrate.py``.

    python -m cudabulletproof_tpu_torch.benchmarks.bench_addrate [--k K]

One launch of the ge_add_chain kernel (``micro.chain``) runs K chained
adds acc <- acc + B (or doublings acc <- 2 acc) in every lane, B the base
point in each lane (``curve.base_point((lanes,))``).  The sweep is the JAX
script's: add at 256, 512, 1024 and 2048 lanes, dbl at 256 and 1024, then
add at 1024 lanes with the relaxation pairs (mul_passes, add_passes) =
(4, 2), (3, 1), (1, 1), (0, 0) (timing-only: fewer passes than the proven
three give wrong points, the same op mix); everything else at (5, 2).  K
comes from ``--k``, else ``BP_ADDRATE_K``, else 4096.

Before any timing a gate runs at K = 8 on 4 lanes: the (5, 2) add chain
must equal 9 B and the dbl chain 2^8 B as compressed bytes against
``utils/oracle.py``, and on the card the kernel must equal its plain twin
(``micro.chain_plain``) limb for limb at every op and pass pair.  A failed
gate raises, so the exit code is nonzero.  After its timing, each (5, 2)
run's last output is checked the same way, (K + 1) B or (2^K mod l) B in
every lane, and raises on a wrong point.  Each time is the median of
``--reps`` (10) calls after a warm-up, by CUDA events on the card and the
host clock on the CPU.  Runs on the card, or on the CPU under
BP_PLATFORM=cpu (the plain twins: no device metric).  ``--lanes`` replaces
the sweep's lane counts (for a quick run).

Prints ``backend=<cuda|cpu>  K=<K> chained ops`` and one line a run in
the JAX script's format:
``<op> lanes=<n> mulpass=<m> addpass=<a>  <ms> ms  <rate> M ops/s``.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch

from ..ops import curve as C, micro as MC
from ..utils import oracle

GATE_K = 8
GATE_LANES = 4
ADD_LANES = (256, 512, 1024, 2048)
DBL_LANES = (256, 1024)
RELAX_LANES = 1024


def median_ms(fn, reps: int, dev: torch.device) -> float:
    """Median ms of fn() over `reps` calls after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_oracle(out: torch.Tensor, op: str, k: int) -> None:
    """Every lane of a (5, 2) chain of k ops from B is (k + 1) B (add) or
    (2^k mod l) B (dbl), as compressed bytes; raises otherwise."""
    scalar = k + 1 if op == "add" else pow(2, k, oracle.ELL)
    got = C.to_bytes_batch(C.unflatten(out)).cpu()
    want = (oracle.BASE * scalar).compress()
    if any(bytes(row.tolist()) != want for row in got):
        raise AssertionError(f"{op} chain of {k} on {len(got)} lanes != "
                             f"{'K + 1' if op == 'add' else '2^K'} B")


def gate(dev: torch.device) -> None:
    """The chains at K = GATE_K against the oracle and, on the card, the
    kernel against its twin at every op and pass pair; raises on a wrong
    value."""
    p = C.flatten(C.base_point((GATE_LANES,), dev)).contiguous()
    for op in MC.CHAIN_OPS:
        check_oracle(MC.chain(p, op, GATE_K), op, GATE_K)
        if dev.type != "cuda":
            continue
        for mp, ap in MC.PASS_PAIRS:
            kern = MC.chain(p, op, GATE_K, mp, ap)
            if not torch.equal(kern, MC.chain_plain(p, op, GATE_K, mp, ap)):
                raise AssertionError(f"{op} chain kernel != twin at passes "
                                     f"({mp}, {ap})")


def run(op: str, lanes: int, k: int, dev: torch.device, mul_passes: int = 5,
        add_passes: int = 2, reps: int = 10) -> float:
    """One sweep point: prints its line, returns chained ops per second;
    at (5, 2) the last timed output must be right (``check_oracle``)."""
    p = C.flatten(C.base_point((lanes,), dev)).contiguous()
    last = []

    def call():
        last[:] = [MC.chain(p, op, k, mul_passes, add_passes)]
    ms = median_ms(call, reps, dev)
    if (mul_passes, add_passes) == (5, 2):
        check_oracle(last[0], op, k)
    rate = k * lanes / (ms / 1e3)
    print(f"{op:4s} lanes={lanes:5d} mulpass={mul_passes} "
          f"addpass={add_passes}  {ms:7.3f} ms  {rate / 1e6:8.1f} M ops/s",
          flush=True)
    return rate


def main(argv=None) -> int:
    from ..cli import device
    ap = argparse.ArgumentParser(prog="bench_addrate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int,
                    default=int(os.environ.get("BP_ADDRATE_K", "4096")))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--lanes", type=int, nargs="+",
                    help="lane counts to sweep instead of the script's")
    args = ap.parse_args(argv)
    dev = device()
    gate(dev)
    k = args.k
    print(f"backend={dev.type}  K={k} chained ops", flush=True)
    adds, dbls = ADD_LANES, DBL_LANES
    relax = RELAX_LANES
    if args.lanes:
        adds = dbls = tuple(args.lanes)
        relax = args.lanes[-1]
    for lanes in adds:
        run("add", lanes, k, dev, reps=args.reps)
    for lanes in dbls:
        run("dbl", lanes, k, dev, reps=args.reps)
    for mp, ap_ in MC.PASS_PAIRS[1:]:
        run("add", relax, k, dev, mp, ap_, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
