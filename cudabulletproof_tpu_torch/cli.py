"""End-to-end check of the port (`python -m cudabulletproof_tpu_torch`),
its counterpart of ``cudabulletproof_tpu/cli.py``: the same scenario, flags
and output lines, on the card.

  1. generators: real prime-order points from a deterministic
     hash-to-curve (``models/generators.py``);
  2. positive test: prove 42 in [0, 2^16) with the host-transcript prover,
     verify it on the card (``rangeproof.verify``) and with the native C++
     verifier (``rangeproof.verify_fast``), with wall times;
  3. negative test: the prover refuses 65536 = 2^16, and a tampered proof
     is rejected by the verifier itself;
  4. the 10,000-element batch field add / mul / square microbenchmark
     (the fe_add, fe_mul and fe_sq kernels).

Runs on the card (``cuda``), or on the CPU with ``BP_PLATFORM=cpu``; with
no card and no ``BP_PLATFORM=cpu`` it raises, it never falls back.  The
last line is ``{"all_tests": "SUCCESS"}`` (exit 0) or ``"FAILED"`` (exit 1).
``--benchmark`` runs the port's benchmark suite
(``benchmarks/bench_msm.py``, as a ``__main__`` module) and returns its exit
status.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def device() -> torch.device:
    """``cpu`` under BP_PLATFORM=cpu, else the current CUDA device."""
    platform = os.environ.get("BP_PLATFORM", "cuda")
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"BP_PLATFORM={platform!r}: use cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: set BP_PLATFORM=cpu to run on "
                           "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def positive_test(range_bits: int, value: int) -> bool:
    from .models import rangeproof as rp
    from .models.generators import get_generators
    from .utils import native, scalars as S

    print(f"=== Positive test: prove {value} in [0, 2^{range_bits}) ===")
    dev = device()
    try:
        gens = get_generators(range_bits, dev)
        proof, t_prove = _timed(rp.prove, value, S.sc_random(), range_bits,
                                gens)
    except rp.ProveError as e:
        print(f"Prover error: {e}")
        return False
    print(f"Proof generated in {t_prove:.6f} s (first call includes one-time "
          "set-up)")

    rp.verify(proof, gens)          # warm-up, as the first call sets up
    ok_dev, t_dev = _timed(rp.verify, proof, gens)
    label = "GPU" if dev.type == "cuda" else "CPU"
    print(f"{label} (fused) verification:  "
          f"{'SUCCESS' if ok_dev else 'FAILED'}  [{t_dev:.6f} s]")

    if native.available():
        ok_nat, t_nat = _timed(rp.verify_fast, proof, gens)
        print(f"Native CPU verification:   {'SUCCESS' if ok_nat else 'FAILED'}"
              f"  [{t_nat:.6f} s]")
        print(f"Device/native latency ratio: {t_dev / max(t_nat, 1e-9):.2f}x")
    elif dev.type == "cuda":
        print("Native CPU verification:   FAILED (native library unavailable)")
        ok_nat = False
    else:
        ok_nat = True
    return ok_dev and ok_nat


def negative_test(range_bits: int) -> bool:
    from .models import rangeproof as rp
    from .models.generators import get_generators
    from .utils import scalars as S, serialization

    bad_value = 1 << range_bits
    print(f"=== Negative test: value {bad_value} = 2^{range_bits} ===")
    gens = get_generators(range_bits, device())
    try:
        rp.prove(bad_value, S.sc_random(), range_bits, gens)
        print("Prover accepted an out-of-range value: FAILED")
        return False
    except rp.ProveError:
        print("Prover refused out-of-range value: FAILED (CORRECT)")

    # a tampered valid proof must be rejected by verification itself
    try:
        proof = rp.prove(3, S.sc_random(), range_bits, gens)
    except rp.ProveError as e:
        print(f"Prover error: {e}")
        return False
    blob = bytearray(serialization.serialize_range_proof(proof))
    blob[40] ^= 1    # flip one bit inside A
    tampered = serialization.deserialize_range_proof(bytes(blob))
    ok = rp.verify(tampered, gens)
    print(f"Tampered-proof verification: "
          f"{'FAILED (CORRECT)' if not ok else 'ACCEPTED (BUG)'}")
    return not ok


def field_microbench(count: int = 10_000) -> None:
    """Batch add / mul / square of `count` elements (limbs in [0, 8191]
    from ``np.random.RandomState(7)``), each timed once after a first call
    that builds the kernels, with a device sync."""
    from .ops import field as F

    dev = device()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"=== Batch field-op microbenchmarks ({count} elements) ===")
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randint(0, F.MASK + 1, size=(count, F.L),
                                     dtype=np.int32)).to(dev)
    b = torch.from_numpy(rng.randint(0, F.MASK + 1, size=(count, F.L),
                                     dtype=np.int32)).to(dev)
    for name, fn, args in [("add", F.add3, (a, b)), ("mul", F.mul, (a, b)),
                           ("square", F.sq, (a,))]:
        fn(*args)                  # builds the kernels outside the timing
        sync()
        _, t = _timed(lambda: (fn(*args), sync()))
        print(f"Batch field {name:6s}: {t:.6f} s  ({count / t:,.0f} op/s)")


BENCH_MODULE = f"{__package__}.benchmarks.bench_msm"


def run_benchmark() -> int:
    """``bench_msm`` with no arguments, run as ``__main__`` (``runpy``), as
    the JAX CLI runs its ``benchmarks/bench_msm.py``; its exit status."""
    import runpy
    argv = sys.argv
    sys.argv = [BENCH_MODULE]
    try:
        runpy.run_module(BENCH_MODULE, run_name="__main__", alter_sys=True)
    except SystemExit as done:
        return done.code if isinstance(done.code, int) else (
            0 if done.code is None else 1)
    finally:
        sys.argv = argv
    return 0


def main(argv=None) -> int:
    from . import config

    ap = argparse.ArgumentParser(prog="cudabulletproof_tpu_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--benchmark", action="store_true",
                    help="run the benchmark suite (benchmarks/bench_msm.py)")
    ap.add_argument("--range-bits", type=int, default=config.DEFAULT_RANGE_BITS)
    ap.add_argument("--value", type=int, default=42)
    ap.add_argument("--skip-microbench", action="store_true")
    args = ap.parse_args(argv)

    if args.benchmark:
        return run_benchmark()

    ok = positive_test(args.range_bits, args.value)
    ok = negative_test(args.range_bits) and ok
    if not args.skip_microbench:
        field_microbench()
    print(json.dumps({"all_tests": "SUCCESS" if ok else "FAILED"}))
    return 0 if ok else 1
