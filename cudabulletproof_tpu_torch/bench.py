"""The benchmark script of the port, the counterpart of the repository's
``bench.py``: prints ONE JSON line with the headline metric and the extras.

    python -m cudabulletproof_tpu_torch.bench

Headline: ``range_proof_verify_16bit_latency``, the median of 30
``rangeproof.verify_fast`` calls on one 16-bit proof of the host prover
(the native C++ verifier).  Extras, on the card:
  * ``gpu_batch16_verify_ms_per_proof``: ``fused.batch_verify`` of 16 copies
    of that proof (the merged batch), median of 10, per proof;
  * ``gpu_msm_2e16_points_per_sec`` and ``gpu_msm_2e20_points_per_sec``:
    ``msm_auto`` on points (i + 1) B and scalars SHA-256("bench%d" % i)
    mod l, 4 calls back to back with one sync at 2^16 (median of 5), one
    at 2^20 (median of 3);
  * ``gpu_msm_window_bits``: the window of msm_auto's bucket MSM at 2^16.
Every proof must be accepted and every MSM's result is checked against
(sum (i + 1) s_i mod l) B; a failure raises (the exit code is nonzero),
extras included.  Runs on the card, or on the CPU under BP_PLATFORM=cpu.
The JAX script's ``vs_baseline`` (a reference figure of another GPU) is
not printed.
"""
from __future__ import annotations

import hashlib
import json
import sys

import torch

from . import config
from .benchmarks.bench_msm import scalar_limbs, timeit
from .models import fused, rangeproof as rp
from .models.generators import get_generators
from .ops import curve as C, field as F, msm as M
from .utils import oracle, scalars as S

# (label, points, timed runs, MSMs back to back in each run)
MSM_RUNS = (("2e16", 1 << 16, 5, 4), ("2e20", 1 << 20, 3, 1))


def make_msm_inputs(n: int, dev):
    """Points (i + 1) B by the ladder and scalars SHA-256("bench%d" % i)
    mod l; with the exact result (sum (i + 1) s_i mod l) B, compressed."""
    ks = [int.from_bytes(hashlib.sha256(b"bench%d" % i).digest(), "little")
          % oracle.ELL for i in range(n)]
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    mult = torch.zeros((n, F.L), dtype=torch.int32, device=dev)
    mult[:, 0] = idx & F.MASK
    mult[:, 1] = idx >> F.W
    pts = C.scalarmult(C.base_point((n,), dev), mult)
    want = (sum((i + 1) * k for i, k in enumerate(ks)) % oracle.ELL
            * oracle.BASE).compress()
    return pts, scalar_limbs(ks, dev), want


def extras(proof, gens, dev, batch: int = 16, reps: int = 10,
           msm_runs=MSM_RUNS, prefix: str = "gpu") -> dict:
    """The batch verify (median of `reps`) and MSM metrics, named
    `prefix`_...; raises on a rejected batch or a wrong MSM."""
    out = {}
    proofs = [proof] * batch
    if not fused.batch_verify(proofs, gens):           # warm-up and gate
        raise AssertionError(f"merged batch of {batch} rejected")

    def batch_ok():
        if not fused.batch_verify(proofs, gens):
            raise AssertionError(f"merged batch of {batch} rejected")
    t = timeit(batch_ok, iters=reps, warmup=0, device=dev)
    out[f"{prefix}_batch{batch}_verify_ms_per_proof"] = round(
        t / batch * 1e3, 3)

    for label, n, iters, d in msm_runs:
        pts, ks, want = make_msm_inputs(n, dev)
        got = bytes(C.to_bytes(M.msm_auto(pts, ks)).cpu().tolist())
        if got != want:
            raise AssertionError(f"msm_auto at {n} != (sum (i+1) s_i) B")

        def run():
            for _ in range(d):
                M.msm_auto(pts, ks)
        out[f"{prefix}_msm_{label}_points_per_sec"] = round(
            n * d / timeit(run, iters=iters, warmup=0, device=dev))
    out[f"{prefix}_msm_window_bits"] = (
        config.accum_plan(min(1 << 16, config.MSM_ACCUM_CHUNK))[0]
        if config.MSM_ACCUM_KERNEL else config.msm_window_for(
            min(1 << 16, config.MSM_CHUNK)))
    return out


def headline(dev, bits: int = 16, value: int = 42, reps: int = 30):
    """(the record with the headline metric, the proof of `value`, its
    generators)."""
    gens = get_generators(bits, dev)
    proof = rp.prove(value, S.sc_random(), bits, gens)
    if not rp.verify(proof, gens):                 # the card's verifier
        raise AssertionError("the host prover's proof is rejected")

    def fast():
        if not rp.verify_fast(proof, gens):        # the native verifier
            raise AssertionError("verify_fast rejected the proof")
    t = timeit(fast, iters=reps, device=dev)
    rec = {"metric": f"range_proof_verify_{bits}bit_latency",
           "value": round(t, 6), "unit": "s"}
    return rec, proof, gens


def main() -> int:
    from .cli import device
    dev = device()
    rec, proof, gens = headline(dev)
    rec.update(extras(proof, gens, dev,
                      prefix="gpu" if dev.type == "cuda" else "cpu"))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
