"""MSM, field-kernel and proof benchmarks of the port, the counterpart of
``benchmarks/bench_msm.py``: the same metrics and checks, one JSON line
each, in its order.

    python -m cudabulletproof_tpu_torch.benchmarks.bench_msm [--big]
    python -m cudabulletproof_tpu_torch.benchmarks.bench_msm --sizes 4096,65536

  * a device line;
  * field multiplies at 2^16 elements, the plain twin (``field.mul_plain``)
    and the fe_mul kernel (``field.mul``), each with its roofline line, and
    the inner product at 2^16 (``field.inner_product``: its limbs from one
    fe_inner_product launch, the combine and the fold in the kernel);
  * ``msm_auto`` points per second at 2^16 (and 2^20 with ``--big``; or the
    ``--sizes`` given), with its roofline and the split-half check
    msm(P, s) == msm(P[:h], s[:h]) + msm(P[h:], s[h:]) (``curve.eq``);
  * the host-transcript prover and verifiers at 16 bits: ``prove``,
    ``verify``, ``verify_fast``, ``prove_fast`` latencies;
  * an aggregated proof of 16 values of 16 bits (``aggregate.verify``) and
    the batched verification of 4 single proofs (``aggregate.batch_verify``).

Points are P_i = k_i B with k_i = (1 + i * 0x9E3779B97F4A7C15) mod l
(ladders of 2^16 rows at a time), scalars (7 + i * 0xDEADBEEF12345) mod l.
Times: median of several calls, the host clock stopped after a device sync.
Runs on the card, or on the CPU under BP_PLATFORM=cpu (the plain twins: no
device metric).  A failed check raises, so the exit code is nonzero.  The
JAX script's ``vs_baseline`` (a reference figure of another GPU) is not
printed.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import config
from ..models import aggregate as agg, rangeproof as rp
from ..models.generators import get_generators
from ..ops import curve as C, field as F, msm as M
from ..utils import oracle, profiling, scalars as S


def timeit(fn, *args, iters=5, warmup=1, device=None):
    """Median seconds of fn(*args), each call ended by a device sync."""
    dev = device or torch.device("cpu")
    for _ in range(warmup):
        fn(*args)
        profiling.sync(dev)
    ts = []
    for _ in range(iters):
        profiling.sync(dev)
        t0 = time.perf_counter()
        fn(*args)
        profiling.sync(dev)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def emit(metric, value, unit, **kw):
    print(json.dumps({"metric": metric, "value": round(value, 6),
                      "unit": unit, **kw}), flush=True)


def device_line(dev: torch.device) -> None:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": name, "backend": dev.type}), flush=True)


def scalar_limbs(ints, dev) -> torch.Tensor:
    """Python ints below 2^255 -> [n, 20] limbs on `dev` (through their
    32-byte encodings: the same limbs as ``field.from_ints`` for values
    below p, in one tensor op)."""
    raw = np.frombuffer(b"".join(k.to_bytes(32, "little") for k in ints),
                        dtype=np.uint8).reshape(-1, 32)
    return F.from_bytes(torch.from_numpy(raw.copy()).to(dev))


def make_points(n: int, dev, seed: int = 1):
    """Points k_i B (k_i = (seed + i * 0x9E3779B97F4A7C15) mod l), by
    ladders of at most 2^16 rows, and scalars (7 + i * 0xDEADBEEF12345)
    mod l, as limbs on `dev`."""
    ks = scalar_limbs([(seed + i * 0x9E3779B97F4A7C15) % oracle.ELL
                       for i in range(n)], dev)
    step = min(n, 1 << 16)
    chunks = [C.scalarmult(C.base_point((ks[off:off + step].shape[0],), dev),
                           ks[off:off + step])
              for off in range(0, n, step)]
    pts = C.GE(*(torch.cat([ch[i] for ch in chunks]) for i in range(4)))
    scalars = scalar_limbs([(7 + i * 0xDEADBEEF12345) % oracle.ELL
                            for i in range(n)], dev)
    return pts, scalars


def bench_field(dev, n: int = 1 << 16, iters: int = 20, rate=None) -> None:
    """Field multiplies (twin, kernel) and the inner product at n."""
    rngnp = np.random.RandomState(0)
    a = torch.from_numpy(rngnp.randint(0, F.MASK + 1, size=(n, F.L),
                                       dtype=np.int32)).to(dev)
    b = torch.from_numpy(rngnp.randint(0, F.MASK + 1, size=(n, F.L),
                                       dtype=np.int32)).to(dev)
    for metric, fn in (("field_mul_plain_throughput", F.mul_plain),
                       ("field_mul_kernel_throughput", F.mul)):
        t = timeit(fn, a, b, iters=iters, device=dev)
        emit(metric, n / t, "mul/s", batch=n, seconds=t)
        print(profiling.field_mul_roofline(n / t, rate).to_json(), flush=True)
    t = timeit(F.inner_product, a, b, iters=iters, device=dev)
    emit("field_inner_product_kernel", n / t, "elem/s", batch=n, seconds=t)


def msm_window(n: int) -> int:
    """The window bits msm_auto's bucket MSM runs at for n points."""
    if config.MSM_ACCUM_KERNEL:
        return config.accum_plan(min(n, config.MSM_ACCUM_CHUNK))[0]
    return config.msm_window_for(min(n, config.MSM_CHUNK))


def bench_msm(dev, sizes, iters: int = 3, warmup: int = 1,
              rate=None) -> None:
    """msm_auto points per second at each size, its roofline, and the
    split-half check (raises if it fails)."""
    for nn in sizes:
        pts, scalars = make_points(nn, dev)
        profiling.sync(dev)
        w = msm_window(nn)
        fn = M.msm_auto
        t = timeit(fn, pts, scalars, iters=iters, warmup=warmup, device=dev)
        label = f"2e{nn.bit_length() - 1}"
        emit(f"msm_points_per_sec_{label}", nn / t, "points/s", n=nn,
             seconds=t, window=w)
        print(profiling.msm_roofline(nn / t, nn, w, rate).to_json(),
              flush=True)
        half = nn // 2
        r_full = fn(pts, scalars)
        r_a = fn(C.GE(*(c[:half] for c in pts)), scalars[:half])
        r_b = fn(C.GE(*(c[half:] for c in pts)), scalars[half:])
        ok = bool(C.eq(r_full, C.add(r_a, r_b)))
        print(json.dumps({"check": f"msm_split_half_{label}", "ok": ok}),
              flush=True)
        if not ok:
            raise AssertionError(f"msm_auto at {nn}: split-half check failed")


def bench_proofs(dev, bits: int = 16, m: int = 16, value: int = 42,
                 batch_values=(1, 7, 42, 65535), iters=(3, 5, 10, 10, 3),
                 warmup: int = 1):
    """The host prover and verifiers at `bits` on a proof of `value`, an
    aggregated proof of m values and the batched verification of single
    proofs of `batch_values` (mod 2^bits); every proof must be accepted
    (raises otherwise).  iters: the timed calls of prove, verify, verify_fast,
    prove_fast and of each of the last two, each after `warmup` calls."""
    it_prove, it_verify, it_fast_v, it_fast_p, it_agg = iters

    def timeit_(*args, iters):
        return timeit(*args, iters=iters, warmup=warmup, device=dev)
    gens = get_generators(bits, dev)
    proof = rp.prove(value, S.sc_random(), bits, gens)
    if not rp.verify(proof, gens):
        raise AssertionError("the host prover's proof is rejected")

    def run(check, *args):
        if not check(*args):
            raise AssertionError(f"{check.__name__} rejected its proof")

    t = timeit_(lambda: rp.prove(value, 12345, bits, gens), iters=it_prove)
    emit(f"range_prove_{bits}bit_latency", t, "s")
    t = timeit_(run, rp.verify, proof, gens, iters=it_verify)
    emit(f"range_verify_{bits}bit_latency", t, "s")
    t = timeit_(run, rp.verify_fast, proof, gens, iters=it_fast_v)
    emit(f"range_verify_fast_{bits}bit_latency", t, "s")
    t = timeit_(lambda: rp.prove_fast(value, 12345, bits, gens),
                iters=it_fast_p)
    emit(f"range_prove_fast_{bits}bit_latency", t, "s")

    gens_agg = get_generators(bits * m, dev)
    top = 1 << bits
    aproof = agg.prove([v * 37 % top for v in range(m)],
                       [S.sc_random() for _ in range(m)], bits, gens_agg)
    t = timeit_(run, agg.verify, aproof, gens_agg, iters=it_agg)
    emit(f"aggregated_verify_m{m}_n{bits}_latency", t, "s", N=bits * m)
    proofs = [rp.prove(v % top, S.sc_random(), bits, gens)
              for v in batch_values]
    t = timeit_(run, agg.batch_verify, proofs, gens, iters=it_agg)
    emit(f"batch_verify_{len(proofs)}_proofs_latency", t, "s",
         per_proof=round(t / len(proofs), 6))


def main(argv=None) -> int:
    from ..cli import device
    ap = argparse.ArgumentParser(prog="bench_msm",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--big", action="store_true", help="include 2^20 MSM")
    ap.add_argument("--sizes", type=str, default="",
                    help="comma-separated MSM sizes (replaces 2^16 / 2^20)")
    args = ap.parse_args(argv)

    dev = device()
    rate = profiling.device_rate(dev)
    device_line(dev)
    bench_field(dev, rate=rate)
    sizes = [1 << 16] + ([1 << 20] if args.big else [])
    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    bench_msm(dev, sizes, rate=rate)
    bench_proofs(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
