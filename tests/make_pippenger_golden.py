"""Write the JAX package's sort-plus-scan MSM outputs as fixtures for the
port's tests.

    python tests/make_pippenger_golden.py [path]

writes ``path`` (by default ``tests/golden/pippenger.npz``).

Inputs come from ``numpy.random.default_rng(SEED)`` and the port's python-int
oracle (``hash_to_point``); the outputs from the JAX package on the CPU
backend, its Pallas kernels in interpret mode:

* ``pallas_curve.seg_scan`` at (depth, lanes) = (4, 4) and (8, 16): weak-limb
  points, head flags of sorted digits whose runs straddle lanes
  (``scan_<d>x<l>_{pt,ht,out,carry}``);
* ``pallas_curve.bucket_fold`` at (m, lanes) = (15, 4), (9, 4), (4, 4) and
  (23, 8): weak-limb rows with the identity, the base and an 8-torsion point
  among them (``fold_<m>x<l>_{body,out}``);
* ``pallas_sort.grouping_order`` at n = 1024 and 4096 for w in {5, 8, 13}
  and pass_bits in {4, 7} (``order_<n>_<w>_<bits>_{digits,out}``);
* ``pippenger.msm_pippenger``, compressed: at n = 32, w = 5 with
  ``MSM_SCAN_LANES`` = 8 and ``MSM_PALLAS_SCAN_FORCE`` on (the chunked scan
  and the fold in the Pallas kernels), and at n = 4096, w = 9 (the XLA
  chunked scan and fold) on 64 distinct points, point i % 64 for scalar i
  (``msm<n>_{points,scalars,bytes}``).

The config attributes are set inside this process only; the JAX package is
read and not changed.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

SEED = 20261018
GOLDEN = Path(__file__).resolve().parent / "golden" / "pippenger.npz"
SCAN_SHAPES = ((4, 4), (8, 16))
FOLD_SHAPES = ((15, 4), (9, 4), (4, 4), (23, 8))
ORDER_SIZES = (1024, 4096)
ORDER_WINDOWS = (5, 8, 13)
ORDER_BITS = (4, 7)
MSM_CASES = ((32, 5, 8, 32), (4096, 9, None, 64))   # n, w, lanes, points
BOUND = 8799                                        # weak limb bound


def _limbs(v: int) -> list:
    return [(v >> (13 * i)) & 0x1FFF for i in range(20)]


def _rows(points) -> np.ndarray:
    """oracle points -> [n, 80] int32 limb rows (x|y|z|t)."""
    return np.array([[x for c in (p.X, p.Y, p.Z, p.T) for x in _limbs(c)]
                     for p in points], dtype=np.int32)


def scan_inputs(rng, depth: int, lanes: int):
    """pt [depth, 80, lanes] weak limbs; ht [depth, 1, lanes] the run starts
    of sorted digits with about three elements a run, element (j, l) the
    sorted element l * depth + j."""
    n = depth * lanes
    pt = rng.integers(0, BOUND + 1, size=(depth, 80, lanes), dtype=np.int32)
    d = np.sort(rng.integers(0, max(2, n // 3), size=n))
    head = np.concatenate([[True], d[1:] != d[:-1]])
    ht = head.reshape(lanes, depth).T[:, None, :].astype(np.int32)
    return pt, ht


def fold_body(rng, m: int):
    from cudabulletproof_tpu_torch.utils import oracle
    body = rng.integers(0, BOUND + 1, size=(m, 80), dtype=np.int32)
    special = _rows([oracle.IDENTITY, oracle.BASE,
                     oracle.small_order_points()[3]])
    at = rng.choice(m, size=min(m, 3), replace=False)
    body[at] = special[:len(at)]
    return body


def msm_inputs(rng, n: int, distinct: int):
    """Points (point i % distinct of hash_to_point(b"golden-msm", .)) as
    [n, 80] rows and scalars mod l, the edge scalars 0, 1, l - 1 first."""
    from cudabulletproof_tpu_torch.utils import oracle
    pts = _rows([oracle.hash_to_point(b"golden-msm", i)
                 for i in range(distinct)])
    ell = oracle.ELL
    ks = [0, 1, ell - 1] + [int.from_bytes(rng.bytes(32), "little") % ell
                            for _ in range(n - 3)]
    return pts[np.arange(n) % distinct], np.array([_limbs(k) for k in ks],
                                                  dtype=np.int32)


def configure_jax() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)


def make() -> dict:
    import jax.numpy as jnp

    from cudabulletproof_tpu import config
    from cudabulletproof_tpu.ops import curve as JC, pallas_curve as PC
    from cudabulletproof_tpu.ops import pallas_sort as PS, pippenger as JP

    rng = np.random.default_rng(SEED)
    out = {}
    for depth, lanes in SCAN_SHAPES:
        pt, ht = scan_inputs(rng, depth, lanes)
        vals, carry = PC.seg_scan(jnp.asarray(pt), jnp.asarray(ht))
        key = f"scan_{depth}x{lanes}"
        out.update({f"{key}_pt": pt, f"{key}_ht": ht,
                    f"{key}_out": np.asarray(vals),
                    f"{key}_carry": np.asarray(carry)})
    for m, lanes in FOLD_SHAPES:
        body = fold_body(rng, m)
        key = f"fold_{m}x{lanes}"
        out[f"{key}_body"] = body
        out[f"{key}_out"] = np.asarray(PC.bucket_fold(jnp.asarray(body),
                                                      lanes=lanes))
    for n in ORDER_SIZES:
        for w in ORDER_WINDOWS:
            digits = rng.integers(0, 1 << w, size=n, dtype=np.int32)
            for bits in ORDER_BITS:
                key = f"order_{n}_{w}_{bits}"
                out[f"{key}_digits"] = digits
                out[f"{key}_out"] = np.asarray(PS.grouping_order(
                    jnp.asarray(digits), w, bits))
    for n, w, lanes, distinct in MSM_CASES:
        pts, sc = msm_inputs(rng, n, distinct)
        saved = (config.MSM_SCAN_LANES, config.MSM_PALLAS_SCAN_FORCE)
        try:
            if lanes is not None:
                config.MSM_SCAN_LANES = lanes
                config.MSM_PALLAS_SCAN_FORCE = True
            p = JC.GE(*(jnp.asarray(pts[:, 20 * i:20 * (i + 1)])
                        for i in range(4)))
            r = JP.msm_pippenger(p, jnp.asarray(sc), w=w)
        finally:
            config.MSM_SCAN_LANES, config.MSM_PALLAS_SCAN_FORCE = saved
        out.update({f"msm{n}_points": pts[:distinct], f"msm{n}_scalars": sc,
                    f"msm{n}_bytes": np.asarray(JC.to_bytes(r))})
    return out


def main(argv) -> int:
    configure_jax()
    path = Path(argv[0]) if argv else GOLDEN
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    np.savez_compressed(path, **make())
    print(f"{path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
