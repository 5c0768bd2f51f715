"""Write the JAX package's aggregated range proofs and batched verification
(``models/aggregate.py``) as fixtures for the port's tests.

    python tests/make_agg_golden.py    # agg_n8_m2, agg_n8_m4, agg_batch_n8

For each (n, m) of ``SIZES``, from ``numpy.random.default_rng(SEED + 16 n
+ m)``, in this order: m values in [0, 2^n), m blindings, then the
2 n m + 4 scalars the prover draws (sL[0..N), sR[0..N), alpha, rho, tau1,
tau2 with N = n m, in its order).  Within this process only,
``cudabulletproof_tpu.utils.scalars.sc_random`` is replaced by a function
that hands out the prover's scalars in turn, and the unmodified
``aggregate.prove`` writes the proof; ``aggregate.verify`` then gives its
verdict on each of ``agg_cases``.  Saved as ``tests/golden/agg_n<n>_m<m>.npz``
(every scalar and point 32 LE bytes):

    values, blindings [m, 32]
    rand [2nm+4, 32]      the prover's draws, in the order it drew them
    blob [len]            serialize_aggregated_proof of the proof
    cases [c], verify [c] the names of ``agg_cases`` and aggregate.verify's
                          verdict on each

For the batched verifier, four single proofs at n = 8 (``BATCH_VALUES``,
blindings and the host prover's 2n + 4 draws each from
``default_rng(SEED + 1)``, written by the unmodified ``rangeproof.prove``)
and ``aggregate.batch_verify``'s verdict on each of ``batch_cases``, in
``tests/golden/agg_batch_n8.npz``:

    rand [4, 2n+4, 32], secret [4, 2, 32]
    blobs [4, len]        serialize_range_proof of each proof
    cases [c], verify [c]

Reads the JAX package and changes nothing in it; runs on the CPU backend
with the compile cache off (a few minutes and a few GB).
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20261018
GOLDEN = Path(__file__).resolve().parent / "golden"
ELL = (1 << 252) + 27742317777372353535851937790883648493
SIZES = ((8, 2), (8, 4))
BATCH_BITS = 8
BATCH_VALUES = (1, 7, 42, 255)


def golden_path(n: int, m: int) -> Path:
    return GOLDEN / f"agg_n{n}_m{m}.npz"


def batch_path() -> Path:
    return GOLDEN / f"agg_batch_n{BATCH_BITS}.npz"


def to_rows(ints) -> np.ndarray:
    return np.array([list(v.to_bytes(32, "little")) for v in ints],
                    dtype=np.uint8).reshape(-1, 32)


def from_rows(rows) -> list:
    return [int.from_bytes(bytes(r), "little") for r in np.asarray(rows)]


def _scalar(rng) -> int:
    return int.from_bytes(rng.bytes(64), "little") % ELL


def draws(n: int, m: int) -> dict:
    """The fixture's values, blindings and prover draws for (n, m)."""
    rng = np.random.default_rng(SEED + 16 * n + m)
    values = [int.from_bytes(rng.bytes(8), "little") % (1 << n)
              for _ in range(m)]
    blindings = [_scalar(rng) for _ in range(m)]
    rand = [_scalar(rng) for _ in range(2 * n * m + 4)]
    return {"values": values, "blindings": blindings, "rand": rand}


def batch_draws() -> dict:
    """The four single proofs' blindings and prover draws."""
    rng = np.random.default_rng(SEED + 1)
    n = BATCH_BITS
    out = {"secret": [], "rand": []}
    for v in BATCH_VALUES:
        out["secret"].append([v, _scalar(rng)])
        out["rand"].append([_scalar(rng) for _ in range(2 * n + 4)])
    return out


def agg_cases(proof) -> dict:
    """name -> (proof, generators of n m / 2 in place of n m): the honest
    proof and corrupted copies.  Works on either package's dataclasses."""
    ip = proof.ip
    return {
        "honest": (proof, False),
        "t_hat + 1": (dataclasses.replace(
            proof, t_hat=(proof.t_hat + 1) % ELL), False),
        "V swapped": (dataclasses.replace(
            proof, V=[proof.V[1], proof.V[0]] + list(proof.V[2:])), False),
        "V dropped": (dataclasses.replace(proof, V=list(proof.V[:-1])),
                      False),
        "last round dropped": (dataclasses.replace(
            proof, ip=dataclasses.replace(ip, L=list(ip.L[:-1]),
                                          R=list(ip.R[:-1]))), False),
        "ip.n halved": (dataclasses.replace(proof, ip=dataclasses.replace(
            ip, n=ip.n // 2)), False),
        "m = 3": (dataclasses.replace(proof, m=3), False),
        "mu + 1": (dataclasses.replace(proof, mu=(proof.mu + 1) % ELL),
                   False),
        "undersized generators": (proof, True),
    }


def batch_cases(proofs: list) -> dict:
    """name -> list of single proofs: the four honest ones, the four with
    one tampered (t_hat + 1, or a round dropped), one alone, none, and two
    of different n."""
    tampered = list(proofs)
    tampered[2] = dataclasses.replace(proofs[2],
                                      t_hat=(proofs[2].t_hat + 1) % ELL)
    dropped = list(proofs)
    ip = proofs[1].ip
    dropped[1] = dataclasses.replace(proofs[1], ip=dataclasses.replace(
        ip, L=list(ip.L[:-1]), R=list(ip.R[:-1])))
    other_n = list(proofs)
    other_n[3] = dataclasses.replace(proofs[3], n=proofs[3].n // 2)
    return {"4 honest": list(proofs), "4, one t_hat + 1": tampered,
            "4, one round dropped": dropped, "one honest": proofs[:1],
            "none": [], "4, one of another n": other_n}


def _fed(values):
    """Replace the JAX package's sc_random by a feed of `values` for the
    duration of a call; raises if the call drew fewer."""
    from cudabulletproof_tpu.utils import scalars

    class Feed:
        def __enter__(self):
            self.it = iter(values)
            self.original = scalars.sc_random
            scalars.sc_random = lambda: next(self.it)

        def __exit__(self, *exc):
            scalars.sc_random = self.original
            if exc[0] is None and next(self.it, None) is not None:
                raise AssertionError("the prover drew fewer scalars than "
                                     "recorded")
    return Feed()


def jax_fixture(n: int, m: int) -> dict:
    """Run the unmodified JAX aggregated prover and verifier for (n, m)."""
    from cudabulletproof_tpu.models import aggregate as agg
    from cudabulletproof_tpu.models.generators import get_generators
    from cudabulletproof_tpu.utils import serialization

    d = draws(n, m)
    gens = get_generators(n * m)
    with _fed(d["rand"]):
        proof = agg.prove(d["values"], d["blindings"], n, gens)
    blob = serialization.serialize_aggregated_proof(proof)
    small = get_generators(n * m // 2)
    names, verdicts = [], []
    for name, (p, undersized) in agg_cases(proof).items():
        names.append(name)
        verdicts.append(agg.verify(p, small if undersized else gens))
    return {"values": to_rows(d["values"]),
            "blindings": to_rows(d["blindings"]),
            "rand": to_rows(d["rand"]),
            "blob": np.frombuffer(blob, dtype=np.uint8),
            "cases": np.array(names), "verify": np.array(verdicts, bool)}


def jax_batch_fixture() -> dict:
    """Four unmodified JAX host proofs and the batched verdicts."""
    from cudabulletproof_tpu.models import aggregate as agg, rangeproof as rp
    from cudabulletproof_tpu.models.generators import get_generators
    from cudabulletproof_tpu.utils import serialization

    d = batch_draws()
    gens = get_generators(BATCH_BITS)
    proofs = []
    for (value, blinding), rand in zip(d["secret"], d["rand"]):
        with _fed(rand):
            proofs.append(rp.prove(value, blinding, BATCH_BITS, gens))
    names, verdicts = [], []
    for name, batch in batch_cases(proofs).items():
        names.append(name)
        verdicts.append(agg.batch_verify(batch, gens))
    blobs = [serialization.serialize_range_proof(p) for p in proofs]
    return {"secret": np.stack([to_rows(s) for s in d["secret"]]),
            "rand": np.stack([to_rows(r) for r in d["rand"]]),
            "blobs": np.stack([np.frombuffer(b, dtype=np.uint8)
                               for b in blobs]),
            "cases": np.array(names), "verify": np.array(verdicts, bool)}


def configure_jax() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)


def write(out_dir: Path = GOLDEN) -> list:
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for n, m in SIZES:
        path = out_dir / golden_path(n, m).name
        np.savez_compressed(path, **jax_fixture(n, m))
        paths.append(path)
    path = out_dir / batch_path().name
    np.savez_compressed(path, **jax_batch_fixture())
    return paths + [path]


def main() -> int:
    configure_jax()
    t0 = time.perf_counter()
    for path in write():
        print(f"{path.name} at {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
