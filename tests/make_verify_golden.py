"""Write the JAX package's fused verifier (``models/fused.py``) on fixed
proofs as fixtures for ``tests/test_torch_verify.py``.

    python tests/make_verify_golden.py            # new native proofs
    python tests/make_verify_golden.py --keep     # the committed proofs again

For n in ``SIZES``: three native proofs (``native.prove_range``; values 0,
2^n - 1 and one from ``numpy.random.default_rng(64 + n)``, blindings from
the same generator; the native prover draws its own nonces, so ``--keep``
reuses the committed ones), then the inputs of ``cases``: each blob with
its weight pair through the unmodified ``fused._verify_parts_fn(n)``
(jitted once per n), and the single and merged-batch verdicts of
``fused._verify_fn`` / ``_batch_verify_merged_fn`` taken on those outputs
(``jax_verdict``: ``_assemble_bases``, ``sum_mod``, the final MSM by the
python-int oracle).  At n = 4 also the verdicts of ``fused.verify`` and
``fused.batch_verify`` themselves (their own random weights) on the same
honest, tampered, small-order and non-canonical proofs.  Saved as
``tests/golden/verify_n<n>.npz``:

    proofs [3, len]       the native proofs' wire bytes
    valid [k], scalars [k, ...], pts [4, k, 20]
                          _verify_parts_fn's outputs on every blob of
                          ``blob_order`` (parts cases, single verdict cases,
                          then the two batches' proofs)
    verdicts [s + 2]      the single verdicts, then the two merged batches'
    fused_verify [s], fused_batch [2]   (n = 4 only)

Reads the JAX package and changes nothing in it; runs on the CPU backend
with the compile cache off: ~100 s of compile per n for the parts program,
several minutes each for ``fused.verify`` and ``fused.batch_verify``.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent / "golden"
SIZES = (4, 8)
FUSED_N = 4
ELL = (1 << 252) + 27742317777372353535851937790883648493
P = (1 << 255) - 19


def golden_path(n: int) -> Path:
    return GOLDEN / f"verify_n{n}.npz"


def make_proofs(n: int) -> list:
    """Three native proofs of n bits (values 0, 2^n - 1 and one drawn)."""
    from cudabulletproof_tpu.utils import native
    rng = np.random.default_rng(64 + n)
    values = [0, (1 << n) - 1, int(rng.integers(0, 1 << n))]
    return [native.prove_range(v, int.from_bytes(rng.bytes(32), "little"), n)
            for v in values]


def tamper(proof) -> dict:
    """name -> a tampered copy; works on either package's dataclasses."""
    from cudabulletproof_tpu.utils import oracle
    tor = oracle.small_order_points()
    ip = proof.ip
    return {
        "t_hat+1": dataclasses.replace(proof, t_hat=(proof.t_hat + 1) % ELL),
        "V=A": dataclasses.replace(proof, V=proof.A),
        "ip.a*2": dataclasses.replace(
            proof, ip=dataclasses.replace(ip, a=ip.a * 2 % ELL)),
        "A small order": dataclasses.replace(proof, A=tor[1].compress()),
        "S non-canonical": dataclasses.replace(
            proof, S=(P + 1).to_bytes(32, "little")),
    }


def _rnd(rng, count) -> list:
    return [int.from_bytes(rng.bytes(32), "little") % (ELL - 1) + 1
            for _ in range(2 * count)]


def cases(proofs: list, n: int) -> dict:
    """The inputs of the three comparisons at n, weights from seeded numpy
    rngs.  ``parts``: honest, tampered, small-order and non-canonical
    proofs as one batch.  ``verdicts``: 3 honest and 5 tampered proofs, one
    at a time.  ``batches``: 3 honest proofs merged, then the same with one
    tampered.  Each is (proofs, weights)."""
    bad = tamper(proofs[0])
    parts = [proofs[1], bad["t_hat+1"], bad["A small order"],
             bad["S non-canonical"]]
    verdicts = list(proofs) + list(bad.values())
    rng = np.random.default_rng(100 + n)
    sunk = proofs[:2] + [dataclasses.replace(proofs[2],
                                             mu=(proofs[2].mu + 1) % ELL)]
    brng = np.random.default_rng(200 + n)
    return {"parts": (parts, _rnd(np.random.default_rng(n), len(parts))),
            "verdicts": (verdicts, [_rnd(rng, 1) for _ in verdicts]),
            "batches": ([(list(proofs), True), (sunk, False)],
                        [_rnd(brng, 3) for _ in range(2)])}


def blob_order(c: dict):
    """(proofs, weight pairs, the index groups of the single verdicts and
    of the two merged batches) in the order the fixture stores them."""
    parts, parts_w = c["parts"]
    verdicts, verdict_w = c["verdicts"]
    batches, batch_w = c["batches"]
    pairs = [parts_w[i:i + 2] for i in range(0, len(parts_w), 2)]
    proofs = parts + verdicts + [p for batch, _ in batches for p in batch]
    rnd = pairs + verdict_w + [w[i:i + 2] for w in batch_w
                               for i in range(0, len(w), 2)]
    a, b = len(parts), len(parts) + len(verdicts)
    groups = [(i,) for i in range(a, b)] + [
        tuple(range(b + 3 * j, b + 3 * j + 3)) for j in range(2)]
    return proofs, rnd, groups


def jax_verdict(n, pack, outs) -> bool:
    """The JAX package's single (one proof) or merged-batch verdict on its
    parts outputs: its base and scalar assembly, the MSM by the oracle, then
    the cofactor-8 identity check."""
    import jax.numpy as jnp
    from cudabulletproof_tpu.models import fused as JFU
    from cudabulletproof_tpu.ops import curve as JC, scalar_field as JS
    from cudabulletproof_tpu.utils import oracle
    valid = all(bool(o[0]) for o in outs)
    sc = jnp.stack([o[1] for o in outs])
    pts = JC.GE(*(jnp.stack([o[2][c] for o in outs]) for c in range(4)))
    if len(outs) == 1:
        scal = sc[0]
    else:
        scal = jnp.concatenate([JS.sum_mod(sc[:, :2 * n + 2], axis=0),
                                sc[:, 2 * n + 2:].reshape(-1, JS.SL)])
    bases = JC.to_oracle(JFU._assemble_bases(pack, n, pts))
    acc = oracle.IDENTITY
    for pt, k in zip(bases, JS.to_ints(JS.canonical(scal))):
        acc = acc + k * pt
    return valid and 8 * acc == oracle.IDENTITY


def jax_fixture(n: int, blobs: list) -> dict:
    """The JAX package on all of ``cases`` at n for the native proofs
    `blobs`."""
    import jax
    import jax.numpy as jnp
    from cudabulletproof_tpu.models import fused as JFU
    from cudabulletproof_tpu.models.generators import get_generators
    from cudabulletproof_tpu.ops import scalar_field as JS
    from cudabulletproof_tpu.utils import serialization as JSER

    gens = get_generators(n)
    pack = JFU._gens_pack(gens, n)
    c = cases([JSER.deserialize_range_proof(b) for b in blobs], n)
    proofs, rnd, groups = blob_order(c)
    parts = jax.jit(JFU._verify_parts_fn(n))
    outs = [parts(jnp.asarray(JFU._proof_blob(p)), JS.from_ints(r), pack)
            for p, r in zip(proofs, rnd, strict=True)]
    out = {
        "proofs": np.stack([np.frombuffer(b, dtype=np.uint8) for b in blobs]),
        "valid": np.array([bool(o[0]) for o in outs]),
        "scalars": np.stack([np.asarray(o[1]) for o in outs]),
        "pts": np.stack([np.stack([np.asarray(o[2][i]) for o in outs])
                         for i in range(4)]),
        "verdicts": np.array([jax_verdict(n, pack, [outs[i] for i in g])
                              for g in groups], dtype=bool)}
    if n == FUSED_N:
        jax.clear_caches()
        verdicts, _ = c["verdicts"]
        batches, _ = c["batches"]
        out["fused_verify"] = np.array([JFU.verify(p, gens)
                                        for p in verdicts], dtype=bool)
        out["fused_batch"] = np.array([JFU.batch_verify(b, gens)
                                       for b, _ in batches], dtype=bool)
    jax.clear_caches()
    return out


def committed_proofs(n: int) -> list:
    with np.load(golden_path(n)) as f:
        return [row.tobytes() for row in f["proofs"]]


def configure_jax() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)


def write(out_dir: Path = GOLDEN, keep: bool = False) -> list:
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for n in SIZES:
        blobs = committed_proofs(n) if keep else make_proofs(n)
        path = out_dir / golden_path(n).name
        np.savez_compressed(path, **jax_fixture(n, blobs))
        paths.append(path)
    return paths


def main(argv) -> int:
    configure_jax()
    t0 = time.perf_counter()
    for path in write(keep="--keep" in argv):
        print(f"{path.name} at {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
