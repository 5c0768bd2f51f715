"""Write the JAX package's prover blobs as fixtures for the port's tests.

    python tests/make_prove_golden.py [n ...]        # default: 4 8

For each n: fixed inputs made from ``numpy.random.default_rng(SEED + n)``
(a value in [0, 2^n), its bits ``aL_bits``, and ``scp`` = [value, blinding,
alpha, rho, tau1, tau2, sL(n), sR(n)] as uniform scalars mod l), the JAX
package's packed generators ``gp``, and the unmodified jitted
``fused._prove_fn(n)`` on them (its Pallas ladder in interpret mode on the
CPU), saved as ``tests/golden/prove_n<n>.npz`` with arrays ``gp`` [2n+2, 80]
int32, ``aL_bits`` [n] int32, ``scp`` [2n+6, 22] int32 scalar limbs and
``blob`` uint8 [5 + 2k + 5, 32].  Reads the JAX package and changes nothing
in it; runs on the CPU backend with the compile cache off.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

SEED = 20261017
GOLDEN = Path(__file__).resolve().parent / "golden"


def golden_path(n: int) -> Path:
    return GOLDEN / f"prove_n{n}.npz"


def prove_inputs(n: int) -> dict:
    """The fixture's (gp, aL_bits, scp) for n, from the seed."""
    from cudabulletproof_tpu.models import fused
    from cudabulletproof_tpu.models.generators import get_generators
    from cudabulletproof_tpu.ops import scalar_field as SC
    from cudabulletproof_tpu.utils.scalars import ELL

    rng = np.random.default_rng(SEED + n)
    value = int.from_bytes(rng.bytes(8), "little") % (1 << n)
    rand = [int.from_bytes(rng.bytes(64), "little") % ELL
            for _ in range(2 * n + 5)]
    return {"gp": np.asarray(fused._gens_pack(get_generators(n), n)),
            "aL_bits": np.array([(value >> i) & 1 for i in range(n)],
                                dtype=np.int32),
            "scp": np.asarray(SC.from_ints([value] + rand))}


def jax_blob(n: int, inputs: dict) -> np.ndarray:
    """The unmodified ``fused._prove_fn(n)`` on the inputs."""
    import jax.numpy as jnp

    from cudabulletproof_tpu.models import fused
    fn = fused._prove_fn(n)
    return np.asarray(fn(jnp.asarray(inputs["gp"]),
                         jnp.asarray(inputs["aL_bits"]),
                         jnp.asarray(inputs["scp"])))


def configure_jax() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)


def main(argv) -> int:
    configure_jax()
    GOLDEN.mkdir(exist_ok=True)
    for n in [int(a) for a in argv] or [4, 8]:
        t0 = time.perf_counter()
        inputs = prove_inputs(n)
        blob = jax_blob(n, inputs)
        np.savez_compressed(golden_path(n), blob=blob, **inputs)
        print(f"n={n}: {golden_path(n).name} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
