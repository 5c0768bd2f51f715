"""Write the JAX package's outputs that ``tests/test_torch_curve.py`` and
``tests/test_torch_field.py`` hold the port's twins against, as the
fixture ``tests/golden/curve_field.npz``.

    python tests/make_curve_field_golden.py [path]

On the inputs of those tests (``test_torch_curve._points()``,
``test_torch_field._operands()``), with tests/conftest.py's JAX setup (the
CPU backend, Pallas in interpret mode):

    add_pallas, add_xla        pallas_curve.add / curve.add_xla of the 8
                               pairs (gens[i], others[i])  [4, 8, 20]
    double_pallas, double_xla  pallas_curve.double / curve.double of
                               gens[:4]                    [4, 4, 20]
    tree_reduce                curve.tree_reduce of gens + others[:5]
                                                           [4, 20]
    pow2523_pallas, pow2523_xla
                               pallas_field.pow2523 / field.pow2523 of a
                                                           [16, 20]

About a minute of one core.  Reads the JAX package and changes nothing in
it.  ``test_torch_curve.py::test_fixture_rebuilds_live`` (``slow``) reruns
it and compares every array.
"""
from __future__ import annotations

import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
GOLDEN = TESTS / "golden" / "curve_field.npz"


def build() -> dict:
    import numpy as np
    import jax.numpy as jnp
    from cudabulletproof_tpu.ops import (curve as JC, field as JF,
                                         pallas_curve as PC,
                                         pallas_field as PF)
    import test_torch_curve
    import test_torch_field

    def pt(g):
        return np.stack([np.asarray(c) for c in g])

    gens, others, _ = test_torch_curve._points()
    jp, jq = JC.from_oracle(gens), JC.from_oracle(others)
    jp4 = JC.from_oracle(gens[:4])
    a, _ = test_torch_field._operands()
    ja = jnp.asarray(a)
    return {
        "add_pallas": pt(PC.add(jp, jq)),
        "add_xla": pt(JC.add_xla(jp, jq)),
        "double_pallas": pt(PC.double(jp4)),
        "double_xla": pt(JC.double(jp4)),
        "tree_reduce": pt(JC.tree_reduce(JC.from_oracle(gens + others[:5]))),
        "pow2523_pallas": np.asarray(PF.pow2523(ja)),
        "pow2523_xla": np.asarray(JF.pow2523(ja)),
    }


def main(argv=None) -> int:
    import numpy as np
    argv = sys.argv[1:] if argv is None else argv
    dst = argv[0] if argv else str(GOLDEN)
    sys.path[:0] = [str(TESTS), str(TESTS.parent)]
    import conftest  # noqa: F401 (the JAX suite's CPU setup)
    import jax
    jax.config.update("jax_enable_compilation_cache", False)
    np.savez(dst, **build())
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
