"""Write the JAX package's outputs that ``tests/test_torch_msm.py`` holds
the port's MSM route against, as the fixture ``tests/golden/msm_ref.npz``.

    python tests/make_msm_golden.py [path]

Runs ``test_torch_msm._jax_reference_main`` on ``test_torch_msm._inputs()``
in this process, with tests/conftest.py's JAX setup (the CPU backend) and
the compile cache off: ``extract_digits_signed`` at every window width of
the tests, and op by op (``jax.disable_jit``) ``madd_precomp``,
``invert``, ``batch_invert``, ``normalize_batch``, ``to_bytes_batch`` and
the XLA ``tree_reduce`` of 300 points (~75 s of one core).  Reads the JAX
package and changes nothing in it.  The ``slow`` test
``test_torch_msm.py::test_jax_reference_rebuilds_live`` reruns it and
compares every array.
"""
from __future__ import annotations

import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
GOLDEN = TESTS / "golden" / "msm_ref.npz"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dst = argv[0] if argv else str(GOLDEN)
    sys.path[:0] = [str(TESTS), str(TESTS.parent)]
    import conftest  # noqa: F401 (the JAX suite's CPU setup)
    import test_torch_msm
    test_torch_msm._jax_reference_main(dst)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
