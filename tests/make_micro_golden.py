"""Write the JAX package's three diagnostic microbenchmark kernels, run in
Pallas interpret mode, as fixtures for ``tests/test_torch_micro.py``.

    python tests/make_micro_golden.py [path] [--jobs N]

writes ``path`` (by default ``tests/golden/micro.npz``).  The kernels are
those of the root ``benchmarks/`` scripts, read and not changed:

* ``bench_addrate.chain_kernel`` for op in (add, dbl) and every
  (mul_passes, add_passes) pair of the script's sweep, at K = 4 chained ops
  on ``curve.base_point`` in 8 lanes (``chain_in`` [80, 8], the script's
  ``_pad_lanes(_flatten(pt))``; ``chain_<op>_<mp>_<ap>`` [80, 8]).  The
  module global ``K`` is set to 4.
* the window kernels of ``_accum_micro.kernel`` (variants full, nosel,
  noadd, cached, tree) and ``_repro_accum3.kernel`` (full, init_loop,
  nostep, nosign, padd, nofold, halvonly, fori, sufonly), at w = 2 and 3
  (nb = 3 and 5 buckets), lanes 8, unroll 2, steps 2, nw 2.  Inputs
  ``win_pt_w<w>`` [steps, unroll, 80, lanes] and ``win_dg_w<w>`` [nw, steps,
  unroll, lanes]: at w = 2 the ``_accum_micro`` points (limbs 3 / 1 / 5 at
  rows 0 / L / 2L), at w = 3 weak limbs in [0, 8799]; the digits from
  ``numpy.random.default_rng(SEED + w)`` in [-(nb - 1), nb - 1].  Outputs
  ``accum_<variant>_w<w>`` / ``repro_<variant>_w<w>`` [nw, 80, lanes].

Each script is imported with ``sys.argv`` patched to small arguments: its
top-level TPU attempt fails fast on the CPU (it prints FAILED), then the
module globals the kernel reads at trace time (``VARIANT``, ``steps``,
``nw``, ``lanes``, ``unroll``, ``nb``) are set and the script's
``pallas_call`` is rebuilt with ``interpret=True``.  Every case runs in its
own process (a pool of ``--jobs``, default 4), since the globals are the
module's: about 40 s of one core for a window case, 2-4 GB each.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "micro.npz"
SEED = 20261019
L = 20
BOUND = 8799
CHAIN_K = 4
CHAIN_LANES = 8
CHAIN_OPS = ("add", "dbl")
PASS_PAIRS = ((5, 2), (4, 2), (3, 1), (1, 1), (0, 0))
WIN_WIDTHS = (2, 3)
WIN_LANES, WIN_UNROLL, WIN_STEPS, WIN_NW = 8, 2, 2, 2
ACCUM_VARIANTS = ("full", "nosel", "noadd", "cached", "tree")
REPRO_VARIANTS = ("full", "init_loop", "nostep", "nosign", "padd", "nofold",
                  "halvonly", "fori", "sufonly")


def window_inputs(w: int):
    """(pt [steps, unroll, 80, lanes], dg [nw, steps, unroll, lanes]) of
    width w."""
    nb = (1 << (w - 1)) + 1
    rng = np.random.default_rng(SEED + w)
    shape = (WIN_STEPS, WIN_UNROLL, 4 * L, WIN_LANES)
    if w == 2:
        pt = np.zeros(shape, np.int32)
        pt[:, :, 0], pt[:, :, L], pt[:, :, 2 * L] = 3, 1, 5
    else:
        pt = rng.integers(0, BOUND + 1, shape, dtype=np.int32)
    dg = rng.integers(-(nb - 1), nb, (WIN_NW, WIN_STEPS, WIN_UNROLL,
                                      WIN_LANES)).astype(np.int32)
    return pt, dg


def _setup():
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")


def _quiet_import(name: str, argv: list):
    """Import benchmarks.<name> with sys.argv = argv, its output dropped."""
    import contextlib
    import importlib
    import io
    saved = sys.argv
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            return importlib.import_module(f"benchmarks.{name}")
    finally:
        sys.argv = saved


def run_chain(op: str, mp: int, ap: int):
    _setup()
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    JB = _quiet_import("bench_addrate", ["bench_addrate"])
    from cudabulletproof_tpu.ops import curve as C, pallas_curve as PC
    import functools
    JB.K = CHAIN_K
    flat = PC._pad_lanes(PC._flatten(C.base_point((CHAIN_LANES,))),
                         CHAIN_LANES)
    kern = functools.partial(JB.chain_kernel, op=op, mul_passes=mp,
                             add_passes=ap)
    spec = pl.BlockSpec((4 * L, CHAIN_LANES), lambda: (0, 0),
                        memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((4 * L, CHAIN_LANES), jnp.int32),
        in_specs=[spec], out_specs=spec, interpret=True)(flat)
    return {"chain_in": np.asarray(flat),
            f"chain_{op}_{mp}_{ap}": np.asarray(out)}


def run_window(script: str, variant: str, w: int):
    _setup()
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    name = "_accum_micro" if script == "accum" else "_repro_accum3"
    argv = [name, variant, str(w), str(WIN_LANES), str(WIN_UNROLL)]
    mod = _quiet_import(name, argv if script == "accum" else argv[:2])
    nb = (1 << (w - 1)) + 1
    mod.VARIANT, mod.nb = variant, nb
    mod.steps, mod.nw, mod.lanes, mod.unroll = (WIN_STEPS, WIN_NW, WIN_LANES,
                                                WIN_UNROLL)
    pt, dg = window_inputs(w)
    out = pl.pallas_call(
        mod.kernel,
        out_shape=jax.ShapeDtypeStruct((WIN_NW, 4 * L, WIN_LANES), jnp.int32),
        grid=(WIN_NW, WIN_STEPS),
        in_specs=[
            pl.BlockSpec((1, WIN_UNROLL, 4 * L, WIN_LANES),
                         lambda w, j: (j, 0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, WIN_UNROLL, WIN_LANES),
                         lambda w, j: (w, j, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 4 * L, WIN_LANES), lambda w, j: (w, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((nb, 4 * L, WIN_LANES), jnp.int32)],
        interpret=True)(jnp.asarray(pt), jnp.asarray(dg))
    return {f"{script}_{variant}_w{w}": np.asarray(out)}


def cases() -> list:
    out = [(run_chain, (op, mp, ap)) for op in CHAIN_OPS
           for mp, ap in PASS_PAIRS]
    for w in WIN_WIDTHS:
        out += [(run_window, ("accum", v, w)) for v in ACCUM_VARIANTS]
        out += [(run_window, ("repro", v, w)) for v in REPRO_VARIANTS]
    return out


def _call(job):
    fn, args = job
    t0 = time.perf_counter()
    res = fn(*args)
    return args, time.perf_counter() - t0, res


def build(jobs: int = 4) -> dict:
    """Every case, each in a fresh process; returns the fixture arrays."""
    import multiprocessing
    arrays = {"chain_k": np.int32(CHAIN_K)}
    for w in WIN_WIDTHS:
        arrays[f"win_pt_w{w}"], arrays[f"win_dg_w{w}"] = window_inputs(w)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx,
                             max_tasks_per_child=1) as pool:
        for args, secs, res in pool.map(_call, cases()):
            print(f"{args}: {secs:.1f} s", flush=True)
            arrays.update(res)
    return arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=str(GOLDEN))
    ap.add_argument("--jobs", type=int, default=4)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    arrays = build(args.jobs)
    np.savez_compressed(args.path, **arrays)
    print(f"wrote {args.path} ({len(arrays)} arrays) in "
          f"{time.perf_counter() - t0:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
