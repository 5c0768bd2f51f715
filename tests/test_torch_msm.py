"""The port's MSM route (ops/pippenger.py, ops/msm.py, the field inversion
and the curve normalization and tile reduction it needs) against the JAX
package and the python-int oracle.

Inputs come from ``random.Random(1234)`` (the ``rng`` fixture) and numpy,
points from ``oracle.hash_to_point``, at small sizes, on the CPU, where the
port runs its kernels' plain twins.  Held:

* exactly, on limbs: ``extract_digits_signed`` against the JAX package's
  (XLA), and ``invert`` against ``invert_plain``;
* on canonical values or bytes, where the two packages take products in
  another order: ``madd_precomp``, ``invert``, ``batch_invert``,
  ``normalize_batch``, ``to_bytes_batch``, and the tile reduction against
  the XLA ``curve.tree_reduce``;
* on points, against the oracle sum (the JAX package's own reference for
  its accumulator in ``tests/test_pallas_curve.py``): the tile reduction,
  the accumulator twin at the block shapes of that test, and ``msm_auto``
  on each of its routes.

The JAX package's outputs (``jax_ref``) are read from the committed
fixture ``tests/golden/msm_ref.npz``, which ``tests/make_msm_golden.py``
writes with ``_jax_reference_main``: each function at one shape, op by op
(``jax.disable_jit``), ~75 s of one core (the XLA ``tree_reduce`` at 300
points compiled whole would alone take ~110 s), so tier-1 compiles none of
it; the ``slow`` test ``test_jax_reference_rebuilds_live`` reruns it in a
child process and compares every array.  No Pallas kernel runs here: the
live comparison with the JAX package's Pallas accumulator and tile
reduction (interpret mode, minutes of compile) is the other ``slow`` test
at the end.
"""
import functools
import hashlib
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabulletproof_tpu.ops import (curve as JC, field as JF,
                                     pippenger as JP)
from cudabulletproof_tpu_torch import config
from cudabulletproof_tpu_torch.ops import (curve as TC, field as TF,
                                           msm as TM, pippenger as TP)
from cudabulletproof_tpu_torch.utils import oracle
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

ELL = oracle.ELL
P = oracle.P
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
GOLDEN = TESTS / "golden" / "msm_ref.npz"
EDGE_SCALARS = [0, 1, 2, ELL - 1, (1 << 253) - 1]
WINDOWS = (3, 4, 5, 6, 8, 11)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _values(limbs) -> list:
    """Limb rows (torch or JAX) -> their values mod p."""
    arr = np.asarray(limbs).reshape(-1, 20)
    return [sum(int(v) << (13 * i) for i, v in enumerate(r)) % P for r in arr]


def _oracle_sum(points, scalars):
    acc = oracle.IDENTITY
    for p, k in zip(points, scalars):
        acc = acc + k * p
    return acc


def _points(label: bytes, n: int) -> list:
    return [oracle.hash_to_point(label, i) for i in range(n)]


def _ge(points) -> TC.GE:
    """list[Point] -> GE [n], also for n = 1."""
    return TC.GE(*(c.reshape(-1, 20) for c in TC.from_oracle(points)))


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    """The inputs of the JAX comparisons, the same in the test worker and
    in the child (read only)."""
    rng = random.Random(1234)
    weak = [[0x1FFF] * 20, [((P + 1) >> (13 * i)) & 0x1FFF for i in range(20)],
            [TF.BOUND] * 20, [0] * 19 + [8191]]
    inv = [rng.randrange(P) for _ in range(56)] + [0, 1, 2, P - 1]
    return {
        # the values of tests/test_pallas_curve.py::test_signed_digit_recoding
        "digits": [0, 1, ELL - 1, 2 ** 253 - 1, rng.randrange(2 ** 253)],
        # random values, 0, 1, 2, p-1 and weak forms (all limbs 8191, p + 1,
        # all limbs 8799)
        "invert": np.concatenate([TF.from_ints(inv).numpy(),
                                  np.array(weak, dtype=np.int32)]),
        "batch_invert": [rng.randrange(1, P) for _ in range(7)] + [P - 1],
        "madd": [oracle.IDENTITY, oracle.BASE] + _points(b"mp", 6),
        # Z != 1 (hash_to_point sums), the identity and an 8-torsion point
        "normalize": _points(b"mp", 6) + [oracle.IDENTITY,
                                          oracle.small_order_points()[3]],
        # two tiles of the reduction, the second identity-padded
        "reduce": _points(b"red", 300),
    }


def _jax_reference_main(dst: str) -> None:
    """The JAX package on ``_inputs()``, op by op but for the digit scans,
    saved to ``dst`` (``tests/make_msm_golden.py`` runs it)."""
    jax.config.update("jax_enable_compilation_cache", False)
    inp = _inputs()
    out = {}
    for w in WINDOWS:          # eager ops around one small scan: jit it
        out[f"digits{w}"] = np.asarray(JP.extract_digits_signed(
            JF.from_ints(inp["digits"]), w))
    with jax.disable_jit():
        out["madd"] = np.asarray(JP.madd_precomp(JC.from_oracle(inp["madd"])))
        out["invert"] = np.asarray(JF.invert(jnp.asarray(inp["invert"])))
        out["batch_invert"] = np.asarray(JF.batch_invert(
            JF.from_ints(inp["batch_invert"])))
        jp = JC.from_oracle(inp["normalize"])
        out["normalize"] = np.stack([np.asarray(c)
                                     for c in JC.normalize_batch(jp)])
        out["to_bytes"] = np.asarray(JC.to_bytes_batch(jp))
        red = JC.tree_reduce(JC.from_oracle(inp["reduce"]))
        out["reduce"] = np.concatenate([np.asarray(c) for c in red])
    np.savez(dst, **out)


def _load(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def jax_ref() -> dict:
    """The JAX package's outputs on ``_inputs()``, from the committed
    fixture."""
    return _load(GOLDEN)


@pytest.mark.slow
def test_jax_reference_rebuilds_live(tmp_path):
    """``tests/make_msm_golden.py`` rerun now, in a child process set up by
    tests/conftest.py like the JAX suite, writes the committed fixture's
    arrays exactly."""
    dst = tmp_path / "msm_ref.npz"
    out = subprocess.run([sys.executable, str(TESTS / "make_msm_golden.py"),
                          str(dst)], cwd=REPO, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    new, old = _load(dst), _load(GOLDEN)
    assert sorted(new) == sorted(old)
    for k in old:
        assert np.array_equal(new[k], old[k]), k


@pytest.mark.parametrize("w", WINDOWS)
def test_extract_digits_signed_matches_jax(jax_ref, w):
    """The digits equal the JAX package's exactly and rebuild the scalar."""
    vals = _inputs()["digits"]
    got = TP.extract_digits_signed(TF.from_ints(vals), w).numpy()
    assert np.array_equal(got, jax_ref[f"digits{w}"])
    half = 1 << (w - 1)
    assert got.min() >= -half and got.max() <= half
    for i, v in enumerate(vals):
        assert sum(int(d) << (w * j) for j, d in enumerate(got[:, i])) == v


def test_madd_precomp_matches_jax(jax_ref):
    pts = _inputs()["madd"]
    got = TP.madd_precomp(TC.from_oracle(pts))
    assert _values(got) == _values(jax_ref["madd"])
    for i, p in enumerate(pts):
        x, y = p.affine()
        assert _values(got[i]) == [(y + x) % P, (y - x) % P,
                                   oracle.D2 * x * y % P,
                                   -oracle.D2 * x * y % P]


def test_invert_matches_jax_and_plain(jax_ref):
    """The JAX package's inverse on values, the twin's on limbs, and the
    inverse times the value is 1 (0 for 0)."""
    a = torch.from_numpy(_inputs()["invert"])
    got = TF.invert(a)
    assert torch.equal(got, TF.invert_plain(a))
    assert _values(got) == _values(jax_ref["invert"])
    assert [v * x % P for v, x in zip(_values(got), _values(a))] == [
        0 if x == 0 else 1 for x in _values(a)]


def test_batch_invert_matches_jax(jax_ref):
    vals = _inputs()["batch_invert"]
    got = _values(TF.batch_invert(TF.from_ints(vals)))
    assert got == _values(jax_ref["batch_invert"])
    assert got == [pow(v, P - 2, P) for v in vals]


def test_normalize_and_compress_match_jax(jax_ref):
    """normalize_batch on values, to_bytes_batch and to_bytes on bytes,
    against the JAX package and the oracle's compression."""
    pts = _inputs()["normalize"]
    tp = TC.from_oracle(pts)
    got = TC.normalize_batch(tp)
    for c in range(4):
        assert _values(got[c]) == _values(jax_ref["normalize"][c])
    assert TC.to_oracle(TC.normalize(tp)) == pts
    raw = TC.to_bytes_batch(tp)
    assert np.array_equal(raw.numpy(), jax_ref["to_bytes"])
    assert torch.equal(TC.to_bytes(tp), raw)
    assert [bytes(r.tolist()) for r in raw] == [p.compress() for p in pts]


def test_reduce_tiles_matches_jax_tree_reduce(jax_ref):
    """300 points: the tile sum equals the XLA tree_reduce as compressed
    bytes; the twin's tiles equal the sums of their 256-point slices."""
    pts = _inputs()["reduce"]
    got = TC.tree_reduce_tiles(TC.from_oracle(pts))
    want = TC.unflatten(torch.from_numpy(jax_ref["reduce"]))
    assert torch.equal(TC.to_bytes(got), TC.to_bytes(want))
    assert TC.to_oracle(want) == [_oracle_sum(pts, [1] * 300)]
    tiles = TC.reduce_tiles_plain(TC.from_oracle(pts))
    assert TC.to_oracle(TC.unflatten(tiles)) == [
        _oracle_sum(pts[:256], [1] * 256), _oracle_sum(pts[256:], [1] * 44)]


@pytest.mark.parametrize("n", [1, 256, 1000])
def test_reduce_tiles_matches_oracle(n):
    """With the identity and 8-torsion points among the summands."""
    pts = _points(b"rd%d" % n, n)
    tor = oracle.small_order_points()
    for i in range(0, n, 97):
        pts[i] = tor[i % 8]
    got = TC.tree_reduce_tiles(_ge(pts))
    assert TC.to_oracle(got) == [_oracle_sum(pts, [1] * n)]


@pytest.mark.parametrize("n, w, threads, slices",
                         [(32, 4, 8, 2), (13, 4, 8, 2), (32, 5, 8, 2)])
def test_msm_accum_matches_oracle(rng, n, w, threads, slices):
    """The accumulator (its plain twin) at the shapes of the JAX package's
    test_pallas_bucket_accum_msm (n = 32 and 13; 16 lanes of it as 8
    threads x 2 slices), with the edge scalars."""
    pts = _points(b"pba%d" % n, n)
    sc = EDGE_SCALARS + [rng.randrange(ELL) for _ in range(n - 5)]
    got = TP.msm_accum(TC.from_oracle(pts), TF.from_ints(sc), w=w,
                       threads=threads, slices=slices)
    assert TC.to_oracle(got) == [_oracle_sum(pts, sc)]


def test_bucket_accum_twin_order_and_padding(rng):
    """Zero digits (padding) touch no bucket: the twin gives the same limbs
    with 8 zero-digit lanes appended, and ``msm._pad_pow2`` pads with zero
    digits; one slice of 32 threads and two of 16 give the same point."""
    n = 24
    pts = _points(b"pad", n)
    sc = [rng.randrange(ELL) for _ in range(n)]
    p, s = TC.from_oracle(pts), TF.from_ints(sc)
    pre, dg = TP.madd_precomp(p), TP.extract_digits_signed(s, 4)
    _, sp = TM._pad_pow2(p, s, pad_min=32)
    pdg = TP.extract_digits_signed(sp, 4)
    assert torch.equal(pdg[:, :n], dg) and pdg[:, n:].abs().max() == 0
    ppre = torch.cat([pre, torch.zeros((8, 80), dtype=torch.int32)])
    one = TP.bucket_accum(pre, dg, 4, 32, 1)
    assert torch.equal(one, TP.bucket_accum(ppre, pdg, 4, 32, 1))
    two = TP.bucket_accum(pre, dg, 4, 16, 2)
    assert TC.to_oracle(TC.unflatten(one)) == TC.to_oracle(
        TC.unflatten(two)) == [_oracle_sum(pts, sc)]


ROUTES = {
    # route: (n, MSM_LADDER_MAX, MSM_PIPPENGER_MIN, MSM_ACCUM_CHUNK)
    "ladder": (5, 1024, 4096, 1 << 16),
    "straus": (9, 4, 16, 1 << 16),
    "accum": (12, 4, 8, 1 << 16),
    "chunked": (40, 4, 8, 16),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_msm_auto_routes_match_oracle(rng, monkeypatch, route):
    n, ladder_max, pip_min, chunk = ROUTES[route]
    monkeypatch.setattr(config, "MSM_LADDER_MAX", ladder_max)
    monkeypatch.setattr(config, "MSM_PIPPENGER_MIN", pip_min)
    monkeypatch.setattr(config, "MSM_ACCUM_CHUNK", chunk)
    taken = []
    for name, mod in (("ladder", TC), ("straus", TM), ("accum", TP)):
        fn = {"ladder": "tree_reduce_tiles", "straus": "msm_windowed",
              "accum": "msm_accum"}[name]
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _name=name, **k):
            taken.append((_name, a[1].shape[0] if _name != "ladder"
                          else a[0].x.shape[0]))
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    pts = _points(b"auto", n)
    sc = [rng.randrange(ELL) for _ in range(n - 2)] + [0, ELL - 1]
    got = TM.msm_auto(TC.from_oracle(pts), TF.from_ints(sc))
    assert TC.to_oracle(got) == [_oracle_sum(pts, sc)]
    want = {"ladder": [("ladder", 5)], "straus": [("straus", 9)],
            "accum": [("accum", 12)],
            "chunked": [("accum", 16)] * 3}[route]
    assert taken == want


def _bench_inputs(n):
    """bench.py's make(): P_i = i B for i = 1..n, s_i = SHA-256("bench%d" %
    i) mod l; and (sum i s_i mod l) B, the exact result."""
    ks = [int.from_bytes(hashlib.sha256(b"bench%d" % i).digest(), "little")
          % ELL for i in range(n)]
    pts = [(i + 1) * oracle.BASE for i in range(n)]
    total = sum((i + 1) * k for i, k in enumerate(ks)) % ELL
    return pts, ks, total * oracle.BASE


def test_msm_auto_bench_inputs_exact(monkeypatch):
    """The check chip_smoke.py makes at 2^16 and 2^20, here at 48 points
    over three accumulator chunks: equal to (sum i s_i mod l) B, compared
    as compressed bytes."""
    monkeypatch.setattr(config, "MSM_LADDER_MAX", 4)
    monkeypatch.setattr(config, "MSM_PIPPENGER_MIN", 8)
    monkeypatch.setattr(config, "MSM_ACCUM_CHUNK", 16)
    pts, ks, want = _bench_inputs(48)
    got = TM.msm_auto(TC.from_oracle(pts), TF.from_ints(ks))
    assert bytes(TC.to_bytes(got).tolist()) == want.compress()


def test_accum_plan():
    """The table at the sizes the port runs, and the rule elsewhere."""
    for n, plan in config.MSM_ACCUM_PLAN.items():
        assert config.accum_plan(n) == plan
        assert 4 <= plan[0] <= 8 and plan[1] in (32, 64, 128, 256)
    assert config.accum_plan(64) == (4, 32, 1)
    w, threads, slices = config.accum_plan(1 << 16, 6)
    assert (w, threads * slices) == (6, 512)


# --- the live comparison with the Pallas kernels (slow) -----------------------
def _pallas_child(dst: str) -> None:
    """Child side of the slow test: the JAX package's accumulator and tile
    reduction in Pallas interpret mode on the inputs of the tests above,
    saved as packed point rows."""
    import random

    from cudabulletproof_tpu.ops import pallas_curve as PC
    rng = random.Random(1234)
    out = {}
    for n in (32, 13):
        pts = _points(b"pba%d" % n, n)
        sc = EDGE_SCALARS + [rng.randrange(ELL) for _ in range(n - 5)]
        r = JP.msm_accum(JC.from_oracle(pts), JF.from_ints(sc), w=4,
                         lanes=8, unroll=2)
        out[f"accum{n}"] = np.concatenate([np.asarray(c) for c in r])
        out[f"sc{n}"] = np.array([str(v) for v in sc])
    r = PC.tree_reduce(JC.from_oracle(_points(b"red", 300)))
    out["reduce300"] = np.concatenate([np.asarray(c) for c in r])
    np.savez(dst, **out)


@pytest.mark.slow
def test_twins_match_pallas_interpret(tmp_path):
    """msm_accum and the tile reduction against the JAX package's Pallas
    msm_accum (w = 4, lanes 8, unroll 2) and pallas_curve.tree_reduce in
    interpret mode, in a child process (their compiles take minutes and
    gigabytes), compared as points."""
    dst = tmp_path / "pallas.npz"
    code = ("import sys; sys.path[:0] = [%r, %r]; import conftest; "
            "import test_torch_msm as t; t._pallas_child(%r)"
            % (str(TESTS), str(REPO), str(dst)))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = np.load(dst)
    for n in (32, 13):
        pts = _points(b"pba%d" % n, n)
        sc = [int(v) for v in ref[f"sc{n}"]]
        got = TP.msm_accum(TC.from_oracle(pts), TF.from_ints(sc), w=4,
                           threads=8, slices=2)
        want = TC.unflatten(torch.from_numpy(ref[f"accum{n}"]))
        assert TC.to_oracle(got) == TC.to_oracle(want) == [
            _oracle_sum(pts, sc)]
    got = TC.tree_reduce_tiles(TC.from_oracle(_points(b"red", 300)))
    want = TC.unflatten(torch.from_numpy(ref["reduce300"]))
    assert TC.to_oracle(got) == TC.to_oracle(want)
