"""cudabulletproof_tpu_torch/ops/curve.py against the JAX package.

Points come from ``oracle.hash_to_point`` and the 8-torsion subgroup,
scalars from numpy with a seed.  The port's plain twins are held limb for
limb against ``cudabulletproof_tpu/ops/pallas_curve.py`` in interpret mode
(``_padd``, ``_pdbl``) and against the XLA curve path (``add_xla``,
``tree_reduce``, ``from_bytes``), the ladder on its points against the XLA
ladder and the python-int oracle; the JAX package's CPU
``double`` is ``add_xla(p, p)``, whose limbs differ from the dedicated
doubling, so ``double`` is compared on the points (python-int oracle).
Tolerance zero.

The add, the doubling and the tree reduction read the JAX outputs from the
committed fixture ``tests/golden/curve_field.npz``
(``tests/make_curve_field_golden.py``; their Pallas-interpret and XLA
compiles cost 12-16 s each on a cold cache), as does
``test_torch_field.py``'s ``pow2523``; ``test_fixture_rebuilds_live``
(``slow``) rebuilds it and compares every array.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabulletproof_tpu.ops import (curve as JC, field as JF,
                                     pallas_curve as PC)
from cudabulletproof_tpu.utils import oracle
from cudabulletproof_tpu_torch.ops import cuda_curve, curve as TC, field as TF
import make_curve_field_golden as golden
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

ELL = oracle.ELL


def _points():
    """(gens, others, scalars): the inputs of these tests (and of the
    fixture's add, doubling and tree reduction)."""
    rng = np.random.default_rng(4242)
    gens = [oracle.hash_to_point(b"pca", i) for i in range(8)]
    others = [oracle.hash_to_point(b"pcb", i) for i in range(8)]
    scalars = [1, ELL - 1] + [int.from_bytes(rng.bytes(32), "little") % ELL
                              for _ in range(2)]
    return gens, others, scalars


@pytest.fixture(scope="module", autouse=True)
def pts():
    torch.set_num_threads(1)
    return _points()


@pytest.fixture(scope="module")
def ref() -> dict:
    with np.load(golden.GOLDEN) as f:
        return {k: f[k] for k in f.files}


def _t(g) -> TC.GE:
    return TC.GE(*(torch.from_numpy(np.array(c)) for c in g))


def _np(g):
    return np.stack([np.asarray(c) for c in g])


def test_add_matches_pallas_and_xla(pts, ref):
    """The twin against ``pallas_curve.add`` (interpret mode) and
    ``add_xla``, limb for limb (fixture), and the oracle."""
    gens, others, _ = pts
    tp, tq = TC.from_oracle(gens), TC.from_oracle(others)
    got = _np(TC.add(tp, tq))
    assert np.array_equal(got, ref["add_pallas"])
    assert np.array_equal(got, ref["add_xla"])
    assert TC.to_oracle(TC.add(tp, tq)) == [
        p + q for p, q in zip(gens, others)]


def test_double_matches_pallas_and_oracle(pts, ref):
    """The dedicated doubling against ``pallas_curve.double`` limb for limb
    (fixture) and the JAX CPU ``double`` and the oracle on the points."""
    gens, _, _ = pts
    got = TC.double(TC.from_oracle(gens[:4]))
    assert np.array_equal(_np(got), ref["double_pallas"])
    # the JAX CPU double is add_xla(p, p): the same points, other limbs
    assert TC.to_oracle(got) == TC.to_oracle(_t(ref["double_xla"])) == [
        p.double() for p in gens[:4]]


def test_small_order_on_torsion(pts):
    gens, _, _ = pts
    tor = oracle.small_order_points()
    mixed = [g + t for g, t in zip(gens, tor)]
    for group, want in ((tor, [True] * 8), (gens, [False] * 8),
                        (mixed, [False] * 8)):
        jp = JC.from_oracle(group)
        got = TC.is_small_order(_t(jp))
        assert got.tolist() == want
        assert got.tolist() == np.asarray(JC.is_small_order(jp)).tolist()
    m8 = TC.mul8(_t(JC.from_oracle(tor)))
    assert TC.is_identity(m8).tolist() == [True] * 8
    assert TC.to_oracle(TC.mul8(_t(JC.from_oracle(gens[:2])))) == [
        8 * g for g in gens[:2]]


def test_ladder_matches_xla_ladder_and_oracle(pts):
    """The w=4 twin vs the XLA ladder (curve.scalarmult) and the oracle, on
    the points.  The Pallas _ladder_win_kernel in interpret mode costs 80 s
    to compile on one core here, so its limb-for-limb check is left to its
    parts: _padd and _pdbl (the tests above, limb for limb) and the window
    digits (the next test)."""
    gens, _, scalars = pts
    jp = JC.from_oracle(gens[:4])
    js = JF.from_ints(scalars)
    got = TC.scalarmult(_t(jp), torch.from_numpy(np.array(js)))
    assert TC.to_oracle(got) == JC.to_oracle(JC.scalarmult(jp, js)) == [
        s * p for s, p in zip(scalars, gens)]


def test_ladder_edge_scalars_and_digits(pts):
    """Scalars 0, 1, 2, l-1 and all limbs 8191 (every digit 15); the digit
    reader equals the TPU kernel's shift-register digits."""
    gens, _, _ = pts
    vals = [0, 1, 2, ELL - 1]
    s = TF.from_ints(vals)
    got = TC.scalarmult(TC.from_oracle(gens[:4]), s)
    assert TC.to_oracle(got) == [v * p for v, p in zip(vals, gens)]
    full = torch.full((1, 20), 0x1FFF, dtype=torch.int32)
    assert TC.ladder_digits(full).tolist() == [[15] * 65]
    rng = np.random.default_rng(99)
    limbs = rng.integers(0, 1 << 13, size=(6, 20), dtype=np.int32)
    for row, digs in zip(limbs, TC.ladder_digits(torch.from_numpy(limbs))):
        v = sum(int(x) << (13 * i) for i, x in enumerate(row))
        assert digs.tolist() == [(v >> (256 - 4 * w)) & 15 for w in range(65)]


def test_broadcast_scalarmult(pts):
    gens, _, scalars = pts
    p = TC.from_oracle(gens[:1])                       # one unbatched point
    got = TC.scalarmult(p, TF.from_ints(scalars))
    assert TC.to_oracle(got) == [s * gens[0] for s in scalars]


def test_tree_reduce_matches_xla(pts, ref):
    """13 points (identity-padded to 16): limbs equal to the JAX XLA tree
    (fixture)."""
    gens, others, _ = pts
    group = gens + others[:5]
    got = TC.tree_reduce(TC.from_oracle(group))
    assert np.array_equal(_np(got), ref["tree_reduce"])
    want = oracle.IDENTITY
    for p in group:
        want = want + p
    assert TC.to_oracle(got) == [want]


def test_from_bytes_matches_jax(pts):
    """Valid encodings, a y with no square root, y >= p (non-canonical),
    and x = 0 with the sign bit set: the mask is bit-exact and the points
    limb-equal to the JAX decompression."""
    gens, _, _ = pts
    tor = oracle.small_order_points()
    encs = [p.compress() for p in gens[:3] + tor[:3]]
    bad_y = next(y for y in range(2, 100)
                 if oracle.decompress(y.to_bytes(32, "little")) is None)
    encs += [bad_y.to_bytes(32, "little"),
             (oracle.P + 1).to_bytes(32, "little"),             # y = 1 + p
             ((1 << 255) - 1).to_bytes(32, "little"),
             (1 | (1 << 255)).to_bytes(32, "little")]           # x = 0, sign
    raw = np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32)
    got, valid = TC.from_bytes(torch.from_numpy(raw.copy()))
    jgot, jvalid = JC.from_bytes(jnp.asarray(raw))
    assert valid.tolist() == np.asarray(jvalid).tolist()
    assert valid.tolist() == [oracle.decompress(e) is not None for e in encs]
    assert np.array_equal(_np(got), _np(jgot))
    assert TC.to_oracle(TC.GE(*(c[:6] for c in got))) == gens[:3] + tor[:3]


def test_dispatch_refuses_non_cuda(pts):
    gens, _, _ = pts
    p = TC.from_oracle(gens[:2])
    before = dict(cuda_curve.launches)
    TC.add(p, p)
    TC.double(p)
    assert cuda_curve.launches == before
    with pytest.raises(ValueError):
        cuda_curve.add(p, p)
    with pytest.raises(ValueError):
        cuda_curve.double(p)
    with pytest.raises(ValueError):
        cuda_curve.ladder(p, TF.from_ints([1, 2]))
    with pytest.raises(ValueError):
        cuda_curve.reduce_tiles(p)


@pytest.mark.slow
def test_fixture_rebuilds_live(tmp_path):
    """``tests/make_curve_field_golden.py`` rerun now, in a child process
    set up by tests/conftest.py, writes the committed fixture's arrays
    exactly."""
    import subprocess
    import sys
    dst = tmp_path / "curve_field.npz"
    out = subprocess.run([sys.executable, golden.__file__, str(dst)],
                         cwd=golden.TESTS.parent, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(dst) as new, np.load(golden.GOLDEN) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            assert np.array_equal(new[k], old[k]), k
