"""cudabulletproof_tpu_torch/ops/field.py against the JAX package.

The same inputs, made with numpy from a seed (random weak limbs plus edge
rows: every limb at the bound 8799, 0, 1, p-1, p..p+2, 2^255-1 and every limb
at 8191), go through the port and through ``cudabulletproof_tpu.ops.field``
(the XLA path) and ``ops/pallas_field.py`` (the Pallas kernels, in interpret
mode on the CPU).  Tolerance zero: integer arithmetic, so limbs must be
equal where the op order is mirrored, and canonical bytes elsewhere.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabulletproof_tpu.ops import field as JF, pallas_field as PF
from cudabulletproof_tpu.utils import oracle
from cudabulletproof_tpu_torch.ops import cuda_field, field as TF
from cudabulletproof_tpu_torch.utils import build
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

P = TF.P


def _raw(v: int) -> list:
    return [(v >> (13 * i)) & 0x1FFF for i in range(20)]


EDGES = [[TF.BOUND] * 20, _raw(0), _raw(1), _raw(P - 1), _raw(P),
         _raw(P + 1), _raw(P + 2), _raw((1 << 255) - 1), [0x1FFF] * 20]


@pytest.fixture(scope="module", autouse=True)
def fe():
    torch.set_num_threads(1)
    rng = np.random.default_rng(20261016)
    rand = rng.integers(0, TF.BOUND + 1, size=(2, 7, 20), dtype=np.int32)
    edges = np.array(EDGES, dtype=np.int32)
    a = np.concatenate([rand[0], edges])
    b = np.concatenate([rand[1], edges[::-1]])
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.ascontiguousarray(x))


def _value(limbs) -> list:
    return [v % P for v in TF.to_ints(_t(np.asarray(limbs)))]


def test_constants_match_jax():
    assert (TF.L, TF.W, TF.MASK, TF.P, TF.FOLD, TF.BOUND) == (
        JF.L, JF.W, JF.MASK, JF.P, JF.FOLD, JF.BOUND)
    assert np.array_equal(TF._K_NEG, JF._K_NEG)


def test_mul_sq_match_xla_and_pallas(fe):
    """mul/sq twins = F.mul_xla and the Pallas _mul/_sq kernels, limb for
    limb, and the oracle mod p."""
    a, b = fe
    got_mul = TF.mul(_t(a), _t(b)).numpy()
    got_sq = TF.sq(_t(a)).numpy()
    assert np.array_equal(got_mul, np.asarray(JF.mul_xla(_j(a), _j(b))))
    assert np.array_equal(got_mul, np.asarray(PF.mul(_j(a), _j(b))))
    assert np.array_equal(got_sq, np.asarray(JF.mul_xla(_j(a), _j(a))))
    assert np.array_equal(got_sq, np.asarray(PF.sq(_j(a))))
    assert int(got_mul.max()) <= TF.BOUND and int(got_sq.max()) <= TF.BOUND
    assert _value(got_mul) == [x * y % P for x, y in
                               zip(_value(a), _value(b))]


def test_mul_broadcasts_a_constant(fe):
    a, _ = fe
    d = TF.from_int(oracle.D)
    got = TF.mul(d, _t(a)).numpy()
    assert np.array_equal(got, np.asarray(JF.mul_xla(JF.from_int(oracle.D),
                                                     _j(a))))


def test_pow2523_matches_pallas_and_xla(fe):
    """The Pallas _pow2523_kernel in interpret mode (15 s here) and the XLA
    chain give the same limbs as the twin."""
    a, _ = fe
    got = TF.pow2523(_t(a)).numpy()
    assert np.array_equal(got, np.asarray(PF.pow2523(_j(a))))
    assert np.array_equal(got, np.asarray(JF.pow2523(_j(a))))
    assert _value(got) == [pow(x, (P - 5) // 8, P) for x in _value(a)]


def test_invert_cpu_matches_xla(fe):
    a, _ = fe
    a = a[:7]                                   # nonzero random rows
    got = TF.invert(_t(a)).numpy()
    assert np.array_equal(got, np.asarray(JF.invert(_j(a))))
    assert _value(got) == [pow(x, P - 2, P) for x in _value(a)]


def test_add_sub_neg_mul_small_match_jax(fe):
    a, b = fe
    ta, tb = _t(a), _t(b)
    ja, jb = _j(a), _j(b)
    assert np.array_equal(TF.add(ta, tb).numpy(), np.asarray(JF.add(ja, jb)))
    assert np.array_equal(TF.sub(ta, tb).numpy(), np.asarray(JF.sub(ja, jb)))
    assert np.array_equal(TF.neg(tb).numpy(), np.asarray(JF.neg(jb)))
    assert np.array_equal(TF.mul_small(ta, 121666).numpy(),
                          np.asarray(JF.mul_small(ja, 121666)))
    with pytest.raises(ValueError):
        TF.mul_small(ta, 1 << 17)
    swap = np.array([i % 2 for i in range(len(a))], dtype=np.int32)
    x, y = TF.cswap(_t(swap), ta, tb)
    jx, jy = JF.cswap(_j(swap), ja, jb)
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert np.array_equal(y.numpy(), np.asarray(jy))


# every value p .. 2^255 - 1 (limbs not reduced mod p)
ADD_EDGES = [[TF.BOUND] * 20, [0x1FFF] * 20, _raw(0), _raw(P - 1)] + [
    _raw(v) for v in range(P, 1 << 255)]


@pytest.mark.parametrize("n", [1, 255, 257, 300, 10_000])
def test_add3_sub3_twins_match_pallas(n):
    """add3_plain / sub3_plain (the twins of the fe_add / fe_sub kernels)
    equal the Pallas ``_add_kernel`` / ``_sub_kernel`` (``PF.add`` /
    ``PF.sub``, interpret mode) limb for limb, at sizes that are not
    multiples of its 256-lane tile, on random weak limbs with the edge rows
    (all limbs 8799 or 8191, 0, p-1, p..2^255-1) among them; the values are
    a + b and a - b mod p, and ``add3`` / ``sub3`` take the twins on the
    CPU."""
    rng = np.random.default_rng(n)
    edges = np.array(ADD_EDGES, dtype=np.int32)
    a = rng.integers(0, TF.BOUND + 1, size=(n, 20), dtype=np.int32)
    b = rng.integers(0, TF.BOUND + 1, size=(n, 20), dtype=np.int32)
    k = min(n, len(edges))
    a[rng.choice(n, k, replace=False)] = edges[:k]
    b[rng.choice(n, k, replace=False)] = edges[::-1][:k]
    got_add = TF.add3_plain(_t(a), _t(b)).numpy()
    got_sub = TF.sub3_plain(_t(a), _t(b)).numpy()
    assert np.array_equal(got_add, np.asarray(PF.add(_j(a), _j(b))))
    assert np.array_equal(got_sub, np.asarray(PF.sub(_j(a), _j(b))))
    assert np.array_equal(TF.add3(_t(a), _t(b)).numpy(), got_add)
    assert np.array_equal(TF.sub3(_t(a), _t(b)).numpy(), got_sub)
    va, vb = _value(a), _value(b)
    assert _value(got_add) == [(x + y) % P for x, y in zip(va, vb)]
    assert _value(got_sub) == [(x - y) % P for x, y in zip(va, vb)]
    assert int(got_add.min()) >= 0 and int(got_sub.min()) >= 0


def test_add3_sub3_dispatch(fe):
    """On a tensor that is not on the CPU (``meta`` stands in for CUDA)
    ``add3`` / ``sub3`` go to the kernel wrappers, which refuse it; the
    plain ``add`` / ``sub`` (two relax passes) launch nothing on any
    device; the wrappers refuse CPU tensors."""
    a, b = fe
    meta = torch.empty((3, 20), dtype=torch.int32, device="meta")
    before = dict(cuda_field.launches)
    assert TF.add(meta, meta).shape == TF.sub(meta, meta).shape == (3, 20)
    for fn in (TF.add3, TF.sub3):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            fn(meta, meta)
    for fn in (cuda_field.add, cuda_field.sub):
        with pytest.raises(ValueError):
            fn(_t(a), _t(b))
    assert cuda_field.launches == before
    # add3 is not add: three relax passes against two, the same value
    two, three = TF.add(_t(a), _t(b)), TF.add3(_t(a), _t(b))
    assert torch.equal(three, TF._relax(two, 1))
    assert _value(two.numpy()) == _value(three.numpy())


def test_canonical_bytes_predicates_match_jax(fe):
    a, b = fe
    ta, ja = _t(a), _j(a)
    assert np.array_equal(TF.canonical(ta).numpy(),
                          np.asarray(JF.canonical(ja)))
    enc = TF.to_bytes(ta)
    assert np.array_equal(enc.numpy(), np.asarray(JF.to_bytes(ja)))
    assert [bytes(r) for r in enc.numpy()] == [
        v.to_bytes(32, "little") for v in _value(a)]
    raw = np.random.default_rng(7).integers(0, 256, (5, 32), dtype=np.uint8)
    assert np.array_equal(TF.from_bytes(_t(raw)).numpy(),
                          np.asarray(JF.from_bytes(_j(raw))))
    assert np.array_equal(TF.eq(ta, _t(b)).numpy(),
                          np.asarray(JF.eq(ja, _j(b))))
    assert np.array_equal(TF.is_zero(ta).numpy(), np.asarray(JF.is_zero(ja)))
    assert TF.is_zero(ta).tolist() == [v == 0 for v in _value(a)]


def test_host_conversion():
    xs = [0, 1, P - 1, P + 5, 1 << 254]
    assert TF.to_ints(TF.from_ints(xs)) == [x % P for x in xs]
    assert np.array_equal(TF.from_ints(xs).numpy(),
                          np.asarray(JF.from_ints(xs)))
    assert TF.from_int(7, (3,)).shape == (3, 20)


def test_dispatch_cpu_uses_twin_and_no_launch(fe):
    """A CPU tensor takes the plain twin (no launch is counted); the kernel
    wrappers refuse anything but CUDA int32 [..., 20]."""
    a, b = fe
    before = dict(cuda_field.launches)
    TF.mul(_t(a), _t(b))
    TF.sq(_t(a))
    assert cuda_field.launches == before
    with pytest.raises(ValueError):
        cuda_field.mul(_t(a), _t(b))                  # CPU tensors
    with pytest.raises(ValueError):
        cuda_field.sq(torch.empty((3, 20), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        TF.pow2523(torch.empty((3, 20), dtype=torch.int32, device="meta"))


def test_build_plan():
    """The kernel library is built from the package's csrc/*.cu for sm_90a
    and bound with pointer-sized ctypes arguments."""
    import ctypes
    names = sorted(p.name for p in build.sources())
    assert names == ["accum_kernels.cu", "curve_kernels.cu", "field_kernels.cu",
                     "radix16_kernels.cu", "scan_kernels.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path().parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "cudabulletproof_tpu_torch")
    for name, argtypes in build.SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name           # the stream
        assert ctypes.c_int64 in argtypes, name               # the count
    src = "\n".join(p.read_text() for p in build.sources())
    for name in build.SIGNATURES:
        assert re.search(rf'extern "C" int {name}\(', src), name


def test_header_constants_match_oracle():
    """fe25519.cuh's 2d limbs and K limbs are the ones the twins use."""
    hdr = (build.CSRC / "fe25519.cuh").read_text()
    body = re.search(r"fe_d2\(\) \{\s*return fe\{\{([^}]*)\}\};", hdr).group(1)
    assert [int(v) for v in body.split(",")] == _raw(oracle.D2)
    assert "FE_KNEG0 = 2 * FE_MASK - 1214" in hdr
    assert int(TF._K_NEG[0]) == 2 * 0x1FFF - 1214
