"""The port's radix-2^16 field (``cudabulletproof_tpu_torch/ops/radix16.py``)
and the radix-13 multiply chain (``field.mul_chain``) against the JAX
package: ``cudabulletproof_tpu/ops/radix16.py`` (its Pallas kernels in
interpret mode, as ``tests/test_radix16.py`` runs them on the CPU) and
``benchmarks/bench_radix16.py::chain13``; and the port's
``benchmarks/bench_radix16.py`` on the CPU.

The same inputs, made with numpy from a seed, go through both packages.
Tolerance zero: the limbs must be equal, not only the values mod p, which
are also held against Python integers.  The edge rows drive the int32
bounds: every limb at 2^16 + 38 (the weak bound) or 0xFFFF, 0, 1, p - 1.
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_radix16 as JB
from cudabulletproof_tpu.ops import field as JF, radix16 as JR
from cudabulletproof_tpu_torch.benchmarks import bench_radix16 as TB
from cudabulletproof_tpu_torch.ops import (cuda_field, cuda_radix16,
                                           field as TF, radix16 as TR)
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

P = TR.P_INT
VALS = [0, 1, 19, (1 << 255) - 20, (1 << 255) - 19 - 1, 1 << 200,
        0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF,
        P - 1, (P + 5) % P, 2**252 + 27742317777372353535851937790883648493]
EDGES = np.array([TR.from_int(0), TR.from_int(1), TR.from_int(P - 1),
                  [TR.BOUND16] * 16, [TR.MASK16] * 16], dtype=np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _value(row, width: int = 16) -> int:
    return sum(int(c) << (width * i) for i, c in enumerate(row)) % P


def _operands(seed: int, n: int):
    """Random weak limbs [n, 16] in [0, 2^16 + 38], the edge rows at random
    places of a and, reversed, of b."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, TR.BOUND16 + 1, size=(n, 16), dtype=np.int32)
    b = rng.integers(0, TR.BOUND16 + 1, size=(n, 16), dtype=np.int32)
    k = min(n, len(EDGES))
    a[rng.choice(n, k, replace=False)] = EDGES[:k]
    b[rng.choice(n, k, replace=False)] = EDGES[::-1][:k]
    return a, b


def _edge_pairs():
    """Every edge row against every edge row."""
    k = len(EDGES)
    return np.repeat(EDGES, k, axis=0), np.tile(EDGES, (k, 1))


def test_int_conversions():
    """to_int / from_int equal the JAX package's on VALS, and round trip."""
    for v in VALS:
        limbs = TR.from_int(v)
        assert np.array_equal(limbs, JR.from_int(v))
        assert TR.to_int(limbs) == JR.to_int(limbs) == v % P
        assert TR.to_int(torch.from_numpy(limbs)) == v % P


@pytest.mark.parametrize("case", ["vals", "vals+600", "random"])
def test_from_radix13_matches_jax(case):
    """VALS' radix-13 limbs, the same with +600 on every limb (weak-normal
    input above 2^255), and 256 seeded rows of limbs in [0, 8799]."""
    if case == "random":
        a13 = np.random.default_rng(13).integers(
            0, TF.BOUND + 1, size=(256, 20), dtype=np.int32)
        a13[0] = TF.BOUND                  # every limb at the weak bound
    else:
        a13 = np.asarray(JF.from_ints(VALS)) + (600 if case != "vals" else 0)
    got = TR.from_radix13(torch.from_numpy(a13)).numpy()
    assert np.array_equal(got, np.asarray(JR.from_radix13(jnp.asarray(a13))))
    for row, src in zip(got, a13):
        assert _value(row) == _value(src, 13)
        assert 0 <= row.min() and row.max() <= TR.BOUND16


@pytest.mark.parametrize("n", [1, 8, 300, "edge pairs"])
def test_mul_sq_match_jax(n):
    """mul and sq equal ``radix16.mul`` / ``sq`` limb for limb (random weak
    limbs with the edge rows, and every pair of edge rows), the values equal
    Python-int products, the limbs stay weak."""
    a, b = _edge_pairs() if n == "edge pairs" else _operands(n, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    m, s = TR.mul(ta, tb).numpy(), TR.sq(ta).numpy()
    assert np.array_equal(m, np.asarray(JR.mul(jnp.asarray(a),
                                               jnp.asarray(b))))
    assert np.array_equal(s, np.asarray(JR.sq(jnp.asarray(a))))
    for k in range(len(a)):
        va, vb = _value(a[k]), _value(b[k])
        assert TR.to_int(m[k]) == va * vb % P
        assert TR.to_int(s[k]) == va * va % P
    assert 0 <= min(m.min(), s.min()) and max(m.max(), s.max()) <= TR.BOUND16


@pytest.mark.parametrize("reps", [0, 1, 2, 5])
def test_mul_chain_matches_jax(reps):
    """mul_chain equals ``radix16.mul_chain`` limb for limb at 40 rows (the
    edge rows among them; reps = 0 gives a) and Python ints."""
    a, b = _operands(100 + reps, 40)
    got = TR.mul_chain(torch.from_numpy(a), torch.from_numpy(b), reps)
    want = np.asarray(JR.mul_chain(jnp.asarray(a), jnp.asarray(b),
                                   reps=reps))
    assert np.array_equal(got.numpy(), want)
    if reps == 0:
        assert np.array_equal(got.numpy(), a)
    for k in range(len(a)):
        assert TR.to_int(got[k]) == _value(a[k]) * pow(_value(b[k]), reps,
                                                       P) % P


@pytest.mark.parametrize("reps", [1, 3])
def test_radix13_chain_matches_jax(reps):
    """field.mul_chain (the twin on the CPU) equals the JAX script's
    ``chain13`` limb for limb at n = 300, every limb 8799 in one row."""
    rng = np.random.default_rng(reps)
    a = rng.integers(0, TF.BOUND + 1, size=(300, 20), dtype=np.int32)
    b = rng.integers(0, TF.BOUND + 1, size=(300, 20), dtype=np.int32)
    a[0] = b[1] = TF.BOUND
    got = TF.mul_chain(torch.from_numpy(a), torch.from_numpy(b), reps)
    assert torch.equal(got, TF.mul_chain_plain(torch.from_numpy(a),
                                               torch.from_numpy(b), reps))
    want = jax.jit(JB.chain13, static_argnames="reps")(
        jnp.asarray(a), jnp.asarray(b), reps)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_dispatch_and_refusals():
    """A tensor that is not on the CPU (``meta`` stands in for CUDA) goes to
    the kernel wrappers, which refuse it, and no launch is counted; the
    wrappers refuse CPU tensors."""
    meta = torch.empty((2, 16), dtype=torch.int32, device="meta")
    meta13 = torch.empty((2, 20), dtype=torch.int32, device="meta")
    before = (dict(cuda_radix16.launches), dict(cuda_field.launches))
    for call in (lambda: TR.mul(meta, meta), lambda: TR.sq(meta),
                 lambda: TR.mul_chain(meta, meta, 2),
                 lambda: TF.mul_chain(meta13, meta13, 2)):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            call()
    cpu = torch.zeros((2, 16), dtype=torch.int32)
    cpu13 = torch.zeros((2, 20), dtype=torch.int32)
    for call in (lambda: cuda_radix16.mul(cpu, cpu),
                 lambda: cuda_radix16.mul_chain(cpu, cpu, 1),
                 lambda: cuda_field.mul_chain(cpu13, cpu13, 1)):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            call()
    assert (cuda_radix16.launches, cuda_field.launches) == before


def _run_bench(argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert TB.main(argv) == 0
    return buf.getvalue().splitlines()


def test_bench_radix16_lines(monkeypatch):
    """The port's bench_radix16 under BP_PLATFORM=cpu at n = 64, reps = 2:
    the JAX script's three lines, the correctness line first."""
    monkeypatch.setenv("BP_PLATFORM", "cpu")
    lines = _run_bench(["64", "2"])
    assert len(lines) == 3
    assert lines[0] == ("correctness ok (chained muls vs oracle); n=64 "
                        "reps=2 backend=cpu")
    assert lines[1].startswith("radix13 20-limb mul: ")
    assert lines[1].endswith(" G mul/s")
    assert lines[2].startswith("radix16 16-limb mul: ")
    assert lines[2].endswith("x radix13)")


@pytest.mark.parametrize("side", ["radix16", "radix13"])
def test_bench_radix16_gate_refuses_wrong_chain(monkeypatch, side):
    """A twin patched to be wrong fails the correctness gate before any
    timing line is printed."""
    monkeypatch.setenv("BP_PLATFORM", "cpu")
    mod = TR if side == "radix16" else TF
    real = mod.mul_chain_plain
    monkeypatch.setattr(mod, "mul_chain_plain",
                        lambda a, b, reps: real(a, b, reps + 1))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(AssertionError, match=f"{side} chain wrong"):
        TB.main(["16", "1"])
    assert buf.getvalue() == ""
