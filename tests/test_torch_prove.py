"""The port's prover (``models/fused.py``: ``prove``, ``_prove``, the IPA
rounds, ``_msm_compressed``) and its binary ladder against the JAX package.

Held live against the JAX package, exactly: ``scalar_field.inner`` on limbs,
``_ipa_masks`` / ``_ipa_scan_tables`` array for array, and the binary ladder
twin (``curve.scalarmult_bin_plain``) on points against the python-int
oracle, edge scalars included.

The whole blob is held against fixtures: ``tests/golden/prove_n<n>.npz``
holds the JAX package's ``fused._prove_fn(n)`` blob on fixed inputs
(``gp``, ``aL_bits``, ``scp``), written by ``tests/make_prove_golden.py``.
Running that program here costs minutes of XLA:CPU compile (its ladder is
the Pallas kernel in interpret mode), so tier-1 reads the fixture and holds
the port's ``_prove`` on the same inputs to it byte for byte (no tolerance)
at n = 4 under both ladders and n = 8 under the window ladder.  The
``slow`` tests rebuild the n = 4 and 8 fixtures live from the JAX package,
hold n = 8 under the binary ladder and n = 64 under both, and hold the
binary twin limb for limb against the Pallas ``_ladder_kernel`` in
interpret mode.

Proofs from ``prove`` with fresh randomness are accepted by the native
verifier and the port's ``fused.verify``; tampered copies are rejected.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import make_prove_golden as golden
from cudabulletproof_tpu.models import fused as JFU
from cudabulletproof_tpu.ops import scalar_field as JS
from cudabulletproof_tpu_torch import config
from cudabulletproof_tpu_torch.models import fused as TFU
from cudabulletproof_tpu_torch.models import generators as TG
from cudabulletproof_tpu_torch.models.rangeproof import ProveError
from cudabulletproof_tpu_torch.ops import (cuda_curve, curve as TC,
                                           field as TF, scalar_field as TS)
from cudabulletproof_tpu_torch.utils import native, oracle
from cudabulletproof_tpu_torch.utils.serialization import \
    serialize_range_proof
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

ELL = oracle.ELL
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
EDGE_SCALARS = [0, 1, 2, ELL - 1, (1 << 253) - 1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _golden(n: int) -> dict:
    with np.load(golden.golden_path(n)) as f:
        return {k: f[k] for k in f.files}


def _mul_exact(p, s: int):
    """s P without reducing s mod l (``Point.__mul__`` reduces, which is
    wrong for points outside the prime-order subgroup)."""
    acc = oracle.IDENTITY
    for bit in bin(s)[2:]:
        acc = acc.double()
        if bit == "1":
            acc = acc + p
    return acc


def _tampered(proof):
    return dataclasses.replace(proof, t_hat=(proof.t_hat + 1) % ELL)


# --- modules of the slice, live against the JAX package ----------------------
def test_inner_matches_jax():
    rng = np.random.default_rng(5)
    for shape in ((9,), (4, 3)):
        a = rng.integers(0, JS.WEAK + 1, size=shape + (TS.SL,), dtype=np.int32)
        b = rng.integers(0, JS.WEAK + 1, size=shape + (TS.SL,), dtype=np.int32)
        got = TS.inner(torch.from_numpy(a), torch.from_numpy(b))
        assert np.array_equal(got.numpy(), np.asarray(JS.inner(a, b)))
    ints = [ELL - 1, 2, 3 << 250]
    got = TS.inner(TS.from_ints(ints), TS.from_ints([5, ELL - 1, 7]))
    assert TS.to_ints(TS.canonical(got)) == [
        ((ELL - 1) * 5 + 2 * (ELL - 1) + (3 << 250) * 7) % ELL]


@pytest.mark.parametrize("n", [2, 4, 8, 64])
def test_ipa_tables_match_jax(n):
    got, want = TFU._ipa_masks(n), JFU._ipa_masks(n)
    assert len(got) == len(want) == n.bit_length() - 1
    for g_round, w_round in zip(got, want):
        assert g_round[0] == w_round[0]
        for g, w in zip(g_round[1:], w_round[1:]):
            assert np.array_equal(g, w) and g.dtype == w.dtype
    tabs, jtabs = TFU._ipa_scan_tables(n), JFU._ipa_scan_tables(n)
    assert tabs.keys() == jtabs.keys()
    for key, v in tabs.items():
        assert np.array_equal(v, np.asarray(jtabs[key])), key
    assert TFU._ipa_scan_tables(1) is JFU._ipa_scan_tables(1) is None


def test_bin_ladder_twin_matches_oracle(monkeypatch):
    """The binary twin on hash points with the edge scalars (0, 1, 2, l-1,
    2^253-1) and random ones, through ``curve.scalarmult`` with the knob at
    0; the 8-torsion points and the identity times the same scalars."""
    rng = np.random.default_rng(17)
    vals = EDGE_SCALARS + [int.from_bytes(rng.bytes(32), "little") % ELL
                           for _ in range(2)]
    pts = [oracle.hash_to_point(b"bin", i) for i in range(len(vals))]
    monkeypatch.setattr(config, "LADDER_WINDOW", 0)
    got = TC.scalarmult(TC.from_oracle(pts), TF.from_ints(vals))
    assert TC.to_oracle(got) == [s * p for s, p in zip(vals, pts)]
    tor = [oracle.IDENTITY] + oracle.small_order_points()[:4]
    got = TC.scalarmult_bin_plain(TC.from_oracle(tor),
                                  TF.from_ints(EDGE_SCALARS))
    assert TC.to_oracle(got) == [_mul_exact(p, s)
                                 for s, p in zip(EDGE_SCALARS, tor)]
    full = torch.full((1, 20), 0x1FFF, dtype=torch.int32)     # 2^260 - 1
    got = TC.scalarmult_bin_plain(TC.from_oracle(pts[:1]), full)
    assert TC.to_oracle(got) == [((1 << 260) - 1) * pts[0]]


def test_ladder_knob(monkeypatch):
    """Both ladders give the same points; any other knob value raises."""
    pts = TC.from_oracle([oracle.hash_to_point(b"knob", i) for i in range(3)])
    s = TF.from_ints([3, ELL - 2, 1 << 200])
    outs = []
    for window in (4, 0):
        monkeypatch.setattr(config, "LADDER_WINDOW", window)
        outs.append(TC.to_oracle(TC.scalarmult(pts, s)))
    assert outs[0] == outs[1]
    for bad in (1, 8, None):
        monkeypatch.setattr(config, "LADDER_WINDOW", bad)
        with pytest.raises(ValueError, match="LADDER_WINDOW"):
            TC.scalarmult(pts, s)


# --- the whole blob against the JAX package's fixtures -----------------------
@pytest.mark.parametrize("n, window", [(4, 4), (4, 0), (8, 4)] + [
    pytest.param(n, w, marks=pytest.mark.slow)
    for n, w in ((8, 0), (64, 4), (64, 0))])
def test_prove_blob_matches_jax_fixture(monkeypatch, n, window):
    """The port's ``_prove`` on the fixture's (gp, aL_bits, scp) writes the
    JAX package's blob byte for byte; the fixture's generators are the
    port's own, and its proof is accepted by the native verifier."""
    ref = _golden(n)
    gp = torch.from_numpy(ref["gp"])
    assert torch.equal(gp, TG.get_generators(n, device="cpu").table)
    monkeypatch.setattr(config, "LADDER_WINDOW", window)
    blob = TFU._prove(gp, torch.from_numpy(ref["aL_bits"]),
                      torch.from_numpy(ref["scp"]), n)
    assert blob.dtype == torch.uint8 and blob.shape == ref["blob"].shape
    assert np.array_equal(blob.numpy(), ref["blob"])
    assert native.verify_range(serialize_range_proof(
        TFU._blob_proof(ref["blob"], n)))


# --- the entry point ---------------------------------------------------------
@pytest.mark.parametrize("n", [4, 8])
def test_prove_accepted_by_native_and_port(n):
    """A proof with fresh randomness is accepted by the native verifier and
    the port's verify on the CPU; t_hat + 1 is rejected by both."""
    gens = TG.get_generators(n, device="cpu")
    value = (1 << n) - 2
    proof = TFU.prove(value, 0xC0FFEE + n, n, gens)
    assert (proof.n, proof.ip.n, len(proof.ip.L)) == (n, n, n.bit_length() - 1)
    assert native.verify_range(serialize_range_proof(proof))
    assert TFU.verify(proof, gens)
    bad = _tampered(proof)
    assert not native.verify_range(serialize_range_proof(bad))
    assert not TFU.verify(bad, gens)


def test_prove_refuses_bad_input():
    gens = TG.get_generators(8, device="cpu")
    for value, n in ((16, 4), (-1, 4), (1 << 8, 8), (3, 6), (0, 0)):
        with pytest.raises(ProveError):
            TFU.prove(value, 1, n, gens)


def test_prove_defaults_to_the_card(monkeypatch):
    """Without gens or a device, ``prove`` asks for the generators on the
    card; on a tensor that is not on the CPU (``meta`` stands in for CUDA)
    its ladder goes to the kernel wrapper under either knob value, which
    refuses it, and never to a plain twin."""
    asked = []

    def spy(n, device="cuda"):
        asked.append((n, device))
        raise RuntimeError("no card here")
    monkeypatch.setattr(TFU, "get_generators", spy)
    with pytest.raises(RuntimeError, match="no card here"):
        TFU.prove(5, 7, 4)
    assert asked == [(4, "cuda")]

    def plain(*_):
        raise AssertionError("plain ladder called for a device tensor")
    monkeypatch.setattr(TC, "scalarmult_plain", plain)
    monkeypatch.setattr(TC, "scalarmult_bin_plain", plain)
    meta = TG.Generators(4, torch.empty((10, 80), dtype=torch.int32,
                                        device="meta"))
    before = dict(cuda_curve.launches)
    for window in (4, 0):
        monkeypatch.setattr(config, "LADDER_WINDOW", window)
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            TFU.prove(5, 7, 4, meta)
    assert cuda_curve.launches == before


# --- live against the JAX package (slow) -------------------------------------
@pytest.mark.slow
def test_golden_fixtures_match_jax_live(tmp_path):
    """tests/make_prove_golden.py run anew (the unmodified jitted
    ``fused._prove_fn(n)``, Pallas ladder in interpret mode) gives the
    committed fixtures: the same inputs and the same blob."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import make_prove_golden "
            "as g; g.GOLDEN = __import__('pathlib').Path(%r); "
            "sys.exit(g.main(['4', '8']))"
            % (str(TESTS), str(REPO), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=3600)
    assert out.returncode == 0, out.stderr[-4000:]
    for n in (4, 8):
        with np.load(tmp_path / f"prove_n{n}.npz") as f:
            live = {k: f[k] for k in f.files}
        ref = _golden(n)
        assert live.keys() == ref.keys()
        for key in ref:
            assert np.array_equal(live[key], ref[key]), (n, key)


def _pallas_ladder_child(dst: str) -> None:
    """Child side of the Pallas test: ``pallas_curve.scalarmult_raw`` with
    ``config.PALLAS_LADDER_WINDOW`` 0 (``_ladder_kernel``, interpret mode)
    on the inputs of ``_bin_ladder_inputs``."""
    from cudabulletproof_tpu import config as jconfig
    from cudabulletproof_tpu.ops import curve as JC, pallas_curve as PC
    assert jconfig.PALLAS_LADDER_WINDOW == 0
    pts, s = _bin_ladder_inputs()
    out = PC.scalarmult_raw(JC.GE(*(c.numpy() for c in pts)), s.numpy())
    np.save(dst, np.concatenate([np.asarray(c) for c in out], axis=-1))


def _bin_ladder_inputs():
    """Hash points, the identity and the 8-torsion points, against the edge
    scalars and random ones."""
    rng = np.random.default_rng(23)
    pts = ([oracle.hash_to_point(b"pbin", i) for i in range(5)]
           + [oracle.IDENTITY] + oracle.small_order_points()[:3])
    vals = EDGE_SCALARS + [int.from_bytes(rng.bytes(32), "little") % ELL
                           for _ in range(len(pts) - len(EDGE_SCALARS))]
    return TC.from_oracle(pts), TF.from_ints(vals)


@pytest.mark.slow
def test_bin_twin_matches_pallas_ladder_kernel(tmp_path):
    """The binary twin limb for limb against the Pallas ``_ladder_kernel``
    in interpret mode, run in a child process with
    BP_PALLAS_LADDER_WINDOW=0 (the JAX package's config reads it at
    import)."""
    dst = tmp_path / "ladder.npy"
    code = ("import sys; sys.path[:0] = [%r, %r]; import conftest; "
            "import test_torch_prove as t; t._pallas_ladder_child(%r)"
            % (str(TESTS), str(REPO), str(dst)))
    env = dict(os.environ, BP_PALLAS_LADDER_WINDOW="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    pts, s = _bin_ladder_inputs()
    got = TC.flatten(TC.scalarmult_bin_plain(pts, s))
    assert np.array_equal(got.numpy(), np.load(dst))
