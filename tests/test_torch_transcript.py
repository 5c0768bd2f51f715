"""SHA-256, the mod-l scalar field and the device transcript of the port.

* ``ops/sha256.py`` against ``hashlib`` (hypothesis over lengths 0-300).
* ``ops/scalar_field.py`` against python ints mod l and, limb for limb,
  against ``cudabulletproof_tpu/ops/scalar_field.py`` on the same inputs.
* ``models/device_transcript.py`` in lockstep with the host
  ``models/transcript.py``; batched ``ipa_challenges`` on [B, k, 32] equal to
  B single runs.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from cudabulletproof_tpu.models.transcript import Transcript
from cudabulletproof_tpu.ops import scalar_field as JS
from cudabulletproof_tpu.utils import oracle
from cudabulletproof_tpu_torch.models.device_transcript import DeviceTranscript
from cudabulletproof_tpu_torch.ops import field as TF, scalar_field as TS
from cudabulletproof_tpu_torch.ops.sha256 import sha256, sha256_concat
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

ELL = oracle.ELL


@pytest.fixture(scope="module", autouse=True)
def sc():
    """Two rows of scalars: random weak limbs (values up to 2^264) and edge
    values (0, 1, l-1, l, l+1, 2^252-1)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(777)
    weak = rng.integers(0, TS.WEAK + 1, size=(4, TS.SL), dtype=np.int32)
    edge = np.stack([TS._int_to_limbs(v, TS.SL) for v in
                     (0, 1, ELL - 1, ELL, ELL + 1, (1 << 252) - 1)])
    a = np.concatenate([weak, edge])
    b = np.concatenate([rng.integers(0, TS.WEAK + 1, size=(4, TS.SL),
                                     dtype=np.int32), edge[::-1]])
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ints(limbs) -> list:
    return [v % ELL for v in TS.to_ints(_t(np.asarray(limbs)))]


def _bytes(rows) -> list:
    return [bytes(r) for r in np.asarray(rows)]


# --- SHA-256 -------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(st.binary(min_size=0, max_size=300))
def test_sha256_matches_hashlib(msg):
    t = torch.frombuffer(bytearray(msg), dtype=torch.uint8) if msg else \
        torch.zeros(0, dtype=torch.uint8)
    assert bytes(sha256(t).tolist()) == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("ln", [55, 56, 63, 64, 119, 120])
def test_sha256_block_boundaries_batched(ln):
    rng = np.random.default_rng(ln)
    msgs = rng.integers(0, 256, size=(3, ln), dtype=np.uint8)
    out = sha256(_t(msgs))
    assert _bytes(out) == [hashlib.sha256(bytes(m)).digest() for m in msgs]


def test_sha256_concat_bytes_and_tensors():
    a = b"domain-sep"
    rng = np.random.default_rng(5)
    b = rng.integers(0, 256, size=(2, 32), dtype=np.uint8)
    c = rng.integers(0, 256, size=(32,), dtype=np.uint8)      # broadcasts
    got = _bytes(sha256_concat(a, _t(b), _t(c)))
    assert got == [hashlib.sha256(a + bytes(r) + bytes(c)).digest()
                   for r in b]


# --- scalar field --------------------------------------------------------------
def test_scalar_ring_ops_match_jax(sc):
    a, b = sc
    ta, tb, ja, jb = _t(a), _t(b), jnp.asarray(a), jnp.asarray(b)
    for name, got, want in (
            ("add", TS.add(ta, tb), JS.add(ja, jb)),
            ("sub", TS.sub(ta, tb), JS.sub(ja, jb)),
            ("neg", TS.neg(tb), JS.neg(jb)),
            ("mul", TS.mul(ta, tb), JS.mul(ja, jb)),
            ("sq", TS.sq(ta), JS.sq(ja)),
            ("canonical", TS.canonical(ta), JS.canonical(ja)),
            ("sum_mod", TS.sum_mod(ta, dim=0), JS.sum_mod(ja, axis=0))):
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    x, y = _ints(a), _ints(b)
    assert _ints(TS.mul(ta, tb)) == [u * v % ELL for u, v in zip(x, y)]
    assert _ints(TS.sub(ta, tb)) == [(u - v) % ELL for u, v in zip(x, y)]
    assert _ints(TS.sum_mod(ta, dim=0)) == [sum(x) % ELL]
    assert TS.is_zero(ta).tolist() == [u == 0 for u in x]


def test_scalar_bytes_invert_powers_match_jax(sc):
    a, _ = sc
    ta, ja = _t(a), jnp.asarray(a)
    enc = TS.to_bytes(ta)
    assert np.array_equal(enc.numpy(), np.asarray(JS.to_bytes(ja)))
    assert _bytes(enc) == [v.to_bytes(32, "little") for v in _ints(a)]
    raw = np.random.default_rng(3).integers(0, 256, (4, 32), dtype=np.uint8)
    assert np.array_equal(TS.from_bytes(_t(raw)).numpy(),
                          np.asarray(JS.from_bytes(jnp.asarray(raw))))
    nz = a[:4]
    inv = TS.invert(_t(nz))
    assert np.array_equal(inv.numpy(), np.asarray(JS.invert(jnp.asarray(nz))))
    assert _ints(inv) == [pow(v, ELL - 2, ELL) for v in _ints(nz)]
    pw = TS.powers(_t(nz[:2]), 6)                     # batched base
    for row, base in zip(pw, nz[:2]):
        assert np.array_equal(row.numpy(),
                              np.asarray(JS.powers(jnp.asarray(base), 6)))
    assert np.array_equal(TS.to_field_limbs(ta).numpy(),
                          np.asarray(JS.to_field_limbs(ja)))
    assert [v % TF.P for v in TF.to_ints(TS.to_field_limbs(ta))] == _ints(a)


def test_scalar_host_conversion():
    xs = [0, 1, ELL - 1, ELL + 3, 1 << 255]
    assert _ints(TS.from_ints(xs)) == [x % ELL for x in xs]
    assert np.array_equal(TS.from_ints(xs).numpy(),
                          np.asarray(JS.from_ints(xs)))
    assert TS.from_int(9, (2, 3)).shape == (2, 3, TS.SL)


# --- transcript ----------------------------------------------------------------
def test_device_transcript_lockstep_with_host():
    rng = np.random.default_rng(9)
    host = Transcript(b"lockstep-test")
    dev = DeviceTranscript(b"lockstep-test")
    for i in range(3):
        blob = rng.integers(0, 256, 32, dtype=np.uint8)
        host.append_point(b"P", bytes(blob))
        dev.append_point(b"P", _t(blob))
        s = int.from_bytes(rng.bytes(32), "little") % ELL
        host.append_scalar(b"s", s)
        dev.append_scalar(b"s", TS.from_int(s))
        dom = b"SomeDomain%d" % i
        assert _ints(dev.challenge(dom)) == [host.challenge(dom)]
        assert bytes(dev.state.tolist()) == host.state


def test_batched_ipa_challenges_equal_single_runs():
    """[B, k, 32] rounds with a [B] transcript = B independent host runs."""
    B, k = 3, 4
    rng = np.random.default_rng(11)
    Ls = rng.integers(0, 256, size=(B, k, 32), dtype=np.uint8)
    Rs = rng.integers(0, 256, size=(B, k, 32), dtype=np.uint8)
    pre = rng.integers(0, 256, size=(B, 32), dtype=np.uint8)
    dev = DeviceTranscript(b"ipa-batch", batch=(B,))
    dev.append_point(b"V", _t(pre))
    us, us_inv = dev.ipa_challenges(_t(Ls), _t(Rs), b"ipa-u")
    assert us.shape == us_inv.shape == (B, k, TS.SL)
    for i in range(B):
        host = Transcript(b"ipa-batch")
        host.append_point(b"V", bytes(pre[i]))
        want = []
        for j in range(k):
            host.append_point(b"ipL", bytes(Ls[i, j]))
            host.append_point(b"ipR", bytes(Rs[i, j]))
            want.append(host.challenge(b"ipa-u"))
        assert _ints(us[i]) == want
        assert _ints(us_inv[i]) == [pow(u, -1, ELL) for u in want]
        assert bytes(dev.state[i].tolist()) == host.state
