"""The port's host-transcript protocol against the JAX package:
``utils/scalars.py``, ``models/transcript.py``, the generators' accessors,
``ops/msm.py``'s ``msm_ints*``, ``models/ipa.py``, ``models/rangeproof.py``
and ``utils/debug.py``.

Held live against the JAX package, exactly (Python ints and bytes): the
transcript, every ``sc_*`` / ``vec_*`` helper, ``fold_scalars``,
``compute_delta``, ``challenges_from_transcript``, and the generators
(limbs, oracle copies, compressed bytes).

Held against fixtures: ``tests/golden/host_prove_n<n>.npz`` holds the JAX
package's host ``rangeproof.prove`` on fixed randomness, ``pedersen_commit``,
a standalone ``ipa.prove`` / ``ipa.verify`` case and the JAX verdicts of
``verify`` and ``verify_deterministic`` on an honest proof and corrupted
copies, written by ``tests/make_host_golden.py``.  Running the JAX host
protocol here costs minutes of XLA:CPU compile, so tier-1 reads the
fixtures and holds the port on the CPU to them byte for byte and verdict for
verdict (no tolerance) at n = 8 and 16; the ``slow`` test rebuilds the
n = 8 and 16 fixtures live and compares.
"""
import dataclasses
import hashlib
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import make_host_golden as golden
from cudabulletproof_tpu.models import ipa as JI, rangeproof as JR
from cudabulletproof_tpu.models import generators as JG
from cudabulletproof_tpu.models import transcript as JT
from cudabulletproof_tpu.utils import scalars as JSC
from cudabulletproof_tpu_torch import config
from cudabulletproof_tpu_torch.models import generators as TG, ipa as TI
from cudabulletproof_tpu_torch.models import rangeproof as TR
from cudabulletproof_tpu_torch.models import transcript as TT
from cudabulletproof_tpu_torch.ops import (cuda_curve, curve as TC,
                                           field as TF, msm as TM)
from cudabulletproof_tpu_torch.utils import (debug, native, oracle,
                                             scalars as TSC, serialization)
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

ELL = oracle.ELL
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
SIZES = (8, 16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _fixture(n: int) -> dict:
    with np.load(golden.golden_path(n)) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def gens():
    return {n: TG.get_generators(n, "cpu") for n in SIZES}


def _seeded(seed: int):
    rng = np.random.default_rng(seed)
    return lambda: int.from_bytes(rng.bytes(64), "little") % ELL


def _feed(ints):
    """A `rand` callable handing out `ints` in turn; it counts the draws."""
    it = iter(ints)

    def draw():
        draw.count += 1
        return next(it)
    draw.count = 0
    return draw


# --- live against the JAX package: pure Python -------------------------------
def test_scalars_match_jax():
    draw = _seeded(1)
    a, b = [draw() for _ in range(9)], [draw() for _ in range(9)]
    a[0], b[1] = 0, ELL - 1
    s = draw()
    assert TSC.ELL == JSC.ELL == ELL
    for name in ("sc_add", "sc_sub", "sc_mul"):
        assert [getattr(TSC, name)(x, y) for x, y in zip(a, b)] == \
            [getattr(JSC, name)(x, y) for x, y in zip(a, b)], name
    assert [TSC.sc_inv(x) for x in a[1:]] == [JSC.sc_inv(x) for x in a[1:]]
    for name in ("vec_add", "vec_sub", "vec_hadamard", "vec_inner"):
        assert getattr(TSC, name)(a, b) == getattr(JSC, name)(a, b), name
    assert TSC.vec_scalar_mul(a, s) == JSC.vec_scalar_mul(a, s)
    assert TSC.vec_powers(s, 17) == JSC.vec_powers(s, 17)
    raw = (ELL + 5).to_bytes(32, "little")
    assert TSC.sc_from_bytes(raw) == JSC.sc_from_bytes(raw) == 5
    assert TSC.sc_to_bytes(ELL + 5) == JSC.sc_to_bytes(ELL + 5)
    with pytest.raises(ValueError):
        TSC.vec_add(a, b[:3])
    assert all(0 <= TSC.sc_random() < ELL for _ in range(8))


def test_transcript_matches_jax():
    rng = np.random.default_rng(2)
    assert TT.challenge(b"dom", b"") == JT.challenge(b"dom", b"")
    for label in (b"tpu-bulletproofs", b"tpu-bulletproofs/range", b""):
        t, j = TT.Transcript(label), JT.Transcript(label)
        for step in range(6):
            pt, raw = rng.bytes(32), rng.bytes(step)
            s = int.from_bytes(rng.bytes(40), "little")
            for tr in (t, j):
                tr.append_point(b"P%d" % step, pt)
                tr.append_scalar(b"s", s)
                tr.append(b"raw", raw)
            assert t.challenge(b"BulletproofYChal") == \
                j.challenge(b"BulletproofYChal")
            assert t.state == j.state
    with pytest.raises(ValueError):
        TT.Transcript().append_point(b"P", b"\x00" * 31)
    # a challenge is SHA-256 of domain || data, top bit cleared, mod l
    h = hashlib.sha256(b"dom" + b"data").digest()
    assert TT.challenge(b"dom", b"data") == \
        (int.from_bytes(h, "little") & ((1 << 255) - 1)) % ELL


@pytest.mark.parametrize("n", [1, 2, 8, 16])
def test_ipa_and_delta_helpers_match_jax(n):
    draw = _seeded(3 + n)
    us = [draw() for _ in range(n.bit_length() - 1)]
    assert TI.fold_scalars(us, n) == JI.fold_scalars(us, n)
    y, z = draw(), draw()
    assert TR.compute_delta(y, z, n) == JR.compute_delta(y, z, n)
    rng = np.random.default_rng(n)
    k = n.bit_length() - 1
    proof = TI.InnerProductProof(n, [rng.bytes(32) for _ in range(k)],
                                 [rng.bytes(32) for _ in range(k)], 1, 2)
    t, j = TT.Transcript(b"x"), JT.Transcript(b"x")
    assert TI.challenges_from_transcript(proof, t) == \
        JI.challenges_from_transcript(proof, j)
    assert t.state == j.state
    with pytest.raises(ValueError):
        TI.fold_scalars(us, 2 * n)


def test_generator_accessors_match_jax(gens):
    """g, h, G, H as limbs and compressed bytes, and the oracle copies, at
    n = 16: the JAX package's Generators field for field, read from the one
    packed table."""
    n = 16
    got, want = gens[n], JG.get_generators(n)
    for name in ("g", "h", "G", "H"):
        for gc, wc in zip(getattr(got, name), getattr(want, name)):
            assert np.array_equal(gc.numpy(), np.asarray(wc)), name
    assert got.G.x.shape == (n, 20) and got.g.x.shape == (20,)
    assert got.G.x.data_ptr() == got.table.data_ptr()      # views
    for name in ("g_pt", "h_pt"):
        assert dataclasses.astuple(getattr(got, name)) == \
            dataclasses.astuple(getattr(want, name))
    for name in ("G_pts", "H_pts"):
        assert [dataclasses.astuple(p) for p in getattr(got, name)] == \
            [dataclasses.astuple(p) for p in getattr(want, name)]
    pts = TC.GE(*(torch.cat([a, b, c[None], d[None]]) for a, b, c, d in
                  zip(got.G, got.H, got.g, got.h)))
    raw = TC.to_bytes_batch(pts).numpy()
    assert [bytes(r) for r in raw] == [p.compress() for p in
                                       (*want.G_pts, *want.H_pts,
                                        want.g_pt, want.h_pt)]


# --- msm_ints* ---------------------------------------------------------------
def _oracle_msm(pts, scalars):
    acc = oracle.IDENTITY
    for p, s in zip(pts, scalars):
        acc = acc + s * p
    return acc


def test_msm_ints_match_oracle():
    """msm_ints and msm_ints_multi against the python-int oracle, at sizes
    below, at and above pad_min (padding to 64 and 128); B = 1, 3, 2."""
    draw = _seeded(5)
    for m, lists in ((2, 1), (64, 3), (70, 2)):
        pts = [oracle.hash_to_point(b"msm", i) for i in range(m)]
        sls = [[draw() for _ in range(m)] for _ in range(lists)]
        sls[0][0] = 0
        sls[-1][-1] = ELL - 1
        bases = TC.from_oracle(pts)
        want = [_oracle_msm(pts, sl).compress() for sl in sls]
        assert TM.msm_ints_multi(bases, sls) == want
        assert TR._compress(TM.msm_ints(bases, sls[-1])) == want[-1]


def test_msm_ints_refuse_bad_scalars():
    pts = TC.from_oracle([oracle.hash_to_point(b"r", i) for i in range(2)])
    with pytest.raises(ValueError, match="2\\^253"):
        TM.msm_ints(pts, [1, 1 << 253])
    with pytest.raises(ValueError):
        TM.msm_ints(pts, [1])
    with pytest.raises(ValueError):
        TM.msm_ints_multi(pts, [[1, 2], [3]])
    # reduced mod p first, as in the JAX package: p + 5 is 5
    assert TM.msm_ints_multi(pts, [[TF.P + 5, 0]]) == \
        TM.msm_ints_multi(pts, [[5, 0]])


# --- fixtures of the JAX host protocol ---------------------------------------
@pytest.mark.parametrize("n", SIZES)
def test_prove_matches_jax_fixture(gens, n):
    """The host prover, fed the fixture's randomness, writes the JAX blob
    byte for byte and draws exactly 2n + 4 scalars; pedersen_commit gives
    the fixture's commitment."""
    fx = _fixture(n)
    value, blinding = golden.from_rows(fx["secret"])
    draw = _feed(golden.from_rows(fx["rand"]))
    proof = TR.prove(value, blinding, n, gens[n], rand=draw)
    assert draw.count == 2 * n + 4
    assert serialization.serialize_range_proof(proof) == fx["blob"].tobytes()
    commit = TR._compress(TR.pedersen_commit(value, blinding, gens[n]))
    assert commit == fx["commit"].tobytes() == proof.V


@pytest.mark.parametrize("n", SIZES)
def test_ipa_matches_jax_fixture(gens, n):
    fx = _fixture(n)
    g = gens[n]
    a, b, hw, q, p_sc = golden.ipa_statement(golden.from_rows(fx["ipa_in"]),
                                             n)
    P = TM.msm_ints(TM.concat_ge(g.G, g.H, g.h), p_sc)
    assert TR._compress(P) == fx["ipa_P"].tobytes()
    ip = TI.prove(g.G, g.H, g.h, a, b, TT.Transcript(golden.IPA_LABEL),
                  q_weight=q, h_weights=hw)
    rows = [*ip.L, *ip.R, ip.a.to_bytes(32, "little"),
            ip.b.to_bytes(32, "little")]
    assert rows == [bytes(r) for r in fx["ipa_proof"]]
    P2 = TC.add(P, g.h)
    got = [TI.verify(g.G, g.H, g.h, P2 if shifted else P, pr,
                     TT.Transcript(golden.IPA_LABEL), q_weight=q,
                     h_weights=hw)
           for pr, shifted in golden.ipa_corruptions(ip).values()]
    assert list(golden.ipa_corruptions(ip)) == fx["ipa_cases"].tolist()
    assert got == fx["ipa_verify"].tolist() == [True, False, False, False]
    half = TC.GE(*(c[:n // 2] for c in g.G))
    assert not TI.verify(half, g.H, g.h, P, ip, TT.Transcript(b"x"))


# every case at n = 8; at n = 16 the honest proof and one case each of a
# changed scalar, a small-order point and undersized generators
VERDICT_CASES = [(8, c) for c in golden.CASES + (golden.UNDERSIZED,)] + [
    (16, c) for c in ("honest", "t_hat + 1", "L0 small order",
                      golden.UNDERSIZED)]


@pytest.mark.parametrize("n,case", VERDICT_CASES)
def test_verdicts_match_jax_fixture(gens, n, case):
    """verify and verify_deterministic give the JAX verdicts on the honest
    proof, on the corrupted copies and on the honest proof against
    undersized generators."""
    fx = _fixture(n)
    names = fx["cases"].tolist()
    assert names == list(golden.CASES) + [golden.UNDERSIZED]
    blob = fx["blob"].tobytes()
    if case == golden.UNDERSIZED:
        proof, g = (serialization.deserialize_range_proof(blob),
                    TG.get_generators(n // 2, "cpu"))
    else:
        proof = serialization.deserialize_range_proof(
            golden.corruptions(blob, n)[case])
        g = gens[n]
    i = names.index(case)
    assert TR.verify(proof, g, rand=_seeded(11)) == fx["verify"][i]
    assert TR.verify_deterministic(proof, g) == fx["verify_det"][i]
    assert bool(fx["verify"][i]) == (case == "honest")


def test_prove_refuses_bad_input(gens):
    for value, n in ((1 << 8, 8), (-1, 8), (3, 6), (0, 0)):
        with pytest.raises(TR.ProveError):
            TR.prove(value, 1, n, gens[8])
    with pytest.raises(ValueError):
        TR.prove(1, 1, 16, gens[8])            # 8 generators for n = 16


def test_fresh_proofs_and_native_routes(gens):
    """A proof with fresh randomness passes both verifiers, the native one
    and verify_fast; verify draws its two weights from `rand`; prove_fast
    at n <= 64 is the native prover's proof, which the port accepts."""
    g = TG.get_generators(4, "cpu")
    proof = TR.prove(13, 77, 4, g)
    assert native.verify_range(serialization.serialize_range_proof(proof))
    draw = _feed([5, 9])
    assert TR.verify(proof, g, rand=draw) and draw.count == 2
    assert TR.verify_deterministic(proof, g)
    assert TR.verify_fast(proof, g)
    fast = TR.prove_fast(13, 77, 4, g)
    assert fast.n == 4 and TR.verify(fast, g)
    assert fast.V == proof.V                   # same value and blinding
    with pytest.raises(TR.ProveError):
        TR.prove_fast(16, 1, 4, g)
    assert config.NATIVE_VERIFY_MAX_BITS == 64
    assert config.DEFAULT_RANGE_BITS == 16


def test_entry_points_default_to_the_card(monkeypatch):
    """Without gens, prove / verify / verify_deterministic ask for the
    generators on the card."""
    asked = []

    def spy(n, device="cuda"):
        asked.append((n, device))
        raise RuntimeError("no card here")
    monkeypatch.setattr(TR, "get_generators", spy)
    fx = _fixture(8)
    proof = serialization.deserialize_range_proof(fx["blob"].tobytes())
    for call in (lambda: TR.prove(5, 7, 8), lambda: TR.verify(proof),
                 lambda: TR.verify_deterministic(proof)):
        with pytest.raises(RuntimeError, match="no card here"):
            call()
    assert asked == [(8, "cuda")] * 3


def test_host_path_on_device_tensor_reaches_kernels(monkeypatch):
    """On generators that are not on the CPU (``meta`` stands in for CUDA),
    the host prover's MSM goes to the ladder kernel wrapper, which refuses
    the tensor, and never to a plain twin."""
    def plain(*_):
        raise AssertionError("plain ladder called for a device tensor")
    monkeypatch.setattr(TC, "scalarmult_plain", plain)
    meta = TG.Generators(8, torch.empty((18, 80), dtype=torch.int32,
                                        device="meta"))
    before = dict(cuda_curve.launches)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TR.prove(5, 7, 8, meta)
    assert cuda_curve.launches == before


def test_debug_trace(monkeypatch, caplog):
    monkeypatch.setattr(config, "TRACE", True)
    with caplog.at_level(logging.DEBUG, logger="cudabulletproof_tpu_torch"):
        debug.banner("STEP")
        debug.trace_scalar("x", 1)
        debug.trace_point("P", bytes(range(32)))
        debug.trace_vector("v", [1, 2, 3, 4, 5])
    assert caplog.messages == [
        "=== STEP ===", "x: 0100000000000000...",
        "P: 0001020304050607... (compressed)",
        "v[5]: 0x1, 0x2, 0x3, 0x4, ..."]
    text = debug.describe_field(TF.from_ints([5, TF.P + 1]))
    assert text == "fe25519[2]: 0x5, 0x1"


# --- live against the JAX package (slow) -------------------------------------
@pytest.mark.slow
def test_host_fixtures_match_jax_live(tmp_path):
    """tests/make_host_golden.py run anew (the unmodified JAX host
    protocol) gives the committed fixtures at n = 8 and 16."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import make_host_golden "
            "as g; g.configure_jax(); "
            "[g.write(n, __import__('pathlib').Path(%r)) for n in (8, 16)]"
            % (str(TESTS), str(REPO), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=3600)
    assert out.returncode == 0, out.stderr[-4000:]
    for n in SIZES:
        with np.load(tmp_path / golden.golden_path(n).name) as f:
            live = {k: f[k] for k in f.files}
        ref = _fixture(n)
        assert live.keys() == ref.keys()
        for key in ref:
            assert np.array_equal(live[key], ref[key]), (n, key)
