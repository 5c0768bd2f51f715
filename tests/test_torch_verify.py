"""The port's verify path (models/fused.py) against the JAX package.

Proofs are native C++ proofs (``native.prove_range``) at n = 4 and 8, as
the JAX suite's own ``tests/test_fused.py`` runs on the CPU, committed with
the JAX package's results on them in ``tests/golden/verify_n{4,8}.npz``
(written by ``tests/make_verify_golden.py``); both packages get the same
generator table (``from_jax_pack``) and the same random-linear-combination
weights.  Held exactly:

* the verify-parts outputs (valid flag, RLC scalar vector, decompressed
  points) against ``fused._verify_parts_fn(n)`` per proof, limb for limb;
* the verdicts of ``verify`` / ``batch_verify`` against the JAX package's
  verdict and ``native.verify_range``.  The JAX verdict is the body of
  ``fused._verify_fn`` / ``_batch_verify_merged_fn`` on the outputs of
  ``_verify_parts_fn`` (``_assemble_bases``, ``sum_mod``), with the final MSM
  evaluated by the python-int oracle; at n = 4 also the verdicts of the JAX
  package's ``fused.verify`` and ``fused.batch_verify`` themselves on the
  same honest, tampered, small-order and non-canonical proofs.  Malformed
  proofs, which ``fused.verify`` refuses before it compiles anything, go
  through ``fused.verify`` itself;
* the wire format against ``utils/serialization.py``, byte for byte.

The parts program compiles for ~100 s per n on the CPU, ``fused.verify``
for minutes, so tier-1 reads the fixtures; the ``slow`` test reruns
``make_verify_golden.py`` on the committed proofs and compares.
"""
import dataclasses
import fcntl
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import make_verify_golden as golden
from cudabulletproof_tpu.models import fused as JFU, ipa as JIPA
from cudabulletproof_tpu.models import rangeproof as JRP
from cudabulletproof_tpu.models.generators import get_generators as jax_gens
from cudabulletproof_tpu.utils import native, oracle
from cudabulletproof_tpu.utils import serialization as JSER
from cudabulletproof_tpu_torch.models import fused as TFU
from cudabulletproof_tpu_torch.models import generators as TG
from cudabulletproof_tpu_torch.ops import (curve as TC, field as TF,
                                           scalar_field as TS)
from cudabulletproof_tpu_torch.utils import serialization as TSER
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

ELL = oracle.ELL
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _load(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _run_dir(tmp_path_factory) -> Path:
    """A directory of this test run that every xdist worker sees."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def _shared(root: Path, name: str, make) -> dict:
    """The arrays ``make()`` returns, made once per test run: the first
    worker to get here makes and saves them, the others wait on the lock
    and read the file (``tests/test_torch_msm.py`` shares its JAX results
    so)."""
    path = root / f"{name}.npz"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = root / f"{name}.part.npz"
            np.savez(tmp, **make())
            os.replace(tmp, path)
    return _load(path)


@pytest.fixture(scope="module", autouse=True)
def setup():
    """Per n: the JAX generators and packed table, the port's generators
    from that table, the committed native proofs and the JAX results."""
    torch.set_num_threads(1)
    out = {}
    for n in golden.SIZES:
        jg = jax_gens(n)
        pack = np.asarray(JFU._gens_pack(jg, n))
        ref = _load(golden.golden_path(n))
        blobs = [row.tobytes() for row in ref["proofs"]]
        out[n] = dict(jax_gens=jg, pack=pack,
                      gens=TG.from_jax_pack(pack, n, device="cpu"),
                      blobs=blobs, ref=ref,
                      proofs=[TSER.deserialize_range_proof(b) for b in blobs])
    return out


def _jax_proof(proof):
    """The same proof as the JAX package's dataclasses."""
    fields = dataclasses.asdict(proof)
    fields["ip"] = JIPA.InnerProductProof(**fields["ip"])
    return JRP.RangeProof(**fields)


def _cases(s, n) -> dict:
    return golden.cases(s["proofs"], n)


def _jax_reference(setup, n) -> dict:
    """The JAX package's results on ``_cases(setup[n], n)`` from the
    fixture, by group: ``parts`` (``valid`` [m], ``scalars`` [m, k, SL],
    ``pts`` [4, m, 20]), ``verdicts`` and ``batches``."""
    ref = setup[n]["ref"]
    a = len(_cases(setup[n], n)["parts"][0])
    singles = len(ref["verdicts"]) - 2          # then the two batches
    return {"parts": {"valid": ref["valid"][:a], "scalars": ref["scalars"][:a],
                      "pts": ref["pts"][:, :a]},
            "verdicts": ref["verdicts"][:singles],
            "batches": ref["verdicts"][singles:]}


def test_generators_match_jax_pack(setup):
    for n in golden.SIZES:
        s = setup[n]
        assert np.array_equal(s["gens"].table.numpy(), s["pack"])
        assert torch.equal(TG.get_generators(n, device="cpu").table,
                           s["gens"].table)
    small = np.asarray(JFU._gens_pack(setup[8]["jax_gens"], 4))
    assert np.array_equal(
        TG.get_generators(8, device="cpu").pack(4).numpy(), small)
    with pytest.raises(ValueError):
        TG.from_jax_pack(setup[4]["pack"], 8, device="cpu")


def test_wire_format_matches_jax(setup):
    for n in golden.SIZES:
        for blob, proof in zip(setup[n]["blobs"], setup[n]["proofs"]):
            assert TSER.serialize_range_proof(proof) == blob
            jp = JSER.deserialize_range_proof(blob)
            assert JSER.serialize_range_proof(jp) == blob
            assert dataclasses.asdict(jp) == dataclasses.asdict(proof)
    with pytest.raises(ValueError):
        TSER.deserialize_range_proof(setup[4]["blobs"][0][:-1])


@pytest.mark.parametrize("n", [4, 8])
def test_verify_parts_match_jax(setup, n):
    """Honest, tampered, small-order and non-canonical proofs as ONE batch
    through the port; each through the JAX parts program on its own."""
    s = setup[n]
    batch, ints = _cases(s, n)["parts"]
    blobs = np.stack([TFU._proof_blob(p) for p in batch])
    valid, scalars, pts = TFU._verify_parts(
        torch.from_numpy(blobs), TS.from_ints(ints).reshape(-1, 2, TS.SL),
        s["gens"].table, n)
    ref = _jax_reference(setup, n)["parts"]
    for i in range(len(batch)):
        assert bool(valid[i]) == bool(ref["valid"][i]), i
        assert np.array_equal(scalars[i].numpy(), ref["scalars"][i]), i
        for c, jc in zip(pts, ref["pts"], strict=True):
            assert np.array_equal(c[i].numpy(), jc[i]), i
    assert valid.tolist() == [True, True, False, False]


@pytest.mark.parametrize("n", [4, 8])
def test_verdicts_match_jax_and_native(setup, n):
    """Honest proofs accepted and every tampered one rejected, by the port,
    the JAX package and the native verifier alike; at n = 4 the port's
    verdicts are also those of the JAX package's own ``fused.verify``."""
    s = setup[n]
    cases, weights = _cases(s, n)["verdicts"]
    ref = _jax_reference(setup, n)["verdicts"]
    got = []
    for proof, ints, jax_verdict in zip(cases, weights, ref, strict=True):
        want = native.verify_range(TSER.serialize_range_proof(proof))
        got.append(TFU.verify(proof, s["gens"], rnd=ints))
        assert got[-1] == want
        assert bool(jax_verdict) == want
    if n == golden.FUSED_N:
        assert got == s["ref"]["fused_verify"].tolist()
    assert [TFU.verify(p, s["gens"]) for p in s["proofs"]] == [True] * 3


def test_verdicts_match_jax_fused_verify(setup):
    """n = 4: the JAX package's own ``fused.verify`` and
    ``fused.batch_verify`` (in the fixture, with their own random weights)
    accept the 3 honest proofs and the honest batch and reject the 5
    tampered proofs (small order and non-canonical among them) and the
    sunk batch, as the JAX verdicts taken on the parts outputs and the
    native verifier do; the port is held to the same verdicts in
    ``test_verdicts_match_jax_and_native`` and
    ``test_batch_verify_matches_jax_and_native``."""
    n = golden.FUSED_N
    s = setup[n]
    c = _cases(s, n)
    ref = _jax_reference(setup, n)
    fused_verify = s["ref"]["fused_verify"].tolist()
    fused_batch = s["ref"]["fused_batch"].tolist()
    assert fused_verify == [True] * 3 + [False] * 5
    assert fused_verify == ref["verdicts"].tolist()
    assert fused_verify == [native.verify_range(
        TSER.serialize_range_proof(p)) for p in c["verdicts"][0]]
    assert fused_batch == ref["batches"].tolist() == [True, False]


def test_malformed_rejected_like_jax(setup):
    """31-byte V, a dropped L, and generators too small for n."""
    s = setup[4]
    proof = s["proofs"][0]
    short_v = dataclasses.replace(proof, V=b"\x00" * 31)
    no_l = dataclasses.replace(
        proof, ip=dataclasses.replace(proof.ip, L=proof.ip.L[:-1]))
    for bad in (short_v, no_l):
        assert TFU.verify(bad, s["gens"]) is False
        assert JFU.verify(_jax_proof(bad), s["jax_gens"]) is False
    assert not native.verify_range(TSER.serialize_range_proof(no_l))
    assert TFU.verify(proof, TG.get_generators(2, device="cpu")) is False
    assert JFU.verify(_jax_proof(proof), jax_gens(2)) is False


@pytest.mark.parametrize("n", [4, 8])
def test_batch_verify_matches_jax_and_native(setup, n):
    """A merged batch of 3 honest proofs is accepted; one tampered proof
    sinks the batch; the JAX merged verdict and the native verifier agree
    (at n = 4 also the JAX package's own ``fused.batch_verify``)."""
    s = setup[n]
    cases, weights = _cases(s, n)["batches"]
    ref = _jax_reference(setup, n)["batches"]
    got = []
    for (batch, want), ints, jax_verdict in zip(cases, weights, ref,
                                                strict=True):
        natives = [native.verify_range(TSER.serialize_range_proof(p))
                   for p in batch]
        assert all(natives) == want
        got.append(TFU.batch_verify(batch, s["gens"], rnd=ints))
        assert got[-1] == want
        assert bool(jax_verdict) == want
    if n == golden.FUSED_N:
        assert got == s["ref"]["fused_batch"].tolist()
    assert TFU.batch_verify([]) is True
    assert TFU.batch_verify([setup[4]["proofs"][0],
                             setup[8]["proofs"][0]]) is False


def test_explicit_weights(setup):
    s = setup[4]
    proof = s["proofs"][2]
    assert TFU.verify(proof, s["gens"], rnd=[1, 2])
    bad = golden.tamper(proof)["ip.a*2"]
    assert not TFU.verify(bad, s["gens"], rnd=[3, 5])
    with pytest.raises(ValueError):
        TFU.verify(proof, s["gens"], rnd=[1])
    with pytest.raises(ValueError):
        TFU.verify(proof, s["gens"], rnd=[ELL, 2])
    with pytest.raises(ValueError):
        TFU.batch_verify(s["proofs"], s["gens"], rnd=[1, 2])


@pytest.mark.slow
def test_verify_fixtures_match_jax_live(tmp_path):
    """tests/make_verify_golden.py run anew on the committed proofs (the
    unmodified JAX package) gives the committed fixtures."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import make_verify_golden "
            "as g; g.configure_jax(); "
            "g.write(__import__('pathlib').Path(%r), keep=True)"
            % (str(TESTS), str(REPO), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=5400)
    assert out.returncode == 0, out.stderr[-4000:]
    for n in golden.SIZES:
        live = _load(tmp_path / golden.golden_path(n).name)
        ref = _load(golden.golden_path(n))
        assert live.keys() == ref.keys()
        for key in ref:
            assert np.array_equal(live[key], ref[key]), (n, key)


def _spy_accum(monkeypatch) -> list:
    """Record the scalar shape of every ``pippenger.msm_accum`` call."""
    calls = []
    accum = TFU.pippenger.msm_accum

    def spy(points, scalars, *args, **kwargs):
        calls.append(tuple(scalars.shape))
        return accum(points, scalars, *args, **kwargs)
    monkeypatch.setattr(TFU.pippenger, "msm_accum", spy)
    return calls


def test_batch_verify_accum_route_matches_jax(setup, monkeypatch):
    """The merged batches of ``test_batch_verify_matches_jax_and_native``
    (37 MSM bases at n = 4) with ``FUSED_ACCUM_MIN`` lowered, so the MSM
    takes the accumulator (``pippenger.msm_accum``, its plain twin here):
    the same verdicts as the JAX package and the native verifier."""
    n = 4
    s = setup[n]
    cases, weights = _cases(s, n)["batches"]
    ref = _jax_reference(setup, n)["batches"]
    calls = _spy_accum(monkeypatch)
    monkeypatch.setattr(TFU.config, "FUSED_ACCUM_MIN", 16)
    for (batch, want), ints, jax_verdict in zip(cases, weights, ref,
                                                strict=True):
        assert TFU.batch_verify(batch, s["gens"], rnd=ints) == want
        assert bool(jax_verdict) == want
    assert calls == [(64, 20)] * 2          # 37 bases padded to 64


def test_msm_point_takes_accum_branch(monkeypatch):
    """From FUSED_ACCUM_MIN bases ``_msm_point`` takes the accumulator (and
    below it the ladder); both equal the oracle sum."""
    pts = [oracle.hash_to_point(b"route", i) for i in range(12)]
    ints = list(range(1, 11)) + [ELL - 1, 2 ** 252]
    want = oracle.IDENTITY
    for p, k in zip(pts, ints):
        want = want + k * p
    calls = _spy_accum(monkeypatch)
    for threshold, taken in ((12, [(16, 20)]), (13, [])):
        calls.clear()
        monkeypatch.setattr(TFU.config, "FUSED_ACCUM_MIN", threshold)
        got = TFU._msm_point(TC.from_oracle(pts), TS.from_ints(ints))
        assert calls == taken
        assert TC.to_oracle(got) == [want]


def test_invert_on_device_tensor_reaches_kernel(monkeypatch):
    """``field.invert`` on a tensor that is not on the CPU (a ``meta``
    tensor stands in for a CUDA one here) goes to the kernel wrapper, which
    refuses it, and never to the plain twin."""
    def plain(_):
        raise AssertionError("invert_plain called for a device tensor")
    monkeypatch.setattr(TF, "invert_plain", plain)
    before = dict(TF.cuda_field.launches)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TF.invert(torch.empty((2, 20), dtype=torch.int32, device="meta"))
    assert TF.cuda_field.launches == before


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without jax and
    without any module of the JAX package (cudabulletproof_tpu)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cudabulletproof_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for name in ('models.aggregate', 'utils.profiling', 'bench',\n"
        "             'benchmarks.bench_msm', 'ops.radix16',\n"
        "             'ops.cuda_radix16', 'benchmarks.bench_radix16'):\n"
        "    assert 'cudabulletproof_tpu_torch.' + name in sys.modules, name\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules\n"
        "                                        if k.startswith('jax'))\n"
        "ref = sorted(k for k in sys.modules if k == 'cudabulletproof_tpu'\n"
        "             or k.startswith('cudabulletproof_tpu.'))\n"
        "assert not ref, ref\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
