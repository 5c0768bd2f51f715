"""The port's verify path (models/fused.py) against the JAX package.

Proofs come from the native C++ prover (``native.prove_range``), at n = 4 and
8 as the JAX suite's own ``tests/test_fused.py`` runs on the CPU; both
packages get the same generator table (``from_jax_pack``) and the same
random-linear-combination weights.  Held exactly:

* the verify-parts outputs (valid flag, RLC scalar vector, decompressed
  points) against ``fused._verify_parts_fn(n)`` per proof, limb for limb;
* the verdicts of ``verify`` / ``batch_verify`` against the JAX package's
  verdict and ``native.verify_range``.  The JAX verdict is the body of
  ``fused._verify_fn`` / ``_batch_verify_merged_fn`` on the outputs of
  ``_verify_parts_fn`` (``_assemble_bases``, ``sum_mod``), with the final MSM
  evaluated by the python-int oracle: ``fused.verify`` itself compiles its
  Pallas-interpret ladder into the program, 4 min (n = 4) and 8 min (n = 8)
  of XLA:CPU compile on one core.  Malformed proofs, which ``fused.verify``
  refuses before it compiles anything, go through ``fused.verify`` itself;
* the wire format against ``utils/serialization.py``, byte for byte.

The parts program runs in one child process per n and test run, configured
by ``tests/conftest.py`` (``_jax_reference``): its XLA:CPU executable holds
about 2 GB, which would otherwise stay in the test worker, beside the JAX
suite's own executables, for the rest of the session.  The child takes the
inputs of all three JAX comparisons at its n, so the program compiles once
per n; under xdist the proofs and the child's outputs are shared between
workers through files in the run's temporary directory.
"""
import dataclasses
import fcntl
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabulletproof_tpu.models import fused as JFU, ipa as JIPA
from cudabulletproof_tpu.models import rangeproof as JRP
from cudabulletproof_tpu.models.generators import get_generators as jax_gens
from cudabulletproof_tpu.ops import curve as JC, scalar_field as JS
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


def _tamper(proof) -> dict:
    tor = oracle.small_order_points()
    ip = proof.ip
    return {
        "t_hat+1": dataclasses.replace(proof, t_hat=(proof.t_hat + 1) % ELL),
        "V=A": dataclasses.replace(proof, V=proof.A),
        "ip.a*2": dataclasses.replace(
            proof, ip=dataclasses.replace(ip, a=ip.a * 2 % ELL)),
        "A small order": dataclasses.replace(proof, A=tor[1].compress()),
        "S non-canonical": dataclasses.replace(
            proof, S=(oracle.P + 1).to_bytes(32, "little")),
    }


def _run_dir(tmp_path_factory) -> Path:
    """A directory of this test run that every xdist worker sees."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def _shared(root: Path, name: str, make) -> dict:
    """The arrays ``make()`` returns, made once per test run: the first
    worker to get here makes and saves them, the others wait on the lock
    and read the file."""
    path = root / f"{name}.npz"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = root / f"{name}.part.npz"
            np.savez(tmp, **make())
            os.replace(tmp, path)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _make_proofs() -> dict:
    """Native proofs per n (values and blindings from a seeded numpy rng;
    the prover draws its own nonces, hence made once and shared)."""
    rng = np.random.default_rng(64)
    out = {}
    for n in (4, 8):
        values = [0, (1 << n) - 1, int(rng.integers(0, 1 << n))]
        out[f"n{n}"] = np.stack([np.frombuffer(native.prove_range(
            v, int.from_bytes(rng.bytes(32), "little"), n), dtype=np.uint8)
            for v in values])
    return out


@pytest.fixture(scope="module", autouse=True)
def setup(tmp_path_factory):
    """Per n: the JAX generators and packed table, the port's generators
    from that table, and the run's native proofs."""
    torch.set_num_threads(1)
    root = _run_dir(tmp_path_factory)
    made = _shared(root, "torch_verify_proofs", _make_proofs)
    out = {"root": root}
    for n in (4, 8):
        jg = jax_gens(n)
        pack = np.asarray(JFU._gens_pack(jg, n))
        blobs = [row.tobytes() for row in made[f"n{n}"]]
        out[n] = dict(jax_gens=jg, pack=pack,
                      gens=TG.from_jax_pack(pack, n, device="cpu"),
                      blobs=blobs,
                      proofs=[TSER.deserialize_range_proof(b) for b in blobs])
    return out


def _rnd(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % (ELL - 1) + 1
            for _ in range(2 * count)]


def _jax_proof(proof):
    """The same proof as the JAX package's dataclasses."""
    fields = dataclasses.asdict(proof)
    fields["ip"] = JIPA.InnerProductProof(**fields["ip"])
    return JRP.RangeProof(**fields)


def _jax_blob(proof) -> np.ndarray:
    """The JAX package's device blob of the same proof."""
    return JFU._proof_blob(_jax_proof(proof))


def _pairs(ints) -> list:
    return [ints[i:i + 2] for i in range(0, len(ints), 2)]


def _cases(s, n) -> dict:
    """The inputs of the three JAX comparisons at n, weights from seeded
    numpy rngs.  ``parts``: honest, tampered, small-order and non-canonical
    proofs as one batch.  ``verdicts``: 3 honest and 5 tampered proofs, one
    at a time.  ``batches``: 3 honest proofs merged, then the same with one
    tampered."""
    bad = _tamper(s["proofs"][0])
    parts = [s["proofs"][1], bad["t_hat+1"], bad["A small order"],
             bad["S non-canonical"]]
    verdicts = list(s["proofs"]) + list(bad.values())
    rng = np.random.default_rng(100 + n)
    good = s["proofs"]
    sunk = good[:2] + [dataclasses.replace(good[2], mu=(good[2].mu + 1) % ELL)]
    brng = np.random.default_rng(200 + n)
    return {"parts": (parts, _rnd(np.random.default_rng(n), len(parts))),
            "verdicts": (verdicts, [_rnd(rng, 1) for _ in verdicts]),
            "batches": ([(good, True), (sunk, False)],
                        [_rnd(brng, 3) for _ in range(2)])}


def _jax_verdict(n, pack, outs) -> bool:
    """The JAX package's single (one proof) or merged-batch verdict on its
    parts outputs: its base and scalar assembly, the MSM by the oracle, then
    the cofactor-8 identity check."""
    valid = all(bool(o[0]) for o in outs)
    sc = jnp.stack([o[1] for o in outs])
    pts = JC.GE(*(jnp.stack([o[2][c] for o in outs]) for c in range(4)))
    if len(outs) == 1:
        scal = sc[0]
    else:
        scal = jnp.concatenate([JS.sum_mod(sc[:, :2 * n + 2], axis=0),
                                sc[:, 2 * n + 2:].reshape(-1, JS.SL)])
    bases = JC.to_oracle(JFU._assemble_bases(pack, n, pts))
    acc = oracle.IDENTITY
    for pt, k in zip(bases, JS.to_ints(JS.canonical(scal))):
        acc = acc + k * pt
    return valid and 8 * acc == oracle.IDENTITY


def _jax_reference_main(src: str, dst: str) -> None:
    """Child side of ``_jax_reference``: reads its inputs from ``src`` and
    writes the parts outputs and verdicts to ``dst``."""
    jax.config.update("jax_enable_compilation_cache", False)
    with np.load(src) as f:
        meta = json.loads(str(f["meta"]))
        pack, blobs = jnp.asarray(f["pack"]), f["blobs"]
    n = meta["n"]
    parts = jax.jit(JFU._verify_parts_fn(n))
    outs = [parts(jnp.asarray(b), JS.from_ints([int(v) for v in r]), pack)
            for b, r in zip(blobs, meta["rnd"], strict=True)]
    np.savez(dst, valid=np.array([bool(o[0]) for o in outs]),
             scalars=np.stack([np.asarray(o[1]) for o in outs]),
             pts=np.stack([np.stack([np.asarray(o[2][c]) for o in outs])
                           for c in range(4)]),
             verdicts=np.array([_jax_verdict(n, pack, [outs[i] for i in b])
                                for b in meta["batches"]], dtype=bool))


def _jax_reference(s, n) -> dict:
    """The JAX package on all of ``_cases(s, n)``, once per n and test run,
    in one child process set up by tests/conftest.py like the JAX suite (CPU
    backend; its compile cache off): each proof blob with its weight pair
    through ``fused._verify_parts_fn(n)``, compiled once, then the single
    and merged-batch verdicts.  Returns, per group of ``_cases``, its slice
    of ``valid`` [m], ``scalars`` [m, k, SL], ``pts`` [4, m, 20] and
    ``verdicts``."""
    cases = _cases(s[n], n)
    parts, parts_w = cases["parts"]
    verdicts, verdict_w = cases["verdicts"]
    batches, batch_w = cases["batches"]
    blobs = [TFU._proof_blob(p) for p in parts]
    blobs += [_jax_blob(p) for p in verdicts]
    blobs += [_jax_blob(p) for batch, _ in batches for p in batch]
    rnd = (_pairs(parts_w) + verdict_w
           + [pair for w in batch_w for pair in _pairs(w)])
    a, b = len(parts), len(parts) + len(verdicts)
    singles = [(i,) for i in range(a, b)]
    merged = [tuple(range(b + 3 * j, b + 3 * j + 3)) for j in range(2)]

    def make():
        root = s["root"]
        src, dst = root / f"jax_in_n{n}.npz", root / f"jax_out_n{n}.npz"
        np.savez(src, pack=s[n]["pack"], blobs=np.stack(blobs),
                 meta=json.dumps({"n": n,
                                  "rnd": [[str(v) for v in r] for r in rnd],
                                  "batches": [list(t)
                                              for t in singles + merged]}))
        code = ("import sys; sys.path[:0] = [%r, %r]; import conftest; "
                "import test_torch_verify as t; t._jax_reference_main(%r, %r)"
                % (str(TESTS), str(REPO), str(src), str(dst)))
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        with np.load(dst) as f:
            return {k: f[k] for k in f.files}

    ref = _shared(s["root"], f"torch_verify_jax_n{n}", make)
    return {"parts": {"valid": ref["valid"][:a], "scalars": ref["scalars"][:a],
                      "pts": ref["pts"][:, :a]},
            "verdicts": ref["verdicts"][:len(singles)],
            "batches": ref["verdicts"][len(singles):]}


def test_generators_match_jax_pack(setup):
    for n in (4, 8):
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
    for n in (4, 8):
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
    the JAX package and the native verifier alike."""
    s = setup[n]
    cases, weights = _cases(s, n)["verdicts"]
    ref = _jax_reference(setup, n)["verdicts"]
    for proof, ints, jax_verdict in zip(cases, weights, ref, strict=True):
        want = native.verify_range(TSER.serialize_range_proof(proof))
        assert TFU.verify(proof, s["gens"], rnd=ints) == want
        assert bool(jax_verdict) == want
    assert [TFU.verify(p, s["gens"]) for p in s["proofs"]] == [True] * 3


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
    sinks the batch; the JAX merged verdict and the native verifier agree."""
    s = setup[n]
    cases, weights = _cases(s, n)["batches"]
    ref = _jax_reference(setup, n)["batches"]
    for (batch, want), ints, jax_verdict in zip(cases, weights, ref,
                                                strict=True):
        natives = [native.verify_range(TSER.serialize_range_proof(p))
                   for p in batch]
        assert all(natives) == want
        assert TFU.batch_verify(batch, s["gens"], rnd=ints) == want
        assert bool(jax_verdict) == want
    assert TFU.batch_verify([]) is True
    assert TFU.batch_verify([setup[4]["proofs"][0],
                             setup[8]["proofs"][0]]) is False


def test_explicit_weights(setup):
    s = setup[4]
    proof = s["proofs"][2]
    assert TFU.verify(proof, s["gens"], rnd=[1, 2])
    bad = _tamper(proof)["ip.a*2"]
    assert not TFU.verify(bad, s["gens"], rnd=[3, 5])
    with pytest.raises(ValueError):
        TFU.verify(proof, s["gens"], rnd=[1])
    with pytest.raises(ValueError):
        TFU.verify(proof, s["gens"], rnd=[ELL, 2])
    with pytest.raises(ValueError):
        TFU.batch_verify(s["proofs"], s["gens"], rnd=[1, 2])


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
