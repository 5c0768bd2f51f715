"""The port's aggregated range proofs and batched verification
(``models/aggregate.py``) and their wire format
(``utils/serialization.py``: ``serialize_aggregated_proof``,
``deserialize_aggregated_proof``) against the JAX package.

Held against fixtures: ``tests/golden/agg_n8_m{2,4}.npz`` hold the JAX
package's ``aggregate.prove`` on fixed randomness and ``aggregate.verify``'s
verdicts on an honest proof and corrupted copies; ``agg_batch_n8.npz``
holds four JAX host proofs and ``aggregate.batch_verify``'s verdicts on
batches of them; all written by ``tests/make_agg_golden.py``.  Running the
JAX protocol costs minutes of XLA:CPU compile, so tier-1 reads the fixtures
and holds the port on the CPU to them byte for byte and verdict for verdict
(no tolerance); the ``slow`` test rebuilds them live and compares.  The
combination weights of the port's verifiers come from seeded numpy draws.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import make_agg_golden as golden
from cudabulletproof_tpu.utils import serialization as JSER
from cudabulletproof_tpu_torch.models import aggregate as TA, generators as TG
from cudabulletproof_tpu_torch.models import rangeproof as TR
from cudabulletproof_tpu_torch.ops import curve as TC
from cudabulletproof_tpu_torch.utils import oracle, serialization as TSER
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

ELL = oracle.ELL
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _load(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _feed(ints):
    it = iter(ints)

    def draw():
        draw.count += 1
        return next(it)
    draw.count = 0
    return draw


def _seeded(seed: int):
    rng = np.random.default_rng(seed)
    return lambda: int.from_bytes(rng.bytes(64), "little") % ELL


@pytest.fixture(scope="module")
def gens():
    return {n: TG.get_generators(n, "cpu") for n in (4, 8, 16, 32)}


@pytest.mark.parametrize("n,m", golden.SIZES)
def test_prove_writes_the_jax_blob(gens, n, m):
    """On the fixture's draws the port's ``aggregate.prove`` writes the JAX
    package's proof byte for byte, drawing as many scalars; the wire format
    round-trips and parses as the JAX package parses it."""
    ref = _load(golden.golden_path(n, m))
    feed = _feed(golden.from_rows(ref["rand"]))
    proof = TA.prove(golden.from_rows(ref["values"]),
                     golden.from_rows(ref["blindings"]), n, gens[n * m],
                     rand=feed)
    assert feed.count == len(ref["rand"]) == 2 * n * m + 4
    blob = ref["blob"].tobytes()
    assert TSER.serialize_aggregated_proof(proof) == blob
    back = TSER.deserialize_aggregated_proof(blob)
    assert back == proof
    jp = JSER.deserialize_aggregated_proof(blob)
    assert dataclasses.asdict(jp) == dataclasses.asdict(proof)
    assert JSER.serialize_aggregated_proof(jp) == blob


@pytest.mark.parametrize("n,m", golden.SIZES)
def test_verify_gives_the_jax_verdicts(gens, n, m):
    """Honest accepted; t_hat + 1, mu + 1, V swapped, V dropped, a round
    dropped, ip.n halved, m = 3 and undersized generators rejected: the
    JAX package's verdict on every case."""
    ref = _load(golden.golden_path(n, m))
    proof = TSER.deserialize_aggregated_proof(ref["blob"].tobytes())
    cases = golden.agg_cases(proof)
    assert list(cases) == ref["cases"].tolist()
    draw = _seeded(n * m)
    got = [TA.verify(p, gens[n * m // 2] if small else gens[n * m],
                     rand=draw)
           for p, small in cases.values()]
    assert got == ref["verify"].tolist()
    assert got[0] and not any(got[1:])


def test_batch_verify_gives_the_jax_verdicts(gens):
    """Four JAX host proofs: the batch accepted; one t_hat + 1, one round
    dropped or one of another n sinks it; one proof alone and no proof are
    accepted: the JAX package's verdict on every case."""
    ref = _load(golden.batch_path())
    proofs = [TSER.deserialize_range_proof(row.tobytes())
              for row in ref["blobs"]]
    cases = golden.batch_cases(proofs)
    assert list(cases) == ref["cases"].tolist()
    draw = _seeded(7)
    got = [TA.batch_verify(batch, gens[golden.BATCH_BITS], rand=draw)
           for batch in cases.values()]
    assert got == ref["verify"].tolist()


def test_refusals_and_helpers(gens):
    """The prover refuses m = 3, a value out of range and mismatched
    blindings; the sharded MSM (mesh=) is not ported and raises; the wire
    format refuses truncated, trailing and oversized input; ``_delta_agg``
    at m = 1 is the single proof's delta."""
    with pytest.raises(TR.ProveError):
        TA.prove([1, 2, 3], [1, 2, 3], 8, gens[32])
    with pytest.raises(TR.ProveError):
        TA.prove([1, 256], [1, 2], 8, gens[16])
    with pytest.raises(ValueError):
        TA.prove([1, 2], [1], 8, gens[16])
    with pytest.raises(ValueError, match="generators"):
        TA.prove([1, 2], [1, 2], 8, gens[8])
    ref = _load(golden.golden_path(8, 2))
    blob = ref["blob"].tobytes()
    proof = TSER.deserialize_aggregated_proof(blob)
    with pytest.raises(NotImplementedError):
        TA.verify(proof, gens[16], mesh=object())
    for bad in (blob[:-1], blob + b"\x00",
                blob[:4] + (1 << 21).to_bytes(4, "little") + blob[8:]):
        with pytest.raises(ValueError):
            TSER.deserialize_aggregated_proof(bad)
    short = dataclasses.replace(proof, A=proof.A[:31])
    with pytest.raises(ValueError):
        TSER.serialize_aggregated_proof(short)
    assert TA.verify(short, gens[16]) is False
    for y, z in ((3, 5), (ELL - 2, 12345)):
        assert TA._delta_agg(y, z, 8, 1) == TR.compute_delta(y, z, 8)


def test_curve_eq():
    """``curve.eq``: projective equality, true for the same point in other
    coordinates (Z = 1 and Z = 2), false for another point."""
    pts = [oracle.BASE, 2 * oracle.BASE, oracle.IDENTITY]
    p = TC.from_oracle(pts)
    two = TC.GE(*(c * 2 for c in p))          # (2X : 2Y : 2Z : 2T)
    assert TC.eq(p, two).tolist() == [True] * 3
    q = TC.from_oracle([2 * oracle.BASE, oracle.BASE, oracle.IDENTITY])
    assert TC.eq(p, q).tolist() == [False, False, True]


@pytest.mark.slow
def test_agg_fixtures_match_jax_live(tmp_path):
    """tests/make_agg_golden.py run anew (the unmodified JAX package) gives
    the committed fixtures."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import make_agg_golden "
            "as g; g.configure_jax(); g.write(__import__('pathlib').Path(%r))"
            % (str(TESTS), str(REPO), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=3600)
    assert out.returncode == 0, out.stderr[-4000:]
    paths = [golden.golden_path(n, m) for n, m in golden.SIZES]
    for path in paths + [golden.batch_path()]:
        live, ref = _load(tmp_path / path.name), _load(path)
        assert live.keys() == ref.keys()
        for key in ref:
            assert np.array_equal(live[key], ref[key]), (path.name, key)
