"""Write the JAX package's host-transcript protocol as fixtures for the
port's tests.

    python tests/make_host_golden.py [n ...]        # default: 8 16 64

For each n, from ``numpy.random.default_rng(SEED + n)``, in this order: a
value in [0, 2^n), a blinding, the 2n + 4 scalars the host prover draws
(sL[0..n), sR[0..n), alpha, rho, tau1, tau2, in its order), then the inputs
of a standalone inner-product case (a, b, h_weights of length n and a
q_weight); every scalar uniform mod l.  Within this process only,
``cudabulletproof_tpu.utils.scalars.sc_random`` is replaced by a function
that hands out the prover's scalars in turn, and the unmodified
``models/rangeproof.py::prove`` writes the proof.  Saved as
``tests/golden/host_prove_n<n>.npz``, every scalar and point as 32 LE bytes:

    secret [2, 32]        value, blinding
    rand [2n+4, 32]       the prover's draws, in the order it drew them
    blob [len]            serialize_range_proof of the proof
    commit [32]           pedersen_commit(value, blinding), compressed
    cases [c]             names of the verdict cases: the blobs of
                          ``corruptions`` and "undersized generators" (the
                          honest proof against the generators of n / 2)
    verify, verify_det [c]  rangeproof.verify / verify_deterministic on each
    ipa_in [3n+1, 32]     a | b | h_weights | q_weight
    ipa_P [32]            P = <a, G> + <b o h_weights, H> + q <a, b> h
    ipa_proof [2k+2, 32]  ipa.prove(G, H, h, ...): L | R | a | b
    ipa_cases [4], ipa_verify [4]  ipa.verify on the honest proof and three
                          corrupted ones (see ``ipa_corruptions``)

Reads the JAX package and changes nothing in it; runs on the CPU backend
with the compile cache off.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20261017
GOLDEN = Path(__file__).resolve().parent / "golden"
P = (1 << 255) - 19
ELL = (1 << 252) + 27742317777372353535851937790883648493
IPA_LABEL = b"host-golden/ipa"
# (0, -1), of order 2, and y = p + 1, a non-canonical encoding of y = 1
SMALL_ORDER = (P - 1).to_bytes(32, "little")
NON_CANONICAL = (P + 1).to_bytes(32, "little")


# the verdict cases: the blobs of ``corruptions``, then the honest proof
# against the generators of n / 2
CASES = ("honest", "blob[40] ^ 1", "t_hat + 1", "taux + 1", "mu + 1",
         "ip.a * 2", "V = A", "A small order", "S non-canonical",
         "L0 small order", "R last non-canonical", "last round dropped")
UNDERSIZED = "undersized generators"


def golden_path(n: int) -> Path:
    return GOLDEN / f"host_prove_n{n}.npz"


def to_rows(ints) -> np.ndarray:
    return np.array([list(v.to_bytes(32, "little")) for v in ints],
                    dtype=np.uint8).reshape(-1, 32)


def from_rows(rows) -> list:
    return [int.from_bytes(bytes(r), "little") for r in np.asarray(rows)]


def draws(n: int) -> dict:
    """The fixture's secret, prover draws and inner-product inputs for n."""
    rng = np.random.default_rng(SEED + n)

    def scalar():
        return int.from_bytes(rng.bytes(64), "little") % ELL

    value = int.from_bytes(rng.bytes(8), "little") % (1 << n)
    secret = [value, scalar()]
    rand = [scalar() for _ in range(2 * n + 4)]
    ipa_in = [scalar() for _ in range(3 * n + 1)]
    return {"secret": secret, "rand": rand, "ipa_in": ipa_in}


def corruptions(blob: bytes, n: int) -> dict:
    """name -> wire bytes: the honest proof and corrupted copies (points
    replaced, scalars changed, a round dropped)."""
    k = n.bit_length() - 1
    V, A, S, T_HAT, TAUX, MU = 4, 36, 68, 228, 164, 196
    L0 = 264
    R_LAST = L0 + 64 * (k - 1) + 32
    A_IP = L0 + 64 * k

    def put(off, data):
        b = bytearray(blob)
        b[off:off + len(data)] = data
        return bytes(b)

    def scalar(off, f):
        v = int.from_bytes(blob[off:off + 32], "little")
        return put(off, (f(v) % ELL).to_bytes(32, "little"))

    flipped = bytearray(blob)
    flipped[40] ^= 1                        # the CLI's tamper (a bit of A)
    dropped = bytearray(blob[:260]) + (k - 1).to_bytes(4, "little") \
        + blob[L0:L0 + 64 * (k - 1)] + blob[A_IP:]
    edited = [
        bytes(blob),
        bytes(flipped),
        scalar(T_HAT, lambda v: v + 1),
        scalar(TAUX, lambda v: v + 1),
        scalar(MU, lambda v: v + 1),
        scalar(A_IP, lambda v: 2 * v),
        put(V, blob[A:A + 32]),
        put(A, SMALL_ORDER),
        put(S, NON_CANONICAL),
        put(L0, SMALL_ORDER),
        put(R_LAST, NON_CANONICAL),
        bytes(dropped),
    ]
    return dict(zip(CASES, edited, strict=True))


def ipa_corruptions(proof) -> dict:
    """name -> (proof, use P + h in place of P): the honest inner-product
    proof, a + 1, L0 and R0 swapped, and the honest proof against P + h."""
    swapped = dataclasses.replace(proof, L=[proof.R[0]] + list(proof.L[1:]),
                                  R=[proof.L[0]] + list(proof.R[1:]))
    return {"honest": (proof, False),
            "a + 1": (dataclasses.replace(proof, a=(proof.a + 1) % ELL), False),
            "L0 <-> R0": (swapped, False),
            "P + h": (proof, True)}


def ipa_statement(ipa_in: list, n: int):
    """(a, b, h_weights, q_weight, the scalars of P over G | H | h)."""
    a, b, hw = ipa_in[:n], ipa_in[n:2 * n], ipa_in[2 * n:3 * n]
    q = ipa_in[3 * n]
    c = sum(x * y for x, y in zip(a, b)) % ELL
    p_sc = a + [x * w % ELL for x, w in zip(b, hw)] + [c * q % ELL]
    return a, b, hw, q, p_sc


def jax_fixture(n: int) -> dict:
    """Run the unmodified JAX host protocol on the draws for n."""
    from cudabulletproof_tpu.models import ipa, rangeproof as rp
    from cudabulletproof_tpu.models.generators import get_generators
    from cudabulletproof_tpu.models.transcript import Transcript
    from cudabulletproof_tpu.ops import curve as C, msm as M
    from cudabulletproof_tpu.utils import scalars, serialization

    d = draws(n)
    gens = get_generators(n)
    feed = iter(d["rand"])
    original = scalars.sc_random
    scalars.sc_random = lambda: next(feed)
    try:
        proof = rp.prove(d["secret"][0], d["secret"][1], n, gens)
    finally:
        scalars.sc_random = original
    if next(feed, None) is not None:
        raise AssertionError("the prover drew fewer scalars than recorded")
    blob = serialization.serialize_range_proof(proof)
    commit = rp._compress(rp.pedersen_commit(d["secret"][0], d["secret"][1],
                                             gens))
    cases, ver, det = [], [], []
    for name, data in corruptions(blob, n).items():
        p = serialization.deserialize_range_proof(data)
        cases.append(name)
        ver.append(rp.verify(p, gens))
        det.append(rp.verify_deterministic(p, gens))
    small = get_generators(n // 2)
    cases.append(UNDERSIZED)
    ver.append(rp.verify(proof, small))
    det.append(rp.verify_deterministic(proof, small))

    G = C.GE(*(c[:n] for c in gens.G))
    H = C.GE(*(c[:n] for c in gens.H))
    a, b, hw, q, p_sc = ipa_statement(d["ipa_in"], n)
    P = M.msm_ints(M.concat_ge(G, H, gens.h), p_sc)
    ip = ipa.prove(G, H, gens.h, a, b, Transcript(IPA_LABEL), q_weight=q,
                   h_weights=hw)
    P2 = C.add(P, gens.h)
    ipa_cases, ipa_ver = [], []
    for name, (pr, shifted) in ipa_corruptions(ip).items():
        ipa_cases.append(name)
        ipa_ver.append(ipa.verify(G, H, gens.h, P2 if shifted else P, pr,
                                  Transcript(IPA_LABEL), q_weight=q,
                                  h_weights=hw))
    ip_rows = [*ip.L, *ip.R, ip.a.to_bytes(32, "little"),
               ip.b.to_bytes(32, "little")]
    return {
        "secret": to_rows(d["secret"]), "rand": to_rows(d["rand"]),
        "blob": np.frombuffer(blob, dtype=np.uint8),
        "commit": np.frombuffer(commit, dtype=np.uint8),
        "cases": np.array(cases), "verify": np.array(ver, dtype=bool),
        "verify_det": np.array(det, dtype=bool),
        "ipa_in": to_rows(d["ipa_in"]),
        "ipa_P": np.asarray(C.to_bytes(P)).astype(np.uint8),
        "ipa_proof": np.frombuffer(b"".join(ip_rows), dtype=np.uint8
                                   ).reshape(-1, 32),
        "ipa_cases": np.array(ipa_cases),
        "ipa_verify": np.array(ipa_ver, dtype=bool),
    }


def configure_jax() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)


def write(n: int, out_dir: Path = GOLDEN) -> Path:
    fx = jax_fixture(n)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / golden_path(n).name
    np.savez_compressed(path, **fx)
    return path


def main(argv) -> int:
    configure_jax()
    for n in [int(a) for a in argv] or [8, 16, 64]:
        t0 = time.perf_counter()
        path = write(n)
        print(f"n={n}: {path.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
