"""The port's sort-plus-scan MSM (``ops/pippenger.py::msm_pippenger``, its
segmented scan and bucket fold, ``ops/sort.py``, the ``MSM_ACCUM_KERNEL =
False`` routes of ``msm.msm_auto`` and ``fused._pippenger_rows``) against
the JAX package and the python-int oracle, on the CPU, where the port runs
its kernels' plain twins.

The JAX package's outputs are committed fixtures,
``tests/golden/pippenger.npz``, written by ``tests/make_pippenger_golden.py``
(its Pallas kernels in interpret mode compile for minutes here).  Held
against them:

* limb for limb, where the port mirrors the op order: ``seg_scan_plain``
  against ``pallas_curve.seg_scan`` (values and carries, runs straddling
  lanes) and ``bucket_fold_plain`` against ``pallas_curve.bucket_fold``;
* integer for integer: ``sort.grouping_order`` against
  ``pallas_sort.grouping_order``;
* as compressed bytes: ``msm_pippenger`` against the JAX package's, through
  the Pallas kernels (n = 32, 8 lanes) and through its XLA scan (n = 4096).

Against the oracle sum: ``msm_pippenger`` on runs that straddle lanes and
on one run over every lane, ``msm_auto`` with the accumulator off, and
merged ``fused.batch_verify`` through the sort-plus-scan route.  The one
``slow`` test rebuilds the fixtures live and compares.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import make_pippenger_golden as golden
from cudabulletproof_tpu import config as jax_config
from cudabulletproof_tpu_torch import config
from cudabulletproof_tpu_torch.models import fused as TFU
from cudabulletproof_tpu_torch.models.generators import get_generators
from cudabulletproof_tpu_torch.ops import (cuda_curve, cuda_sort, curve as TC,
                                           field as TF, msm as TM,
                                           pippenger as TP, sort as TSO)
from cudabulletproof_tpu_torch.utils import native, oracle
from cudabulletproof_tpu_torch.utils.serialization import (
    deserialize_range_proof, serialize_range_proof)
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

ELL = oracle.ELL
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref() -> dict:
    with np.load(golden.GOLDEN) as f:
        return {k: f[k] for k in f.files}


def _oracle_sum(points, scalars):
    acc = oracle.IDENTITY
    for p, k in zip(points, scalars):
        acc = acc + k * p
    return acc


def _compressed(p: TC.GE) -> bytes:
    return bytes(TC.to_bytes(p).tolist())


# --- the twins against the Pallas kernels (fixtures) -------------------------
@pytest.mark.parametrize("depth,lanes", golden.SCAN_SHAPES)
def test_seg_scan_twin_matches_pallas(ref, depth, lanes):
    key = f"scan_{depth}x{lanes}"
    ht = ref[f"{key}_ht"]
    heads = ht[:, 0, :].T.reshape(-1)
    assert heads[0] and not heads.all()
    assert (~heads.reshape(lanes, depth)[1:, 0]).any()   # a run straddles
    vals, carry = TP.seg_scan(torch.from_numpy(ref[f"{key}_pt"]),
                              torch.from_numpy(ht))
    assert np.array_equal(vals.numpy(), ref[f"{key}_out"])
    assert np.array_equal(carry.numpy(), ref[f"{key}_carry"])


@pytest.mark.parametrize("m,lanes", golden.FOLD_SHAPES)
def test_bucket_fold_twin_matches_pallas(ref, m, lanes):
    key = f"fold_{m}x{lanes}"
    got = TP.bucket_fold(torch.from_numpy(ref[f"{key}_body"]), lanes)
    assert np.array_equal(got.numpy(), ref[f"{key}_out"])


@pytest.mark.parametrize("n,w,bits", [
    (n, w, b) for n in golden.ORDER_SIZES for w in golden.ORDER_WINDOWS
    for b in golden.ORDER_BITS])
def test_grouping_order_matches_jax(ref, n, w, bits):
    key = f"order_{n}_{w}_{bits}"
    digits = torch.from_numpy(ref[f"{key}_digits"])
    got = TSO.grouping_order(digits, w, bits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref[f"{key}_out"])
    assert torch.equal(got.long(), torch.argsort(digits, stable=True))


def test_sort_twins_skewed_and_out_of_range_keys():
    """All keys equal, two values, and keys outside [0, radix) (uncounted,
    rank 0, as in the Pallas kernels)."""
    rng = np.random.default_rng(3)
    for k in (np.full(2048, 5), rng.choice([0, 9], size=2048),
              rng.integers(-2, 18, size=2048)):
        kb = torch.from_numpy(k.astype(np.int32).reshape(2, 8, 128))
        counts = TSO.hist_plain(kb, 16)
        valid = (k >= 0) & (k < 16)
        assert int(counts.sum()) == int(valid.sum())
        flat = counts.reshape(-1)
        base = (torch.cumsum(flat, 0) - flat).reshape(16, 8, 128).int()
        r = TSO.rank_plain(kb, base, 16).reshape(-1).numpy()
        assert (r[~valid.reshape(-1)] == 0).all()
        assert sorted(r[valid.reshape(-1)]) == list(range(int(valid.sum())))


def _split_sort_model(keys: torch.Tensor, radix: int, warps: int):
    """sort_hist and sort_rank as the kernels split each slot's rows, in
    plain torch (no JAX): `warps` contiguous chunks of ceil(nblk / warps)
    rows (the last uneven or empty); phase 1 counts each chunk; the counts
    are their sum; phase 2 starts each chunk's counter of each value at
    base plus the counts of the chunks before it; phase 3 walks the chunks
    in step, as the warps do, each key taking its counter and adding one.
    A key outside [0, radix), and the padding past the last row, go to a
    spare counter and get rank 0.  Returns (counts, base, rank)."""
    nblk = keys.shape[0]
    chunk = -(-nblk // warps)
    k = torch.full((warps * chunk, TSO.BLOCK), radix, dtype=torch.int64)
    k[:nblk] = keys.reshape(nblk, TSO.BLOCK)
    valid = (k >= 0) & (k < radix)
    k = torch.where(valid, k, radix).reshape(warps, chunk, TSO.BLOCK)
    cnt = torch.zeros((warps, radix + 1, TSO.BLOCK), dtype=torch.int64)
    cnt.scatter_add_(1, k, torch.ones_like(k))
    counts = cnt.sum(0)[:radix]
    flat = counts.reshape(-1)
    base = (flat.cumsum(0) - flat).reshape(radix, TSO.BLOCK)
    cnt = cnt.cumsum(0) - cnt
    cnt[:, :radix] += base
    rank = torch.zeros_like(k)
    w = torch.arange(warps)[:, None]
    col = torch.arange(TSO.BLOCK)
    for j in range(chunk):
        kt = k[:, j]
        rank[:, j] = cnt[w, kt, col]
        cnt[w, kt, col] += 1
    rank = torch.where(valid, rank.reshape(-1, TSO.BLOCK), 0)[:nblk]
    shape = (TSO.SUB, TSO.LN)
    return (counts.to(torch.int32).reshape(radix, *shape),
            base.to(torch.int32).reshape(radix, *shape),
            rank.to(torch.int32).reshape(nblk, *shape))


# (rows of 1024 keys, radix, keys): no rows, one, three, 64 (2^16 keys)
# and 1024 (2^20); radix 1, 2, 128 and 256; random keys, all equal, two
# values, and keys of -1 and radix among them
SPLIT_CASES = [(0, 1, "random"), (0, 256, "random"), (1, 1, "equal"),
               (1, 2, "two"), (1, 128, "random"), (1, 256, "out"),
               (3, 1, "equal"), (3, 2, "out"), (3, 128, "random"),
               (3, 256, "two"), (3, 256, "out"), (64, 1, "out"),
               (64, 128, "random"), (64, 2, "equal"), (64, 2, "out"),
               (1024, 2, "random")]


@pytest.mark.parametrize("nblk,radix,keys", SPLIT_CASES)
def test_split_rows_give_the_twins_counts_and_ranks(nblk, radix, keys):
    """The invariant that lets the sort kernels spread a slot over warps:
    whatever chunks a slot's rows are split into (one, three with an
    uneven last or empty ones, eight), counting each chunk and starting
    each from base plus the earlier chunks' counts gives hist_plain's
    counts and rank_plain's ranks."""
    rng = np.random.default_rng(nblk * 1000 + radix)
    n = nblk * 1024
    k = {"random": lambda: rng.integers(0, radix, size=n),
         "equal": lambda: np.full(n, radix - 1),
         "two": lambda: rng.choice([0, radix - 1], size=n),
         "out": lambda: rng.integers(-1, radix + 1, size=n)}[keys]()
    kb = torch.from_numpy(k.astype(np.int32).reshape(nblk, 8, 128))
    want = TSO.hist_plain(kb, radix)
    flat = want.reshape(-1)
    base = (torch.cumsum(flat, 0) - flat).to(torch.int32).reshape(radix, 8,
                                                                   128)
    want_rank = TSO.rank_plain(kb, base, radix)
    for warps in (1, 3, 8):
        counts, got_base, rank = _split_sort_model(kb, radix, warps)
        assert torch.equal(counts, want)
        assert torch.equal(got_base, base)
        assert torch.equal(rank, want_rank), warps


@pytest.mark.parametrize("keys", ["equal", "two"])
@pytest.mark.parametrize("nblk", [1, 4096, (1 << 16) - 1])
def test_packed_counter_prefix_never_carries(nblk, keys):
    """sort_rank's phase 2 takes the prefix over its 16 chunks of two
    16-bit counters (neighbouring slots) in one 32-bit word: below 2^16
    rows no count or prefix reaches 2^16, so the packed sums equal each
    counter's own prefix, all equal keys (the largest counts) included."""
    chunks, slots, radix = 16, 16, 2
    rng = np.random.default_rng(nblk)
    k = (np.zeros((nblk, slots), np.int64) if keys == "equal"
         else rng.integers(0, radix, size=(nblk, slots)))
    chunk = -(-nblk // chunks)
    cnt = np.stack([np.stack([(k[c * chunk:(c + 1) * chunk] == v).sum(0)
                              for v in range(radix)])
                    for c in range(chunks)])             # [chunks, radix, slots]
    want = np.cumsum(cnt, 0) - cnt
    words = cnt.astype(np.uint16).reshape(chunks, -1).view(np.uint32)
    got = np.empty_like(words)
    run = np.zeros_like(words[0])
    for c in range(chunks):
        got[c] = run
        run = run + words[c]
    got = got.view(np.uint16).reshape(cnt.shape)
    assert want.max() < 1 << 16
    assert np.array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("kernel", ["hist", "rank"])
def test_sort_wrappers_refuse_other_devices(monkeypatch, kernel, device):
    """The CUDA wrappers take CUDA tensors only: CPU and meta keys raise
    before any launch, with no fallback; the dispatchers in ops/sort.py
    hand CPU tensors to the twins without loading the kernel library."""
    keys = torch.zeros((2, 8, 128), dtype=torch.int32, device=device)
    base = torch.zeros((4, 8, 128), dtype=torch.int32, device=device)
    args = (keys, 4) if kernel == "hist" else (keys, base, 4)
    before = dict(cuda_sort.launches)

    def no_library(*_):
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(cuda_sort.build, "launch", no_library)
    with pytest.raises(ValueError, match="need a CUDA tensor"):
        getattr(cuda_sort, kernel)(*args)
    assert cuda_sort.launches == before
    if device == "cpu":
        twin = TSO.hist_plain if kernel == "hist" else TSO.rank_plain
        assert torch.equal(getattr(TSO, kernel)(*args), twin(*args))


@pytest.mark.parametrize("n,w,lanes,distinct", golden.MSM_CASES)
def test_msm_pippenger_matches_jax(ref, monkeypatch, n, w, lanes, distinct):
    """The JAX package's msm_pippenger result as compressed bytes, and the
    oracle's."""
    if lanes is not None:
        monkeypatch.setattr(config, "MSM_SCAN_LANES", lanes)
    pts = ref[f"msm{n}_points"]
    sc = ref[f"msm{n}_scalars"]
    want = bytes(ref[f"msm{n}_bytes"].tolist())
    ints = [sum(int(v) << (13 * i) for i, v in enumerate(r)) for r in sc]
    base = TC.to_oracle(TC.unflatten(torch.from_numpy(pts)))
    total = [0] * distinct
    for i, k in enumerate(ints):
        total[i % distinct] += k
    assert _oracle_sum(base, total).compress() == want
    p = TC.unflatten(torch.from_numpy(pts[np.arange(n) % distinct]))
    assert _compressed(TP.msm_pippenger(p, torch.from_numpy(sc), w=w)) == want


# --- the glue against the oracle ---------------------------------------------
@pytest.mark.parametrize("case", ["straddle", "one_run", "unchunked"])
def test_msm_pippenger_matches_oracle(monkeypatch, case):
    """Runs of equal digits that straddle lanes (64 points, 16 lanes of 4,
    w = 4: ~4 points a bucket); every scalar equal (one run over all the
    lanes in every window: the carry crosses them all); and the unchunked
    scan (24 points, not a multiple of the lanes)."""
    monkeypatch.setattr(config, "MSM_SCAN_LANES", 16)
    rng = np.random.default_rng(21)
    n = 24 if case == "unchunked" else 64
    pts = [oracle.hash_to_point(b"pip", i % 16) for i in range(n)]
    if case == "one_run":
        sc = [0x1234567 << 200] * n
    else:
        sc = [0, 1, ELL - 1] + [int.from_bytes(rng.bytes(32), "little") % ELL
                                for _ in range(n - 3)]
    got = TP.msm_pippenger(TC.from_oracle(pts), TF.from_ints(sc), w=4)
    assert TC.to_oracle(got) == [_oracle_sum(pts, sc)]


def _spy(monkeypatch, mod, name: str) -> list:
    """Record (points, w or None) of every call of mod.name."""
    calls = []
    orig = getattr(mod, name)

    def spy(points, scalars, *args, **kwargs):
        w = kwargs.get("w", args[0] if args else None)
        calls.append((scalars.shape[0], w))
        return orig(points, scalars, *args, **kwargs)
    monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("n,calls", [(24, [(24, 4)]), (12, [(8, 4)] * 2)])
def test_msm_auto_accum_off_matches_oracle(monkeypatch, n, calls):
    """With MSM_ACCUM_KERNEL off and the thresholds lowered: one
    msm_pippenger at msm_window_for(n) bits up to MSM_CHUNK points, chunks
    of MSM_CHUNK (the last padded) above; never the accumulator."""
    monkeypatch.setattr(config, "MSM_ACCUM_KERNEL", False)
    monkeypatch.setattr(config, "MSM_LADDER_MAX", 4)
    monkeypatch.setattr(config, "MSM_PIPPENGER_MIN", 8)
    monkeypatch.setattr(config, "MSM_CHUNK", 8 if n == 12 else 32)
    monkeypatch.setattr(config, "MSM_SCAN_LANES", 4)
    pip = _spy(monkeypatch, TP, "msm_pippenger")
    acc = _spy(monkeypatch, TP, "msm_accum")
    rng = np.random.default_rng(n)
    pts = [oracle.hash_to_point(b"auto-off", i) for i in range(n)]
    sc = [int.from_bytes(rng.bytes(32), "little") % ELL for _ in range(n)]
    got = TM.msm_auto(TC.from_oracle(pts), TF.from_ints(sc))
    assert TC.to_oracle(got) == [_oracle_sum(pts, sc)]
    assert pip == calls and acc == []


def test_knobs_read_at_call_time(monkeypatch):
    """MSM_ACCUM_KERNEL picks msm_auto's bucket MSM and the fused
    threshold at each call (on by default: the accumulator routes of the
    port as they were); MSM_PALLAS_SORT picks the grouping at each call."""
    assert config.MSM_ACCUM_KERNEL is True
    assert config.MSM_PALLAS_SORT is False
    assert TFU._fused_msm_min() == config.FUSED_ACCUM_MIN == 2048
    monkeypatch.setattr(config, "MSM_LADDER_MAX", 4)
    monkeypatch.setattr(config, "MSM_PIPPENGER_MIN", 8)
    pip = _spy(monkeypatch, TP, "msm_pippenger")
    acc = _spy(monkeypatch, TP, "msm_accum")
    pts = TC.from_oracle([oracle.hash_to_point(b"knob", i) for i in range(8)])
    sc = TF.from_ints(list(range(1, 9)))
    want = TC.to_oracle(TM.msm_auto(pts, sc))
    assert (acc, pip) == ([(8, None)], [])
    monkeypatch.setattr(config, "MSM_ACCUM_KERNEL", False)
    assert TFU._fused_msm_min() == config.FUSED_PIPPENGER_MIN == 16384
    assert TC.to_oracle(TM.msm_auto(pts, sc)) == want
    assert (acc, pip) == ([(8, None)], [(8, 4)])

    grouped = []
    orig = TSO.grouping_order

    def spy(digits, w, *args):
        grouped.append((digits.shape[0], w))
        return orig(digits, w, *args)
    monkeypatch.setattr(TSO, "grouping_order", spy)
    d = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32, size=1024, dtype=np.int32))
    assert torch.equal(TP._digit_order(d, 5), torch.argsort(d, stable=True))
    assert grouped == []
    monkeypatch.setattr(config, "MSM_PALLAS_SORT", True)
    assert torch.equal(TP._digit_order(d, 5), torch.argsort(d, stable=True))
    assert grouped == [(1024, 5)]
    assert torch.equal(TP._digit_order(d[:1000], 5),      # not 1024 | n
                       torch.argsort(d[:1000], stable=True))
    assert grouped == [(1024, 5)]


def test_window_for_matches_jax():
    """The scan branch of the JAX package's cost model, an operation
    count: 9 at 2^12, 11 at 2^14 and 2^15, 13 at 2^16."""
    assert [config.msm_window_for(1 << k) for k in (12, 14, 15, 16)] == [
        9, 11, 11, 13]
    for k in range(4, 21):
        assert config.msm_window_for(1 << k) == jax_config.msm_window_for(
            1 << k)
    assert (config.MSM_CHUNK, config.MSM_SCAN_LANES,
            config.MSM_PALLAS_SORT_BITS, config.FUSED_PIPPENGER_MIN) == (
        jax_config.MSM_CHUNK, jax_config.MSM_SCAN_LANES,
        jax_config.MSM_PALLAS_SORT_BITS, jax_config.FUSED_PIPPENGER_MIN)


@pytest.mark.skipif(not native.available(), reason="native library "
                    "unavailable")
def test_batch_verify_sort_scan_route(monkeypatch):
    """A merged batch of two native proofs at n = 4 (28 MSM bases, padded
    to 32) with the accumulator off and FUSED_PIPPENGER_MIN lowered, so the
    MSM is msm_pippenger at w = 4 (16 lanes: the chunked scan): honest
    accepted, one tampered rejected, as the native verifier says."""
    monkeypatch.setattr(config, "MSM_ACCUM_KERNEL", False)
    monkeypatch.setattr(config, "FUSED_PIPPENGER_MIN", 16)
    monkeypatch.setattr(config, "MSM_SCAN_LANES", 16)
    pip = _spy(monkeypatch, TP, "msm_pippenger")
    rng = np.random.default_rng(4)
    proofs = [deserialize_range_proof(native.prove_range(
        v, int.from_bytes(rng.bytes(32), "little"), 4)) for v in (3, 15)]
    gens = get_generators(4, device="cpu")
    weights = [5, 7, 11, 13]
    assert TFU.batch_verify(proofs, gens, rnd=weights)
    bad = [proofs[0], dataclasses.replace(proofs[1],
                                          t_hat=(proofs[1].t_hat + 1) % ELL)]
    assert not native.verify_range(serialize_range_proof(bad[1]))
    assert not TFU.batch_verify(bad, gens, rnd=weights)
    assert pip == [(32, 4)] * 2


def test_device_tensors_reach_the_wrappers(monkeypatch):
    """A tensor that is not on the CPU (``meta`` stands in for CUDA here)
    goes to the kernel wrapper, which refuses it, never to the twin."""
    def plain(*_):
        raise AssertionError("a plain twin was called for a device tensor")
    for mod, name in ((TP, "seg_scan_plain"), (TP, "bucket_fold_plain"),
                      (TSO, "hist_plain"), (TSO, "rank_plain")):
        monkeypatch.setattr(mod, name, plain)
    before = {**cuda_curve.launches, **cuda_sort.launches}
    meta = torch.empty((2, 80, 4), dtype=torch.int32, device="meta")
    keys = torch.empty((1, 8, 128), dtype=torch.int32, device="meta")
    for call in (lambda: TP.seg_scan(meta, meta[:, :1]),
                 lambda: TP.bucket_fold(meta[0].T, 4),
                 lambda: TSO.hist(keys, 4),
                 lambda: TSO.rank(keys, keys.expand(4, 8, 128), 4)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert {**cuda_curve.launches, **cuda_sort.launches} == before
    with pytest.raises(ValueError, match="multiple of 1024"):
        TSO.grouping_order(torch.zeros(1000, dtype=torch.int32), 5)


# --- the live comparison with the JAX package (slow) -------------------------
@pytest.mark.slow
def test_fixture_matches_live_jax(ref, tmp_path):
    """Rebuild the fixture with the JAX package (Pallas interpret mode, in
    a child process) and compare every array with the committed one."""
    dst = tmp_path / "pippenger.npz"
    script = TESTS / "make_pippenger_golden.py"
    out = subprocess.run([sys.executable, str(script), str(dst)], cwd=REPO,
                         capture_output=True, text=True, timeout=3600)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(dst) as f:
        assert sorted(f.files) == sorted(ref)
        for k in f.files:
            assert np.array_equal(f[k], ref[k]), k
