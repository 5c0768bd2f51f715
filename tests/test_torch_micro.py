"""The port's diagnostic microbenchmarks (``ops/micro.py`` and the scripts
``benchmarks/{bench_addrate,_accum_micro,_repro_accum3}.py`` of the port)
against the JAX package's root ``benchmarks/`` scripts.

The JAX kernels (``bench_addrate.chain_kernel``, ``_accum_micro.kernel``,
``_repro_accum3.kernel``) ran in Pallas interpret mode on the CPU into the
committed fixture ``tests/golden/micro.npz`` (``tests/make_micro_golden.py``
wrote it; the ``slow`` test here rebuilds it live and compares every
array), so tier-1 compiles no JAX.  Held, tolerance zero (integer limbs):

* the chain twin at every (op, pass pair) of the script's sweep, K = 4 on
  8 lanes, limb for limb, the timing-only pairs included (their limbs
  outgrow int32 and wrap as the JAX package's do);
* the (5, 2) chains against Python-int points and compressed bytes;
* the window twin at every variant of both scripts, at w = 2 and 3,
  limb for limb;
* the three scripts' ``main`` on the CPU (BP_PLATFORM=cpu) at tiny
  arguments, printing the JAX scripts' line formats;
* the dispatch and the wrappers' refusals.
"""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from cudabulletproof_tpu_torch.benchmarks import (_accum_micro as TA,
                                                  _repro_accum3 as TRP,
                                                  bench_addrate as TBA)
from cudabulletproof_tpu_torch.ops import (cuda_micro, curve as TC,
                                           micro as MC)
from cudabulletproof_tpu_torch.utils import oracle
import make_micro_golden as golden

GOLDEN = golden.GOLDEN


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fix() -> dict:
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_fixture_covers_every_case(fix):
    """The fixture holds every chain and window case the maker lists."""
    want = {f"chain_{op}_{mp}_{ap}" for op in MC.CHAIN_OPS
            for mp, ap in MC.PASS_PAIRS}
    for w in golden.WIN_WIDTHS:
        want |= {f"accum_{v}_w{w}" for v in MC.ACCUM_VARIANTS}
        want |= {f"repro_{v}_w{w}" for v in MC.REPRO_VARIANTS}
    assert want <= set(fix)
    assert (MC.PASS_PAIRS, MC.ACCUM_VARIANTS, MC.REPRO_VARIANTS) == (
        golden.PASS_PAIRS, golden.ACCUM_VARIANTS, golden.REPRO_VARIANTS)


@pytest.mark.parametrize("mp,ap", MC.PASS_PAIRS)
@pytest.mark.parametrize("op", MC.CHAIN_OPS)
def test_chain_matches_jax(fix, op, mp, ap):
    """chain_plain on the script's base-point block equals chain_kernel's
    output limb for limb; ``chain`` on a CPU tensor is the twin."""
    p = MC.rows_from_lanes(fix["chain_in"])
    k = int(fix["chain_k"])
    got = MC.chain_plain(p, op, k, mp, ap)
    assert np.array_equal(MC.lanes_from_rows(got), fix[f"chain_{op}_{mp}_{ap}"])
    assert torch.equal(MC.chain(p, op, k, mp, ap), got)


@pytest.mark.parametrize("op", MC.CHAIN_OPS)
def test_chain_52_matches_oracle(op):
    """The (5, 2) chain of K = 8 from B is (K + 1) B (add) or 2^K B (dbl),
    as points and as compressed bytes; K = 0 returns p."""
    k = 8
    scalar = k + 1 if op == "add" else 1 << k
    p = TC.flatten(TC.base_point((3,)))
    got = MC.chain(p, op, k)
    want = oracle.BASE * scalar
    assert TC.to_oracle(TC.unflatten(got)) == [want] * 3
    assert [bytes(r.tolist()) for r in TC.to_bytes_batch(TC.unflatten(got))] \
        == [want.compress()] * 3
    assert torch.equal(MC.chain(p, op, 0), p)


def _window_cases():
    for w in golden.WIN_WIDTHS:
        for v in MC.ACCUM_VARIANTS:
            yield "accum", v, w
        for v in MC.REPRO_VARIANTS:
            yield "repro", v, w


@pytest.mark.parametrize("script,variant,w", list(_window_cases()))
def test_window_matches_jax(fix, script, variant, w):
    """accum_window_plain on the fixture's points and digits equals the
    script's kernel limb for limb: lane 0, or every lane for nofold and
    sufonly (the JAX output's other lanes are zero padding)."""
    pt = MC.rows_from_lanes(fix[f"win_pt_w{w}"])
    dg = torch.from_numpy(fix[f"win_dg_w{w}"])
    jax_out = fix[f"{script}_{variant}_w{w}"]
    got = MC.accum_window(pt, dg, variant, MC.nb_for(w))
    assert torch.equal(got, MC.window_from_jax(jax_out, variant))
    if variant not in MC.LANE_VARIANTS:
        assert not jax_out[:, :, 1:].any()


def test_layout_round_trip():
    """rows_from_lanes and lanes_from_rows are inverse transposes."""
    block = np.arange(2 * 3 * 80 * 4, dtype=np.int32).reshape(2, 3, 80, 4)
    rows = MC.rows_from_lanes(block)
    assert rows.shape == (2, 3, 4, 80) and int(rows[1, 2, 3, 5]) == \
        block[1, 2, 5, 3]
    assert np.array_equal(MC.lanes_from_rows(rows), block)


def _lines(main, argv, monkeypatch) -> list:
    monkeypatch.setenv("BP_PLATFORM", "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_bench_addrate_lines(monkeypatch):
    """The port's bench_addrate at K = 2 on 4 lanes: the header, then the
    JAX script's sweep lines (add, dbl, the four relax pairs)."""
    lines = _lines(TBA.main, ["--k", "2", "--lanes", "4", "--reps", "1"],
                   monkeypatch)
    assert lines[0] == "backend=cpu  K=2 chained ops"
    pat = re.compile(r"(add |dbl ) lanes= +(\d+) mulpass=(\d) addpass=(\d)"
                     r"  +[\d.]+ ms  +[\d.]+ M ops/s")
    got = [pat.fullmatch(ln).groups() for ln in lines[1:]]
    assert got == [("add ", "4", "5", "2"), ("dbl ", "4", "5", "2")] + [
        ("add ", "4", str(mp), str(ap)) for mp, ap in MC.PASS_PAIRS[1:]]


def test_bench_addrate_gate_refuses_wrong_chain(monkeypatch):
    """A chain patched to be one op short fails the gate before any line
    is printed."""
    real = MC.chain
    monkeypatch.setattr(MC, "chain", lambda p, op, k, *a: real(p, op, k - 1,
                                                                *a))
    monkeypatch.setenv("BP_PLATFORM", "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(AssertionError, match="add chain of 8"):
        TBA.main(["--k", "1", "--lanes", "4"])
    assert buf.getvalue() == ""


def test_bench_addrate_checks_timed_output(monkeypatch):
    """A chain that goes wrong only past the gate's K fails the timed
    run's oracle check before its line is printed."""
    real = MC.chain
    monkeypatch.setattr(MC, "chain", lambda p, op, k, *a: real(
        p, op, k if k == TBA.GATE_K else k - 1, *a))
    monkeypatch.setenv("BP_PLATFORM", "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(AssertionError, match="add chain of 2 on 4 lanes"):
        TBA.main(["--k", "2", "--lanes", "4", "--reps", "1"])
    assert buf.getvalue() == "backend=cpu  K=2 chained ops\n"


def test_accum_micro_lines(monkeypatch):
    """The port's _accum_micro at w = 2, 8 lanes, unroll 2, n = 64 (four
    steps): one JAX-format line per variant."""
    lines = _lines(TA.main, [",".join(MC.ACCUM_VARIANTS), "2", "8", "2",
                             "--n", "64", "--reps", "1"], monkeypatch)
    pat = re.compile(r"VARIANT (\w+) w=2 lanes=8 u=2: [\d.]+ ms total "
                     r"\(65 win\)  [\d.]+ ms/window  [\d.]+ us/slot")
    assert [pat.fullmatch(ln).group(1) for ln in lines] == list(
        MC.ACCUM_VARIANTS)


def test_accum_micro_inputs():
    """The JAX script's inputs: limbs 3 / 1 / 5 at rows 0 / L / 2L, the
    digits of default_rng(0) in [-(nb - 1), nb - 1] in its shape."""
    pt, dg = TA.inputs(4, 8, 2, 64, torch.device("cpu"))
    assert pt.shape == (4, 2, 8, 80) and dg.shape == (65, 4, 2, 8)
    assert pt[..., [0, 20, 40]].unique().tolist() == [1, 3, 5]
    assert int(pt.sum()) == 4 * 2 * 8 * 9
    want = np.random.default_rng(0).integers(-8, 9, (65, 4, 2, 8))
    assert np.array_equal(dg.numpy(), want)


def test_repro_accum3_lines(monkeypatch):
    """The port's _repro_accum3 at the script's shape: the JAX line for
    three variants, each a plain run of the twin."""
    lines = _lines(TRP.main, ["full,nofold,nostep"], monkeypatch)
    assert lines == [f"VARIANT {v} OK (2, 80, 1024)"
                     for v in ("full", "nofold", "nostep")]


def test_refusals_and_dispatch():
    """Unknown ops, pass pairs and variants raise; the script's dead 'mul'
    branch raises; tensors that are not on the CPU (``meta`` stands in for
    CUDA) go to the wrappers, which refuse them, and so do CPU tensors
    handed to the wrappers; no launch is counted."""
    p = torch.zeros((2, 80), dtype=torch.int32)
    with pytest.raises(ValueError, match="'mul' branch"):
        MC.chain(p, "mul", 1)
    with pytest.raises(ValueError, match="passes"):
        MC.chain(p, "add", 1, 2, 2)
    pt = torch.zeros((1, 1, 2, 80), dtype=torch.int32)
    dg = torch.zeros((1, 1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        MC.accum_window(pt, dg, "bogus", 3)
    with pytest.raises(ValueError, match="needs"):
        MC.accum_window(pt, dg[0], "full", 3)
    before = dict(cuda_micro.launches)
    meta = torch.empty((2, 80), dtype=torch.int32, device="meta")
    for call in (lambda: MC.chain(meta, "add", 1),
                 lambda: MC.accum_window(pt.to("meta"), dg.to("meta"),
                                         "full", 3),
                 lambda: cuda_micro.chain(p, "add", 1, 5, 2),
                 lambda: cuda_micro.accum_window(pt, dg, "full", 3)):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="at most 17"):
        cuda_micro.accum_window(pt, dg, "full", 33)
    assert cuda_micro.launches == before


def test_bucket_storage_choice():
    """Shared memory while a block's 64 lanes of buckets fit (nb <= 11:
    w <= 4), else device memory (w = 5)."""
    assert cuda_micro.window_smem_bytes(9) == 64 * 9 * 320
    assert cuda_micro.uses_shared(MC.nb_for(4))
    assert cuda_micro.uses_shared(11)
    assert not cuda_micro.uses_shared(12)
    assert not cuda_micro.uses_shared(MC.nb_for(5))


@pytest.mark.slow
def test_fixture_rebuilds_live(tmp_path):
    """The JAX kernels in Pallas interpret mode, rebuilt now by
    make_micro_golden, equal the committed fixture array for array."""
    dst = tmp_path / "micro.npz"
    assert golden.main([str(dst), "--jobs", "4"]) == 0
    with np.load(dst) as new, np.load(GOLDEN) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            assert np.array_equal(new[k], old[k]), k
