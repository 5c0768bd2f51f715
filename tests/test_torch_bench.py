"""The port's benchmarks on the CPU at tiny sizes: the functions of
``cudabulletproof_tpu_torch/benchmarks/bench_msm.py`` and
``cudabulletproof_tpu_torch/bench.py`` print the metrics of the JAX
package's ``benchmarks/bench_msm.py`` and ``bench.py`` (named without
"jnp", "pallas" or "tpu", with no ``vs_baseline``) and pass their checks:
the split-half MSM identity, every proof accepted, every MSM exact.  On the
CPU no device rate exists, so every roofline's speed of light is null.

What a CPU run times is the plain twins on the host, not the card; these
tests read no number but the checks.
"""
import json

import pytest
import torch

from cudabulletproof_tpu_torch import bench
from cudabulletproof_tpu_torch.benchmarks import bench_msm as BM
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _lines(capsys) -> list:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_field_and_msm_lines(capsys):
    """The device line, field mul (twin, then kernel) with rooflines, the
    inner product, and msm_auto at 16 points with its roofline and a
    passing split-half check, in the JAX script's order."""
    BM.device_line(CPU)
    BM.bench_field(CPU, n=300, iters=1)
    BM.bench_msm(CPU, [16], iters=1, warmup=0)
    out = _lines(capsys)
    assert out[0] == {"device": "cpu", "backend": "cpu"}
    names = [o.get("metric") or o.get("roofline") or o.get("check")
             for o in out[1:]]
    assert names == ["field_mul_plain_throughput", "field_mul",
                     "field_mul_kernel_throughput", "field_mul",
                     "field_inner_product_kernel",
                     "msm_points_per_sec_2e4", "msm_2e4",
                     "msm_split_half_2e4"]
    assert out[-1]["ok"] is True
    assert out[1]["batch"] == 300 and out[6]["window"] == BM.msm_window(16)
    for roof in (out[2], out[4], out[7]):
        assert roof["speed_of_light_per_sec"] is None
        assert roof["fraction_of_sol"] is None


def test_make_points_and_split_half_refusal(monkeypatch):
    """make_points gives k_i B with k_i = 1 + i * 0x9E3779B97F4A7C15 mod l
    (held against the oracle at 3 points); a wrong MSM fails the split-half
    check with an AssertionError."""
    from cudabulletproof_tpu_torch.ops import curve as C
    from cudabulletproof_tpu_torch.utils import oracle
    pts, sc = BM.make_points(3, CPU)
    want = [((1 + i * 0x9E3779B97F4A7C15) % oracle.ELL) * oracle.BASE
            for i in range(3)]
    assert C.to_oracle(pts) == want
    assert sc.shape == (3, 20)
    calls = []
    real = BM.M.msm_auto

    def off_by_base(p, s):          # the third call (one half) is wrong
        calls.append(1)
        out = real(p, s)
        return C.add(out, C.base_point()) if len(calls) == 3 else out
    monkeypatch.setattr(BM.M, "msm_auto", off_by_base)
    with pytest.raises(AssertionError, match="split-half"):
        BM.bench_msm(CPU, [4], iters=1, warmup=0)


def test_proof_lines(capsys):
    """The host prover and verifiers, an aggregated proof and a batch of
    single proofs (one, to keep the CPU's ladders few) at 2 bits: their
    latency lines, every proof accepted."""
    BM.bench_proofs(CPU, bits=2, m=1, value=2, batch_values=(3,),
                    iters=(1, 1, 1, 1, 1), warmup=0)
    out = _lines(capsys)
    assert [o["metric"] for o in out] == [
        "range_prove_2bit_latency", "range_verify_2bit_latency",
        "range_verify_fast_2bit_latency", "range_prove_fast_2bit_latency",
        "aggregated_verify_m1_n2_latency", "batch_verify_1_proofs_latency"]
    assert all(o["unit"] == "s" and o["value"] > 0 for o in out)
    assert not any("vs_baseline" in o for o in out)


def test_bench_record(capsys):
    """bench.py's record: the headline over verify_fast and the extras (a
    merged batch of 2, msm_auto at 16 points, exact), named for the CPU."""
    rec, proof, gens = bench.headline(CPU, bits=2, value=2, reps=1)
    assert rec["metric"] == "range_proof_verify_2bit_latency"
    assert rec["unit"] == "s" and "vs_baseline" not in rec
    extra = bench.extras(proof, gens, CPU, batch=2, reps=1,
                         msm_runs=(("2e4", 16, 1, 1),), prefix="cpu")
    assert sorted(extra) == ["cpu_batch2_verify_ms_per_proof",
                             "cpu_msm_2e4_points_per_sec",
                             "cpu_msm_window_bits"]
    assert extra["cpu_msm_window_bits"] == BM.msm_window(1 << 16)


def test_profiling_helpers(tmp_path):
    """utils/profiling.py: the bound is the larger of operations over the
    IMAD rate and bytes over the HBM rate; the rooflines count IMAD_MUL a
    multiply and Pippenger's (2n + 3 * 2^w) adds a window; without a rate
    the speed of light is null; ``timed`` returns seconds a call on the
    CPU; ``trace`` writes a profiler trace into its directory."""
    from cudabulletproof_tpu_torch.utils import profiling as PR
    assert PR.bound(16.73e9, 1, 16.73e12) == (1.0, "operations")
    assert PR.bound(0, 3.35e9, 16.73e12) == (1.0, "bytes")
    roof = PR.field_mul_roofline(1e9, PR.IMAD_MUL * 1e10)
    assert roof.speed_of_light_per_sec == 1e10 and roof.fraction == 0.1
    n, w = 1 << 16, 4
    adds = -(-253 // w) * (2 * n + 3 * (1 << w)) / n
    roof = PR.msm_roofline(1e6, n, w, adds * PR.IMAD_ADD * 1e7)
    assert roof.name == "msm_2e16" and abs(roof.fraction - 0.1) < 1e-12
    assert json.loads(PR.msm_roofline(1.0, n, w, None).to_json())[
        "fraction_of_sol"] is None
    assert PR.device_rate(CPU) is None
    assert PR.timed(torch.ones, 3, iters=2, device=CPU) > 0
    with PR.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir())


def test_group4_bench_work_and_build_dirs(monkeypatch, tmp_path):
    """bench_group4 counts the window ladder's work (267 doublings and 72
    adds a point) and the accumulator's (a mixed add per nonzero digit, the
    fold and the combine) as chip_smoke.py reports them, and refuses to run
    without a card; the build module names another checkout's library by
    its sources (the same sources, the same library)."""
    import shutil
    from cudabulletproof_tpu_torch.benchmarks import bench_group4 as G4
    from cudabulletproof_tpu_torch.utils import build
    from cudabulletproof_tpu_torch.utils.profiling import (
        IMAD_ADD, IMAD_DBL, IMAD_MADD)
    assert G4.ladder_work(402) == (402 * (267 * IMAD_DBL + 72 * IMAD_ADD),
                                   402 * (2 * 320 + 80))
    dg = torch.tensor([[0, 1, -8], [8, 0, 0]], dtype=torch.int32)
    imads, nbytes = G4.accum_work(dg, 3, 4)
    assert imads == (3 * IMAD_MADD + 2 * 2 * 8 * IMAD_ADD
                     + 2 * (4 * IMAD_DBL + IMAD_ADD))
    assert nbytes == 3 * 320 + 6 * 4 + 320
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert G4.main([]) == 1
    other = tmp_path / "csrc"
    shutil.copytree(build.CSRC, other)
    assert build.library_path(other) == build.library_path()
    assert [p.name for p in build.sources(other)] == [
        p.name for p in build.sources()]
    (other / "curve_kernels.cu").write_text("// edited\n")
    assert build.library_path(other) != build.library_path()
