"""The port's CLI (``cudabulletproof_tpu_torch/cli.py``, ``__main__.py``)
on the CPU (``BP_PLATFORM=cpu``), against the JAX package's CLI
(``cudabulletproof_tpu/cli.py``): the same scenario, flags and output
lines, with the device named as the port runs it.

The JAX CLI itself is not run here (its prover and verifier compile for
minutes on the CPU); its output lines are read from its source, and the
port's lines must contain them.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cudabulletproof_tpu import cli as JCLI
from cudabulletproof_tpu_torch import cli, config
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

REPO = Path(__file__).resolve().parents[1]
# fixed parts of the JAX CLI's output lines that the port prints as well
JAX_LINES = [
    "=== Positive test: prove ", "Proof generated in ",
    " (fused) verification:  ", "Native CPU verification:   ",
    "Device/native latency ratio: ", "=== Negative test: value ",
    "Prover refused out-of-range value: FAILED (CORRECT)",
    "Tampered-proof verification: ", "FAILED (CORRECT)",
    "=== Batch field-op microbenchmarks (", "Batch field ", " op/s)",
    '"all_tests"',
]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("BP_PLATFORM", "cpu")


def test_jax_lines_are_the_jax_clis():
    src = inspect.getsource(JCLI)
    for line in JAX_LINES:
        assert line in src, line


def test_positive_test(capsys):
    assert cli.positive_test(8, 42)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "=== Positive test: prove 42 in [0, 2^8) ==="
    assert out[1].startswith("Proof generated in ")
    assert out[2].startswith("CPU (fused) verification:  SUCCESS  [")
    assert out[3].startswith("Native CPU verification:   SUCCESS  [")
    assert out[4].startswith("Device/native latency ratio: ")
    assert not cli.positive_test(8, 256)            # out of range
    assert "Prover error: value out of range" in capsys.readouterr().out


def test_negative_test(capsys):
    assert cli.negative_test(8)
    assert capsys.readouterr().out.splitlines() == [
        "=== Negative test: value 256 = 2^8 ===",
        "Prover refused out-of-range value: FAILED (CORRECT)",
        "Tampered-proof verification: FAILED (CORRECT)"]


def test_field_microbench(capsys):
    cli.field_microbench(300)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "=== Batch field-op microbenchmarks (300 elements) ==="
    assert [ln[:18] for ln in out[1:]] == [
        "Batch field add   ", "Batch field mul   ", "Batch field square"]
    assert all(ln.endswith(" op/s)") for ln in out[1:])


def test_main_success_and_flags(capsys):
    assert cli.main(["--range-bits", "4", "--value", "7",
                     "--skip-microbench"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "=== Positive test: prove 7 in [0, 2^4) ==="
    assert "Prover refused out-of-range value: FAILED (CORRECT)" in out
    assert json.loads(out[-1]) == {"all_tests": "SUCCESS"}
    assert not any("microbenchmarks" in ln for ln in out)
    with pytest.raises(SystemExit):
        cli.main(["--range-bits", "x"])


def test_benchmark_runs_the_ports_bench(monkeypatch):
    """``--benchmark`` runs the port's ``benchmarks/bench_msm.py`` as
    ``__main__`` with no arguments of its own (as the JAX CLI runs its
    bench_msm.py) and returns its exit status; sys.argv is restored."""
    calls = []

    def fake_run(name, run_name, alter_sys):
        calls.append((name, run_name, list(sys.argv)))
        raise SystemExit(3 if len(calls) == 1 else None)
    monkeypatch.setattr("runpy.run_module", fake_run)
    argv = list(sys.argv)
    assert cli.main(["--benchmark"]) == 3
    assert cli.main(["--benchmark", "--range-bits", "8"]) == 0
    assert sys.argv == argv
    mod = "cudabulletproof_tpu_torch.benchmarks.bench_msm"
    assert calls == [(mod, "__main__", [mod])] * 2
    assert importlib.util.find_spec(mod) is not None


def test_main_failure_exits_1(capsys, monkeypatch):
    """A failed positive test makes the run FAILED with exit 1 (the negative
    test, run elsewhere, stands in as passed)."""
    monkeypatch.setattr(cli, "negative_test", lambda n: True)
    assert cli.main(["--range-bits", "8", "--value", "300",
                     "--skip-microbench"]) == 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "all_tests": "FAILED"}


def test_device_choice(monkeypatch):
    """BP_PLATFORM=cpu is the CPU; otherwise the card, and without one a
    RuntimeError, never the CPU; another platform name is refused."""
    assert cli.device() == torch.device("cpu")
    monkeypatch.delenv("BP_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="BP_PLATFORM=cpu"):
        cli.device()
    with pytest.raises(RuntimeError):
        cli.positive_test(8, 1)
    monkeypatch.setenv("BP_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        cli.device()
    assert config.DEFAULT_RANGE_BITS == 16


def test_python_dash_m_with_trace():
    """``python -m cudabulletproof_tpu_torch`` with BP_TRACE=1 logs the
    protocol's steps (``[bp] === PROOF GENERATION STEPS ===``) and ends in
    SUCCESS with exit 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(BP_PLATFORM="cpu", BP_TRACE="1", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "cudabulletproof_tpu_torch", "--range-bits",
         "4", "--value", "9", "--skip-microbench"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[bp] === PROOF GENERATION STEPS ===" in out.stderr
    assert "[bp] === PROOF VERIFICATION (fused) ===" in out.stderr
    assert out.stdout.splitlines()[-1] == '{"all_tests": "SUCCESS"}'
