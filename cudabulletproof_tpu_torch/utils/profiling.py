"""Roofline model and profiling helpers of the port, the H100 counterpart
of ``cudabulletproof_tpu/utils/profiling.py`` (``Roofline`` :45,
``field_mul_roofline`` :67, ``msm_roofline`` :72, ``trace`` :86, ``timed``
:95).

The speed of light is the card's own, read on the card: 64 int32
multiply-adds (IMAD) a clock on each SM (CUDA C++ Programming Guide,
throughput of arithmetic instructions, compute capability 9.0) times the
SMs times the maximum SM clock ``nvidia-smi`` reports, and HBM3 at
3.35 TB/s (NVIDIA's H100 SXM data sheet).  An operation's cost is its
int32 multiply-adds as the port's kernels compute it (``IMAD_*``): the limb
products (400 for a multiply, 210 for a square), the 38 fold products x608
and the 3 relaxation carries x608; additions and masks are not counted.
Off the card there is no rate: ``imad_per_s`` raises, and a roofline built
without one reports its speed of light as null ("not measured").
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import time
from dataclasses import dataclass

import torch

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
IMAD_MUL = 400 + 38 + 3
IMAD_SQ = 210 + 38 + 3
IMAD_ADD = 9 * IMAD_MUL                       # unified point add
IMAD_DBL = 4 * IMAD_SQ + 4 * IMAD_MUL         # dedicated doubling
IMAD_MADD = 7 * IMAD_MUL                      # mixed add of the accumulator
IMAD_INNER = 400                              # limb products an element
# a radix-2^16 multiply (ops/radix16.py): two banks of 256 limb products,
# 31 fold products, the double wrap (2) and 3 relaxation carries x38
IMAD_R16 = 2 * 256 + 31 + 2 + 3
FE_BYTES = 20 * 4                             # 80 B a field element
R16_BYTES = 16 * 4                            # 64 B a radix-2^16 element
PT_BYTES = 4 * FE_BYTES                       # 320 B a point row


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` answer for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def imad_per_s(device=None) -> tuple:
    """(the card's int32 IMAD rate, the max SM clock in MHz it rests on)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the IMAD rate is the card's")
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(
        device if device is not None else 0).multi_processor_count
    return IMAD_PER_CLOCK_PER_SM * sms * mhz * 1e6, mhz


def bound(imads: float, nbytes: float, rate: float) -> tuple:
    """(bound_ms, bound_by): the larger of operations over the IMAD rate and
    bytes over the HBM rate."""
    ops_ms = imads / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def device_rate(device: torch.device):
    """The IMAD rate of `device` if it is a card, else None."""
    return imad_per_s(device)[0] if device.type == "cuda" else None


@dataclass
class Roofline:
    name: str
    achieved_per_sec: float
    speed_of_light_per_sec: float | None     # None: no card, not measured

    @property
    def fraction(self) -> float | None:
        if self.speed_of_light_per_sec is None:
            return None
        return self.achieved_per_sec / self.speed_of_light_per_sec

    def to_json(self) -> str:
        sol = self.speed_of_light_per_sec
        frac = self.fraction
        return json.dumps({
            "roofline": self.name,
            "achieved_per_sec": round(self.achieved_per_sec, 1),
            "speed_of_light_per_sec": None if sol is None else round(sol, 1),
            "fraction_of_sol": None if frac is None else round(frac, 4),
        })


def field_mul_roofline(achieved_muls_per_sec: float,
                       rate: float | None) -> Roofline:
    """Field multiplies per second against rate / IMAD_MUL."""
    return Roofline("field_mul", achieved_muls_per_sec,
                    None if rate is None else rate / IMAD_MUL)


def msm_roofline(points_per_sec: float, n: int, w: int,
                 rate: float | None) -> Roofline:
    """Pippenger's count: about 2n + 3 * 2^w point adds a window over
    ceil(253 / w) windows, per point, each IMAD_ADD."""
    windows = -(-253 // w)
    adds_per_point = windows * (2 * n + 3 * (1 << w)) / n
    sol = None if rate is None else rate / (adds_per_point * IMAD_ADD)
    return Roofline(f"msm_2e{n.bit_length() - 1}", points_per_sec, sol)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(dirname: str):
    """torch.profiler trace of the CPU and the card, written as a Chrome
    trace into `dirname`."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(dirname)):
        yield


def timed(fn, *args, iters=5, device=None):
    """Mean seconds of fn(*args) over `iters` calls after one warm-up, the
    clock stopped after a device sync (`device`, default the card when
    there is one)."""
    dev = device or torch.device("cuda" if torch.cuda.is_available()
                                 else "cpu")
    fn(*args)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync(dev)
    return (time.perf_counter() - t0) / iters
