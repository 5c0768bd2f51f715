#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cudabulletproof_tpu_torch) on one NVIDIA
GPU with sm_90a (H100).

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is nonzero):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile the port's CUDA kernels from csrc/ with nvcc, one
     process per source, all at once.
  3. kernels: each of the twenty-four kernels against its plain torch twin on
     the card, on inputs from a fixed numpy seed at the paths' shapes plus
     edge inputs; equality must be exact, limb for limb (tolerance 0:
     integer arithmetic).  fe_add / fe_sub at 1, 25 (the edge rows),
     255, 257 and 10,000 elements (the CLI's microbenchmark size, the one
     timed; their bound is 240 bytes an element over the HBM rate).  The sort-plus-scan kernels: ge_seg_scan at
     [depth 64, lanes 1024] (one window at 2^16, runs of equal digits that
     straddle lanes) and [32, 1024] (the B = 1024 batch's windows), and
     small shapes with all heads, no heads and a head at every lane start
     but one; ge_bucket_fold at 8191 and 2047 rows (w = 13 and 11) and
     fewer rows than lanes, with the identity, the base and the 8-torsion
     points among them; sort_hist / sort_rank at 2^16 keys with radix 64
     and 128 (the 6 + 7 bit passes of w = 13), random, all equal and two
     values.  fe_inner_product at 1, 255, 256, 257, 10,000, 33,068
     (tiles share the partial's columns from 32,768 on), 2^17 (the bound)
     and 2^16 (the bench's, timed), fe_inner_product_batched at B = 1, 3,
     16 with n = 300 and 4096: the partial sums (the wrappers, timed
     against ip_partial_plain) and the public functions' limbs after the
     combine, on random weak limbs with the edge rows among them; their
     bound is 160 bytes an element over the HBM rate (400 IMADs an element
     is less).  Kernel and twin times, at the last shape of each kernel:
     median of CUDA-event runs; the bound is the larger of the kernel's
     int32 multiply-adds over the card's IMAD rate and its bytes over the
     HBM rate; the sort kernels' library yardstick is a stable
     torch.argsort of the same keys.  The radix-2^16 kernels r16_mul and
     r16_sq at 1, 255, 257 and 2^16 elements (timed) and on every pair of
     the edge rows (zero, one, p - 1, every limb 2^16 + 38 or 0xFFFF), on
     random weak limbs in [0, 2^16 + 38]; the chains r16_mul_chain and
     fe_mul_chain at every (n, reps) of n = 1, 255, 257, 2^16 and reps = 0,
     1, 64 and on the edge pairs (for fe_mul_chain the 20-limb edge rows,
     every limb 8799 among them), the last, (2^16, 64), the bench's shape
     and the one timed; their bound is 548 (radix 16) or 441 (radix 13)
     IMADs a multiply over the IMAD rate for the chains and r16_mul /
     r16_sq's 3 / 2 x 64 bytes an element over the HBM rate.  The
     microbenchmark kernels: ge_add_chain at every op (add, dbl) and
     (mul_passes, add_passes) pair of bench_addrate's sweep, K = 16 on 256
     lanes (the base point and random weak rows; the timing-only pairs'
     limbs wrap modulo 2^32 in both), timed at add (5, 2), K = 64 on 2048
     lanes; ge_accum_window at each of its 13 variants at nw = 4, 2 steps,
     unroll 4, 1024 lanes, w = 4 (random weak points and digits), full,
     cached and tree at w = 5 (17 buckets, kept in device memory) and full
     with the buckets forced to device memory, timed at _accum_micro's
     defaults (65 windows of 2^16 points, w = 4), and once more, timed and
     logged, at _repro_accum3's shape and inputs; their bound is their
     IMADs (the chain's links; a mixed add per nonzero digit, the fold and
     the tree's unified adds) over the card's rate.  The two kernels on
     the four-lane group law: ge_ladder_win at 1, 3, 7, 8, 9 and 1024
     points (below, at and past its blocks of 8 points), the prover's
     counts and 147 and 402 (timed), its first rows the edge points
     against the edge scalars; ge_bucket_accum at 1000 points (a multiple
     of no K) for w = 4..8 with mixed, all-zero and all -2^(w-1) digits at
     threads 32 and 256 with slices 1 and 3, then at each
     MSM_ACCUM_PLAN entry, 4096 (timed) last.  fe_mul, fe_sq, fe_add,
     ge_add and ge_double also get, beside the one-call time, the time a
     launch over a run of 100 launches (CUDA events / count) and the
     profiler's device time of the kernel itself a launch.
  4. single verify, n = 64: native-library proofs are accepted, tampered
     ones rejected, every verdict equal to the native verifier's.
  5. merged batch verify, B = 16, n = 64 (the ladder MSM), and B = 128 and
     256 (2306 and 4482 MSM bases: the accumulator MSM), and with
     config.MSM_ACCUM_KERNEL off B = 1024 (17,538 bases, padded to 32,768:
     the sort-plus-scan msm_pippenger at w = 11): honest batches accepted, a
     batch with one tampered proof rejected, the native verifier agreeing
     on every proof.
  6. msm: msm_auto on bench.py's inputs (P_i = (i+1) B, s_i =
     SHA-256("bench%d" % i) mod l) at 2^10 (ladder + tile reduction), 2^11
     (Straus), 2^16 (accumulator) and 2^20 (16 accumulator chunks), each
     equal to (sum (i+1) s_i mod l) B as compressed bytes; the 2^16 result
     against the native library's MSM; points per second; and the sweep of
     the accumulator over w = 4..8 and three block shapes at 2^12, 2^13 and
     2^16, each result exact.  Then with config.MSM_ACCUM_KERNEL off (the
     sort-plus-scan route): msm_auto at 2^16 (one msm_pippenger, w = 13)
     and 2^20 (16 chunks and a fold), each equal to the same exact bytes
     and the 2^16 one to the native MSM; msm_pippenger at 2^16 under
     config.MSM_PALLAS_SORT (the counting-sort kernels), the same bytes;
     points per second of each; sort.grouping_order against a stable
     torch.argsort of one window's digits at 2^16.
  7. prove, n = 64: fused._prove on fixed inputs (the JAX package's n = 64
     fixture, tests/golden/prove_n64.npz: its generators, bits and
     randomness) under config.LADDER_WINDOW = 4 and = 0, each path counted
     from zero (the window ladder's kernel and not the binary one's, and the
     reverse); both blobs equal to the fixture's blob byte for byte; V, A and
     S equal to the python-int oracle's commitments; the proof accepted by
     the native verifier and by fused.verify, t_hat + 1 rejected by both;
     one verify under the binary ladder, counted, accepted as native
     accepts it.
  8. the CLI (python -m cudabulletproof_tpu_torch) in-process through
     cli.main, at its default --range-bits 16 and at 64: each must end in
     {"all_tests": "SUCCESS"} with exit 0.  The host-transcript prover
     (models/rangeproof.py) at n = 64, fed the randomness of the JAX
     package's fixture tests/golden/host_prove_n64.npz, must write its blob
     byte for byte; a proof with fresh randomness must pass
     rangeproof.verify, verify_deterministic, fused.verify and the native
     verifier, and a tampered copy must fail all four.
  9. the benchmarks, each its own process: ``python -m
     cudabulletproof_tpu_torch --benchmark``, ``python -m
     cudabulletproof_tpu_torch.benchmarks.bench_msm --big``, ``python -m
     cudabulletproof_tpu_torch.bench``, ``python -m
     cudabulletproof_tpu_torch.benchmarks.bench_radix16``, the three
     diagnostic scripts ``bench_addrate`` (its sweep at K = 4096),
     ``_accum_micro`` (its five variants at its defaults, the buckets in
     shared and then in device memory) and ``_repro_accum3`` (its nine
     variants), and ``bench_group4`` (ge_ladder_win at 147, 402 and 1024
     points, ge_bucket_accum at each plan entry with its combine's
     device time, each equal to its twin); each must exit 0 and print its
     lines (echoed with the
     card's name) with every check passed: the split-half MSM identities at
     2^16 and 2^20, every proof accepted, the bench's MSMs exact, both
     multiply chains equal to Python ints, the add and dbl chains equal to
     (K + 1) B and 2^K B and to their twins, every window equal to its twin
     (bench_radix16's, bench_addrate's and _accum_micro's times are logged
     beside their bounds).
 10. the main paths, counted: the launch counters are set to 0 before each
     path (one verify; a batch of 16; batches of 128 and 256; the four
     msm_auto sizes; with the accumulator off msm_auto at 2^16 and 2^20,
     msm_pippenger at 2^16 under MSM_PALLAS_SORT and the batch of 1024;
     phase 7's; the CLI at --range-bits 64; the bench, ``cli.main
     (["--benchmark"])`` in this process; the radix A/B,
     ``bench_radix16.main([])`` in this process, which must launch
     r16_mul_chain and fe_mul_chain and no other kernel) and read after it;
     every kernel but fe_sub, fe_inner_product_batched, r16_mul, r16_sq,
     ge_add_chain and ge_accum_window must launch on them (those six have
     no program path, in the JAX package either: they must launch in phase
     3).  Then wall times
     (fused.prove under each ladder, median of 3, with fresh randomness:
     the last proof of each must pass the native verifier; the host prover
     at n = 16 and 64, the host verifiers, fused.verify and the native
     verifier at n = 64, median of 3; the CLI's microbenchmark) and the
     torch profiler's view of one verify, one prove, one msm_auto at 2^16
     with the accumulator off, one host prove and one host verify at
     n = 64.
The line before the last is the card's name and power limit, the one
before it the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from cudabulletproof_tpu_torch import cli, config
from cudabulletproof_tpu_torch.models import fused, rangeproof as RP
from cudabulletproof_tpu_torch.models.generators import get_generators
from cudabulletproof_tpu_torch.benchmarks import _accum_micro as AM
from cudabulletproof_tpu_torch.benchmarks import bench_group4 as G4
from cudabulletproof_tpu_torch.ops import (cuda_curve, cuda_field,
                                           cuda_micro, cuda_radix16,
                                           cuda_sort)
from cudabulletproof_tpu_torch.ops import curve as C, field as F
from cudabulletproof_tpu_torch.ops import micro as MC
from cudabulletproof_tpu_torch.ops import msm as M, pippenger as PP
from cudabulletproof_tpu_torch.ops import radix16 as R16
from cudabulletproof_tpu_torch.ops import scalar_field as SC, sort as SO
from cudabulletproof_tpu_torch.utils import build, native, oracle
from cudabulletproof_tpu_torch.utils.profiling import (
    FE_BYTES, IMAD_ADD, IMAD_DBL, IMAD_INNER, IMAD_MADD, IMAD_MUL, IMAD_R16,
    IMAD_SQ, PT_BYTES, R16_BYTES, bound, imad_per_s, smi)
from cudabulletproof_tpu_torch.utils.serialization import (
    deserialize_range_proof, serialize_range_proof)

SEED = 20261016
N_BITS = 64
BATCH = 16
BIG_BATCHES = (128, 256)
# the merged batch that crosses config.FUSED_PIPPENGER_MIN with the
# accumulator off: 130 + 17 * 1024 = 17,538 bases
SCAN_BATCH = 1024
# shapes on the paths at n = 64: 17 proof points per proof, so 17 / 272
# field elements decompressed for B = 1 / 16; the MSM has 2n+2+17 = 147
# bases for one proof and 2n+2+16*17 = 402 for the merged batch of 16; the
# batches of 128 and 256 pad theirs to 4096 and 8192
FE_SHAPES = (17, 272)
PT_SHAPES = (147, 402)
# the prover's ladder calls at n = 64: V (2 points), T1|T2 (2 x 2), an IPA
# round's L|R (2 x 65), A|S (2 x 129)
PROVE_LADDER_SHAPES = (2, 4, 130, 258)
# the binary ladder's cases; the last (402, the merged batch of 16) is the
# one its record reports, as for the window ladder
LADDER_BIN_SHAPES = (1, 4096) + PROVE_LADDER_SHAPES + PT_SHAPES
# the window ladder's: counts below, at and past its blocks of 8 points,
# msm_auto's largest ladder (1024), the prover's, then 147 and 402
LADDER_WIN_SHAPES = (1, 3, 7, 8, 9, 1024) + PROVE_LADDER_SHAPES + PT_SHAPES
PROVE_GOLDEN = "tests/golden/prove_n64.npz"
PROVE_REPS = 3
INVERT_SHAPES = (1, 272, 4096)
REDUCE_SHAPES = (147, 256, 1000, 4096)
ACCUM_BASES = 4096
# the accumulator's edge cases: at 1000 points (a multiple of no K) every
# window width with mixed, all-zero and all -2^(w-1) digits, at threads 32
# and 256 with slices 1 and 3 (one pair a digit kind); then each plan entry
# at its size, the last (4096 at its plan) the one timed
ACCUM_EDGE_BASES = 1000
ACCUM_EDGE_SHAPES = {"mixed": (32, 3), "zero": (256, 1), "min": (256, 3)}
# kernels whose time a launch is also measured over a run of launches
# (their one-call time is mostly the host's): the CUDA-event time of the
# run over the count, and the profiler's device time of the kernel itself
# (by its __global__ name) a launch
RUN_TIMED = {"fe_mul": "fe_mul_kernel", "fe_sq": "fe_sq_kernel",
             "fe_add": "fe_add3_kernel", "ge_add": "ge_add_kernel",
             "ge_double": "ge_double_kernel"}
RUN_LAUNCHES = 100
MSM_SIZES = (1 << 10, 1 << 11, 1 << 16, 1 << 20)
SWEEP_SIZES = (1 << 12, 1 << 13, 1 << 16)
SWEEP_WINDOWS = (4, 5, 6, 7, 8)
SWEEP_POINTS_PER_BUCKET = (1, 4, 16)
NATIVE_MSM_SIZE = 1 << 16
NATIVE_MSM_TIMEOUT_S = 60
# the sort-plus-scan route: msm_auto sizes with the accumulator off, and
# the scan and fold shapes of its windows: [depth, lanes] of a window at
# 2^16 (w = 13) and of the batch of 1024 (32,768 bases, w = 11), the fold's
# 2^w - 1 rows in 128 lanes
SCAN_MSM_SIZES = (1 << 16, 1 << 20)
SCAN_SHAPES = ((32, 1024, 1 << 11), (64, 1024, 1 << 13))
FOLD_ROWS = (1, 100, 128, 2047, 8191)
SORT_KEYS = 1 << 16
# the field add / sub kernels: element counts, the last the CLI's
ADD_SHAPES = (1, 255, 257, 10_000)
# the inner products: element counts (the tile edges, 32,768 + 300 where
# tiles start to share the partial's columns, 2^17 the bound), the last,
# 2^16, the bench's and the one timed; (B, n) of the batched kernel, the
# last timed
IP_SHAPES = (1, 255, 256, 257, 10_000, 32_768 + 300, 1 << 17, 1 << 16)
IP_BATCHED_SHAPES = ((1, 300), (3, 300), (16, 300), (1, 4096), (3, 4096),
                     (16, 4096))
# the radix-2^16 kernels and both multiply chains: element counts (the
# last timed) and chain lengths; the bench's (n, reps) is the last case
R16_SHAPES = (1, 255, 257, 1 << 16)
CHAIN_REPS = (0, 1, 64)
# the microbenchmark kernels: the chain checked at every (op, pass pair) at
# K = 16 on 256 lanes (the base point, the script's input, in half of them,
# random weak rows in the rest), then timed at the add (5, 2) sweep point of
# 2048 lanes with K = 64 (the twin's time grows with K: ~8 ms a link;
# bench_addrate times the kernel at K = 4096);
# the window checked at every variant at nw = 4, 2 steps, unroll 4, 1024
# lanes, w = 4 (buckets in shared memory), then full, cached and tree at
# w = 5 (17 buckets: device memory) and full with the buckets forced to
# device memory at w = 4; timed at _accum_micro's defaults
MICRO_CHAIN = (16, 256)
MICRO_CHAIN_TIMED = (64, 2048)
MICRO_WINDOW = (4, 2, 4, 1024)                 # nw, steps, unroll, lanes
# the host-transcript protocol: the JAX package's host prover fixture, the
# CLI's runs, the host prover's timed sizes
HOST_GOLDEN = "tests/golden/host_prove_n{}.npz"
CLI_RUNS = ([], ["--range-bits", str(N_BITS)])
HOST_PROVE_BITS = (16, N_BITS)

KERNELS = [
    # name, source, TPU kernel it replaces
    ("fe_mul", "field_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_field.py:144"),
    ("fe_sq", "field_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_field.py:148"),
    ("fe_pow2523", "field_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_field.py:249"),
    ("fe_invert", "field_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_field.py:241"),
    ("fe_add", "field_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_field.py:152"),
    ("fe_sub", "field_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_field.py:156"),
    ("ge_add", "curve_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_curve.py:151"),
    ("ge_double", "curve_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_curve.py:156"),
    ("ge_ladder_win", "curve_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_curve.py:193"),
    ("ge_ladder_bin", "curve_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_curve.py:160"),
    ("ge_reduce", "curve_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_curve.py:610"),
    ("ge_bucket_accum", "accum_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_curve.py:468"),
    ("ge_seg_scan", "scan_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_curve.py:232"),
    ("ge_bucket_fold", "scan_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_curve.py:371"),
    ("sort_hist", "scan_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_sort.py:41"),
    ("sort_rank", "scan_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_sort.py:56"),
    ("fe_inner_product", "field_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_field.py:268"),
    ("fe_inner_product_batched", "field_kernels.cu",
     "cudabulletproof_tpu/ops/pallas_field.py:329"),
    ("r16_mul", "radix16_kernels.cu",
     "cudabulletproof_tpu/ops/radix16.py:142"),
    ("r16_sq", "radix16_kernels.cu",
     "cudabulletproof_tpu/ops/radix16.py:146"),
    ("r16_mul_chain", "radix16_kernels.cu",
     "cudabulletproof_tpu/ops/radix16.py:191"),
    ("fe_mul_chain", "field_kernels.cu", "benchmarks/bench_radix16.py:33"),
    ("ge_add_chain", "micro_kernels.cu", "benchmarks/bench_addrate.py:100"),
    ("ge_accum_window", "micro_window_kernels.cu",
     "benchmarks/_accum_micro.py:30, benchmarks/_repro_accum3.py:22"),
]
# kernels that no program path launches, in the JAX package either; each
# must launch in the kernel phase instead
NO_PATH = {"fe_sub": "none in the JAX package (only its tests call "
                     "pallas_field.sub)",
           "fe_inner_product_batched": "none in the JAX package (only its "
                                       "tests call "
                                       "pallas_field.inner_product_batched)",
           "r16_mul": "none in the JAX package (only tests/test_radix16.py "
                      "calls radix16.mul / sq)",
           "r16_sq": "none in the JAX package (only tests/test_radix16.py "
                     "calls radix16.mul / sq)",
           "ge_add_chain": "none in the JAX package either (a diagnostic "
                           "script: benchmarks/bench_addrate.py)",
           "ge_accum_window": "none in the JAX package either (diagnostic "
                              "scripts: benchmarks/_accum_micro.py, "
                              "benchmarks/_repro_accum3.py)"}


def log(*args):
    print(*args, flush=True)


def reset_counts():
    for mod in (cuda_field, cuda_curve, cuda_sort, cuda_radix16, cuda_micro):
        for k in mod.launches:
            mod.launches[k] = 0


def counts() -> dict:
    return {**cuda_field.launches, **cuda_curve.launches,
            **cuda_sort.launches, **cuda_radix16.launches,
            **cuda_micro.launches}


def accum_off(fn):
    """fn() with config.MSM_ACCUM_KERNEL off (the sort-plus-scan route),
    restored after it."""
    config.MSM_ACCUM_KERNEL = False
    try:
        return fn()
    finally:
        config.MSM_ACCUM_KERNEL = True


# --- 3. kernels against their twins ---------------------------------------
def raw_limbs(v: int) -> list:
    """Limbs of v < 2^260 without reduction mod p."""
    return [(v >> (F.W * i)) & F.MASK for i in range(F.L)]


def edge_fe() -> np.ndarray:
    rows = [[F.BOUND] * F.L, [F.MASK] * F.L, raw_limbs(0), raw_limbs(1),
            raw_limbs(2), raw_limbs(F.P - 1)]
    rows += [raw_limbs(v) for v in range(F.P, 1 << 255)]      # p .. 2^255-1
    return np.array(rows, dtype=np.int32)


def edge_r16() -> np.ndarray:
    """Radix-2^16 edge rows: 0, 1, p - 1, every limb 2^16 + 38 (the weak
    bound), every limb 0xFFFF."""
    rows = [R16.from_int(0), R16.from_int(1), R16.from_int(F.P - 1),
            [R16.BOUND16] * R16.L16, [R16.MASK16] * R16.L16]
    return np.array(rows, dtype=np.int32)


def edge_pairs(edge: np.ndarray) -> tuple:
    """(a, b) rows that pair every edge row with every edge row."""
    k = len(edge)
    return np.repeat(edge, k, axis=0), np.tile(edge, (k, 1))


def edge_points() -> np.ndarray:
    pts = [oracle.IDENTITY, oracle.BASE] + oracle.small_order_points()
    rows = [[v for c in (p.X, p.Y, p.Z, p.T) for v in raw_limbs(c)]
            for p in pts]
    rows.append([F.BOUND] * (4 * F.L))
    fe = edge_fe()
    for i in range(0, len(fe) - 3, 4):                        # edge coords
        rows.append(np.concatenate(fe[i:i + 4]).tolist())
    return np.array(rows, dtype=np.int32)


def edge_scalars() -> np.ndarray:
    vals = [0, 1, 2, oracle.ELL - 1, (1 << 253) - 1]
    rows = [raw_limbs(v) for v in vals] + [[F.MASK] * F.L]   # 2^260 - 1
    return np.array(rows, dtype=np.int32)


def cuda_median_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def seg_scan_adds(heads: np.ndarray, depth: int, lanes: int) -> int:
    """Unified adds of the segmented scan on these heads (sorted order):
    one per element that starts no segment, and one per lane of each
    cross-lane stage that merges (its run flag still 0)."""
    h = heads.reshape(lanes, depth)
    adds = int((~h).sum())
    f = h.any(axis=1)
    lane = np.arange(lanes)
    s = 1
    while s < lanes:
        adds += int(((lane >= s) & ~f).sum())
        f = np.where(lane >= s, f | np.roll(f, s), f)
        s *= 2
    return adds


def fold_work(m: int, lanes: int = 128) -> tuple:
    """(IMADs, bytes) of the bucket fold of m rows: two adds a padded row,
    the cross-lane scan, the carry's log2(depth) doublings a lane, one add a
    lane and the halving; the rows read once, one point written."""
    depth = cuda_curve.fold_depth(m, lanes)
    stages = sum(lanes - s for s in (1 << k for k in range(16))
                 if s < lanes)
    adds = 2 * depth * lanes + stages + lanes + lanes - 1
    dbls = (depth.bit_length() - 1) * lanes
    return adds * IMAD_ADD + dbls * IMAD_DBL, (m + 1) * PT_BYTES


def scan_operands(rng, dev, depth: int, lanes: int, heads: np.ndarray):
    """Weak-limb points [depth, 80, lanes] with the identity, the base and
    the 8-torsion points among them, and the head flags [depth, 1, lanes]
    of `heads` (in sorted order: element (j, l) is sorted element l * depth
    + j)."""
    n = depth * lanes
    rows = rng.integers(0, F.BOUND + 1, size=(n, 4 * F.L), dtype=np.int32)
    edge = edge_points()
    at = rng.choice(n, size=min(n, len(edge)), replace=False)
    rows[at] = edge[:len(at)]
    pt = rows.reshape(lanes, depth, 4 * F.L).transpose(1, 2, 0)
    ht = heads.reshape(lanes, depth).T[:, None, :].astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(pt)).to(dev),
            torch.from_numpy(np.ascontiguousarray(ht)).to(dev))


def sorted_heads(rng, n: int, values: int) -> np.ndarray:
    """The run starts of n sorted random digits below `values`."""
    d = np.sort(rng.integers(0, values, size=n))
    return np.concatenate([[True], d[1:] != d[:-1]])


def kernel_cases(rng, dev):
    """name -> list of (label, kernel call, plain call, IMADs, bytes[,
    library call]); the last case of each kernel is the one its JSON record
    reports."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand_fe(n):
        return rng.integers(0, F.BOUND + 1, size=(n, F.L), dtype=np.int32)

    def rand_pts(n):
        return rng.integers(0, F.BOUND + 1, size=(n, 4 * F.L), dtype=np.int32)

    def rand_scalars(n):
        vals = [int.from_bytes(rng.bytes(32), "little") % oracle.ELL
                for _ in range(n)]
        return np.array([raw_limbs(v) for v in vals],
                        dtype=np.int32).reshape(n, F.L)

    cases = {k[0]: [] for k in KERNELS}
    IP_OPERANDS.clear()
    for n in FE_SHAPES:
        a = t(np.concatenate([rand_fe(n), edge_fe()]))
        b = t(np.concatenate([rand_fe(n), edge_fe()[::-1]]))
        m = a.shape[0]
        cases["fe_mul"].append((n, lambda a=a, b=b: cuda_field.mul(a, b),
                                lambda a=a, b=b: F.mul_plain(a, b),
                                m * IMAD_MUL, 3 * m * FE_BYTES))
        cases["fe_sq"].append((n, lambda a=a: cuda_field.sq(a),
                               lambda a=a: F.sq_plain(a),
                               m * IMAD_SQ, 2 * m * FE_BYTES))
        cases["fe_pow2523"].append(
            (n, lambda a=a: cuda_field.pow2523(a),
             lambda a=a: F.pow2523_plain(a),
             m * (251 * IMAD_SQ + 11 * IMAD_MUL), 2 * m * FE_BYTES))
    for n in INVERT_SHAPES:
        a = t(np.concatenate([rand_fe(n), edge_fe()]))
        m = a.shape[0]
        cases["fe_invert"].append(
            (n, lambda a=a: cuda_field.invert(a),
             lambda a=a: F.invert_plain(a),
             m * (254 * IMAD_SQ + 11 * IMAD_MUL), 2 * m * FE_BYTES))
    def ladder_operands(n):
        """n rows and scalars: the edge points against the edge scalars,
        paired cyclically over the first (at most 2 x the edge points)
        rows, then random rows and scalars."""
        edge, esc = edge_points(), edge_scalars()
        k = min(n, 2 * len(edge))
        rows = np.concatenate([np.resize(edge, (k, 4 * F.L)),
                               rand_pts(n - k)])
        s = np.concatenate([np.resize(esc, (k, F.L)), rand_scalars(n - k)])
        return C.unflatten(t(rows)), t(s)

    for n in PT_SHAPES:
        p = C.unflatten(t(np.concatenate([rand_pts(n), edge_points()])))
        q = C.unflatten(t(np.concatenate([rand_pts(n), edge_points()[::-1]])))
        m = p.x.shape[0]
        cases["ge_add"].append((n, lambda p=p, q=q: cuda_curve.add(p, q),
                                lambda p=p, q=q: C.add_plain(p, q),
                                m * IMAD_ADD, 3 * m * PT_BYTES))
        cases["ge_double"].append((n, lambda p=p: cuda_curve.double(p),
                                   lambda p=p: C.double_plain(p),
                                   m * IMAD_DBL, 2 * m * PT_BYTES))
    for n in LADDER_WIN_SHAPES:
        ps, s = ladder_operands(n)
        cases["ge_ladder_win"].append(
            (n, lambda p=ps, s=s: cuda_curve.ladder(p, s),
             lambda p=ps, s=s: C.scalarmult_plain(p, s),
             *G4.ladder_work(n)))
    for n in LADDER_BIN_SHAPES:
        ps, s = ladder_operands(n)
        ms = s.shape[0]
        cases["ge_ladder_bin"].append(
            (n, lambda p=ps, s=s: cuda_curve.ladder_bin(p, s),
             lambda p=ps, s=s: C.scalarmult_bin_plain(p, s),
             ms * 2 * C.SCALAR_BITS * IMAD_ADD,
             ms * (2 * PT_BYTES + FE_BYTES)))
    for n in REDUCE_SHAPES:
        rows = np.concatenate([rand_pts(n - len(edge_points())),
                               edge_points()])
        p = C.unflatten(t(rng.permutation(rows)))
        tiles = -(-n // C.REDUCE_TILE)
        cases["ge_reduce"].append(
            (n, lambda p=p: cuda_curve.reduce_tiles(p),
             lambda p=p: C.reduce_tiles_plain(p),
             (n - tiles) * IMAD_ADD, (n + tiles) * PT_BYTES))
    def accum_case(label, n, dg, w, threads, slices):
        pre = t(rand_pts(n))
        cases["ge_bucket_accum"].append(
            (label, lambda pre=pre, dg=dg, w=w, th=threads, sl=slices:
                 cuda_curve.bucket_accum(pre, dg, w, th, sl),
             lambda pre=pre, dg=dg, w=w, th=threads, sl=slices:
                 PP.bucket_accum_plain(pre, dg, w, th, sl),
             *G4.accum_work(dg, n, w)))

    def accum_scalars(n):
        return t(np.concatenate([rand_scalars(n - len(edge_scalars())),
                                 edge_scalars()]))

    sc = accum_scalars(ACCUM_EDGE_BASES)
    for w in range(4, 9):
        mixed = PP.extract_digits_signed(sc, w)
        for kind, (threads, slices) in ACCUM_EDGE_SHAPES.items():
            dg = {"mixed": mixed, "zero": torch.zeros_like(mixed),
                  "min": torch.full_like(mixed, -(1 << (w - 1)))}[kind]
            accum_case(f"{ACCUM_EDGE_BASES} w={w} {kind} digits, "
                       f"{threads}x{slices}", ACCUM_EDGE_BASES, dg, w,
                       threads, slices)
    for n in sorted(config.MSM_ACCUM_PLAN, key=lambda n: n == ACCUM_BASES):
        w, threads, slices = config.accum_plan(n)
        accum_case(f"{n} w={w}", n, PP.extract_digits_signed(
            accum_scalars(n), w), w, threads, slices)

    depth, lanes = 4, 8
    starts = np.zeros(depth * lanes, bool)
    starts[::depth] = True
    starts[depth] = False                       # lane 1 continues lane 0
    patterns = [("all heads", depth, lanes, np.ones(depth * lanes, bool)),
                ("no heads", depth, lanes, np.zeros(depth * lanes, bool)),
                ("heads at lane starts but one", depth, lanes, starts)]
    big_starts = np.zeros(16 * 1024, bool)
    big_starts[::16] = True
    big_starts[16 * 7] = False
    patterns.append(("16x1024 heads at lane starts but one", 16, 1024,
                     big_starts))
    patterns.append(("64x1024 runs of ~4096", 64, 1024,
                     sorted_heads(rng, 1 << 16, 16)))
    patterns += [(f"{d}x{ln} w={v.bit_length() - 1}", d, ln,
                  sorted_heads(rng, d * ln, v)) for d, ln, v in SCAN_SHAPES]
    for label, d, ln, heads in patterns:
        pt, ht = scan_operands(rng, dev, d, ln, heads)
        cases["ge_seg_scan"].append(
            (label, lambda pt=pt, ht=ht: cuda_curve.seg_scan(pt, ht),
             lambda pt=pt, ht=ht: PP.seg_scan_plain(pt, ht),
             seg_scan_adds(heads, d, ln) * IMAD_ADD,
             d * ln * (2 * PT_BYTES + 4) + ln * PT_BYTES))
    for m in FOLD_ROWS:
        rows = rng.integers(0, F.BOUND + 1, size=(m, 4 * F.L),
                            dtype=np.int32)
        edge = edge_points()[:min(m, 10)]                # identity, B, tor
        rows[rng.choice(m, size=len(edge), replace=False)] = edge
        body = t(rows)
        cases["ge_bucket_fold"].append(
            (m, lambda b=body: cuda_curve.bucket_fold(b),
             lambda b=body: PP.bucket_fold_plain(b), *fold_work(m)))
    nblk = SORT_KEYS // SO.BLOCK
    for label, radix, keys in (
            ("radix 128, all equal", 128, np.full(SORT_KEYS, 127)),
            ("radix 64, two values", 64,
             rng.choice([3, 40], size=SORT_KEYS)),
            ("radix 64", 64, rng.integers(0, 64, size=SORT_KEYS)),
            ("radix 128", 128, rng.integers(0, 128, size=SORT_KEYS))):
        kb = t(keys.astype(np.int32).reshape(nblk, SO.SUB, SO.LN))
        base = SO.hist_plain(kb, radix).reshape(-1)
        base = (torch.cumsum(base, 0) - base).to(torch.int32).reshape(
            radix, SO.SUB, SO.LN)
        flat = kb.permute(1, 2, 0).reshape(-1)          # traversal order
        table = radix * SO.BLOCK * 4
        label = f"{SORT_KEYS} {label}"
        cases["sort_hist"].append(
            (label, lambda kb=kb, r=radix: cuda_sort.hist(kb, r),
             lambda kb=kb, r=radix: SO.hist_plain(kb, r),
             0, SORT_KEYS * 4 + table,
             lambda f=flat: torch.argsort(f, stable=True)))
        cases["sort_rank"].append(
            (label, lambda kb=kb, b=base, r=radix: cuda_sort.rank(kb, b, r),
             lambda kb=kb, b=base, r=radix: SO.rank_plain(kb, b, r),
             0, 2 * SORT_KEYS * 4 + table,
             lambda f=flat: torch.argsort(f, stable=True)))
    def ip_rows(shape):
        """Random weak limbs [*shape, 20] with the edge rows at random
        places of each row of elements."""
        x = rand_fe(int(np.prod(shape))).reshape(*shape, F.L)
        edge = edge_fe()
        for row in x.reshape(-1, shape[-1], F.L):
            k = min(shape[-1], len(edge))
            row[rng.choice(shape[-1], size=k, replace=False)] = edge[:k]
        return t(x)

    for n in IP_SHAPES:
        a, b = ip_rows((1, n)), ip_rows((1, n))
        cases["fe_inner_product"].append(
            (n, lambda a=a, b=b: cuda_field.inner_product_partial(
                a, b, batched=False),
             lambda a=a, b=b: F.ip_partial_plain(a, b),
             n * IMAD_INNER, 2 * n * FE_BYTES + FE_BYTES))
        IP_OPERANDS[("fe_inner_product", n)] = (a[0], b[0])
    for rows, n in IP_BATCHED_SHAPES:
        a, b = ip_rows((rows, n)), ip_rows((rows, n))
        cases["fe_inner_product_batched"].append(
            (f"{rows} x {n}",
             lambda a=a, b=b: cuda_field.inner_product_partial(
                 a, b, batched=True),
             lambda a=a, b=b: F.ip_partial_plain(a, b),
             rows * n * IMAD_INNER, rows * (2 * n + 1) * FE_BYTES))
        IP_OPERANDS[("fe_inner_product_batched", (rows, n))] = (a, b)
    edge = edge_fe()
    for n in ADD_SHAPES[:1] + (len(edge),) + ADD_SHAPES[1:]:
        a, b = rand_fe(n), rand_fe(n)
        k = min(n, len(edge))
        a[:k] = edge[:k]
        b[n - k:] = edge[::-1][:k]
        a, b = t(a), t(b)
        label = f"{n} (the edge rows)" if n == len(edge) else n
        for name, kern, plain in (("fe_add", cuda_field.add, F.add3_plain),
                                  ("fe_sub", cuda_field.sub, F.sub3_plain)):
            cases[name].append((label,
                                lambda a=a, b=b, k=kern: k(a, b),
                                lambda a=a, b=b, p=plain: p(a, b),
                                0, 3 * n * FE_BYTES))

    def with_edges(x, rows):
        """x with the rows `rows` at random places of its first half (as
        many as fit; n = 1 stays random)."""
        k = min(len(x) // 2, len(rows))
        x[rng.choice(len(x), size=k, replace=False)] = rows[:k]
        return x

    def rand_r16(n):
        return rng.integers(0, R16.BOUND16 + 1, size=(n, R16.L16),
                            dtype=np.int32)

    # the radix-2^16 kernels and both chains: the edge pairs first, the
    # bench's shape last
    e16, e13 = edge_r16(), edge_fe()
    ops16 = [("edge pairs", *edge_pairs(e16))] + [
        (n, with_edges(rand_r16(n), e16), with_edges(rand_r16(n), e16[::-1]))
        for n in R16_SHAPES]
    ops13 = [("edge pairs", *edge_pairs(e13))] + [
        (n, with_edges(rand_fe(n), e13), with_edges(rand_fe(n), e13[::-1]))
        for n in R16_SHAPES]
    for label, a, b in ops16:
        a, b = t(a), t(b)
        m = a.shape[0]
        cases["r16_mul"].append((label,
                                 lambda a=a, b=b: cuda_radix16.mul(a, b),
                                 lambda a=a, b=b: R16.mul_plain(a, b),
                                 m * IMAD_R16, 3 * m * R16_BYTES))
        cases["r16_sq"].append((label, lambda a=a: cuda_radix16.sq(a),
                                lambda a=a: R16.sq_plain(a),
                                m * IMAD_R16, 2 * m * R16_BYTES))
    for name, ops, kern, plain, imad, row_bytes in (
            ("r16_mul_chain", ops16, cuda_radix16.mul_chain,
             R16.mul_chain_plain, IMAD_R16, R16_BYTES),
            ("fe_mul_chain", ops13, cuda_field.mul_chain, F.mul_chain_plain,
             IMAD_MUL, FE_BYTES)):
        for label, a, b in ops:
            a, b = t(a), t(b)
            m = a.shape[0]
            for reps in CHAIN_REPS:
                cases[name].append(
                    (f"{label}, reps {reps}",
                     lambda a=a, b=b, r=reps, k=kern: k(a, b, r),
                     lambda a=a, b=b, r=reps, p=plain: p(a, b, r),
                     m * reps * imad, 3 * m * row_bytes))
    micro_cases(cases, t, rand_pts)
    return cases


def chain_imads(op: str, mp: int) -> int:
    """IMADs of one link of the script's chain at mul_passes mp: 9
    multiplies an add; 4 squares (210 products) and 4 multiplies a
    doubling; each with 38 fold products and mp relaxation carries."""
    mul, sq = 400 + 38 + mp, 210 + 38 + mp
    return 9 * mul if op == "add" else 4 * sq + 4 * mul


def window_work(dg: torch.Tensor, nb: int, nbytes: int) -> tuple:
    """(IMADs, bytes) of the full window on these digits: a mixed add per
    nonzero digit, the fold's 2 (nb - 1) unified adds a lane and the
    tree's lanes - 1 a window; each input read once, the output written."""
    nw, _, _, lanes = dg.shape
    adds = nw * lanes * 2 * (nb - 1) + nw * (lanes - 1)
    imads = int((dg != 0).sum()) * IMAD_MADD + adds * IMAD_ADD
    return imads, nbytes + dg.numel() * 4 + nw * PT_BYTES


def micro_cases(cases: dict, t, rand_pts) -> None:
    """ge_add_chain and ge_accum_window: see MICRO_CHAIN / MICRO_WINDOW."""
    k, lanes = MICRO_CHAIN
    half = lanes // 2
    base = C.flatten(C.base_point((half,))).numpy()
    rows = t(np.concatenate([base, rand_pts(lanes - half)]))
    for op in MC.CHAIN_OPS:
        for mp, ap in MC.PASS_PAIRS:
            cases["ge_add_chain"].append(
                (f"{op} ({mp}, {ap}), K {k}, {lanes} lanes",
                 lambda op=op, mp=mp, ap=ap: cuda_micro.chain(rows, op, k,
                                                              mp, ap),
                 lambda op=op, mp=mp, ap=ap: MC.chain_plain(rows, op, k, mp,
                                                            ap),
                 k * lanes * chain_imads(op, mp), 2 * lanes * PT_BYTES))
    k, lanes = MICRO_CHAIN_TIMED
    timed = t(C.flatten(C.base_point((lanes,))).numpy())
    cases["ge_add_chain"].append(
        (f"add (5, 2), K {k}, {lanes} lanes",
         lambda: cuda_micro.chain(timed, "add", k, 5, 2),
         lambda: MC.chain_plain(timed, "add", k, 5, 2),
         k * lanes * chain_imads("add", 5), 2 * lanes * PT_BYTES))

    rng = np.random.default_rng(SEED + 9)
    nw, steps, unroll, lanes = MICRO_WINDOW
    win = []
    for w in (4, 5):
        nb = MC.nb_for(w)
        pt = t(rand_pts(steps * unroll * lanes).reshape(steps, unroll, lanes,
                                                        -1))
        dg = t(rng.integers(-(nb - 1), nb, (nw, steps, unroll, lanes),
                            dtype=np.int32))
        win.append((w, nb, pt, dg))
    (w4, nb4, pt4, dg4), (w5, nb5, pt5, dg5) = win
    runs = [(v, w4, nb4, pt4, dg4) for v in MC.VARIANTS]
    runs += [(v, w5, nb5, pt5, dg5) for v in ("full", "cached", "tree")]
    for v, w, nb, pt, dg in runs:
        where = "shared" if cuda_micro.uses_shared(nb) else "device"
        cases["ge_accum_window"].append(
            (f"{v}, w {w}, [{nw}, {steps}, {unroll}, {lanes}], buckets in "
             f"{where} memory",
             lambda v=v, nb=nb, pt=pt, dg=dg:
                 cuda_micro.accum_window(pt, dg, v, nb),
             lambda v=v, nb=nb, pt=pt, dg=dg: MC.accum_window_plain(pt, dg,
                                                                    v, nb),
             *window_work(dg, nb, pt.numel() * 4)))
    w, lanes, unroll = 4, 1024, 4
    pt, dg = AM.inputs(w, lanes, unroll, 1 << 16, pt4.device)
    nb = MC.nb_for(w)
    cases["ge_accum_window"].append(
        (f"full, _accum_micro's defaults (w {w}, {lanes} lanes, unroll "
         f"{unroll}, 2^16 points, {AM.NW} windows)",
         lambda: cuda_micro.accum_window(pt, dg, "full", nb),
         lambda: MC.accum_window_plain(pt, dg, "full", nb),
         *window_work(dg, nb, pt.numel() * 4)))


# the inner products' operands by (kernel, shape), kept by kernel_cases for
# check_inner_products
IP_OPERANDS = {}


def time_repro_shape(dev, rate) -> None:
    """ge_accum_window at _repro_accum3's shape and inputs (every digit 0:
    the fold and the tree are all the work), variant full: equal to its
    twin, its time and the twin's beside the bound."""
    from cudabulletproof_tpu_torch.benchmarks import _repro_accum3 as RA
    pt, dg = RA.inputs(dev)
    kern = lambda: cuda_micro.accum_window(pt, dg, "full", RA.NB)
    plain = lambda: MC.accum_window_plain(pt, dg, "full", RA.NB)
    if not torch.equal(kern(), plain()):
        raise AssertionError("ge_accum_window at _repro_accum3's shape: "
                             "kernel != plain")
    ms, plain_ms = cuda_median_ms(kern), cuda_median_ms(plain, reps=3)
    bound_ms, by = bound(*window_work(dg, RA.NB, pt.numel() * 4), rate)
    log(f"kernel ge_accum_window n=full, _repro_accum3's shape ([{RA.NW}, "
        f"{RA.STEPS}, {RA.UNROLL}, {RA.LANES}], nb {RA.NB}, digits 0): equal "
        f"to plain, {ms:.4f} ms vs plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({by})")


def check_inner_products() -> None:
    """The public functions around the fe_inner_product kernels: at every
    shape of the kernel phase ``field.inner_product`` /
    ``inner_product_batched`` on the card (the kernel, then the column
    combine and the fold in torch) give the plain twins' limbs exactly; the
    time of each at the timed shape, beside the twin's."""
    fns = {"fe_inner_product": (F.inner_product, F.inner_product_plain),
           "fe_inner_product_batched": (F.inner_product_batched,
                                        F.inner_product_batched_plain)}
    for (name, shape), (a, b) in IP_OPERANDS.items():
        fn, plain = fns[name]
        got = fn(a, b)
        if not torch.equal(got, plain(a, b)):
            raise AssertionError(f"{name} at {shape}: the public function's "
                                 "limbs != the twin's")
        timed = shape in (IP_SHAPES[-1], IP_BATCHED_SHAPES[-1])
        if timed:
            ms = cuda_median_ms(lambda: fn(a, b))
            plain_ms = cuda_median_ms(lambda: plain(a, b), reps=3)
        log(f"kernel {name:15s} n={shape}: field.{fn.__name__} limbs equal "
            "to the twin's" + (f", {ms:.4f} ms (kernel, combine and fold) "
                               f"vs plain {plain_ms:.3f} ms" if timed else ""))


def as_tensor(out) -> torch.Tensor:
    """A kernel's or twin's result as one tensor: points (a GE or the
    wrappers' (x, y, z, t) tuple) as [n, 80] rows; the scan's (values,
    carries) pair flattened and joined."""
    if isinstance(out, tuple) and len(out) == 4:
        return C.flatten(out)
    if isinstance(out, tuple):
        return torch.cat([o.reshape(-1) for o in out])
    return out


def check_kernels(dev, rate) -> dict:
    """Every kernel equal to its twin, limb for limb, in every case; returns
    per-kernel {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms},
    the times and the bound of its last case (the only one timed)."""
    rng = np.random.default_rng(SEED)
    results = {}
    for name, cases in kernel_cases(rng, dev).items():
        worst = 0
        for i, (label, kern, plain, imads, nbytes, *lib) in enumerate(cases):
            got = as_tensor(kern())
            torch.cuda.synchronize()
            want = as_tensor(plain())
            err = int((got.long() - want.long()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at {label}: kernel != plain "
                                     f"(max abs limb difference {err})")
            worst = max(worst, err)
            if i < len(cases) - 1:
                log(f"kernel {name:15s} n={label}: equal to plain")
                continue
            slow = name in ("ge_bucket_accum", "ge_ladder_bin",
                            "ge_add_chain", "ge_accum_window")
            ms = cuda_median_ms(kern)
            plain_ms = cuda_median_ms(plain, reps=1 if slow else 3)
            bound_ms, bound_by = bound(imads, nbytes, rate)
            library_ms = cuda_median_ms(lib[0]) if lib else None
            run = ""
            if name in RUN_TIMED:
                dev_ms = sum(v for k, v in G4.device_ms_by_kernel(
                    kern, RUN_LAUNCHES).items() if RUN_TIMED[name] in k)
                run = (f", {G4.run_ms(kern, RUN_LAUNCHES):.4f} ms a launch "
                       f"over {RUN_LAUNCHES} (device {dev_ms:.4f} ms a "
                       "launch)")
            log(f"kernel {name:15s} n={label}: equal to plain, {ms:.4f} ms "
                f"vs plain {plain_ms:.3f} ms{run}, bound {bound_ms:.4f} ms "
                f"({bound_by})" + (f", library {library_ms:.4f} ms"
                                   if lib else ""))
            results[name] = {"max_abs_err": worst, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": library_ms}
    # both ladders and the tile sum on real points against the oracle
    pts = [oracle.hash_to_point(b"smoke", i) for i in range(4)]
    scs = [1, 7, oracle.ELL - 1, 0x1234567 << 200]
    for ladder in (cuda_curve.ladder, cuda_curve.ladder_bin):
        got = C.to_oracle(ladder(C.from_oracle(pts, dev),
                                 F.from_ints(scs, dev)))
        if got != [s * p for s, p in zip(scs, pts)]:
            raise AssertionError(f"{ladder.__name__} kernel disagrees with "
                                 "the oracle")
    check_inner_products()
    tor = oracle.small_order_points()
    many = [oracle.hash_to_point(b"tiles", i) for i in range(292)] + tor
    want = oracle.IDENTITY
    for p in many:
        want = want + p
    if C.to_oracle(C.tree_reduce_tiles(C.from_oracle(many, dev))) != [want]:
        raise AssertionError("tile reduction disagrees with the oracle")
    return results


# --- 4-5. the verify path -----------------------------------------------------
def native_proof(value: int, gamma: int) -> bytes:
    blob = native.prove_range(value, gamma, N_BITS)
    if blob is None:
        raise RuntimeError(f"native prover refused value {value}")
    return blob


def tampered(proof):
    tor = oracle.small_order_points()
    ell = oracle.ELL
    return {
        "t_hat+1": dataclasses.replace(proof, t_hat=(proof.t_hat + 1) % ell),
        "V=A": dataclasses.replace(proof, V=proof.A),
        "ip.a*2": dataclasses.replace(
            proof, ip=dataclasses.replace(proof.ip, a=proof.ip.a * 2 % ell)),
        "A small order": dataclasses.replace(proof, A=tor[1].compress()),
        "S non-canonical y": dataclasses.replace(
            proof, S=(F.P + 1).to_bytes(32, "little")),
        "dropped L": dataclasses.replace(
            proof, ip=dataclasses.replace(proof.ip, L=proof.ip.L[:-1])),
    }


def check_single(gens, rng):
    values = [0, 42, (1 << N_BITS) - 1] + [
        int(v) for v in rng.integers(0, 1 << 63, size=2, dtype=np.int64)]
    proofs = []
    for v in values:
        blob = native_proof(v, int.from_bytes(rng.bytes(32), "little"))
        proof = deserialize_range_proof(blob)
        if serialize_range_proof(proof) != blob:
            raise AssertionError("wire format round trip changed the bytes")
        ok = fused.verify(proof, gens)
        if not ok or not native.verify_range(blob):
            raise AssertionError(f"honest proof of {v} rejected")
        proofs.append(proof)
    log(f"single verify n={N_BITS}: {len(proofs)} honest native proofs "
        "accepted")
    for label, bad in tampered(proofs[1]).items():
        got = fused.verify(bad, gens)
        want = native.verify_range(serialize_range_proof(bad))
        if got or got != want:
            raise AssertionError(f"tampered '{label}': port {got}, "
                                 f"native {want}")
        log(f"single verify rejects '{label}' (native agrees)")
    return proofs


def batch_proofs(rng, count: int):
    """`count` native proofs of random values and blindings (drawn from rng
    in order), made on every host core at once (the native prover releases
    the interpreter lock and reads its nonces from /dev/urandom)."""
    values = [int(v) for v in rng.integers(0, 1 << 63, size=count,
                                            dtype=np.int64)]
    gammas = [int.from_bytes(rng.bytes(32), "little") for _ in values]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        blobs = list(pool.map(native_proof, values, gammas))
    return [deserialize_range_proof(b) for b in blobs]


def check_batch(gens, proofs):
    """An honest merged batch accepted; the same with one proof tampered
    rejected; the native verifier agreeing on every proof of both."""
    b = len(proofs)
    honest = [native.verify_range(serialize_range_proof(p)) for p in proofs]
    if not all(honest) or not fused.batch_verify(proofs, gens):
        raise AssertionError(f"merged batch of {b} honest proofs rejected "
                             f"(native: {sum(honest)} of {b} accepted)")
    bad = list(proofs)
    bad[b // 2] = dataclasses.replace(bad[b // 2],
                                      mu=(bad[b // 2].mu + 1) % oracle.ELL)
    natives = [native.verify_range(serialize_range_proof(p)) for p in bad]
    if natives != [i != b // 2 for i in range(b)]:
        raise AssertionError(f"native verdicts on the tampered batch: "
                             f"{natives}")
    if fused.batch_verify(bad, gens):
        raise AssertionError(f"merged batch of {b} with a tampered proof "
                             "accepted")
    m = 2 * N_BITS + 2 + b * (5 + 2 * (N_BITS.bit_length() - 1))
    log(f"merged batch verify B={b} n={N_BITS} ({m} MSM bases): honest "
        "batch accepted, batch with one tampered proof rejected (native "
        "agrees on every proof)")


# --- 6. msm -------------------------------------------------------------------
def bench_inputs(n: int, dev):
    """bench.py's make(n) on the card: points (i+1) B by the ladder kernel,
    scalars SHA-256("bench%d" % i) mod l; with the ints of the scalars."""
    ks = [int.from_bytes(hashlib.sha256(b"bench%d" % i).digest(), "little")
          % oracle.ELL for i in range(n)]
    raw = np.frombuffer(b"".join(k.to_bytes(32, "little") for k in ks),
                        dtype=np.uint8).reshape(n, 32)
    scalars = F.from_bytes(torch.from_numpy(raw.copy()).to(dev))
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    mult = torch.zeros((n, F.L), dtype=torch.int32, device=dev)
    mult[:, 0] = idx & F.MASK
    mult[:, 1] = idx >> F.W
    points = C.scalarmult(C.base_point((n,), dev), mult)
    torch.cuda.synchronize()
    return points, scalars, ks


def expected_bytes(ks, n: int) -> bytes:
    """(sum (i+1) s_i mod l) B, compressed."""
    k = sum((i + 1) * s for i, s in enumerate(ks[:n])) % oracle.ELL
    return (k * oracle.BASE).compress()


def head(points: C.GE, scalars: torch.Tensor, n: int):
    return C.GE(*(c[:n] for c in points)), scalars[:n]


def to_compressed(p: C.GE) -> bytes:
    return bytes(C.to_bytes(p).cpu().tolist())


def native_msm(points: C.GE, ks, n: int):
    """The native library's MSM of the first n inputs, or None if it takes
    longer than NATIVE_MSM_TIMEOUT_S (it runs in a daemon thread)."""
    pts = C.to_bytes_batch(C.GE(*(c[:n] for c in points))).cpu().numpy()
    sc = b"".join(k.to_bytes(32, "little") for k in ks[:n])
    box = {}
    worker = threading.Thread(
        target=lambda: box.setdefault("out", native.point_msm(
            pts.tobytes(), sc, n)), daemon=True)
    t0 = time.perf_counter()
    worker.start()
    worker.join(NATIVE_MSM_TIMEOUT_S)
    return box.get("out"), time.perf_counter() - t0


def check_msm(points, scalars, ks, rate):
    """msm_auto at each size equal to the exact result; returns the
    per-size wall medians (s), the window sweep and the native library's
    2^16 result (None if it did not finish)."""
    wall = {}
    for n in MSM_SIZES:
        p, s = head(points, scalars, n)
        got = to_compressed(M.msm_auto(p, s))
        if got != expected_bytes(ks, n):
            raise AssertionError(f"msm_auto at {n} points != (sum i s_i) B")
        wall[n] = wall_median_s(lambda p=p, s=s: M.msm_auto(p, s), 3)
        log(f"[msm] msm_auto n={n}: equal to (sum (i+1) s_i mod l) B; median "
            f"{wall[n] * 1e3:.2f} ms = {n / wall[n]:.0f} points/s")
    n = NATIVE_MSM_SIZE
    out, secs = native_msm(points, ks, n)
    if out is None:
        log(f"[msm] native bp_point_msm at {n} points did not finish in "
            f"{NATIVE_MSM_TIMEOUT_S} s ({secs:.1f} s waited): comparison "
            "skipped")
    elif out != expected_bytes(ks, n):
        raise AssertionError(f"the native MSM at {n} points disagrees with "
                             "msm_auto's exact result")
    else:
        log(f"[msm] native bp_point_msm at {n} points agrees with msm_auto "
            f"({secs:.1f} s on the host)")
    sweep = {}
    for n in SWEEP_SIZES:
        p, s = head(points, scalars, n)
        pre = PP.madd_precomp(p)
        want = expected_bytes(ks, n)
        for w in SWEEP_WINDOWS:
            dg = PP.extract_digits_signed(s, w)
            bound_ms, by = bound(*G4.accum_work(dg, n, w), rate)
            shapes = {config.accum_block_shape(n, w, f)
                      for f in SWEEP_POINTS_PER_BUCKET}
            for threads, slices in sorted(shapes):
                got = cuda_curve.bucket_accum(pre, dg, w, threads, slices)
                if to_compressed(C.unflatten(got)) != want:
                    raise AssertionError(f"accumulator at {n}, w={w}, "
                                         f"{threads}x{slices} is wrong")
                ms = cuda_median_ms(lambda: cuda_curve.bucket_accum(
                    pre, dg, w, threads, slices), reps=3)
                sweep[(n, w, threads, slices)] = ms
                log(f"[sweep] n={n} w={w} threads={threads} slices={slices}: "
                    f"kernel {ms:.3f} ms (bound {bound_ms:.3f} ms, {by})")
    return wall, sweep, out


def check_msm_scan(points, scalars, ks, native_out):
    """The sort-plus-scan route (accumulator off): msm_auto at each of
    SCAN_MSM_SIZES and msm_pippenger at 2^16 under MSM_PALLAS_SORT equal
    to the exact result (and at 2^16 to the native MSM); returns label ->
    (points, wall median in s)."""
    wall = {}
    n16 = SCAN_MSM_SIZES[0]
    runs = [(f"msm_auto n={n}, accumulator off", n,
             lambda p, s: accum_off(lambda: M.msm_auto(p, s)))
            for n in SCAN_MSM_SIZES]
    runs.append((f"msm_pippenger n={n16} w={config.msm_window_for(n16)}, "
                 "MSM_PALLAS_SORT", n16, pallas_sort_pippenger))
    for label, n, fn in runs:
        p, s = head(points, scalars, n)
        got = to_compressed(fn(p, s))
        if got != expected_bytes(ks, n):
            raise AssertionError(f"{label} != (sum i s_i) B")
        if n == NATIVE_MSM_SIZE and native_out is not None \
                and got != native_out:
            raise AssertionError(f"{label} != the native MSM")
        secs = wall_median_s(lambda p=p, s=s, fn=fn: fn(p, s), 3)
        wall[label] = (n, secs)
        log(f"[msm] {label}: equal to (sum (i+1) s_i mod l) B"
            + (" and to the native MSM" if n == NATIVE_MSM_SIZE
               and native_out is not None else "")
            + f"; median {secs * 1e3:.2f} ms = {n / secs:.0f} points/s")
    p, s = head(points, scalars, n16)
    w = config.msm_window_for(n16)
    d = PP.extract_digits(s, w)[0].contiguous()
    order = SO.grouping_order(d, w, config.MSM_PALLAS_SORT_BITS)
    if not torch.equal(order.long(), torch.argsort(d, stable=True)):
        raise AssertionError("grouping_order != a stable argsort")
    pair_ms = cuda_median_ms(lambda: SO.grouping_order(
        d, w, config.MSM_PALLAS_SORT_BITS))
    arg_ms = cuda_median_ms(lambda: torch.argsort(d, stable=True))
    log(f"[sort] one window's digits at {n16}, w={w}: grouping_order "
        f"({len(SO._plan_passes(w, config.MSM_PALLAS_SORT_BITS))} passes of "
        f"sort_hist + sort_rank) {pair_ms:.4f} ms, equal to torch.argsort"
        f"(stable=True) {arg_ms:.4f} ms")
    return wall


def pallas_sort_pippenger(p, s):
    """msm_pippenger at msm_window_for(n) bits with MSM_PALLAS_SORT on."""
    config.MSM_PALLAS_SORT = True
    try:
        return PP.msm_pippenger(p, s, w=config.msm_window_for(s.shape[0]))
    finally:
        config.MSM_PALLAS_SORT = False


# --- 7. prove -----------------------------------------------------------------
# the kernels the prover launches besides its ladder: the halving of the
# ladder's products (ge_add) and the compression's batch inversion
PROVE_KERNELS = ["fe_mul", "fe_invert", "ge_add"]
# and the verifier's: decompression, small-order check, the MSM's tree
VERIFY_KERNELS = ["fe_mul", "fe_sq", "fe_pow2523", "ge_add", "ge_double"]
LADDERS = {4: "ge_ladder_win", 0: "ge_ladder_bin"}


def prove_fixture(gens, dev) -> dict:
    """The JAX package's n = 64 prover fixture on the card: gp, aL_bits and
    scp as tensors, the blob as numpy; its generators must be the port's."""
    path = Path(__file__).resolve().parent / PROVE_GOLDEN
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    out = {k: torch.from_numpy(ref[k]).to(dev)
           for k in ("gp", "aL_bits", "scp")}
    if not torch.equal(out["gp"], gens.pack(N_BITS)):
        raise AssertionError("the fixture's generators are not the port's")
    out["blob"] = ref["blob"]
    return out


def oracle_commitments(ref: dict) -> list:
    """V, A, S of the fixture's inputs by the python-int oracle, compressed:
    value g + blinding h, alpha h + <aL, G> + <aR, H> (aR = aL - 1) and
    rho h + <sL, G> + <sR, H>."""
    n = N_BITS
    ints = [v % oracle.ELL for v in SC.to_ints(ref["scp"])]
    bits = ref["aL_bits"].tolist()
    G = [oracle.hash_to_point(b"/G", i) for i in range(n)]
    H = [oracle.hash_to_point(b"/H", i) for i in range(n)]
    g, h = oracle.hash_to_point(b"/g", 0), oracle.hash_to_point(b"/h", 0)

    def msm(pairs):
        acc = oracle.IDENTITY
        for k, pt in pairs:
            acc = acc + k * pt
        return acc.compress()
    value, blinding, alpha, rho = ints[:4]
    sL, sR = ints[6:6 + n], ints[6 + n:6 + 2 * n]
    return [msm([(value, g), (blinding, h)]),
            msm([(alpha, h)] + list(zip(bits, G))
                + [(b - 1, pt) for b, pt in zip(bits, H)]),
            msm([(rho, h)] + list(zip(sL, G)) + list(zip(sR, H)))]


def check_prove(gens, dev, verify_proof) -> list:
    """Phase 7; returns the launch counts of its counted paths."""
    ref = prove_fixture(gens, dev)
    counts_of, blobs = [], {}
    for window, ladder in LADDERS.items():
        config.LADDER_WINDOW = window
        other = [k for k in LADDERS.values() if k != ladder]

        def path(window=window):
            blobs[window] = fused._prove(ref["gp"], ref["aL_bits"],
                                         ref["scp"], N_BITS).cpu().numpy()
            return True
        counts_of.append(counted(f"prove n={N_BITS}, LADDER_WINDOW={window}",
                                 path, PROVE_KERNELS + [ladder], other))
    config.LADDER_WINDOW = 4
    for window, blob in blobs.items():
        if not np.array_equal(blob, ref["blob"]):
            raise AssertionError(f"prove blob under LADDER_WINDOW={window} != "
                                 "the JAX package's blob")
    log(f"prove n={N_BITS}: the blobs under both ladders equal the JAX "
        "package's blob byte for byte")
    if [bytes(r) for r in ref["blob"][:3]] != oracle_commitments(ref):
        raise AssertionError("V, A, S differ from the oracle's commitments")
    log("prove: V, A, S equal the python-int oracle's commitments")
    proof = fused._blob_proof(ref["blob"], N_BITS)
    if not (native.verify_range(serialize_range_proof(proof))
            and fused.verify(proof, gens)):
        raise AssertionError("the port's proof is rejected")
    bad = dataclasses.replace(proof, t_hat=(proof.t_hat + 1) % oracle.ELL)
    if native.verify_range(serialize_range_proof(bad)) or fused.verify(
            bad, gens):
        raise AssertionError("the port's proof with t_hat + 1 is accepted")
    log("prove: the proof accepted by the native verifier and fused.verify; "
        "t_hat + 1 rejected by both")

    config.LADDER_WINDOW = 0
    want = native.verify_range(serialize_range_proof(verify_proof))
    counts_of.append(counted(
        "one verify, LADDER_WINDOW=0",
        lambda: want and fused.verify(verify_proof, gens),
        VERIFY_KERNELS + ["ge_ladder_bin"], ["ge_ladder_win"]))
    config.LADDER_WINDOW = 4
    return counts_of


# --- 8. the CLI and the host-transcript protocol -------------------------------
# the kernels the CLI at n = 64 launches: the host prover's ladders, halving
# adds and compressions; the verifier's decompression, small-order check,
# ladder MSM with its tile sum and cofactor doublings; the microbenchmark's
# add, mul and square
CLI_KERNELS = ["fe_add", "fe_mul", "fe_sq", "fe_pow2523", "fe_invert",
               "ge_ladder_win", "ge_add", "ge_double", "ge_reduce"]


def run_cli(argv) -> list:
    """``cli.main(argv)`` in this process on the card, its output echoed
    after it and returned as lines; it must exit 0 and end in
    {"all_tests": "SUCCESS"}."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"  cli {' '.join(argv) or '(defaults)'} | {ln}")
    if rc != 0 or not lines or lines[-1] != '{"all_tests": "SUCCESS"}':
        raise AssertionError(f"the CLI with {argv}: exit {rc}, last line "
                             f"{lines[-1] if lines else None!r}")
    return lines


def ints(rows) -> list:
    return [int.from_bytes(bytes(r), "little") for r in np.asarray(rows)]


def check_host(gens):
    """Phase 8: the CLI's two runs; the host prover on the fixture's
    randomness against the JAX blob; a fresh proof and tampered copies
    through the four verifiers.  Returns (the fresh proof, the CLI's
    microbenchmark lines of its last run)."""
    for argv in CLI_RUNS:
        lines = run_cli(argv)
    bench = [ln for ln in lines if ln.startswith("Batch field ")]
    path = Path(__file__).resolve().parent / HOST_GOLDEN.format(N_BITS)
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    value, blinding = ints(ref["secret"])
    feed = iter(ints(ref["rand"]))
    proof = RP.prove(value, blinding, N_BITS, gens, rand=lambda: next(feed))
    if next(feed, None) is not None:
        raise AssertionError("the host prover drew fewer scalars than the "
                             "fixture's")
    if serialize_range_proof(proof) != ref["blob"].tobytes():
        raise AssertionError("the host prover's blob != the JAX package's")
    log(f"host prove n={N_BITS}: the blob equals the JAX package's host "
        "prover's byte for byte")
    fresh = RP.prove((1 << N_BITS) - 1, 0x5EED, N_BITS, gens)
    flipped = bytearray(serialize_range_proof(fresh))
    flipped[40] ^= 1
    cases = {"honest": fresh,
             "t_hat + 1": dataclasses.replace(
                 fresh, t_hat=(fresh.t_hat + 1) % oracle.ELL),
             "blob[40] ^ 1": deserialize_range_proof(bytes(flipped))}
    for label, p in cases.items():
        got = {"rangeproof.verify": RP.verify(p, gens),
               "verify_deterministic": RP.verify_deterministic(p, gens),
               "fused.verify": fused.verify(p, gens),
               "native.verify_range": native.verify_range(
                   serialize_range_proof(p))}
        if set(got.values()) != {label == "honest"}:
            raise AssertionError(f"host proof '{label}': verdicts {got}")
        log(f"host proof '{label}': "
            + ("accepted" if label == "honest" else "rejected")
            + " by " + ", ".join(got))
    return fresh, bench


# --- 9. the benchmarks -----------------------------------------------------
REPO = Path(__file__).resolve().parent
BENCH_MSM = "cudabulletproof_tpu_torch.benchmarks.bench_msm"
# (label, python arguments, the check of its output lines)
BENCH_RUNS = (
    ("--benchmark", ["-m", "cudabulletproof_tpu_torch", "--benchmark"],
     lambda lines: check_bench_msm_lines(lines, (16,))),
    ("bench_msm --big", ["-m", BENCH_MSM, "--big"],
     lambda lines: check_bench_msm_lines(lines, (16, 20))),
    ("bench", ["-m", "cudabulletproof_tpu_torch.bench"],
     lambda lines: check_bench_record(lines)),
    ("bench_radix16",
     ["-m", "cudabulletproof_tpu_torch.benchmarks.bench_radix16"],
     lambda lines: check_bench_radix16_lines(lines)),
    ("bench_addrate",
     ["-m", "cudabulletproof_tpu_torch.benchmarks.bench_addrate"],
     lambda lines: check_addrate_lines(lines)),
    ("_accum_micro",
     ["-m", "cudabulletproof_tpu_torch.benchmarks._accum_micro",
      ",".join(MC.ACCUM_VARIANTS)],
     lambda lines: check_accum_micro_lines(lines)),
    ("_repro_accum3",
     ["-m", "cudabulletproof_tpu_torch.benchmarks._repro_accum3",
      ",".join(MC.REPRO_VARIANTS)],
     lambda lines: check_repro_lines(lines)),
    ("bench_group4",
     ["-m", "cudabulletproof_tpu_torch.benchmarks.bench_group4"],
     lambda lines: check_group4_lines(lines)),
)
# bench_addrate's default K and the lines of its sweep: (op, lanes,
# mul_passes, add_passes)
ADDRATE_K = 4096
ADDRATE_RUNS = ([("add", n, 5, 2) for n in (256, 512, 1024, 2048)]
                + [("dbl", n, 5, 2) for n in (256, 1024)]
                + [("add", 1024, mp, ap) for mp, ap in MC.PASS_PAIRS[1:]])
ADDRATE_LINE = (r"(add|dbl) +lanes= *(\d+) mulpass=(\d) addpass=(\d)  +"
                r"([\d.]+) ms  +([\d.]+) M ops/s")
ACCUM_LINE = (r"VARIANT (\w+) w=4 lanes=1024 u=4: ([\d.]+) ms total \(65 "
              r"win\)  ([\d.]+) ms/window  ([\d.]+) us/slot")
# bench_radix16's defaults (the JAX script's) and its lines
R16_BENCH = (1 << 16, 64)
R16_BENCH_LINES = (
    r"correctness ok \(chained muls vs oracle\); n=(\d+) reps=(\d+) "
    r"backend=cuda",
    r"radix13 20-limb mul: +([\d.]+) ms +([\d.]+) G mul/s",
    r"radix16 16-limb mul: +([\d.]+) ms +([\d.]+) G mul/s  "
    r"\(([\d.]+)x radix13\)")
BENCH_TIMEOUT_S = 400
BENCH_PROOF_METRICS = [
    "range_prove_16bit_latency", "range_verify_16bit_latency",
    "range_verify_fast_16bit_latency", "range_prove_fast_16bit_latency",
    "aggregated_verify_m16_n16_latency", "batch_verify_4_proofs_latency"]
BENCH_KEYS = ["range_proof_verify_16bit_latency",
              "gpu_batch16_verify_ms_per_proof", "gpu_msm_2e16_points_per_sec",
              "gpu_msm_2e20_points_per_sec", "gpu_msm_window_bits"]
# the kernels the bench path launches for certain: the inner product and
# field multiplies, make_points' ladders, the accumulator MSM at 2^16, the
# split-half check's add
BENCH_KERNELS = ["fe_inner_product", "fe_mul", "fe_invert", "ge_ladder_win",
                 "ge_bucket_accum", "ge_add"]


def check_bench_msm_lines(lines, exps) -> None:
    """bench_msm's JSON lines in the JAX script's order: the card, field
    mul (twin, kernel) with rooflines against the card's rate, the inner
    product, per MSM size the points per second, its roofline and a passing
    split-half check, then the proof latencies."""
    recs = [json.loads(ln) for ln in lines]
    if recs[0].get("backend") != "cuda":
        raise AssertionError(f"bench_msm ran on {recs[0]}")
    want = ["field_mul_plain_throughput", "field_mul",
            "field_mul_kernel_throughput", "field_mul",
            "field_inner_product_kernel"]
    for e in exps:
        want += [f"msm_points_per_sec_2e{e}", f"msm_2e{e}",
                 f"msm_split_half_2e{e}"]
    want += BENCH_PROOF_METRICS
    got = [r.get("metric") or r.get("roofline") or r.get("check")
           for r in recs[1:]]
    if got != want:
        raise AssertionError(f"bench_msm printed {got}, expected {want}")
    for r in recs[1:]:
        if "check" in r and r["ok"] is not True:
            raise AssertionError(f"bench_msm check failed: {r}")
        if "roofline" in r and not r["speed_of_light_per_sec"]:
            raise AssertionError(f"roofline without the card's rate: {r}")
        if "metric" in r and not r["value"] > 0:
            raise AssertionError(f"bench_msm metric not positive: {r}")


def check_bench_record(lines) -> None:
    """bench.py's one JSON line with the headline and the extras."""
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines, not 1")
    rec = json.loads(lines[0])
    if rec.get("metric") != BENCH_KEYS[0] or not rec["value"] > 0:
        raise AssertionError(f"bench headline: {rec}")
    missing = [k for k in BENCH_KEYS[1:] if not rec.get(k)]
    if missing or "vs_baseline" in rec:
        raise AssertionError(f"bench record {rec}: missing {missing}")


def check_bench_radix16_lines(lines) -> None:
    """bench_radix16's three lines at its defaults: the correctness gate
    passed on the card, then both chains' times and rates (positive); logs
    each chain's time against its bound (the chain's IMADs over the card's
    rate)."""
    found = [re.fullmatch(pat, ln) for pat, ln in zip(R16_BENCH_LINES, lines)]
    if len(lines) != len(R16_BENCH_LINES) or not all(found):
        raise AssertionError(f"bench_radix16 printed {lines}")
    if tuple(int(v) for v in found[0].groups()) != R16_BENCH:
        raise AssertionError(f"bench_radix16 ran at {found[0].groups()}")
    nums = [float(v) for m in found[1:] for v in m.groups()]
    if not all(v > 0 for v in nums):
        raise AssertionError(f"bench_radix16 numbers not positive: {nums}")
    rate = imad_per_s()[0]
    muls = R16_BENCH[0] * R16_BENCH[1]
    for label, ms, imad in (("radix13", nums[0], IMAD_MUL),
                            ("radix16", nums[2], IMAD_R16)):
        bound_ms = muls * imad / rate * 1e3
        log(f"bench_radix16 {label}: {ms} ms (host clock) against its bound "
            f"{bound_ms:.4f} ms ({muls} multiplies x {imad} IMADs): "
            f"{bound_ms / ms:.3f} of the bound")


def check_addrate_lines(lines) -> None:
    """bench_addrate's header and its sweep at K = 4096 on the card, each
    rate positive; logs each run's time against its bound (K x lanes links
    x their IMADs over the card's rate)."""
    if lines[0] != f"backend=cuda  K={ADDRATE_K} chained ops":
        raise AssertionError(f"bench_addrate header: {lines[:1]}")
    found = [re.fullmatch(ADDRATE_LINE, ln) for ln in lines[1:]]
    if len(found) != len(ADDRATE_RUNS) or not all(found):
        raise AssertionError(f"bench_addrate printed {lines}")
    rate = imad_per_s()[0]
    for m, (op, lanes, mp, ap) in zip(found, ADDRATE_RUNS):
        if (m[1], int(m[2]), int(m[3]), int(m[4])) != (op, lanes, mp, ap):
            raise AssertionError(f"bench_addrate ran {m.groups()}")
        ms = float(m[5])
        if not (ms > 0 and float(m[6]) > 0):
            raise AssertionError(f"bench_addrate numbers: {m.groups()}")
        bound_ms = ADDRATE_K * lanes * chain_imads(op, mp) / rate * 1e3
        log(f"bench_addrate {op} lanes={lanes} ({mp}, {ap}): {ms} ms against "
            f"its bound {bound_ms:.4f} ms: {bound_ms / ms:.4f} of the bound")


def check_accum_micro_lines(lines) -> None:
    """_accum_micro's five variants at its defaults (buckets in shared
    memory at w = 4), each with its time; logs each against the full
    window's bound on its own digits."""
    found = [re.fullmatch(ACCUM_LINE, ln) for ln in lines]
    if len(found) != len(MC.ACCUM_VARIANTS) or not all(found) or [
            m[1] for m in found] != list(MC.ACCUM_VARIANTS):
        raise AssertionError(f"_accum_micro printed {lines}")
    if not all(float(m[2]) > 0 for m in found):
        raise AssertionError(f"_accum_micro times not positive: {lines}")
    pt, dg = AM.inputs(4, 1024, 4, 1 << 16, torch.device("cpu"))
    imads, nbytes = window_work(dg, MC.nb_for(4), pt.numel() * 4)
    bound_ms, by = bound(imads, nbytes, imad_per_s()[0])
    for m in found:
        log(f"_accum_micro {m[1]}: {m[2]} ms against the "
            f"full window's bound {bound_ms:.4f} ms ({by})")


def check_group4_lines(lines) -> None:
    """bench_group4: one line for each ladder size and plan entry."""
    want = ([("ge_ladder_win", n) for n in G4.LADDER_SIZES]
            + [("ge_bucket_accum", n) for n in sorted(config.MSM_ACCUM_PLAN)])
    got = [(m.group(1), int(m.group(2))) for m in
           (re.match(r"(ge_\w+) n=(\d+) .*\[this\] [\d. ]+ ms.*bound", ln)
            for ln in lines) if m]
    if got != want:
        raise AssertionError(f"bench_group4 printed {got}, expected {want}")


def check_repro_lines(lines) -> None:
    """_repro_accum3's nine variants, each checked against its twin."""
    want = [f"VARIANT {v} OK (2, 80, 1024)" for v in MC.REPRO_VARIANTS]
    if lines != want:
        raise AssertionError(f"_repro_accum3 printed {lines}")


def run_benchmarks(card: str) -> dict:
    """Phase 9: each of BENCH_RUNS as its own process from the checkout's
    root; each must exit 0 and print its lines with every check passed.
    Returns label -> seconds."""
    secs = {}
    for label, args, check in BENCH_RUNS:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, *args], cwd=REPO,
                             env=dict(os.environ, BP_PLATFORM="cuda"),
                             capture_output=True, text=True,
                             timeout=BENCH_TIMEOUT_S)
        secs[label] = time.perf_counter() - t0
        lines = out.stdout.splitlines()
        for ln in lines:
            log(f"[{card}] bench | {label} | {ln}")
        if out.returncode != 0:
            raise AssertionError(f"{label}: exit {out.returncode}\n"
                                 f"{out.stderr[-4000:]}")
        check(lines)
        log(f"bench {label}: exit 0, every check passed, "
            f"{secs[label]:.1f} s")
    return secs


def bench_in_process() -> bool:
    """``cli.main(["--benchmark"])`` in this process (its lines checked as
    the process's are), for the counted run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--benchmark"])
    check_bench_msm_lines(buf.getvalue().splitlines(), (16,))
    return rc == 0


def bench_radix16_in_process() -> bool:
    """``bench_radix16.main([])`` in this process (its lines checked as the
    process's are), for the counted run.  Imported here: it imports
    bench_msm, which ``cli.main(["--benchmark"])`` runs as ``__main__``
    (runpy warns if the module is already loaded)."""
    from cudabulletproof_tpu_torch.benchmarks import bench_radix16
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_radix16.main([])
    check_bench_radix16_lines(buf.getvalue().splitlines())
    return rc == 0


# --- 10. timing -------------------------------------------------------------
def wall_median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_call(fn):
    """Kernel launches and device time of one call, as the profiler sees
    them: (cudaLaunchKernel calls, device events, device ms, the device
    time by kernel name, largest first); None where it recorded no device
    activity.  Reads the profiler's raw event records: ``prof.events()``
    would build a tree of every CPU op, minutes at the prover's ~580 k
    launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launches = sum(1 for e in events if e.name() == "cudaLaunchKernel")
    by_name = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            count, us = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (count + 1, us + e.duration_ns() / 1e3)
    dev_events = sum(c for c, _ in by_name.values())
    dev_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return launches, (dev_events or None), (dev_ms or None), top


def msm_route_kernels(n: int) -> list:
    """The kernels msm_auto's route for n points launches."""
    if n <= config.MSM_LADDER_MAX:
        return ["ge_ladder_win", "ge_reduce"]
    if n < config.MSM_PIPPENGER_MIN:
        return ["ge_add", "ge_double"]
    need = ["fe_invert", "ge_bucket_accum"]
    return need + ["ge_add"] if n > config.MSM_ACCUM_CHUNK else need


def counted(label: str, fn, need, forbid=()) -> dict:
    """Run one main path with the counters set to 0 before it; the kernels
    in `need` must have launched in it, those in `forbid` not."""
    reset_counts()
    if not fn():
        raise AssertionError(f"{label}: wrong result")
    torch.cuda.synchronize()
    got = counts()
    missing = [k for k in need if got[k] == 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}")
    stray = [k for k in forbid if got[k]]
    if stray:
        raise AssertionError(f"{label} launched {stray}")
    log(f"launches in {label}: " + ", ".join(
        f"{k} {v}" for k, v in got.items() if v))
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    rate, mhz = imad_per_s()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs at "
        f"up to {mhz:.0f} MHz: {rate / 1e12:.2f} T int32 IMAD/s")

    t0 = time.perf_counter()
    path = build.build()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")
    ptxas = path.with_suffix(".log").read_text().strip()
    if ptxas:
        log("ptxas:\n" + "\n".join("  " + ln for ln in ptxas.splitlines()
                                   if "registers" in ln or "spill" in ln
                                   or "stack" in ln
                                   or "Compiling entry" in ln))
    record = run(torch.device("cuda", 0), card, rate)
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev, card: str, rate: float) -> dict:
    """Phases 3 to 10 on `dev`; returns the per-kernel record."""
    t_start = time.perf_counter()
    reset_counts()
    kern = check_kernels(dev, rate)
    time_repro_shape(dev, rate)
    phase = counts()
    unlaunched = [k for k in NO_PATH if phase[k] == 0]
    if unlaunched:
        raise AssertionError(f"the kernel phase launched no {unlaunched}")
    log(f"[time] kernels checked at {time.perf_counter() - t_start:.0f} s")

    rng = np.random.default_rng(SEED + 1)
    gens = get_generators(N_BITS, dev)
    proofs = check_single(gens, rng)
    batch = batch_proofs(rng, BATCH)
    check_batch(gens, batch)
    big = batch_proofs(rng, SCAN_BATCH)
    for b in BIG_BATCHES:
        check_batch(gens, big[:b])
    log(f"[time] verdicts checked at {time.perf_counter() - t_start:.0f} s")
    accum_off(lambda: check_batch(gens, big))
    log(f"[time] batch of {SCAN_BATCH} (accumulator off) checked at "
        f"{time.perf_counter() - t_start:.0f} s")

    points, scalars, ks = bench_inputs(max(MSM_SIZES), dev)
    msm_wall, sweep, native_out = check_msm(points, scalars, ks, rate)
    log(f"[time] msm checked at {time.perf_counter() - t_start:.0f} s")
    scan_wall = check_msm_scan(points, scalars, ks, native_out)
    log(f"[time] sort-plus-scan msm checked at "
        f"{time.perf_counter() - t_start:.0f} s")

    try:
        prove_counts = check_prove(gens, dev, proofs[0])
    finally:
        config.LADDER_WINDOW = 4
    log(f"[time] prove checked at {time.perf_counter() - t_start:.0f} s")
    os.environ["BP_PLATFORM"] = "cuda"
    host_proof, bench = check_host(gens)
    log(f"[time] CLI and host protocol checked at "
        f"{time.perf_counter() - t_start:.0f} s")
    run_benchmarks(card)
    log(f"[time] benchmarks checked at {time.perf_counter() - t_start:.0f} s")

    # the main paths, counted: counters set to 0 before each, read after it
    verify_kernels = VERIFY_KERNELS + ["ge_ladder_win"]
    accum_kernels = ["fe_mul", "fe_sq", "fe_pow2523", "fe_invert",
                     "ge_double", "ge_bucket_accum"]
    # (label, path, kernels that must launch, kernels that must not)
    other = ["ge_ladder_bin"]
    paths = [
        ("one verify", lambda: fused.verify(proofs[0], gens), verify_kernels,
         other),
        (f"one merged batch of {BATCH}",
         lambda: fused.batch_verify(batch, gens), verify_kernels, other),
    ]
    for b in BIG_BATCHES:
        paths.append((f"one merged batch of {b}",
                      lambda b=b: fused.batch_verify(big[:b], gens),
                      accum_kernels, other))
    for n in MSM_SIZES:
        p, s = head(points, scalars, n)
        paths.append((f"msm_auto at {n}",
                      lambda p=p, s=s, n=n: to_compressed(M.msm_auto(p, s))
                      == expected_bytes(ks, n), msm_route_kernels(n), other))
    scan_kernels = ["ge_seg_scan", "ge_bucket_fold", "ge_double", "ge_add"]
    not_accum = other + ["ge_bucket_accum"]
    for n in SCAN_MSM_SIZES:
        p, s = head(points, scalars, n)
        paths.append((f"msm_auto at {n}, accumulator off",
                      lambda p=p, s=s, n=n: to_compressed(accum_off(
                          lambda: M.msm_auto(p, s))) == expected_bytes(ks, n),
                      scan_kernels, not_accum))
    n16 = SCAN_MSM_SIZES[0]
    p, s = head(points, scalars, n16)
    paths.append((f"msm_pippenger at {n16}, MSM_PALLAS_SORT",
                  lambda p=p, s=s: to_compressed(pallas_sort_pippenger(p, s))
                  == expected_bytes(ks, n16),
                  scan_kernels + ["sort_hist", "sort_rank"], not_accum))
    paths.append((f"one merged batch of {SCAN_BATCH}, accumulator off",
                  lambda: accum_off(lambda: fused.batch_verify(big, gens)),
                  VERIFY_KERNELS + ["ge_seg_scan", "ge_bucket_fold"],
                  not_accum))
    paths.append((f"the CLI at --range-bits {N_BITS}",
                  lambda: bool(run_cli(CLI_RUNS[1])), CLI_KERNELS,
                  other + list(NO_PATH)))
    paths.append(("the bench, cli.main(['--benchmark'])", bench_in_process,
                  BENCH_KERNELS, other + list(NO_PATH)))
    r16_kernels = ["r16_mul_chain", "fe_mul_chain"]
    paths.append(("the radix A/B, bench_radix16.main([])",
                  bench_radix16_in_process, r16_kernels,
                  [k for k in counts() if k not in r16_kernels]))
    launches = {k: 0 for k in counts()}
    for got in prove_counts + [counted(*path) for path in paths]:
        for k, v in got.items():
            launches[k] += v
    missing = [name for name, *_ in KERNELS
               if launches[name] == 0 and name not in NO_PATH]
    if missing:
        raise AssertionError(f"the main paths launched no {missing}")

    single_s = wall_median_s(lambda: fused.verify(proofs[0], gens), 3)
    batch_s = wall_median_s(lambda: fused.batch_verify(batch, gens), 3)
    log(f"[{card}] single verify n={N_BITS}: median {single_s * 1e3:.1f} ms")
    log(f"[{card}] merged batch verify B={BATCH} n={N_BITS}: median "
        f"{batch_s * 1e3:.1f} ms = {batch_s * 1e3 / BATCH:.2f} ms/proof")
    for b in BIG_BATCHES:
        s = wall_median_s(lambda b=b: fused.batch_verify(big[:b], gens), 3)
        log(f"[{card}] merged batch verify B={b} n={N_BITS}: median "
            f"{s * 1e3:.1f} ms = {s * 1e3 / b:.2f} ms/proof")
    s = wall_median_s(lambda: accum_off(lambda: fused.batch_verify(
        big, gens)), 3)
    log(f"[{card}] merged batch verify B={SCAN_BATCH} n={N_BITS}, "
        f"accumulator off: median {s * 1e3:.1f} ms = "
        f"{s * 1e3 / SCAN_BATCH:.2f} ms/proof")
    for n, s in msm_wall.items():
        log(f"[{card}] msm_auto n={n}: median {s * 1e3:.2f} ms = "
            f"{n / s:.0f} points/s")
    for label, (n, s) in scan_wall.items():
        log(f"[{card}] {label}: median {s * 1e3:.2f} ms = {n / s:.0f} "
            "points/s")
    for n in SWEEP_SIZES:
        runs = {k[1:]: v for k, v in sweep.items() if k[0] == n}
        best = min(runs, key=runs.get)
        plan = config.accum_plan(n)
        log(f"[{card}] accumulator sweep n={n}: best (w, threads, slices) = "
            f"{best} {runs[best]:.3f} ms; config {plan} "
            f"{runs.get(plan, float('nan')):.3f} ms")
    prove_value, prove_gamma = (1 << N_BITS) - 1, 0x5EED
    try:
        for window in LADDERS:
            config.LADDER_WINDOW = window
            last = {}
            s = wall_median_s(lambda: last.update(proof=fused.prove(
                prove_value, prove_gamma, N_BITS, gens)), PROVE_REPS)
            log(f"[{card}] prove n={N_BITS}, LADDER_WINDOW={window}: median "
                f"{s * 1e3:.1f} ms")
            if not native.verify_range(serialize_range_proof(last["proof"])):
                raise AssertionError("fused.prove with fresh randomness: "
                                     "rejected by the native verifier")
            log(f"prove: fused.prove of 2^{N_BITS} - 1 with fresh randomness "
                f"(LADDER_WINDOW={window}) accepted by the native verifier")
    finally:
        config.LADDER_WINDOW = 4
    for n in HOST_PROVE_BITS:
        g = get_generators(n, dev)
        s = wall_median_s(lambda g=g, n=n: RP.prove(
            (1 << n) - 1, prove_gamma, n, g), 3)
        log(f"[{card}] host prove n={n}: median {s * 1e3:.1f} ms")
    host_blob = serialize_range_proof(host_proof)
    for label, fn in (
            ("host rangeproof.verify", lambda: RP.verify(host_proof, gens)),
            ("host verify_deterministic",
             lambda: RP.verify_deterministic(host_proof, gens)),
            ("fused.verify", lambda: fused.verify(host_proof, gens)),
            ("native.verify_range (host CPU)",
             lambda: native.verify_range(host_blob))):
        s = wall_median_s(fn, 3)
        log(f"[{card}] {label} n={N_BITS}, one host proof: median "
            f"{s * 1e3:.2f} ms")
    for ln in bench:
        log(f"[{card}] CLI microbenchmark (10,000 elements): {ln}")
    p16, s16 = head(points, scalars, SCAN_MSM_SIZES[0])
    for label, fn in (
            ("one verify", lambda: fused.verify(proofs[0], gens)),
            ("one prove", lambda: fused.prove(prove_value, prove_gamma,
                                              N_BITS, gens)),
            (f"msm_auto at {SCAN_MSM_SIZES[0]}, accumulator off",
             lambda: accum_off(lambda: M.msm_auto(p16, s16))),
            (f"one host prove n={N_BITS}",
             lambda: RP.prove(prove_value, prove_gamma, N_BITS, gens)),
            (f"one host verify n={N_BITS}",
             lambda: RP.verify(host_proof, gens))):
        t0 = time.perf_counter()
        n_launch, dev_events, dev_ms, top = profile_call(fn)
        log(f"[time] profiled {label} in {time.perf_counter() - t0:.0f} s")
        log(f"[{card}] profiler, {label}: {n_launch} cudaLaunchKernel "
            f"calls, "
            f"{dev_events if dev_events is not None else 'not measured'} "
            "device events, device time "
            f"{f'{dev_ms:.2f} ms' if dev_ms is not None else 'not measured'}")
        for name, (count, us) in top[:12]:
            log(f"  device {us / 1e3:9.3f} ms  {count:7d} x  {name[:90]}")
    log(f"[time] total {time.perf_counter() - t_start:.0f} s")

    if "jax" in sys.modules or any(k == "cudabulletproof_tpu" or k.startswith(
            "cudabulletproof_tpu.") for k in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    return {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"cudabulletproof_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"],
         **({"paths": NO_PATH[name], "kernel_phase_launches": phase[name]}
            if name in NO_PATH else {})}
        for name, src, replaces in KERNELS]}


if __name__ == "__main__":
    sys.exit(main())
