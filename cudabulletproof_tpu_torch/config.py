"""Constants of the PyTorch port.

Each is a module constant.  Three are knobs, each with code behind every
value and read at call time: ``LADDER_WINDOW``, ``MSM_ACCUM_KERNEL`` and
``MSM_PALLAS_SORT``; ``TRACE`` turns the protocol trace on
(``utils/debug.py``); every other constant has one value the ported code
runs.

Knobs of the JAX package that have no counterpart here, and why:

* ``PALLAS_CURVE`` / ``PALLAS_CURVE_MIN``: the port has no size threshold.  A
  CUDA tensor always goes to its kernel and a CPU tensor to the plain version.
* ``MSM_PALLAS_SCAN`` / ``MSM_PALLAS_SCAN_FORCE`` and ``MSM_FOLD_KERNEL``: a
  CUDA tensor always takes the segmented-scan and bucket-fold kernels
  (ge_seg_scan, ge_bucket_fold), a CPU tensor their plain twins.
* ``MSM_CHUNKED_SCAN``: the chunked scan is the only scan on the card; the
  unchunked one runs where the JAX package's rule sends an MSM too small to
  chunk (``pippenger._bucket_window``).
* ``msm_accum_plan`` and its TPU cost model (``_accum_cost_ns``): replaced by
  ``MSM_ACCUM_PLAN``, measured on the H100, and ``accum_plan``.
* ``MSM_VMAP_WINDOWS``, ``MSM_RADIX_SORT`` / ``_BITS``,
  ``MSM_SCAN_RAW_LAYOUT``, ``BP_COMPILE_CACHE``: XLA/TPU-only settings.
* ``require_exact``: it guards against the JAX package's stage-timing
  instrumentation (``benchmarks/_stages.py``), which the port does not have.
"""
import os

# Base count from which a fused MSM takes the bucket accumulator (the JAX
# package's ``config.FUSED_ACCUM_MIN``); below it the MSM is the windowed
# ladder plus a tree reduction.  At n = 64 a merged batch of B proofs has
# 130 + 17 B bases, so B >= 113 takes the accumulator.
FUSED_ACCUM_MIN = 2048

# The per-point ladder of ``curve.scalarmult`` (the JAX package's
# ``config.PALLAS_LADDER_WINDOW``): 4 = fixed 4-bit windows over a 16-entry
# table (the ge_ladder_win kernel, the default), 0 = binary double-and-add
# over the 260 scalar bits (ge_ladder_bin).  Read at call time; any other
# value raises there.
LADDER_WINDOW = 4

# Base count from which a fused MSM takes the sort-plus-scan
# ``pippenger.msm_pippenger`` when MSM_ACCUM_KERNEL is off (the JAX
# package's ``config.FUSED_PIPPENGER_MIN``, not re-decided on the H100).  At
# n = 64 a merged batch of B proofs has 130 + 17 B bases, so B >= 957.
FUSED_PIPPENGER_MIN = 16384

# ``ops/msm.py::msm_auto`` routes (the JAX package's TPU routes): up to
# MSM_LADDER_MAX points the ladder plus the tile reduction; below
# MSM_PIPPENGER_MIN Straus with STRAUS_WINDOW-bit digits; from it the
# accumulator, in chunks of MSM_ACCUM_CHUNK points whose results are added,
# or with MSM_ACCUM_KERNEL off ``pippenger.msm_pippenger``, in chunks of
# MSM_CHUNK points at ``msm_window_for(MSM_CHUNK)``.
MSM_LADDER_MAX = 1024
MSM_PIPPENGER_MIN = 4096
MSM_ACCUM_CHUNK = 1 << 16
MSM_CHUNK = 1 << 16
STRAUS_WINDOW = 4

# The bucket MSM of msm_auto and the fused MSMs (the JAX package's knob of
# the same name): True the signed-bucket accumulator (ge_bucket_accum),
# False the sort-plus-scan ``msm_pippenger`` (ge_seg_scan, ge_bucket_fold).
# Read at call time.
MSM_ACCUM_KERNEL = True
# How ``msm_pippenger`` groups the points of a window by digit (the JAX
# package's knob): False a stable ``torch.argsort``, True the counting sort
# ``sort.grouping_order`` (the sort_hist and sort_rank kernels) in LSD passes
# of MSM_PALLAS_SORT_BITS bits, where the point count is a multiple of 1024.
# Both give the same permutation.  Read at call time.
MSM_PALLAS_SORT = False
MSM_PALLAS_SORT_BITS = 7
# Lanes of the chunked segmented scan: lane l scans the sorted points
# [l * depth, (l + 1) * depth), depth = n / lanes.  The JAX package's
# layout, on the card too: in bench_group4's sweep on an H100 (PERF.md §6
# row 14), 4096 lanes took ge_seg_scan from 0.32 to 0.18 ms a window of
# 2^16 points and 2048 from 0.175 to 0.138 ms at 2^15: ~3 ms of msm_auto's
# 77-87 ms at 2^16 with the accumulator off, not worth a second layout and
# its own chunking rule.
MSM_SCAN_LANES = 1024
# Lanes of the bucket fold: lane l folds the padded rows [l * depth, (l + 1)
# * depth).  The JAX package's ``pallas_curve.bucket_fold`` default, which
# the CPU path keeps (its twin equals the Pallas kernel limb for limb).
MSM_FOLD_LANES = 128
# The card path's fold layout (ge_bucket_fold).  Any layout gives the same
# point, a group sum; the kernel equals its twin limb for limb at the layout
# it runs.  The fastest of bench_group4's sweep over 128..4096 lanes on an
# H100 (PERF.md §6 row 15): 0.203 ms for 8191 rows (0.555 at 128 lanes,
# 0.205 at 2048), 0.157 ms for 2047 (0.220 at 128, 0.175 at 256).
MSM_FOLD_LANES_CUDA = 1024


def fold_lanes(device) -> int:
    """Lanes of the bucket fold on `device` (a torch.device)."""
    return MSM_FOLD_LANES_CUDA if device.type == "cuda" else MSM_FOLD_LANES


# The group widths of the Fermat chain kernels (fe_invert, fe_pow2523): an
# element's ~265 dependent field products run on G lanes (G divides 20;
# csrc/fe25519.cuh's feg_mul), a wide group for the latency of a few
# elements, a narrow one for the throughput of many.  CHAIN_LANES_CUDA
# holds (most elements, G) in rising order, the last entry for any count.
# From bench_group4 --sweep of both kernels at the counts the paths run
# (1, 17, 272, 2176, 4352, 17408) and G = 1, 2, 4, 5, 10, 20 on an H100
# (PERF.md section 6; device ms a launch): G = 10 is the fastest at 1 to
# 272 elements (0.0439-0.0450; G = 5 0.0472-0.0488, G = 1 0.113-0.118),
# G = 5 at 2176 (0.048-0.049; G = 10 0.065) and 4352 (0.074-0.075; G = 10
# 0.082-0.084), G = 1 at 17,408 (0.172-0.174; G = 4 and 5 0.206-0.216).
# A count between two swept counts takes the width of the larger.  G = 2,
# 4 and 20 won at no count and are not built.
CHAIN_WIDTHS = (1, 5, 10)
CHAIN_LANES_CUDA = ((272, 10), (4352, 5), (None, 1))


def chain_lanes(device, n: int) -> int:
    """Group width G of fe_invert / fe_pow2523 for n elements on `device`,
    a CUDA torch.device (the CPU runs their twins, which have no width)."""
    if device.type != "cuda":
        raise ValueError(f"no chain width on {device}: the twins run there")
    for most, lanes in CHAIN_LANES_CUDA[:-1]:
        if n <= most:
            return lanes
    return CHAIN_LANES_CUDA[-1][1]


# The accumulator's plan at the padded sizes the port runs: points ->
# (window bits w, threads a block, blocks a window), a "thread" being a
# unit of the four lanes that hold a point.  2^12 and 2^13 are the
# merged batches of 128 and 256 proofs at n = 64, 2^16 the chunk of
# msm_auto.  Each is the fastest of chip_smoke.py's sweep over w = 4..8 and
# three block shapes on an H100 (PERF.md).
MSM_ACCUM_PLAN = {
    1 << 12: (5, 32, 1),
    1 << 13: (4, 128, 2),
    1 << 16: (4, 128, 4),
}
# Elsewhere (sizes no caller pads to, and the CPU tests' small ones): this
# window, and a thread takes MSM_ACCUM_POINTS_PER_BUCKET points for each of
# its 2^(w-1) buckets.
MSM_ACCUM_DEFAULT_WINDOW = 4
MSM_ACCUM_POINTS_PER_BUCKET = 4


def accum_block_shape(n: int, w: int,
                      per_bucket: int = MSM_ACCUM_POINTS_PER_BUCKET
                      ) -> tuple[int, int]:
    """(threads, slices) for an n-point accumulator at window w: the
    threads of a window are the power of two (at least 32) that gives each
    about per_bucket * 2^(w-1) points, so a thread's fixed cost, the
    weighted fold of 2 * 2^(w-1) adds, stays a bounded share of its work;
    at most 128 threads a block."""
    per_thread = per_bucket << (w - 1)
    k = 32
    while k * 2 * per_thread <= n:
        k *= 2
    threads = min(k, 128)
    return threads, k // threads


def accum_plan(n: int, w: int | None = None) -> tuple[int, int, int]:
    """(w, threads, slices) of the accumulator for an n-point MSM: the
    table's entry where there is one for n (and w, if given, is its
    window), else ``accum_block_shape``'s for w (default
    MSM_ACCUM_DEFAULT_WINDOW)."""
    plan = MSM_ACCUM_PLAN.get(n)
    if plan is not None and w in (None, plan[0]):
        return plan
    w = MSM_ACCUM_DEFAULT_WINDOW if w is None else w
    return (w, *accum_block_shape(n, w))


def msm_window_for(n: int) -> int:
    """Window bits of ``msm_pippenger`` for n points: the JAX package's
    operation count (``config.msm_window_for``, path "scan"), per window
    about 2n scan adds and 3 * 2^w bucket-fold adds, minimized over
    ceil(253 / w) windows for w in 4..13.  A count, not a timing: 9 at
    2^12, 11 at 2^14 and 2^15, 13 from 2^16."""
    best_w, best_c = 4, float("inf")
    for w in range(4, 14):
        c = -(-253 // w) * (2 * n + 3 * (1 << w))
        if c < best_c:
            best_w, best_c = w, c
    return best_w


# The host-transcript protocol (``models/rangeproof.py``, ``cli.py``), with
# the JAX package's defaults: the CLI's default range (``--range-bits``),
# and the largest n that ``verify_fast`` / ``prove_fast`` send to the native
# C++ library (a single small proof is host-scale work).
DEFAULT_RANGE_BITS = 16
NATIVE_VERIFY_MAX_BITS = 64

# BP_TRACE=1 logs the protocol's steps and values (``utils/debug.py``).
TRACE = os.environ.get("BP_TRACE", "") not in ("", "0", "false", "False")
