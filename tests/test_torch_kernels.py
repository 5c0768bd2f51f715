"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py imports jax to configure the JAX suite.)
Each kernel against its plain torch twin on the same CUDA tensors, limb for
limb (tolerance zero), at the verify path's shapes and with broadcast
operands; and the wrappers' contract: launch counting, refusal of what the
kernels do not take.
"""
import numpy as np
import pytest
import torch

import make_host_golden as host_golden
import make_prove_golden as golden
from cudabulletproof_tpu_torch import cli, config
from cudabulletproof_tpu_torch.models import fused as TFU, rangeproof as TR
from cudabulletproof_tpu_torch.benchmarks.bench_calls import allocations
from cudabulletproof_tpu_torch.models.generators import get_generators
from cudabulletproof_tpu_torch.ops import (cuda_curve, cuda_field,
                                           cuda_micro, cuda_radix16,
                                           cuda_sort, curve as TC,
                                           field as TF, micro as TMC,
                                           msm as TM, pippenger as TP,
                                           radix16 as TR16,
                                           sort as TSO)
from cudabulletproof_tpu_torch.utils import oracle, serialization
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


def _rand(rng, shape, dev):
    return torch.from_numpy(
        rng.integers(0, TF.BOUND + 1, size=shape, dtype=np.int32)).to(dev)


def _raw(v: int) -> list:
    return [(v >> (13 * i)) & 0x1FFF for i in range(20)]


@pytest.mark.parametrize("n", [17, 272])
def test_field_kernels_equal_twins(dev, n):
    rng = np.random.default_rng(n)
    a, b = _rand(rng, (n, 20), dev), _rand(rng, (n, 20), dev)
    assert torch.equal(cuda_field.mul(a, b), TF.mul_plain(a, b))
    assert torch.equal(cuda_field.sq(a), TF.sq_plain(a))
    assert torch.equal(cuda_field.pow2523(a), TF.pow2523_plain(a))


# the Fermat chains' counts: below, at and past a block of 32 / G elements
# at each width, one verify's decompression (17), a batch of 16's (272)
# and the kernel table's invert (4096)
CHAIN_COUNTS = (1, 2, 5, 6, 7, 17, 272, 4096)
# 0, 1, 2, p-1, all limbs 8191 and every value p .. 2^255 - 1
CHAIN_EDGES = [_raw(v) for v in (0, 1, 2, TF.P - 1)] + [[0x1FFF] * 20] + [
    _raw(v) for v in range(TF.P, 1 << 255)]


def _chain_operands(rng, n, dev):
    """n random weak-limb rows with the edge rows over the first of them,
    then the edge rows alone."""
    edges = torch.tensor(CHAIN_EDGES, dtype=torch.int32, device=dev)
    a = _rand(rng, (n, 20), dev)
    k = min(n, len(CHAIN_EDGES))
    a[:k] = edges[:k]
    return a, edges


@pytest.mark.parametrize("n", CHAIN_COUNTS)
def test_invert_kernel_equals_twin(dev, n):
    """At every group width (config.CHAIN_WIDTHS), on n rows and on the
    edge rows alone, limb for limb; the public function (at its rule's
    width) gives the same limbs, and the inverse times the value is 1 (0
    for 0)."""
    rng = np.random.default_rng(n)
    for a in _chain_operands(rng, n, dev):
        want = TF.invert_plain(a)
        for lanes in config.CHAIN_WIDTHS:
            assert torch.equal(cuda_field.invert(a, lanes), want), lanes
        got = TF.invert(a)
        assert torch.equal(got, want)
        one = TF.canonical(TF.mul(got, a))
        zero = TF.is_zero(a)
        assert torch.equal(one[..., 0], (~zero).to(torch.int32))
        assert int(one[..., 1:].abs().sum()) == 0


@pytest.mark.parametrize("n", CHAIN_COUNTS)
def test_pow2523_kernel_equals_twin(dev, n):
    """At every group width (config.CHAIN_WIDTHS), on n rows and on the
    edge rows alone, limb for limb; the public function (at its rule's
    width) gives the same limbs."""
    rng = np.random.default_rng(n + 1)
    for a in _chain_operands(rng, n, dev):
        want = TF.pow2523_plain(a)
        for lanes in config.CHAIN_WIDTHS:
            assert torch.equal(cuda_field.pow2523(a, lanes), want), lanes
        assert torch.equal(TF.pow2523(a), want)


def test_pow2523_kernel_at_batch_of_1024(dev):
    """17,408 elements, the decompression of a merged batch of 1024 proofs,
    at the width the rule picks, with the edge rows."""
    n = 17 * 1024
    a, _ = _chain_operands(np.random.default_rng(n), n, dev)
    before = cuda_field.launches["fe_pow2523"]
    assert torch.equal(TF.pow2523(a), TF.pow2523_plain(a))
    assert cuda_field.launches["fe_pow2523"] == before + 1


# all limbs 8799 or 8191, 0, p-1 and every value p .. 2^255 - 1
ADD_EDGES = [[TF.BOUND] * 20, [0x1FFF] * 20, _raw(0), _raw(TF.P - 1)] + [
    _raw(v) for v in range(TF.P, 1 << 255)]


@pytest.mark.parametrize("n", [1, 255, 257, 300, 10_000])
def test_add_sub_kernels_equal_twins(dev, n):
    """fe_add / fe_sub against add3_plain / sub3_plain, limb for limb, at
    sizes that are not multiples of 256, with the edge rows."""
    rng = np.random.default_rng(n)
    a, b = _rand(rng, (n, 20), dev), _rand(rng, (n, 20), dev)
    edges = torch.tensor(ADD_EDGES, dtype=torch.int32, device=dev)
    k = min(n, len(ADD_EDGES))
    a[:k] = edges[:k]
    b[n - k:] = edges.flip(0)[:k]
    got = cuda_field.add(a, b)
    assert torch.equal(got, TF.add3_plain(a, b))
    assert torch.equal(TF.add3(a, b), got)
    got = cuda_field.sub(a, b)
    assert torch.equal(got, TF.sub3_plain(a, b))
    assert torch.equal(TF.sub3(a, b), got)


def test_add_sub_kernels_contract(dev):
    """Broadcast and strided operands; n = 0 launches nothing; CPU and
    non-int32 operands are refused; one launch counted per call."""
    rng = np.random.default_rng(4)
    a = _rand(rng, (4, 5, 20), dev)
    d = TF.from_int(oracle.D, device=dev)                 # [20] constant
    assert torch.equal(cuda_field.add(d, a), TF.add3_plain(d, a))
    assert torch.equal(cuda_field.sub(a, d), TF.sub3_plain(a, d))
    t = a.transpose(0, 1)                                 # non-contiguous
    assert torch.equal(cuda_field.sub(t, t.flip(0)),
                       TF.sub3_plain(t, t.flip(0)))
    before = dict(cuda_field.launches)
    empty = torch.zeros((0, 20), dtype=torch.int32, device=dev)
    assert cuda_field.add(empty, empty).shape == (0, 20)
    assert cuda_field.sub(empty, empty).shape == (0, 20)
    for fn in (cuda_field.add, cuda_field.sub):
        with pytest.raises(TypeError):
            fn(a.long(), a.long())
        with pytest.raises(ValueError):
            fn(a, a.cpu())
        with pytest.raises(ValueError):
            fn(a[..., :19], a[..., :19])
    assert cuda_field.launches == before
    cuda_field.add(a, a)
    cuda_field.sub(a, a)
    assert {k: cuda_field.launches[k] - before[k] for k in before} == {
        "fe_mul": 0, "fe_sq": 0, "fe_pow2523": 0, "fe_invert": 0,
        "fe_add": 1, "fe_sub": 1, "fe_inner_product": 0,
        "fe_inner_product_batched": 0, "fe_mul_chain": 0}


def test_field_broadcast_and_strides(dev):
    rng = np.random.default_rng(3)
    a = _rand(rng, (4, 5, 20), dev)
    d = TF.from_int(oracle.D, device=dev)                 # [20] constant
    assert torch.equal(TF.mul(d, a), TF.mul_plain(d, a))
    t = a.transpose(0, 1)                                 # non-contiguous
    assert torch.equal(TF.sq(t), TF.sq_plain(t))


# point counts of the window ladder: blocks of 8 points (4 lanes each), so
# counts below, at and past a block, and the paths' 147 / 402 / 1024
LADDER_COUNTS = [1, 3, 7, 8, 9, 147, 402, 1024]


def _ladder_operands(rng, n, dev):
    """n weak-limb rows and scalars mod l, the edges first: the identity,
    the base, the eight small-order points (8-torsion among them) and a row
    of limbs at 8799 against the scalars 0, 1, l-1, 2^253-1 and every limb
    8191, paired cyclically over the first 66 rows."""
    pts = [oracle.IDENTITY, oracle.BASE] + oracle.small_order_points()
    edge_rows = TC.flatten(TC.from_oracle(pts, dev)).tolist() + [
        [TF.BOUND] * 80]
    edge_sc = [_raw(v) for v in (0, 1, oracle.ELL - 1, (1 << 253) - 1)] + [
        [0x1FFF] * 20]
    rows = _rand(rng, (n, 80), dev)
    s = TF.from_ints([int.from_bytes(rng.bytes(32), "little") % oracle.ELL
                      for _ in range(n)], dev)
    k = min(n, 66)
    rows[:k] = torch.tensor([edge_rows[i % len(edge_rows)] for i in range(k)],
                            dtype=torch.int32, device=dev)
    s[:k] = torch.tensor([edge_sc[i % len(edge_sc)] for i in range(k)],
                         dtype=torch.int32, device=dev)
    return TC.unflatten(rows), s


@pytest.mark.parametrize("n", LADDER_COUNTS)
def test_curve_kernels_equal_twins(dev, n):
    rng = np.random.default_rng(n)
    p = TC.unflatten(_rand(rng, (n, 80), dev))
    q = TC.unflatten(_rand(rng, (n, 80), dev))
    lp, s = _ladder_operands(rng, n, dev)
    for got, want in ((cuda_curve.add(p, q), TC.add_plain(p, q)),
                      (cuda_curve.double(p), TC.double_plain(p)),
                      (cuda_curve.ladder(lp, s), TC.scalarmult_plain(lp, s)),
                      (cuda_curve.ladder_bin(lp, s),
                       TC.scalarmult_bin_plain(lp, s))):
        assert torch.equal(TC.flatten(got), TC.flatten(want))


# ge_add, ge_double and fe_mul read their operands in place (a pointer and
# a row stride each): counts around the four-lane kernels' blocks of 8
# points, the paths' 147 and 402, msm_auto's 1024 and the CLI's 10,000, on
# each layout the paths hand them
IN_PLACE_COUNTS = [0, 1, 7, 8, 9, 147, 402, 1024, 10_000]
IN_PLACE_LAYOUTS = ["contiguous", "views of an add", "halves", "row [20]",
                    "row [1, 20]"]


def _edge_point_rows(dev):
    """The identity, the base, the eight small-order points and a row of
    limbs at 8799, as [11, 80] rows."""
    pts = [oracle.IDENTITY, oracle.BASE] + oracle.small_order_points()
    return torch.cat([TC.flatten(TC.from_oracle(pts, dev)), torch.full(
        (1, 80), TF.BOUND, dtype=torch.int32, device=dev)])


def _in_place_operands(rng, n, layout, dev):
    """(p, q) GE operands of ge_add and (a, b) = (p.x, q.y) of fe_mul at
    `layout`, n rows, the edge rows first: the edge points, then ADD_EDGES
    in p's x and q's y."""
    edge = _edge_point_rows(dev)
    fe = torch.tensor(ADD_EDGES, dtype=torch.int32, device=dev)

    def rows(m, flip):
        r = _rand(rng, (m, 80), dev)
        k = min(m, len(edge))
        r[:k] = (edge.flip(0) if flip else edge)[:k]
        k = max(0, min(m - len(edge), len(fe)))
        col = 20 if flip else 0
        r[len(edge):len(edge) + k, col:col + 20] = (
            fe.flip(0) if flip else fe)[:k]
        return r
    if layout == "halves":              # curve.tree_reduce's c[:h], c[h:]
        both = TC.unflatten(rows(2 * n, False))
        p, q = TC.GE(*(c[:n] for c in both)), TC.GE(*(c[n:] for c in both))
    else:
        p, q = TC.unflatten(rows(n, False)), TC.unflatten(rows(n, True))
        if layout == "contiguous":
            p = TC.GE(*(c.contiguous() for c in p))
            q = TC.GE(*(c.contiguous() for c in q))
        elif layout == "views of an add":
            p, q = TC.GE(*cuda_curve.add(p, q)), TC.GE(*cuda_curve.add(q, p))
        else:                            # one point against n
            one = TC.unflatten(_edge_point_rows(dev)[1])          # the base
            q = one if layout == "row [20]" else TC.GE(*(c[None]
                                                         for c in one))
    return (p, q), (p.x, q.y)


@pytest.mark.parametrize("layout", IN_PLACE_LAYOUTS)
@pytest.mark.parametrize("n", IN_PLACE_COUNTS)
def test_in_place_kernels_equal_twins(dev, n, layout):
    """ge_add, ge_double and fe_mul on operands read in place equal
    add_plain / double_plain / mul_plain limb for limb (the doubling of p,
    the identity its first row, and of q: one point alone on the row
    layouts); n = 0 launches nothing."""
    rng = np.random.default_rng(1000 + n)
    (p, q), (a, b) = _in_place_operands(rng, n, layout, dev)
    names = ("ge_add", "ge_double", "fe_mul")
    before = [{**cuda_curve.launches, **cuda_field.launches}[k]
              for k in names]
    got = cuda_curve.add(p, q)
    assert torch.equal(TC.flatten(got), TC.flatten(TC.add_plain(p, q)))
    for pt in (p, q):
        two = cuda_curve.double(pt)
        assert two[0].shape == pt.x.shape
        assert torch.equal(TC.flatten(two), TC.flatten(TC.double_plain(pt)))
    assert torch.equal(cuda_field.mul(a, b), TF.mul_plain(a, b))
    assert torch.equal(cuda_field.mul(b, a), TF.mul_plain(b, a))
    assert got[0].shape == (n, 20)
    launched = int(n > 0)
    doubled = launched + int(n > 0 or layout.startswith("row"))   # p, q
    assert [{**cuda_curve.launches, **cuda_field.launches}[k] for k in names] \
        == [before[0] + launched, before[1] + doubled,
            before[2] + 2 * launched]


@pytest.mark.parametrize("batch", ["[4, 5]", "transposed"])
def test_in_place_kernels_batches(dev, batch):
    """A [4, 5] batch flattens to one row stride and is read in place; a
    transposed batch does not, and is copied first: both equal the twins
    and keep the batch shape."""
    rng = np.random.default_rng(7)
    p = TC.unflatten(_rand(rng, (4, 5, 80), dev))
    q = TC.unflatten(_rand(rng, (4, 5, 80), dev))
    if batch == "transposed":
        p = TC.GE(*(c.transpose(0, 1) for c in p))
        q = TC.GE(*(c.transpose(0, 1) for c in q))
    got = cuda_curve.add(p, q)
    assert got[0].shape == p.x.shape
    assert torch.equal(TC.flatten(got), TC.flatten(TC.add_plain(p, q)))
    got = cuda_curve.double(q)
    assert got[0].shape == q.x.shape
    assert torch.equal(TC.flatten(got), TC.flatten(TC.double_plain(q)))
    assert torch.equal(cuda_field.mul(p.x, q.t), TF.mul_plain(p.x, q.t))
    d = TF.from_int(oracle.D, device=dev)
    assert torch.equal(cuda_field.mul(d, p.y), TF.mul_plain(d, p.y))


@pytest.mark.parametrize("layout", ["views of an add", "halves",
                                    "row [20]"])
def test_in_place_call_is_one_allocation_one_launch(dev, layout):
    """On view and broadcast operands a call allocates exactly one tensor
    (its output) and launches its kernel once (ge_double on p and on q:
    one point alone on the row layout)."""
    rng = np.random.default_rng(11)
    (p, q), (a, b) = _in_place_operands(rng, 402, layout, dev)
    for fn, counts, name in (
            (lambda: cuda_curve.add(p, q), cuda_curve.launches, "ge_add"),
            (lambda: cuda_curve.double(p), cuda_curve.launches, "ge_double"),
            (lambda: cuda_curve.double(q), cuda_curve.launches, "ge_double"),
            (lambda: cuda_field.mul(a, b), cuda_field.launches, "fe_mul")):
        fn()
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
        launched = counts[name]
        out = fn()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] \
            - allocated == 1, name
        assert counts[name] == launched + 1, name
        del out


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 130, 147, 258, 402])
def test_ladder_bin_kernel_equals_twin(dev, n):
    """The binary ladder (one-warp blocks of 8 points) below, at and past a
    block, at the prover's shapes (V, an IPA round, A|S at n = 64) and the
    verify paths' 147 and 402: weak-limb rows with the identity, the base
    and the 8-torsion points among them, against random and edge scalars
    (0, 1, 2, l-1, 2^253-1, the top limb's top bit, all limbs 8191); then
    one point broadcast against n scalars, and [2, m] batches, as the
    prover calls it."""
    rng = np.random.default_rng(n)
    rows = _rand(rng, (n, 80), dev)
    tor = [oracle.IDENTITY, oracle.BASE] + oracle.small_order_points()
    rows[:min(n, len(tor))] = TC.flatten(TC.from_oracle(tor[:n], dev))
    p = TC.unflatten(rows)
    edges = [_raw(v) for v in (0, 1, 2, oracle.ELL - 1, (1 << 253) - 1,
                               1 << 259)] + [[0x1FFF] * 20]
    vals = [int.from_bytes(rng.bytes(32), "little") % oracle.ELL
            for _ in range(n)]
    s = TF.from_ints(vals, dev)
    s[-min(n, len(edges)):] = torch.tensor(edges[:n], dtype=torch.int32,
                                           device=dev)
    got = cuda_curve.ladder_bin(p, s)
    want = TC.scalarmult_bin_plain(p, s)
    assert torch.equal(TC.flatten(got), TC.flatten(want))
    one = TC.GE(*(c[min(1, n - 1)] for c in p))           # unbatched
    got = TC.GE(*cuda_curve.ladder_bin(one, s))
    want = TC.scalarmult_bin_plain(TC.GE(*(c.expand(n, 20) for c in one)), s)
    assert torch.equal(TC.flatten(got), TC.flatten(want))
    pair = TC.GE(*(torch.stack([c, c.flip(0)]) for c in p))   # [2, n]
    got = TC.GE(*cuda_curve.ladder_bin(pair, s))
    assert got.x.shape == (2, n, 20)
    flipped = TC.GE(*(c.flip(0) for c in p))
    assert torch.equal(TC.flatten(TC.GE(*(c[1] for c in got))),
                       TC.flatten(TC.scalarmult_bin_plain(flipped, s)))


# the tile reduction's counts: msm_ints pads to a power of two >= 64, so
# 64 .. 1024 points (1 to 4 tiles of 256), and part of a tile (147) and of
# the fourth (1000)
@pytest.mark.parametrize("n", [64, 147, 256, 512, 1000, 1024])
def test_reduce_kernel_equals_twin(dev, n):
    """Weak-limb rows with the identity and the 8-torsion points among
    them; the tile sums limb for limb, and a real sum against the oracle."""
    rng = np.random.default_rng(n)
    tor = oracle.small_order_points() + [oracle.BASE]
    rows = _rand(rng, (n, 80), dev)
    rows[:len(tor)] = TC.flatten(TC.from_oracle(tor, dev))
    p = TC.unflatten(rows[torch.from_numpy(rng.permutation(n)).to(dev)])
    assert torch.equal(cuda_curve.reduce_tiles(p), TC.reduce_tiles_plain(p))
    pts = [oracle.hash_to_point(b"kred", i) for i in range(300)] + tor
    want = oracle.IDENTITY
    for q in pts:
        want = want + q
    got = TC.tree_reduce_tiles(TC.from_oracle(pts, dev))
    assert TC.to_oracle(got) == [want]


@pytest.mark.parametrize("layout", ["coordinate views", "contiguous",
                                    "a ladder's output"])
def test_reduce_kernel_in_place(dev, layout):
    """ge_reduce reads x, y, z, t in place: on coordinate views of an
    [n, 80] output, contiguous [n, 20] coordinates and the window ladder's
    output (msm_auto's route) it equals the twin limb for limb, with one
    allocation (the partials) and one launch a call."""
    rng = np.random.default_rng(21)
    n = 700
    p = TC.unflatten(_rand(rng, (n, 80), dev))
    if layout == "contiguous":
        p = TC.GE(*(c.contiguous() for c in p))
    elif layout == "a ladder's output":
        p, _ = _ladder_operands(rng, n, dev)
        p = TC.GE(*cuda_curve.ladder(p, TF.from_ints(list(range(n)), dev)))
    assert torch.equal(cuda_curve.reduce_tiles(p), TC.reduce_tiles_plain(p))
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    launched = cuda_curve.launches["ge_reduce"]
    out = cuda_curve.reduce_tiles(p)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        - allocated == 1
    assert cuda_curve.launches["ge_reduce"] == launched + 1
    assert out.shape == (3, 80)


# fe_sq's operand layouts.  The paths hand it contiguous rows only; the
# others hold the row stride it shares with fe_mul: a coordinate view of an
# [n, 80] row and its high half, a [1, 20] row expanded to n (stride 0),
# and, at no n of their own, one element alone, a [4, 5] batch and a
# transposed one (copied)
SQ_LAYOUTS = [(layout, n) for layout in ["contiguous", "coordinate view",
                                         "high half", "row [1, 20] expanded"]
              for n in [1, 31, 32, 33, 272]] + [
    ("one element", 20), ("[4, 5] batch", 20), ("transposed batch", 20)]


@pytest.mark.parametrize("layout,n", SQ_LAYOUTS)
def test_sq_kernel_in_place(dev, layout, n):
    """fe_sq on every layout equals sq_plain limb for limb, with the edge
    rows at the start of the coordinate rows each layout reads, in the
    operand's batch shape; but for the transposed batch, a call is one
    allocation and one launch."""
    rng = np.random.default_rng(n)
    rows = _rand(rng, (2 * max(n, 20), 80), dev)
    k = min(n, len(ADD_EDGES))
    edges = torch.tensor(ADD_EDGES[:k], dtype=torch.int32, device=dev)
    rows[:k, 40:60] = edges
    rows[n:n + k, 40:60] = edges
    pts = TC.unflatten(rows)
    grid = pts.z[:20].reshape(4, 5, 20)
    a = {"contiguous": pts.z[:n].contiguous(), "coordinate view": pts.z[:n],
         "high half": pts.z[n:2 * n], "one element": pts.z[0],
         "row [1, 20] expanded": pts.z[:1].expand(n, 20),
         "[4, 5] batch": grid,
         "transposed batch": grid.transpose(0, 1)}[layout]
    got = cuda_field.sq(a)
    assert got.shape == a.shape
    assert torch.equal(got, TF.sq_plain(a))
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    launched = cuda_field.launches["fe_sq"]
    out = cuda_field.sq(a)
    assert cuda_field.launches["fe_sq"] == launched + 1
    if layout != "transposed batch":
        assert torch.cuda.memory_stats()["allocation.all.allocated"] \
            - allocated == 1
    del out


# (w, digits, n) of the accumulator's cases: every window width at 1000
# points (a multiple of no K = threads * slices) with mixed, all-zero and
# all -2^(w-1) digits; then each plan entry at its own size
ACCUM_CASES = [(w, digits, 1000) for w in range(4, 9)
               for digits in ("mixed", "zero", "min")] + [
    (w, "mixed", n) for n, (w, _, _) in sorted(config.MSM_ACCUM_PLAN.items())]


@pytest.mark.parametrize("w,digits,n", ACCUM_CASES)
def test_bucket_accum_kernel_equals_twin(dev, w, digits, n):
    """Weak-limb operand rows; mixed digits from random plus edge scalars
    (0, 1, l-1, 2^253-1, all limbs 8191), or every digit 0, or every digit
    -2^(w-1): the kernel's limbs equal the twin's at threads 32 and 256
    with slices 1 and 3 (at 1000 points), or at the plan's block shape."""
    rng = np.random.default_rng(w * 7 + n)
    pre = _rand(rng, (n, 80), dev)
    vals = [int.from_bytes(rng.bytes(32), "little") % oracle.ELL
            for _ in range(n - 5)]
    vals += [0, 1, oracle.ELL - 1, (1 << 253) - 1]
    s = torch.cat([TF.from_ints(vals, dev),
                   torch.full((1, 20), 0x1FFF, dtype=torch.int32, device=dev)])
    dg = TP.extract_digits_signed(s, w)
    if digits == "zero":
        dg = torch.zeros_like(dg)
    elif digits == "min":
        dg = torch.full_like(dg, -(1 << (w - 1)))
    if n in config.MSM_ACCUM_PLAN:
        shapes = [config.accum_plan(n)[1:]]
    else:
        shapes = [(32, 1), (32, 3), (256, 1), (256, 3)]
    for threads, slices in shapes:
        got = cuda_curve.bucket_accum(pre, dg, w, threads, slices)
        assert torch.equal(got, TP.bucket_accum_plain(pre, dg, w, threads,
                                                      slices))


def test_msm_routes_match_oracle(dev):
    """msm_auto on the card on real points: the ladder route and (with the
    thresholds lowered) the accumulator, chunked."""
    pts = [oracle.hash_to_point(b"kmsm", i) for i in range(40)]
    rng = np.random.default_rng(7)
    sc = [int.from_bytes(rng.bytes(32), "little") % oracle.ELL
          for _ in range(40)]
    want = oracle.IDENTITY
    for p, k in zip(pts, sc):
        want = want + k * p
    p, s = TC.from_oracle(pts, dev), TF.from_ints(sc, dev)
    assert TC.to_oracle(TM.msm_auto(p, s)) == [want]
    old = (TM.config.MSM_LADDER_MAX, TM.config.MSM_PIPPENGER_MIN,
           TM.config.MSM_ACCUM_CHUNK)
    try:
        (TM.config.MSM_LADDER_MAX, TM.config.MSM_PIPPENGER_MIN,
         TM.config.MSM_ACCUM_CHUNK) = (4, 8, 16)
        before = cuda_curve.launches["ge_bucket_accum"]
        assert TC.to_oracle(TM.msm_auto(p, s)) == [want]
        assert cuda_curve.launches["ge_bucket_accum"] == before + 3
    finally:
        (TM.config.MSM_LADDER_MAX, TM.config.MSM_PIPPENGER_MIN,
         TM.config.MSM_ACCUM_CHUNK) = old


@pytest.mark.parametrize("n", LADDER_COUNTS)
@pytest.mark.parametrize("window", [4, 0])
def test_ladder_matches_oracle(dev, monkeypatch, window, n):
    """Real points times 0, l-1, 2^253-1, a sparse scalar and random ones,
    against the oracle."""
    monkeypatch.setattr(config, "LADDER_WINDOW", window)
    rng = np.random.default_rng(n)
    pts = [oracle.hash_to_point(b"kern", i) for i in range(n)]
    scs = [0, oracle.ELL - 1, (1 << 253) - 1, 0xDEADBEEF << 180][:n]
    scs += [int.from_bytes(rng.bytes(32), "little") % oracle.ELL
            for _ in range(n - len(scs))]
    got = TC.scalarmult(TC.from_oracle(pts, dev), TF.from_ints(scs, dev))
    assert TC.to_oracle(got) == [k * p for k, p in zip(scs, pts)]


@pytest.mark.parametrize("window", [4, 0])
def test_prove_on_card_matches_jax_fixture(dev, monkeypatch, window):
    """``_prove`` at n = 8 on the card writes the JAX package's committed
    blob (tests/golden/prove_n8.npz) byte for byte, launching the ladder
    kernel of the knob and not the other."""
    with np.load(golden.golden_path(8)) as f:
        ref = {k: f[k] for k in f.files}
    gp = torch.from_numpy(ref["gp"]).to(dev)
    assert torch.equal(gp, get_generators(8, dev).table)
    monkeypatch.setattr(config, "LADDER_WINDOW", window)
    before = dict(cuda_curve.launches)
    blob = TFU._prove(gp, torch.from_numpy(ref["aL_bits"]).to(dev),
                      torch.from_numpy(ref["scp"]).to(dev), 8)
    assert np.array_equal(blob.cpu().numpy(), ref["blob"])
    used, unused = (("ge_ladder_win", "ge_ladder_bin") if window == 4
                    else ("ge_ladder_bin", "ge_ladder_win"))
    assert cuda_curve.launches[used] > before[used]
    assert cuda_curve.launches[unused] == before[unused]


def test_launch_counts_and_refusals(dev):
    a = torch.zeros((3, 20), dtype=torch.int32, device=dev)
    field_before = dict(cuda_field.launches)
    before = cuda_field.launches["fe_mul"]
    cuda_field.mul(a, a)
    assert cuda_field.launches["fe_mul"] == before + 1
    empty = torch.zeros((0, 20), dtype=torch.int32, device=dev)
    assert cuda_field.mul(empty, empty).shape == (0, 20)  # nothing launched
    assert cuda_field.launches["fe_mul"] == before + 1
    with pytest.raises(TypeError):
        cuda_field.mul(a.long(), a.long())
    with pytest.raises(ValueError):
        cuda_field.mul(a[:, :19], a[:, :19])
    with pytest.raises(ValueError):
        cuda_field.mul(a, a.cpu())
    p = TC.identity((2,), dev)
    before = dict(cuda_curve.launches)
    TC.add(p, p)
    TC.double(p)
    TC.scalarmult(p, TF.from_ints([1, 2], dev))
    cuda_curve.ladder_bin(p, TF.from_ints([1, 2], dev))
    TC.tree_reduce_tiles(p)
    pre = torch.zeros((2, 80), dtype=torch.int32, device=dev)
    dg = torch.ones((64, 2), dtype=torch.int32, device=dev)
    cuda_curve.bucket_accum(pre, dg, 4, 32, 1)
    assert {k: cuda_curve.launches[k] - before[k] for k in before} == {
        "ge_add": 1, "ge_double": 1, "ge_ladder_win": 1, "ge_ladder_bin": 1,
        "ge_reduce": 1, "ge_bucket_accum": 1, "ge_seg_scan": 0,
        "ge_bucket_fold": 0}
    s = TF.from_ints([1, 2], dev)
    with pytest.raises(ValueError):
        cuda_curve.ladder_bin(TC.identity((2,)), s)       # points on the CPU
    with pytest.raises(TypeError):
        cuda_curve.ladder_bin(p, s.long())
    with pytest.raises(ValueError):
        cuda_curve.ladder_bin(p, s[:, :19])
    with pytest.raises(RuntimeError):
        cuda_curve.ladder_bin(p, TF.from_ints([1, 2, 3], dev))   # 2 vs 3
    assert cuda_curve.launches["ge_ladder_bin"] == before["ge_ladder_bin"] + 1
    inv = cuda_field.launches["fe_invert"]
    TF.invert(a)
    assert cuda_field.launches["fe_invert"] == inv + 1
    for width in (0, 2, 3, 4, 20, 32):            # no width the kernels take
        with pytest.raises(ValueError, match="groups of"):
            cuda_field.invert(a, width)
        with pytest.raises(ValueError, match="groups of"):
            cuda_field.pow2523(a, width)
    assert cuda_field.launches["fe_invert"] == inv + 1
    TF.add3(a, a)
    TF.sub3(a, a)
    TF.add(a, a)                                  # plain torch: no launch
    TF.sub(a, a)
    assert {k: cuda_field.launches[k] - field_before[k]
            for k in field_before} == {
        "fe_mul": 1, "fe_sq": 0, "fe_pow2523": 0, "fe_invert": 1,
        "fe_add": 1, "fe_sub": 1, "fe_inner_product": 0,
        "fe_inner_product_batched": 0, "fe_mul_chain": 0}
    with pytest.raises(ValueError):
        cuda_curve.bucket_accum(pre, dg, 3, 32, 1)        # w outside 4..8
    with pytest.raises(ValueError):
        cuda_curve.bucket_accum(pre, dg, 4, 48, 1)        # not a power of 2
    with pytest.raises(ValueError):
        cuda_curve.bucket_accum(pre, dg[:, :1], 4, 32, 1)  # shapes differ


def _scan_operands(rng, depth, lanes, dev, heads=None, buckets=None):
    """Weak-limb points [depth, 80, lanes] with the identity, the base and
    the 8-torsion points among them, and head flags [depth, 1, lanes]:
    `heads` [depth * lanes] in sorted order if given, else the run starts of
    sorted random digits below `buckets` (runs that straddle lanes), element
    (j, l) the sorted element l * depth + j."""
    n = depth * lanes
    rows = rng.integers(0, TF.BOUND + 1, size=(n, 80), dtype=np.int32)
    tor = [oracle.IDENTITY, oracle.BASE] + oracle.small_order_points()
    rows[:min(n, len(tor))] = TC.flatten(TC.from_oracle(tor[:n])).numpy()
    rows = rows[rng.permutation(n)]
    if heads is None:
        d = np.sort(rng.integers(0, buckets, size=n))
        heads = np.concatenate([[True], d[1:] != d[:-1]])
    pt = rows.reshape(lanes, depth, 80).transpose(1, 2, 0)
    ht = np.asarray(heads).reshape(lanes, depth).T[:, None, :]
    return (torch.from_numpy(np.ascontiguousarray(pt)).to(dev),
            torch.from_numpy(np.ascontiguousarray(ht, dtype=np.int32)).to(dev))


def _head_patterns(depth, lanes):
    """All heads; no heads; a head at every lane start but lane 1's; one
    head, at the first element (a run of equal digits across every lane)."""
    n = depth * lanes
    starts = np.zeros(n, bool)
    starts[::depth] = True
    if lanes > 1:
        starts[depth] = False
    single = np.zeros(n, bool)
    single[0] = True
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "starts": starts, "single": single}


@pytest.mark.parametrize("depth,lanes,buckets", [
    (64, 1024, 1 << 13),          # one window at 2^16, w = 13
    (64, 1024, 16),               # runs of ~4096: carries across 64 lanes
    (32, 1024, 1 << 11),          # the B = 1024 batch's MSM, w = 11
    (4, 4, 5), (8, 16, 40), (3, 5, 4)])
def test_seg_scan_kernel_equals_twin(dev, depth, lanes, buckets):
    rng = np.random.default_rng(depth * lanes + buckets)
    pt, ht = _scan_operands(rng, depth, lanes, dev, buckets=buckets)
    got, want = cuda_curve.seg_scan(pt, ht), TP.seg_scan_plain(pt, ht)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("pattern", ["all", "none", "starts", "single"])
@pytest.mark.parametrize("depth,lanes", [(4, 8), (16, 1024), (64, 1024),
                                         (1, 1), (3, 1), (1, 2), (2, 5)])
def test_seg_scan_kernel_head_patterns(dev, depth, lanes, pattern):
    rng = np.random.default_rng(lanes)
    pt, ht = _scan_operands(rng, depth, lanes, dev,
                            heads=_head_patterns(depth, lanes)[pattern])
    got, want = cuda_curve.seg_scan(pt, ht), TP.seg_scan_plain(pt, ht)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,lanes", [
    (8191, 128), (2047, 128), (100, 128), (128, 128), (1, 128), (15, 4),
    (23, 8), (1, 1), (7, 1), (3, 2), (129, 256),
    # the card path's layout, and the layouts around it; lanes past the
    # halving's last block (128 points) run its rounds as launches
    (8191, config.MSM_FOLD_LANES_CUDA), (2047, config.MSM_FOLD_LANES_CUDA),
    (8191, 512), (2047, 2048), (8191, 4096), (100, 1024)])
def test_bucket_fold_kernel_equals_twin(dev, m, lanes):
    """Weak-limb rows with the identity, the base and the 8-torsion points
    among them: w = 13 and 11 tables, fewer rows than lanes, as many."""
    rng = np.random.default_rng(m)
    rows = _rand(rng, (m, 80), dev)
    tor = [oracle.IDENTITY, oracle.BASE] + oracle.small_order_points()
    rows[-min(m, len(tor)):] = TC.flatten(TC.from_oracle(tor[:m], dev))
    got = cuda_curve.bucket_fold(rows, lanes)
    assert torch.equal(got, TP.bucket_fold_plain(rows, lanes))


@pytest.mark.parametrize("table", ["one point", "one row"])
@pytest.mark.parametrize("lanes", [128, config.MSM_FOLD_LANES_CUDA])
def test_bucket_fold_kernel_edge_tables(dev, lanes, table):
    """8191 rows: every row the same point (one run across every lane), or
    every row the identity but the last: limb for limb the twin, and the
    oracle's sum_b b * S_b as a point."""
    m = 8191
    p = oracle.hash_to_point(b"fold", 0)
    if table == "one point":
        pts, want = [p] * m, (m * (m + 1) // 2) * p
    else:
        pts, want = [oracle.IDENTITY] * (m - 1) + [p], p
    rows = TC.flatten(TC.from_oracle(pts, dev))
    got = cuda_curve.bucket_fold(rows, lanes)
    assert torch.equal(got, TP.bucket_fold_plain(rows, lanes))
    assert TC.to_oracle(TC.unflatten(got)) == [want]


def test_bucket_fold_layouts_agree_on_curve_points(dev):
    """On curve points ((i+1) B, the identity and the 8-torsion points
    among them) the card path's layout and the JAX package's fold to the
    same point, the oracle's sum_b b * S_b."""
    m = 2047
    pts = [oracle.IDENTITY] + oracle.small_order_points()
    acc = oracle.IDENTITY
    while len(pts) < m:
        acc = acc + oracle.BASE
        pts.append(acc)
    want = oracle.IDENTITY
    for b, q in zip(range(m, 0, -1), pts):
        want = want + b * q
    rows = TC.flatten(TC.from_oracle(pts, dev))
    for lanes in (128, config.MSM_FOLD_LANES_CUDA, 2048):
        got = TC.unflatten(cuda_curve.bucket_fold(rows, lanes))
        assert TC.to_oracle(got) == [want], lanes


# (rows of 1024 keys, radix, keys): one LSD pass at 2^16 keys (the 7 + 6
# bit passes of w = 13) with random keys, all equal, two values; no rows,
# one, four (the 4096-key tests), 1024 (2^20 keys), and 2^16 (sort_rank's
# 32-bit counters); radix 1, 2 (the last pass of the 4096-key tests), 16
# and 256 (the most shared memory); keys of -1 and radix
SORT_CASES = ([(64, r, k) for r in (128, 64) for k in ("random", "equal",
                                                        "two")]
              + [(0, 128, "random"), (1, 2, "random"), (1, 256, "out"),
                 (4, 1, "equal"), (4, 2, "out"), (4, 16, "two"),
                 (1024, 128, "random"), (1024, 16, "out"),
                 (64, 256, "random"), (64, 256, "equal"), (64, 256, "out"),
                 (1 << 16, 2, "out")])


@pytest.mark.parametrize("nblk,radix,keys", SORT_CASES)
def test_sort_kernels_equal_twins(dev, nblk, radix, keys):
    """sort_hist and sort_rank equal their twins integer for integer, each
    one launch and one allocation a call; keys outside [0, radix) are not
    counted and get rank 0."""
    rng = np.random.default_rng(nblk * 1000 + radix)
    n = nblk * 1024
    k = {"random": lambda: rng.integers(0, radix, size=n),
         "equal": lambda: np.full(n, radix - 1),
         "two": lambda: rng.choice([3, radix // 2], size=n),
         "out": lambda: rng.integers(-1, radix + 1, size=n)}[keys]()
    kb = torch.from_numpy(k.astype(np.int32).reshape(nblk, 8, 128)).to(dev)
    before = dict(cuda_sort.launches)
    counts = cuda_sort.hist(kb, radix)
    assert torch.equal(counts, TSO.hist_plain(kb, radix))
    flat = counts.reshape(-1)
    base = (torch.cumsum(flat, 0) - flat).reshape(radix, 8, 128).int()
    got = cuda_sort.rank(kb, base, radix)
    assert torch.equal(got, TSO.rank_plain(kb, base, radix))
    assert {name: cuda_sort.launches[name] - before[name]
            for name in before} == {"sort_hist": 1, "sort_rank": 1}
    if keys != "out":
        assert torch.equal(got.reshape(-1).sort()[0],
                           torch.arange(n, device=dev, dtype=torch.int32))
    if nblk:
        assert allocations(lambda: cuda_sort.hist(kb, radix)) == 1
        assert allocations(lambda: cuda_sort.rank(kb, base, radix)) == 1


@pytest.mark.parametrize("n,w,bits", [(1 << 16, 13, 7), (4096, 5, 4),
                                      (1 << 20, 13, 7), (1 << 16, 13, 8)])
def test_grouping_order_on_card_is_stable_argsort(dev, n, w, bits):
    rng = np.random.default_rng(n + w)
    d = torch.from_numpy(rng.integers(0, 1 << w, size=n,
                                      dtype=np.int32)).to(dev)
    before = dict(cuda_sort.launches)
    got = TSO.grouping_order(d, w, bits)
    assert torch.equal(got.long(), torch.argsort(d, stable=True))
    passes = -(-w // bits)
    assert {k: cuda_sort.launches[k] - before[k] for k in before} == {
        "sort_hist": passes, "sort_rank": passes}


@pytest.mark.parametrize("pallas_sort", [False, True])
def test_msm_pippenger_on_card_matches_oracle(dev, monkeypatch, pallas_sort):
    """2048 bases (64 distinct points) at w = 8 with 256 lanes (the chunked
    scan, runs across lanes) and 40 at w = 5 (the unchunked scan): equal to
    the oracle sum, through ge_seg_scan and ge_bucket_fold (and the sort
    kernels under MSM_PALLAS_SORT where n is a multiple of 1024)."""
    monkeypatch.setattr(config, "MSM_PALLAS_SORT", pallas_sort)
    monkeypatch.setattr(config, "MSM_SCAN_LANES", 256)
    pts = [oracle.hash_to_point(b"kpip", i) for i in range(64)]
    rng = np.random.default_rng(11)
    for n, w in ((2048, 8), (40, 5)):
        sc = [0, 1, oracle.ELL - 1] + [
            int.from_bytes(rng.bytes(32), "little") % oracle.ELL
            for _ in range(n - 3)]
        want = oracle.IDENTITY
        for i, k in enumerate(sc):
            want = want + k * pts[i % 64]
        p = TC.from_oracle([pts[i % 64] for i in range(n)], dev)
        before = {**cuda_curve.launches, **cuda_sort.launches}
        got = TP.msm_pippenger(p, TF.from_ints(sc, dev), w=w)
        assert TC.to_oracle(got) == [want]
        after = {**cuda_curve.launches, **cuda_sort.launches}
        used = {k for k in after if after[k] > before[k]}
        chunked = n % 256 == 0
        assert ("ge_seg_scan" in used) == chunked
        assert "ge_bucket_fold" in used and "ge_bucket_accum" not in used
        assert ("sort_hist" in used) == (pallas_sort and n % 1024 == 0)


def test_msm_auto_accum_off_on_card(dev, monkeypatch):
    """msm_auto with the accumulator off and the thresholds lowered: one
    msm_pippenger at 24 bases, three chunks of 16 at 40; the oracle sum."""
    monkeypatch.setattr(config, "MSM_ACCUM_KERNEL", False)
    monkeypatch.setattr(config, "MSM_LADDER_MAX", 4)
    monkeypatch.setattr(config, "MSM_PIPPENGER_MIN", 8)
    monkeypatch.setattr(config, "MSM_CHUNK", 32)
    monkeypatch.setattr(config, "MSM_SCAN_LANES", 8)
    pts = [oracle.hash_to_point(b"kauto", i) for i in range(40)]
    rng = np.random.default_rng(5)
    sc = [int.from_bytes(rng.bytes(32), "little") % oracle.ELL
          for _ in range(40)]
    for n in (24, 40):
        want = oracle.IDENTITY
        for p, k in zip(pts[:n], sc[:n]):
            want = want + k * p
        before = dict(cuda_curve.launches)
        got = TM.msm_auto(TC.from_oracle(pts[:n], dev),
                          TF.from_ints(sc[:n], dev))
        assert TC.to_oracle(got) == [want]
        assert cuda_curve.launches["ge_bucket_accum"] == \
            before["ge_bucket_accum"]
        assert cuda_curve.launches["ge_bucket_fold"] > \
            before["ge_bucket_fold"]


def test_scan_sort_launch_counts_and_refusals(dev):
    """One launch counted per wrapper call; wrong devices, dtypes and
    shapes refused before any launch."""
    before = {**cuda_curve.launches, **cuda_sort.launches}
    pt = torch.zeros((2, 80, 4), dtype=torch.int32, device=dev)
    ht = torch.ones((2, 1, 4), dtype=torch.int32, device=dev)
    cuda_curve.seg_scan(pt, ht)
    cuda_curve.bucket_fold(torch.zeros((5, 80), dtype=torch.int32,
                                       device=dev), 4)
    keys = torch.zeros((1, 8, 128), dtype=torch.int32, device=dev)
    counts = cuda_sort.hist(keys, 4)
    cuda_sort.rank(keys, counts, 4)
    after = {**cuda_curve.launches, **cuda_sort.launches}
    assert {k: after[k] - before[k] for k in before if after[k] != before[k]
            } == {"ge_seg_scan": 1, "ge_bucket_fold": 1, "sort_hist": 1,
                  "sort_rank": 1}
    with pytest.raises(ValueError):
        cuda_curve.seg_scan(pt.cpu(), ht.cpu())
    with pytest.raises(TypeError):
        cuda_curve.seg_scan(pt.long(), ht)
    with pytest.raises(ValueError):
        cuda_curve.seg_scan(pt, ht[:1])
    with pytest.raises(ValueError):
        cuda_curve.bucket_fold(pt[0].T.contiguous(), 3)     # 3 lanes
    with pytest.raises(ValueError):
        cuda_sort.hist(keys, 257)
    with pytest.raises(ValueError):
        cuda_sort.rank(keys, counts[:2], 4)
    with pytest.raises(ValueError):
        cuda_sort.hist(keys.reshape(2, 4, 128), 4)
    assert {**cuda_curve.launches, **cuda_sort.launches} == after


@pytest.mark.parametrize("n", [8, 16])
def test_host_prove_on_card_matches_jax_fixture(dev, n):
    """The host prover on the card, fed the fixture's randomness, writes the
    JAX package's blob byte for byte; verify and verify_deterministic give
    the JAX verdicts on every case of the fixture."""
    with np.load(host_golden.golden_path(n)) as f:
        fx = {k: f[k] for k in f.files}
    gens = get_generators(n, dev)
    value, blinding = host_golden.from_rows(fx["secret"])
    rand = iter(host_golden.from_rows(fx["rand"]))
    proof = TR.prove(value, blinding, n, gens, rand=lambda: next(rand))
    blob = serialization.serialize_range_proof(proof)
    assert blob == fx["blob"].tobytes()
    got_v, got_d = [], []
    for data in host_golden.corruptions(blob, n).values():
        p = serialization.deserialize_range_proof(data)
        got_v.append(TR.verify(p, gens))
        got_d.append(TR.verify_deterministic(p, gens))
    small = get_generators(n // 2, dev)
    got_v.append(TR.verify(proof, small))
    got_d.append(TR.verify_deterministic(proof, small))
    assert got_v == fx["verify"].tolist()
    assert got_d == fx["verify_det"].tolist()


def test_cli_on_card(dev, monkeypatch, capsys):
    """The CLI on the card (no BP_PLATFORM): SUCCESS, exit 0, the device
    named GPU; its microbenchmark launches fe_add, fe_mul and fe_sq."""
    monkeypatch.delenv("BP_PLATFORM", raising=False)
    assert cli.main(["--range-bits", "8", "--skip-microbench"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("GPU (fused) verification:  SUCCESS")
               for ln in out)
    assert out[-1] == '{"all_tests": "SUCCESS"}'
    before = dict(cuda_field.launches)
    cli.field_microbench(300)
    assert all(cuda_field.launches[k] > before[k]
               for k in ("fe_add", "fe_mul", "fe_sq"))
    assert cuda_field.launches["fe_sub"] == before["fe_sub"]


def _ip_operands(rng, shape, dev):
    """Random weak limbs [*shape, 20] with all-8799, all-8191, 0, 1 and
    p - 1 rows at random places of every row of elements."""
    x = rng.integers(0, TF.BOUND + 1, size=shape + (20,), dtype=np.int32)
    edges = np.array([[TF.BOUND] * 20, [0x1FFF] * 20, _raw(0), _raw(1),
                      _raw(TF.P - 1)], dtype=np.int32)
    n = shape[-1]
    for row in x.reshape(-1, n, 20) if n else ():
        k = min(n, len(edges))
        row[rng.choice(n, size=k, replace=False)] = edges[:k]
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 32_768, 32_769,
                               32_768 + 300, 1 << 17])
def test_inner_product_kernel_equals_twin(dev, n):
    """fe_inner_product: ``field.inner_product`` gives the twin's limbs,
    exactly, from one counted launch and one allocation a call, at the
    tile edges, the column boundary (tiles share columns from 32,769
    elements on) and the bound; the value is <a, b> mod p."""
    rng = np.random.default_rng(n)
    a, b = _ip_operands(rng, (1, n), dev), _ip_operands(rng, (1, n), dev)
    before = cuda_field.launches["fe_inner_product"]
    got = TF.inner_product(a[0], b[0])
    assert torch.equal(got, TF.inner_product_plain(a[0], b[0]))
    assert torch.equal(cuda_field.inner_product(a, b, batched=False), got[None])
    assert cuda_field.launches["fe_inner_product"] == before + 2
    assert allocations(lambda: TF.inner_product(a[0], b[0])) == 1
    if n <= 257:
        va, vb = TF.to_ints(a[0]), TF.to_ints(b[0])
        want = sum(x * y for x, y in zip(va, vb)) % TF.P
        assert TF.to_ints(got[None])[0] % TF.P == want


@pytest.mark.parametrize("rows,n", [(1, 300), (3, 300), (16, 4096),
                                    (2, 32_769), (5, 0)])
def test_inner_product_batched_kernel_equals_twin(dev, rows, n):
    """fe_inner_product_batched: the twin's limbs from one counted launch
    and one allocation a call; a second row is refused unbatched."""
    rng = np.random.default_rng(rows * n + rows)
    a, b = _ip_operands(rng, (rows, n), dev), _ip_operands(rng, (rows, n), dev)
    before = cuda_field.launches["fe_inner_product_batched"]
    got = TF.inner_product_batched(a, b)
    assert torch.equal(got, TF.inner_product_batched_plain(a, b))
    assert torch.equal(cuda_field.inner_product(a, b, batched=True), got)
    assert cuda_field.launches["fe_inner_product_batched"] == before + 2
    assert allocations(lambda: TF.inner_product_batched(a, b)) == 1
    if rows > 1:
        with pytest.raises(ValueError, match="one row"):
            cuda_field.inner_product(a, b, batched=False)


def test_inner_product_operand_layouts(dev):
    """Rows that are not contiguous (a transposed batch) or not 16-byte
    aligned (a view one row in) are copied once, and the limbs are the
    twin's; no row is launched for B = 0."""
    rng = np.random.default_rng(7)
    a, b = _ip_operands(rng, (2, 301), dev), _ip_operands(rng, (2, 301), dev)
    t = a.transpose(0, 1).contiguous().transpose(0, 1)
    assert not t.is_contiguous()
    assert torch.equal(TF.inner_product_batched(t, b),
                       TF.inner_product_batched_plain(a, b))
    flat = a.reshape(-1)[1:1 + 300 * 20].reshape(300, 20)
    assert flat.data_ptr() % 16 != 0
    assert torch.equal(TF.inner_product(flat, b[0, :300]),
                       TF.inner_product_plain(flat, b[0, :300]))
    before = cuda_field.launches["fe_inner_product_batched"]
    empty = TF.inner_product_batched(a[:0], b[:0])
    assert empty.shape == (0, 20)
    assert cuda_field.launches["fe_inner_product_batched"] == before


def test_inner_product_tickets_per_stream(dev):
    """Calls on two streams take two ticket arrays, and every launch leaves
    its stream's zero; the limbs are the twin's on both."""
    rng = np.random.default_rng(11)
    a, b = _ip_operands(rng, (3, 1000), dev), _ip_operands(rng, (3, 1000), dev)
    want = TF.inner_product_batched_plain(a, b)
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        on_side = TF.inner_product_batched(a, b)
    here = TF.inner_product_batched(a, b)
    torch.cuda.synchronize()
    assert torch.equal(on_side, want) and torch.equal(here, want)
    streams = {k[1] for k in cuda_field._tickets if k[0] == dev.index}
    assert {side.cuda_stream,
            torch.cuda.current_stream(dev).cuda_stream} <= streams
    assert not any(t.any() for t in cuda_field._tickets.values())


def test_aggregate_on_card_matches_jax_fixture(dev):
    """aggregate.prove on the card writes the JAX package's blob at
    (n, m) = (8, 2); verify accepts it and rejects t_hat + 1."""
    import dataclasses

    import make_agg_golden as agg_golden
    from cudabulletproof_tpu_torch.models import aggregate as TA
    with np.load(agg_golden.golden_path(8, 2)) as f:
        ref = {k: f[k] for k in f.files}
    gens = get_generators(16, dev)
    feed = iter(agg_golden.from_rows(ref["rand"]))
    proof = TA.prove(agg_golden.from_rows(ref["values"]),
                     agg_golden.from_rows(ref["blindings"]), 8, gens,
                     rand=lambda: next(feed))
    assert serialization.serialize_aggregated_proof(proof) == \
        ref["blob"].tobytes()
    assert TA.verify(proof, gens)
    assert not TA.verify(dataclasses.replace(
        proof, t_hat=(proof.t_hat + 1) % oracle.ELL), gens)


def test_bench_on_card(dev, capsys):
    """bench_msm's field and MSM parts on the card at small sizes: the
    kernel lines, rooflines against the card's rate, the split-half check."""
    import json

    from cudabulletproof_tpu_torch.benchmarks import bench_msm as BM
    from cudabulletproof_tpu_torch.utils import profiling
    rate = profiling.device_rate(dev)
    BM.bench_field(dev, n=4096, iters=2, rate=rate)
    BM.bench_msm(dev, [4096], iters=1, rate=rate)
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out[-1] == {"check": "msm_split_half_2e12", "ok": True}
    assert all(o["speed_of_light_per_sec"] > 0 for o in out
               if "roofline" in o)


def _r16_edges():
    """Radix-2^16 edge rows: 0, 1, p - 1, every limb 2^16 + 38 (the weak
    bound), every limb 0xFFFF."""
    return np.array([TR16.from_int(0), TR16.from_int(1),
                     TR16.from_int(TF.P - 1), [TR16.BOUND16] * 16,
                     [TR16.MASK16] * 16], dtype=np.int32)


def _r16_operands(n, dev, width=16):
    """(a, b) [n, width]: every pair of edge rows for n = "edges", else
    random weak limbs (below 2^16 + 38, or 8799 for width 20) with the edge
    rows at random places of the first half."""
    if width == 16:
        edges, top = _r16_edges(), (1 << 16) + 38
    else:
        edges = np.array([[TF.BOUND] * 20, [0x1FFF] * 20, _raw(0), _raw(1),
                          _raw(TF.P - 1)], dtype=np.int32)
        top = TF.BOUND
    if n == "edges":
        k = len(edges)
        a, b = np.repeat(edges, k, axis=0), np.tile(edges, (k, 1))
    else:
        rng = np.random.default_rng(n + width)
        a = rng.integers(0, top + 1, size=(n, width), dtype=np.int32)
        b = rng.integers(0, top + 1, size=(n, width), dtype=np.int32)
        k = min(n // 2, len(edges))
        a[rng.choice(n, k, replace=False)] = edges[:k]
        b[rng.choice(n, k, replace=False)] = edges[::-1][:k]
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


@pytest.mark.parametrize("n", ["edges", 1, 255, 257, 1 << 16])
def test_radix16_kernels_equal_twins(dev, n):
    """r16_mul and r16_sq against mul_plain / sq_plain, limb for limb; the
    public functions take the kernels; values against Python ints on the
    edge pairs."""
    a, b = _r16_operands(n, dev)
    m = cuda_radix16.mul(a, b)
    s = cuda_radix16.sq(a)
    assert torch.equal(m, TR16.mul_plain(a, b))
    assert torch.equal(s, TR16.sq_plain(a))
    before = dict(cuda_radix16.launches)
    assert torch.equal(TR16.mul(a, b), m) and torch.equal(TR16.sq(a), s)
    assert cuda_radix16.launches["r16_mul"] == before["r16_mul"] + 1
    assert cuda_radix16.launches["r16_sq"] == before["r16_sq"] + 1
    if n == "edges":
        for x, y, got in zip(a.cpu(), b.cpu(), m.cpu()):
            assert TR16.to_int(got) == TR16.to_int(x) * TR16.to_int(y) % TF.P


@pytest.mark.parametrize("reps", [0, 1, 64])
@pytest.mark.parametrize("n", ["edges", 1, 255, 257, 1 << 16])
def test_mul_chain_kernels_equal_twins(dev, n, reps):
    """r16_mul_chain and fe_mul_chain against their twins, limb for limb
    (reps = 0 copies a); (2^16, 64) is the bench's shape."""
    a, b = _r16_operands(n, dev)
    got = TR16.mul_chain(a, b, reps)
    assert torch.equal(got, TR16.mul_chain_plain(a, b, reps))
    if reps == 0:
        assert torch.equal(got, a)
    a, b = _r16_operands(n, dev, width=20)
    got = TF.mul_chain(a, b, reps)
    assert torch.equal(got, TF.mul_chain_plain(a, b, reps))


def test_radix16_launch_counts_and_refusals(dev):
    """One launch counted per call (none for zero rows); wrong dtype, wrong
    width and a CPU operand refused, with nothing counted."""
    a = torch.zeros((3, 16), dtype=torch.int32, device=dev)
    a13 = torch.zeros((3, 20), dtype=torch.int32, device=dev)
    before = (dict(cuda_radix16.launches), dict(cuda_field.launches))
    cuda_radix16.mul(a, a)
    cuda_radix16.sq(a)
    cuda_radix16.mul_chain(a, a, 2)
    cuda_field.mul_chain(a13, a13, 2)
    cuda_radix16.mul(a[:0], a[:0])
    cuda_field.mul_chain(a13[:0], a13[:0], 2)
    assert {k: cuda_radix16.launches[k] - before[0][k]
            for k in before[0]} == {"r16_mul": 1, "r16_sq": 1,
                                    "r16_mul_chain": 1}
    assert cuda_field.launches["fe_mul_chain"] == \
        before[1]["fe_mul_chain"] + 1
    after = (dict(cuda_radix16.launches), dict(cuda_field.launches))
    with pytest.raises(TypeError):
        cuda_radix16.mul(a.long(), a.long())
    with pytest.raises(ValueError):
        cuda_radix16.sq(a13)                              # 20 limbs
    with pytest.raises(ValueError):
        cuda_radix16.mul(a, a.cpu())
    with pytest.raises(TypeError):
        cuda_field.mul_chain(a13.long(), a13.long(), 1)
    with pytest.raises(ValueError):
        cuda_field.mul_chain(a, a, 1)                     # 16 limbs
    with pytest.raises(ValueError):
        cuda_field.mul_chain(a13, a13.cpu(), 1)
    assert (dict(cuda_radix16.launches), dict(cuda_field.launches)) == after


def test_bench_radix16_on_card(dev, capsys, monkeypatch):
    """The port's bench_radix16 at its defaults on the card: the gate
    passes and both timing lines print positive rates."""
    from cudabulletproof_tpu_torch.benchmarks import bench_radix16 as TB
    monkeypatch.setenv("BP_PLATFORM", "cuda")
    assert TB.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("correctness ok (chained muls vs oracle); n=65536 "
                        "reps=64 backend=cuda")
    assert lines[1].startswith("radix13 20-limb mul: ")
    assert lines[2].startswith("radix16 16-limb mul: ")
    assert float(lines[2].split()[5]) > 0


def _chain_rows(dev, lanes):
    """The base point in half the lanes (the script's input), random weak
    rows in the rest."""
    rng = np.random.default_rng(lanes)
    base = TC.flatten(TC.base_point((lanes // 2,), dev))
    return torch.cat([base, _rand(rng, (lanes - lanes // 2, 80), dev)])


@pytest.mark.parametrize("mp,ap", TMC.PASS_PAIRS)
@pytest.mark.parametrize("op", TMC.CHAIN_OPS)
def test_add_chain_kernel_equals_twin(dev, op, mp, ap):
    """ge_add_chain against its twin at every op and pass pair, K = 0, 1
    and 16 on 130 lanes (the timing-only pairs' limbs wrap modulo 2^32 in
    both); the (5, 2) chains equal (K + 1) B and 2^K B."""
    p = _chain_rows(dev, 130)
    for k in (0, 1, 16):
        got = TMC.chain(p, op, k, mp, ap)
        assert torch.equal(got, TMC.chain_plain(p, op, k, mp, ap))
    if (mp, ap) == (5, 2):
        want = oracle.BASE * (17 if op == "add" else 1 << 16)
        assert TC.to_oracle(TC.unflatten(got[:65])) == [want] * 65


@pytest.mark.parametrize("variant", TMC.VARIANTS)
def test_accum_window_kernel_equals_twin(dev, variant):
    """ge_accum_window against its twin at each variant, w = 2, 4 and 5
    (3, 9 and 17 buckets), 100 lanes (not a power of two: the tree drops
    the odd lane as the script does), the buckets in shared memory (w = 2
    and 4) and in device memory (w = 5)."""
    rng = np.random.default_rng(7)
    for w, shared in ((2, True), (4, True), (5, False)):
        nb = TMC.nb_for(w)
        assert cuda_micro.uses_shared(nb) == shared
        pt = _rand(rng, (2, 3, 100, 80), dev)
        dg = torch.from_numpy(rng.integers(-(nb - 1), nb, (3, 2, 3, 100),
                                           dtype=np.int32)).to(dev)
        want = TMC.accum_window_plain(pt, dg, variant, nb)
        got = TMC.accum_window(pt, dg, variant, nb)
        assert torch.equal(got, want), w


def test_micro_launch_counts_and_refusals(dev):
    """One launch counted per call (none for zero lanes); wrong dtype,
    width, a CPU operand, too many buckets and the dead 'mul' op refused,
    with nothing counted."""
    p = torch.zeros((3, 80), dtype=torch.int32, device=dev)
    pt = torch.zeros((1, 1, 4, 80), dtype=torch.int32, device=dev)
    dg = torch.zeros((2, 1, 1, 4), dtype=torch.int32, device=dev)
    before = dict(cuda_micro.launches)
    cuda_micro.chain(p, "add", 2, 5, 2)
    cuda_micro.accum_window(pt, dg, "full", 3)
    cuda_micro.chain(p[:0], "dbl", 2, 5, 2)
    cuda_micro.accum_window(pt[:, :, :0], dg[..., :0], "full", 3)
    assert {k: cuda_micro.launches[k] - before[k] for k in before} == {
        "ge_add_chain": 1, "ge_accum_window": 1}
    after = dict(cuda_micro.launches)
    with pytest.raises(TypeError):
        cuda_micro.chain(p.long(), "add", 1, 5, 2)
    with pytest.raises(ValueError):
        cuda_micro.chain(p[:, :20], "add", 1, 5, 2)
    with pytest.raises(ValueError, match="'mul' branch"):
        cuda_micro.chain(p, "mul", 1, 5, 2)
    with pytest.raises(ValueError):
        cuda_micro.accum_window(pt, dg.cpu(), "full", 3)
    with pytest.raises(ValueError, match="at most 17"):
        cuda_micro.accum_window(pt, dg, "full", 33)
    assert dict(cuda_micro.launches) == after


def test_micro_scripts_on_card(dev, capsys, monkeypatch):
    """The three diagnostic scripts on the card at small arguments: the
    gates pass (chains against the oracle and their twins, windows against
    their twins) and every line prints."""
    from cudabulletproof_tpu_torch.benchmarks import (
        _accum_micro as TA, _repro_accum3 as TRP, bench_addrate as TBA)
    monkeypatch.setenv("BP_PLATFORM", "cuda")
    assert TBA.main(["--k", "64", "--lanes", "256", "--reps", "2"]) == 0
    assert TA.main([",".join(TMC.ACCUM_VARIANTS), "--reps", "2"]) == 0
    assert TRP.main([",".join(TMC.REPRO_VARIANTS)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "backend=cuda  K=64 chained ops"
    assert len(lines) == 1 + 6 + 5 + 9
    assert lines[-9:] == [f"VARIANT {v} OK (2, 80, 1024)"
                          for v in TMC.REPRO_VARIANTS]
