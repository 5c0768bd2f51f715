"""The operand plan of the in-place kernel wrappers (CPU, no JAX).

``cuda_curve.add``, ``cuda_curve.double``, ``cuda_curve.reduce_tiles``,
``cuda_field.mul`` and ``cuda_field.sq`` pass each operand to their kernel
as a data pointer and one row stride (``cuda_field.operand``), and copy an
operand only where its batch dims do not flatten to one stride.  The plan
is a function of tensor metadata, so it runs here on CPU tensors: which
layouts pass without a copy (the same ``data_ptr``) and at what stride,
which are copied, and -- read back with ``torch.as_strided`` from the
pointer and the stride, as the kernel reads them -- that row i of the plan
is row i of the broadcast operand.  Also that every C entry of the kernel
library takes the arguments ``utils/build.py`` binds (no compiler here),
that a library of an older C interface is refused, and that the Fermat
chain kernels' group width (``config.chain_lanes``) is one they take at
every count while the CPU path never asks for one.
"""
import ctypes
import math
import re
import types

import pytest
import torch

from cudabulletproof_tpu_torch import config
from cudabulletproof_tpu_torch.ops import (cuda_curve, cuda_field,
                                           curve as TC, field as TF)
from cudabulletproof_tpu_torch.utils import build

L = 20


def _rows(*shape):
    return torch.arange(int(torch.tensor(shape).prod()),
                        dtype=torch.int32).reshape(shape)


def _read(t: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """n rows of L limbs at t's data pointer, row stride `step`."""
    return torch.as_strided(t, (n, L), (step, 1), t.storage_offset())


# ge_double's operand at the batches it is called with: one point (the
# Straus and Horner accumulators'), [1] and a [2, 3] batch
DOUBLE_BATCHES = ((), (1,), (2, 3))
# ge_reduce's: GE [n] (the ladder's output, the tiles' partials)
REDUCE_BATCH = (9,)


def _point_layouts(batch) -> dict:
    """layout -> (a GE at `batch`, its coordinates' expected row stride):
    the coordinate views of an [*batch, 80] output, contiguous [*batch, 20]
    coordinates and one point [20] broadcast."""
    return {"coordinate views": (TC.unflatten(_rows(*batch, 4 * L)), 4 * L),
            "contiguous": (TC.GE(*(_rows(*batch, L) for _ in "xyzt")), L),
            "one point broadcast": (TC.unflatten(_rows(4 * L)), 0)}


def _double_layouts() -> dict:
    """label -> (operand, batch, stride) of each coordinate of ge_double's
    operand at each layout and batch (a batch of one row reads it at 0)."""
    out = {}
    for batch in DOUBLE_BATCHES:
        for layout, (p, step) in _point_layouts(batch).items():
            for name, c in zip("xyzt", p):
                out[f"double {layout} {name}, batch {list(batch)}"] = (
                    c, batch, step if math.prod(batch) > 1 else 0)
    return out


def _layouts():
    """label -> (operand, batch, expected row stride or None for a copy)."""
    pts = TC.unflatten(_rows(9, 4 * L))          # an [n, 80] output's views
    big = TC.unflatten(_rows(4, 5, 4 * L))
    flat = _rows(4, 5, L)
    return {
        "coordinate view x": (pts.x, (9,), 4 * L),
        "coordinate view t": (pts.t, (9,), 4 * L),
        "low half": (pts.y[:4], (4,), 4 * L),
        "high half": (pts.z[4:8], (4,), 4 * L),
        "contiguous": (_rows(9, L), (9,), L),
        "row [20] against [n, 20]": (_rows(L), (9,), 0),
        "row [1, 20] against [n, 20]": (_rows(1, L), (9,), 0),
        "row [20] alone": (_rows(L), (), 0),
        "[4, 5] batch": (flat, (4, 5), L),
        "[4, 5] coordinate views": (big.y, (4, 5), 4 * L),
        "[5] against a [4, 5] batch": (flat[0], (4, 5), None),
        "[4, 1] against a [4, 5] batch": (flat[:, :1], (4, 5), None),
        "transposed batch": (flat.transpose(0, 1), (5, 4), None),
        "limbs not at stride 1": (_rows(L, 9).T, (9,), None),
        **_double_layouts(),
        **{f"sq {k}": (t, t.shape[:-1], step)
           for k, (t, step) in _sq_layouts().items()},
    }


def _sq_layouts() -> dict:
    """layout -> (fe_sq's operand, its expected row stride) on the layouts
    the paths pass: contiguous rows, a coordinate view of an [n, 80] row
    (the high half too), one element alone and a [1, 20] row expanded."""
    pts = TC.unflatten(_rows(18, 4 * L))
    return {"contiguous [9, 20]": (_rows(9, L), L),
            "coordinate view": (pts.z, 4 * L),
            "high half of a coordinate view": (pts.x[9:], 4 * L),
            "one element [20]": (_rows(L), 0),
            "row [1, 20] expanded to 9": (_rows(1, L).expand(9, L), 0)}


@pytest.mark.parametrize("label", list(_layouts()))
def test_operand_plan(label):
    t, batch, step = _layouts()[label]
    assert cuda_field.row_stride(t.shape, t.stride(), batch) == step
    got, got_step = cuda_field.operand(t, batch, L)
    n = int(torch.tensor(batch).prod())
    want = t.expand(*batch, L).reshape(n, L)
    if step is None:                              # copied, contiguous
        assert got.data_ptr() != t.data_ptr() and got_step == L
        assert got.is_contiguous()
    else:                                         # read in place
        assert got is t and got_step == step
    assert torch.equal(_read(got, got_step, n), want)


def test_check_operands_refuse_other_devices():
    """The wrappers' checks take CUDA tensors only: CPU and meta operands
    raise (the card tests hold the dtype, width and device refusals)."""
    a = _rows(4, 5, L)
    meta = torch.empty((4, 5, L), dtype=torch.int32, device="meta")
    for ops in ((a, a), (meta, meta), (a, meta)):
        with pytest.raises(ValueError):
            cuda_field.check_operands(L, ops)


def _c_params(src: str, name: str) -> list:
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    assert m, name
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


def test_c_entries_take_the_bound_arguments():
    """Each C entry has as many parameters as SIGNATURES binds, a pointer
    where it binds c_void_p and an int64_t where it binds c_int64; the
    library's interface version is build.ABI."""
    src = "\n".join(p.read_text() for p in build.sources())
    for name, argtypes in build.SIGNATURES.items():
        params = _c_params(src, name)
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            if argtype is ctypes.c_void_p:
                assert "*" in param, (name, param)
            else:
                assert argtype is ctypes.c_int64, (name, param)
                assert param.startswith("int64_t "), (name, param)
    m = re.search(r'extern "C" int bp_abi_version\(\) \{ return (\d+); \}',
                  src)
    assert m and int(m.group(1)) == build.ABI
    # ge_double reads its point in place: x, y, z, t, then their strides
    assert _c_params(src, "bp_ge_double") == [
        "const int32_t* px", "const int32_t* py", "const int32_t* pz",
        "const int32_t* pt", "int64_t spx", "int64_t spy", "int64_t spz",
        "int64_t spt", "int32_t* out", "int64_t n", "void* stream"]
    # fe_sq reads its operand in place, as fe_mul does
    assert _c_params(src, "bp_fe_sq") == [
        "const int32_t* a", "int64_t sa", "int32_t* out", "int64_t n",
        "void* stream"]
    # the inner products write finished limbs and take their scratch and
    # the stream's row tickets
    assert _c_params(src, "bp_fe_inner_product") == [
        "const int32_t* a", "const int32_t* b", "int32_t* out",
        "int32_t* scratch", "int32_t* tickets", "int64_t n", "void* stream"]
    assert _c_params(src, "bp_fe_inner_product_batched") == [
        "const int32_t* a", "const int32_t* b", "int32_t* out",
        "int32_t* scratch", "int32_t* tickets", "int64_t rows", "int64_t n",
        "void* stream"]
    # ge_reduce reads its points in place, as ge_double does
    assert _c_params(src, "bp_ge_reduce") == [
        "const int32_t* px", "const int32_t* py", "const int32_t* pz",
        "const int32_t* pt", "int64_t spx", "int64_t spy", "int64_t spz",
        "int64_t spt", "int32_t* out", "int64_t n", "void* stream"]
    # the Fermat chains take the width of their lane groups
    for name in ("bp_fe_invert", "bp_fe_pow2523"):
        assert _c_params(src, name) == [
            "const int32_t* a", "int32_t* out", "int64_t n", "int64_t lanes",
            "void* stream"]
    # sort_rank keeps its counters in shared memory: no scratch table
    assert _c_params(src, "bp_sort_rank") == [
        "const int32_t* keys", "const int32_t* base", "int32_t* rank",
        "int64_t nblk", "int64_t radix", "void* stream"]


@pytest.mark.parametrize("batch", [*DOUBLE_BATCHES, REDUCE_BATCH])
@pytest.mark.parametrize("layout", ["coordinate views", "contiguous",
                                    "one point broadcast"])
def test_point_arguments(layout, batch):
    """``cuda_curve.point_args`` passes each point as its x, y, z, t data
    pointers, then their row strides, the order of bp_ge_add /
    bp_ge_double / bp_ge_reduce; read back from (pointer, stride),
    coordinate c of row i is row i of the broadcast coordinate c, for p
    alone and for (p, q)."""
    p, _ = _point_layouts(batch)[layout]
    q = TC.unflatten(_rows(*batch, 4 * L) + 7)
    n = math.prod(batch)
    for pts in ((p,), (p, q)):
        args, keep = cuda_curve.point_args(pts, batch)
        assert len(args) == 8 * len(pts)
        by_ptr = {t.data_ptr(): t for t in keep}
        for j, pt in enumerate(pts):
            ptrs, steps = args[8 * j:8 * j + 4], args[8 * j + 4:8 * j + 8]
            for c, ptr, step in zip(pt, ptrs, steps):
                want = c.expand(*batch, L).reshape(n, L)
                assert torch.equal(_read(by_ptr[ptr], step, n), want)


def _launched(monkeypatch, fn) -> tuple:
    """(output, (C entry, arguments) of its one launch) of `fn` run on CPU
    tensors, the CUDA-only check replaced by the batch it computes
    (metadata only: no kernel runs)."""
    def on_cpu(width, ts):
        assert all(t.shape[-1] == width for t in ts)
        return torch.device("cpu"), torch.broadcast_shapes(
            *(t.shape[:-1] for t in ts))
    calls = []
    monkeypatch.setattr(cuda_field, "check_operands", on_cpu)
    monkeypatch.setattr(cuda_curve, "check_operands", on_cpu)
    monkeypatch.setattr(build, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    out = fn()
    assert len(calls) == 1
    return out, calls[0]


@pytest.mark.parametrize("layout", list(_sq_layouts()))
def test_sq_arguments(monkeypatch, layout):
    """``cuda_field.sq`` launches ``bp_fe_sq(a, row stride, out, n)`` on its
    operand in place: read back from (pointer, stride), row i is row i of
    the operand; out is [*batch, 20]; one launch, counted."""
    a, step = _sq_layouts()[layout]
    before = cuda_field.launches["fe_sq"]
    out, (name, args) = _launched(monkeypatch, lambda: cuda_field.sq(a))
    n = math.prod(a.shape[:-1])
    assert name == "bp_fe_sq" and len(args) == 4
    assert args[0] == a.data_ptr() and args[1] == step
    assert args[2] == out.data_ptr() and args[3] == n
    assert out.shape == a.shape and out.dtype == torch.int32
    assert torch.equal(_read(a, step, n), a.reshape(n, L))
    assert cuda_field.launches["fe_sq"] == before + 1


@pytest.mark.parametrize("layout", ["coordinate views", "contiguous",
                                    "one point broadcast"])
def test_reduce_arguments(monkeypatch, layout):
    """``cuda_curve.reduce_tiles`` launches ``bp_ge_reduce(x, y, z, t, their
    row strides, out, n)`` on GE [n] read in place (one point broadcast
    against n rows of another coordinate); out is one [80] row a tile of
    256; one launch, counted."""
    n = 300
    p, step = _point_layouts((n,))[layout]
    if layout == "one point broadcast":          # x at [n, 20], the rest one
        p = TC.GE(_rows(n, L), *p[1:])
    before = cuda_curve.launches["ge_reduce"]
    out, (name, args) = _launched(monkeypatch,
                                  lambda: cuda_curve.reduce_tiles(p))
    assert name == "bp_ge_reduce" and len(args) == 10
    assert args[8] == out.data_ptr() and args[9] == n
    assert out.shape == (2, 4 * L) and out.dtype == torch.int32
    by_ptr = {c.data_ptr(): c for c in p}
    for c, ptr, s in zip(p, args[:4], args[4:8]):
        assert torch.equal(_read(by_ptr[ptr], s, n), c.expand(n, L))
    assert args[5:8] == (step,) * 3 and args[4] == (
        L if layout == "one point broadcast" else step)
    assert cuda_curve.launches["ge_reduce"] == before + 1


class _Library:
    """Stands for a built kernel library of C interface `version` (None:
    one from before ``bp_abi_version``): every entry, none of them run."""

    def __init__(self, version):
        if version is not None:
            self.bp_abi_version = lambda: version
        for name in build.SIGNATURES:
            setattr(self, name, types.SimpleNamespace())


@pytest.mark.parametrize("version", [None, 2, 3, 4, 5, 6, build.ABI,
                                     build.ABI + 1])
def test_older_library_is_refused(monkeypatch, version):
    """``build.load`` binds every entry of a library of this checkout's C
    interface, with the argument types of SIGNATURES, and refuses a library
    of any other (an older ge_double entry took one packed point, older
    fe_invert / fe_pow2523 entries no group width, older fe_sq / ge_reduce
    entries packed rows, older inner-product entries a zeroed partial and
    no scratch, an older sort_rank entry a scratch counter table)."""
    assert build.ABI == 7
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: _Library(version))
    if version != build.ABI:
        with pytest.raises(RuntimeError, match="C interface version"):
            build.load("lib.so")
        return
    handle = build.load("lib.so")
    assert set(handle.entries) == set(build.SIGNATURES)
    for name, fn in handle.entries.items():
        assert fn.argtypes == build.SIGNATURES[name]
        assert fn.restype is ctypes.c_int


def test_chain_width_rule(monkeypatch):
    """Every count from 1 to 2^17 gets a group width that divides 20 and
    that the kernels take; a CPU device gets none, and the CPU path of
    ``field.invert`` / ``pow2523`` never asks (it runs the twins)."""
    dev = torch.device("cuda", 0)
    assert all(20 % g == 0 for g in config.CHAIN_WIDTHS)
    widths = {config.chain_lanes(dev, n) for n in range(1, (1 << 17) + 1)}
    assert widths <= set(config.CHAIN_WIDTHS)
    with pytest.raises(ValueError, match="no chain width"):
        config.chain_lanes(torch.device("cpu"), 17)

    def asked(*_):
        raise AssertionError("config.chain_lanes asked on the CPU path")
    monkeypatch.setattr(config, "chain_lanes", asked)
    a = TF.from_ints([2, TF.P - 1])
    assert torch.equal(TF.invert(a), TF.invert_plain(a))
    assert torch.equal(TF.pow2523(a), TF.pow2523_plain(a))
