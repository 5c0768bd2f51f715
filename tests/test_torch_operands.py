"""The operand plan of the in-place kernel wrappers (CPU, no JAX).

``cuda_curve.add`` and ``cuda_field.mul`` pass each operand to their kernel
as a data pointer and one row stride (``cuda_field.operand``), and copy an
operand only where its batch dims do not flatten to one stride.  The plan
is a function of tensor metadata, so it runs here on CPU tensors: which
layouts pass without a copy (the same ``data_ptr``) and at what stride,
which are copied, and -- read back with ``torch.as_strided`` from the
pointer and the stride, as the kernel reads them -- that row i of the plan
is row i of the broadcast operand.  Also that every C entry of the kernel
library takes the arguments ``utils/build.py`` binds (no compiler here).
"""
import ctypes
import re

import pytest
import torch

from cudabulletproof_tpu_torch.ops import cuda_field, curve as TC
from cudabulletproof_tpu_torch.utils import build

L = 20


def _rows(*shape):
    return torch.arange(int(torch.tensor(shape).prod()),
                        dtype=torch.int32).reshape(shape)


def _read(t: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """n rows of L limbs at t's data pointer, row stride `step`."""
    return torch.as_strided(t, (n, L), (step, 1), t.storage_offset())


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
    }


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
