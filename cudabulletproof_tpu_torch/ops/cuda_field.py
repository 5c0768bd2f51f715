"""Wrappers of the hand-written CUDA field kernels (csrc/field_kernels.cu).

    fe_mul      <- cudabulletproof_tpu/ops/pallas_field.py::_mul_kernel
    fe_sq       <- pallas_field.py::_sq_kernel
    fe_pow2523  <- pallas_field.py::_pow2523_kernel
    fe_invert   <- pallas_field.py::_invert_kernel
    fe_add      <- pallas_field.py::_add_kernel (a + b, three relax rounds)
    fe_sub      <- pallas_field.py::_sub_kernel (a + (K - b), three rounds)
    fe_inner_product          <- pallas_field.py::_inner_product_kernel
    fe_inner_product_batched  <- pallas_field.py::_inner_product_batched_kernel
    fe_mul_chain  <- benchmarks/bench_radix16.py::chain13's kernel ``kern``
                     (``reps`` dependent fe_mul in one launch)

Each wrapper takes CUDA int32 tensors of 20-limb field elements whose batch
dims broadcast, expands them to one shape, makes them contiguous and flat
``[n, 20]``, launches on PyTorch's current stream into an output made with
``torch.empty``, and restores the batch shape.  ``mul`` and ``sq`` (and
``cuda_curve``'s ``add``, ``double`` and ``reduce_tiles``) read their
operands in place instead: each operand passes as its data pointer and one
row stride (``operand``), so that on the paths' layouts -- contiguous rows,
coordinate views of a point row, slices of them, a broadcast row -- a call
allocates only its output and launches once; an operand whose batch dims do
not flatten to one stride is copied first.  ``pow2523`` and ``invert`` also
pass the width G of the lane groups that run each element's Fermat chain
(``config.chain_lanes`` for the count unless the caller names one).
``inner_product`` takes ``[B, n, 20]`` operands and returns their ``[B,
20]`` limbs from one launch (the column sums; the last block of a row
combines and folds them), in one allocation; rows that are not contiguous
and 16-byte aligned are copied once.  Each wrapper raises on anything its
kernel does not take; there is no fallback.  The plain twins live in
``ops/field.py`` (``mul_plain``, ``sq_plain``, ``pow2523_plain``,
``invert_plain``, ``add3_plain``, ``sub3_plain``,
``inner_product_batched_plain``, ``mul_chain_plain``).

``launches`` counts kernel launches per kernel, one per launch and nowhere
else, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..utils import build

L = 20
launches = {"fe_mul": 0, "fe_sq": 0, "fe_pow2523": 0, "fe_invert": 0,
            "fe_add": 0, "fe_sub": 0, "fe_inner_product": 0,
            "fe_inner_product_batched": 0, "fe_mul_chain": 0}
IP_LANES = 256             # elements a tile (the Pallas kernels' LANES)
IP_COLUMNS = 128           # tile t belongs to column t % 128
IP_TERMS = 2 * L + 1       # a column's terms: s0 at k, h0 at k + 1, h1 at k + 2
MAX_ROWS = 65535           # the grid's y extent
_tickets = {}              # (device index, raw stream) -> the rows' tickets


def check_operands(width: int, ts) -> tuple:
    """Check CUDA int32 operands of row width `width` on one device; returns
    (their device, their broadcast batch shape)."""
    dev = ts[0].device
    shape = ts[0].shape
    same = True
    for t in ts:
        d, sh = t.device, t.shape
        if d.type != "cuda":
            raise ValueError(f"kernel operand on {d}, needs a CUDA tensor")
        if d != dev:
            raise ValueError(f"kernel operands on {dev} and {d}")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operand of dtype {t.dtype}, needs int32")
        if not sh or sh[-1] != width:
            raise ValueError(f"kernel operand of shape {tuple(sh)}, "
                             f"needs [..., {width}]")
        same = same and sh == shape
    if same:
        return dev, shape[:-1]
    return dev, torch.broadcast_shapes(*(t.shape[:-1] for t in ts))


def flat_operands(width: int, *ts: torch.Tensor):
    """Check CUDA int32 operands of row width `width` on one device;
    broadcast their batch dims and flatten to contiguous [n, width].
    Returns (batch shape, flat tensors)."""
    _, batch = check_operands(width, ts)
    flats = [t.expand(*batch, width).reshape(-1, width).contiguous()
             for t in ts]
    return batch, flats


def row_stride(shape, stride, batch):
    """The one row stride (in elements) at which a tensor of `shape` and
    `stride` ([..., width], limbs at stride 1), broadcast to `batch`, holds
    row i of the flattened batch at i * row stride: 0 where every row is the
    same (a broadcast); None where the limbs are not at stride 1 or the
    batch dims do not flatten to one stride (a transposed batch, a
    broadcast outer dim over a strided inner one).  Metadata only."""
    if stride[-1] != 1:
        return None
    lead = len(batch) - (len(shape) - 1)     # batch dims the tensor lacks
    step = span = None
    for d in range(len(batch) - 1, -1, -1):  # innermost first
        size = batch[d]
        if size == 1:
            continue
        k = d - lead
        eff = stride[k] if k >= 0 and shape[k] != 1 else 0
        if step is None:
            step = eff
        elif eff != span:
            return None
        span = eff * size
    return 0 if step is None else step


def operand(t: torch.Tensor, batch, width: int) -> tuple:
    """(tensor, row stride) of an operand broadcast to `batch`: the tensor
    itself, read in place at its data pointer, where ``row_stride`` finds
    one stride; else a contiguous copy of its broadcast (stride `width`)."""
    shape, stride = t.shape, t.stride()
    if len(shape) == 2 and len(batch) == 1 and stride[1] == 1:
        return t, (stride[0] if shape[0] != 1 else 0)   # [n, w] or [1, w]
    step = row_stride(shape, stride, batch)
    if step is None:
        return t.expand(*batch, width).contiguous(), width
    return t, step


def launch_rows(counts: dict, name: str, width: int, *ts: torch.Tensor,
                extra=()) -> torch.Tensor:
    """Launch ``bp_<name>(*flat operands, out, n, *extra, stream)`` on rows
    of `width` limbs and count it in `counts`; returns out in the
    operands' batch shape (no launch for n = 0)."""
    batch, flats = flat_operands(width, *ts)
    out = torch.empty_like(flats[0])
    n = out.shape[0]
    if n:
        build.launch(f"bp_{name}", out.device, *flats, out, n, *extra)
        counts[name] += 1
    return out.reshape(*batch, width)


def _run(name: str, *ts: torch.Tensor, extra=()) -> torch.Tensor:
    return launch_rows(launches, name, L, *ts, extra=extra)


def _in_place(name: str, *ts: torch.Tensor) -> torch.Tensor:
    """One launch of ``bp_<name>(a, row stride of a, ..., out, n, stream)``
    on the operands read in place (``operand``): one allocation, the
    output in their broadcast batch shape."""
    dev, batch = check_operands(L, ts)
    planned = [operand(t, batch, L) for t in ts]
    out = torch.empty((*batch, L), dtype=torch.int32, device=dev)
    n = math.prod(batch)
    if n:
        args = [x for t, s in planned for x in (t.data_ptr(), s)]
        build.launch(f"bp_{name}", dev, *args, out.data_ptr(), n)
        launches[name] += 1
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p; both read in place."""
    return _in_place("fe_mul", a, b)


def sq(a: torch.Tensor) -> torch.Tensor:
    """a^2 mod p; read in place."""
    return _in_place("fe_sq", a)


def _chain(name: str, a: torch.Tensor, lanes=None) -> torch.Tensor:
    """The Fermat chain kernel `name` (fe_pow2523 or fe_invert) on a, each
    element on a group of `lanes` lanes (default ``config.chain_lanes`` for
    the count)."""
    dev, batch = check_operands(L, (a,))
    if lanes is None:
        lanes = config.chain_lanes(dev, math.prod(batch))
    if lanes not in config.CHAIN_WIDTHS:
        raise ValueError(f"{name} on groups of {lanes} lanes: the kernels "
                         f"take {config.CHAIN_WIDTHS}")
    return _run(name, a, extra=(lanes,))


def pow2523(a: torch.Tensor, lanes=None) -> torch.Tensor:
    return _chain("fe_pow2523", a, lanes)


def invert(a: torch.Tensor, lanes=None) -> torch.Tensor:
    return _chain("fe_invert", a, lanes)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _run("fe_add", a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _run("fe_sub", a, b)


def mul_chain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """x <- x*b, `reps` times from x = a, in one launch (reps <= 0 copies
    a)."""
    return _run("fe_mul_chain", a, b, extra=(int(reps),))


def _ip_rows(t: torch.Tensor) -> torch.Tensor:
    """t itself where its rows are contiguous and 16-byte aligned (the
    kernel's int4 loads), else one contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _row_tickets(dev: torch.device) -> torch.Tensor:
    """The inner-product kernel's per-row tickets for the current stream of
    `dev`: zeros made at the stream's first call, which every launch leaves
    zero (its last block of a row resets that row's), so each launch on the
    stream finds them zero; a stream never shares them with another."""
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    tickets = _tickets.get(key)
    if tickets is None:
        tickets = _tickets[key] = torch.zeros(MAX_ROWS, dtype=torch.int32,
                                              device=dev)
    return tickets


def inner_product(a: torch.Tensor, b: torch.Tensor,
                  batched: bool) -> torch.Tensor:
    """<a_i, b_i> mod p of a, b [B, n, 20] as [B, 20] weak limbs, the JAX
    package's limbs (``field.inner_product_batched_plain``'s): one launch,
    ``bp_fe_inner_product`` (counted as fe_inner_product) for B = 1 when
    not `batched`, else ``bp_fe_inner_product_batched``, into one
    allocation that holds the limbs and the kernel's column terms
    ``[B, min(128, tiles), 41]``.  B = 0 launches nothing."""
    dev, _ = check_operands(L, (a, b))
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"inner product of {tuple(a.shape)} and "
                         f"{tuple(b.shape)}: needs two [B, n, {L}]")
    rows, n = a.shape[0], a.shape[1]
    if not batched and rows != 1:
        raise ValueError(f"fe_inner_product takes one row, not {rows}")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} inner products in one launch: at most "
                         f"{MAX_ROWS}")
    columns = min(IP_COLUMNS, max(1, -(-n // IP_LANES)))
    out = torch.empty(rows * (L + columns * IP_TERMS), dtype=torch.int32,
                      device=dev)
    if rows:
        ptr = out.data_ptr()
        scratch = ptr + 4 * rows * L
        a, b = _ip_rows(a), _ip_rows(b)
        tickets = _row_tickets(dev)
        if batched:
            build.launch("bp_fe_inner_product_batched", dev, a, b, ptr,
                         scratch, tickets, rows, n)
            launches["fe_inner_product_batched"] += 1
        else:
            build.launch("bp_fe_inner_product", dev, a, b, ptr, scratch,
                         tickets, n)
            launches["fe_inner_product"] += 1
    return out[:rows * L].view(rows, L)
