"""The port's field inner products (``ops/field.py``: ``inner_product``,
``inner_product_batched``, their twins ``inner_product_plain``,
``inner_product_batched_plain``, the partial ``ip_partial_plain`` and the
glue ``ip_combine`` / ``fold_wide``) against the JAX package's Pallas
``pallas_field.inner_product`` / ``inner_product_batched`` in interpret
mode, as ``tests/test_pallas_field.py`` runs them on the CPU.

The same inputs, made with numpy from a seed (random weak limbs with edge
rows among them: every limb 8799 or 8191, 0, 1, p - 1), go through both.
Tolerance zero: the limbs must be equal, not only the value mod p, which is
also held against Python integers.  n = 33,068 (= 128 * 256 + 300) takes
the column wrap: from 32,769 elements on, several tiles add into one column
of the partial, and only the JAX partition gives the JAX limbs.  Two tests
in torch alone (no JAX compile) pin that partition, which the CUDA kernel
keeps: the lo sums may be grouped any way, the kernel's column terms
among them; hi split per tile instead of per column changes the limbs.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabulletproof_tpu.ops import pallas_field as PF
from cudabulletproof_tpu_torch.ops import cuda_field, field as TF
from jax_release import release_jax_programs  # noqa: F401 (autouse)
pytest_plugins = ["jax_maps_guard"]  # see tests/jax_maps_guard.py

P = TF.P


def _raw(v: int) -> list:
    return [(v >> (13 * i)) & 0x1FFF for i in range(20)]


EDGES = [[TF.BOUND] * 20, [0x1FFF] * 20, _raw(0), _raw(1), _raw(P - 1)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _operands(seed: int, shape: tuple):
    """Random weak limbs of `shape` + (20,), the edge rows at random places
    of each row of a and, reversed, of b."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, TF.BOUND + 1, size=shape + (20,), dtype=np.int32)
    b = rng.integers(0, TF.BOUND + 1, size=shape + (20,), dtype=np.int32)
    edges = np.array(EDGES, dtype=np.int32)
    n = shape[-1]
    k = min(n, len(edges))
    for row_a, row_b in zip(a.reshape(-1, n, 20), b.reshape(-1, n, 20)):
        row_a[rng.choice(n, k, replace=False)] = edges[:k]
        row_b[rng.choice(n, k, replace=False)] = edges[::-1][:k]
    return a, b


def _value(limbs) -> int:
    return sum(int(v) << (13 * i) for i, v in enumerate(limbs)) % P


def _want(a, b) -> int:
    return sum(_value(x) * _value(y) for x, y in zip(a, b)) % P


@pytest.mark.parametrize("n", [1, 8, 255, 256, 257, 1000, 128 * 256 + 300])
def test_inner_product_matches_pallas(n):
    """The twin equals ``PF.inner_product`` limb for limb; ``inner_product``
    takes the twin on the CPU; the value is <a, b> mod p."""
    a, b = _operands(n, (n,))
    got = TF.inner_product_plain(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(PF.inner_product(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(TF.inner_product(torch.from_numpy(a),
                                        torch.from_numpy(b)), got)
    assert _value(got.numpy()) == _want(a, b)
    assert 0 <= int(got.min()) and int(got.max()) <= TF.BOUND


def test_inner_product_batched_matches_pallas():
    """(B, n) = (3, 300): the batched twin equals
    ``PF.inner_product_batched`` limb for limb, each row equals the single
    twin on that row, and the values are the rows' <a, b> mod p."""
    a, b = _operands(3, (3, 300))
    got = TF.inner_product_batched(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(PF.inner_product_batched(jnp.asarray(a),
                                               jnp.asarray(b)))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, TF.inner_product_batched_plain(
        torch.from_numpy(a), torch.from_numpy(b)))
    for i in range(3):
        assert torch.equal(got[i], TF.inner_product_plain(
            torch.from_numpy(a[i]), torch.from_numpy(b[i])))
        assert _value(got[i].numpy()) == _want(a[i], b[i])


def test_partial_columns_and_fold():
    """The partial is the Pallas kernel's layout: at 600 elements (three
    tiles) the lo sums of tile t sit in column t and its hi sums in column
    128 + t, all other columns 0; ``fold_wide`` is the JAX ``_fold_wide``
    on random 41-coefficient rows (41 -> 22 -> 20)."""
    a, b = _operands(600, (1, 600))
    part = TF.ip_partial_plain(torch.from_numpy(a), torch.from_numpy(b))[0]
    assert part.shape == (39, 256) and part.dtype == torch.int32
    conv = TF.limb_conv(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    conv = torch.nn.functional.pad(conv, (0, 0, 0, 768 - 600))
    tiles = conv.reshape(3, 256, 39)
    for t in range(3):
        assert torch.equal(part[:, t], (tiles[t] & TF.MASK).sum(0).int())
        assert torch.equal(part[:, 128 + t], (tiles[t] >> TF.W).sum(0).int())
    assert not part[:, 3:128].any() and not part[:, 131:].any()
    rng = np.random.default_rng(41)
    t = rng.integers(0, 1 << 30, size=(5, 41), dtype=np.int32)
    got = TF.fold_wide(torch.from_numpy(t)).numpy()
    assert np.array_equal(got, np.asarray(PF._fold_wide(jnp.asarray(t.T)).T))


def test_bounds_and_dispatch():
    """More than 2^17 elements are refused, as the JAX functions assert; a
    tensor that is not on the CPU (``meta`` stands in for CUDA) goes to the
    kernel wrapper, which refuses it, and no launch is counted; the
    wrapper refuses CPU tensors and a second row unless batched."""
    big = torch.zeros((TF.IP_MAX + 1, 20), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        TF.inner_product(big, big)
    with pytest.raises(ValueError, match="at most"):
        TF.inner_product_batched(big[None], big[None])
    with pytest.raises(ValueError):
        TF.inner_product_batched(big[None, :3], big[None, :4])
    before = dict(cuda_field.launches)
    meta = torch.empty((2, 5, 20), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TF.inner_product(meta[0], meta[0])
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TF.inner_product_batched(meta, meta)
    cpu = torch.zeros((2, 5, 20), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_field.inner_product(cpu, cpu, batched=True)
    assert cuda_field.launches == before
    zero = TF.inner_product(cpu[0, :0], cpu[0, :0])
    assert zero.shape == (20,) and not zero.any()


@functools.lru_cache(maxsize=1)
def _shared_columns(n: int):
    """a, b [n, 20] (n > 32,768: tiles t and t + 128 share column t % 128)
    with the edge rows in tile 0 and in every later tile of its column, the
    coefficients split per element into lo and hi [tiles, 256, 39], the
    tiles' columns, and the twin's limbs."""
    a, b = _operands(n, (n,))
    tiles = -(-n // TF.IP_LANES)
    edges = np.array(EDGES, dtype=np.int32)
    for t in range(0, tiles, TF.IP_COLUMNS):
        at = t * TF.IP_LANES + 7
        a[at:at + len(edges)] = edges
        b[at:at + len(edges)] = edges[::-1]
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    c = torch.nn.functional.pad(TF.limb_conv(a, b),
                                (0, 0, 0, tiles * TF.IP_LANES - n))
    c = c.reshape(tiles, TF.IP_LANES, 39)
    col = torch.arange(tiles) % TF.IP_COLUMNS
    return a, b, c & TF.MASK, c >> TF.W, col, TF.inner_product_plain(a, b)


def _by_column(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """[tiles, 39] sums -> [128, 39], tile t's into column t % 128."""
    out = torch.zeros((TF.IP_COLUMNS, x.shape[-1]), dtype=torch.int32)
    return out.index_add_(0, col, x)


def _limbs(s0, h0, h1) -> torch.Tensor:
    """The Pallas glue after the column sums: s0 at offset 0, h0 at 1, h1
    at 2 into 41 terms, then fold_wide and normalize_weak."""
    pad = torch.nn.functional.pad
    t = pad(s0, (0, 2)) + pad(h0, (1, 1)) + pad(h1, (2, 0))
    return TF.normalize_weak(TF.fold_wide(t))


def _split(hi: torch.Tensor) -> tuple:
    """hi sums [.., 39] split again and summed over the leading dim: (the
    low 13 bits, the rest)."""
    return (hi & TF.MASK).sum(0, dtype=torch.int32), \
        (hi >> TF.W).sum(0, dtype=torch.int32)


@pytest.mark.parametrize("lo_by", ["all at once", "per tile", "per column",
                                   "column terms"])
def test_lo_partition_is_free(lo_by):
    """Torch only: at n = 33,068 (tiles 0 and 128, 1 and 129 share a
    column), with the edge rows in tiles that share a column, the lo sums
    may be grouped any way -- all at once,
    per tile, per column -- and the twin's limbs stay the same, as long as
    hi is split per column; "column terms" is the kernel's grouping: each
    column's lo sums, its hi sums split at once, at offsets 0, 1, 2, then
    summed over the columns."""
    _, _, lo, hi, col, want = _shared_columns(128 * 256 + 300)
    h0, h1 = _split(_by_column(hi.sum(1, dtype=torch.int32), col))
    if lo_by == "all at once":
        s0 = lo.sum((0, 1), dtype=torch.int32)
    elif lo_by == "per tile":
        s0 = lo.sum(1, dtype=torch.int32).sum(0, dtype=torch.int32)
    elif lo_by == "per column":
        s0 = _by_column(lo.sum(1, dtype=torch.int32), col).sum(
            0, dtype=torch.int32)
    else:
        cl = _by_column(lo.sum(1, dtype=torch.int32), col)
        ch = _by_column(hi.sum(1, dtype=torch.int32), col)
        pad = torch.nn.functional.pad
        terms = pad(cl, (0, 2)) + pad(ch & TF.MASK, (1, 1)) + \
            pad(ch >> TF.W, (2, 0))
        got = TF.normalize_weak(TF.fold_wide(terms.sum(0, dtype=torch.int32)))
        assert torch.equal(got, want)
        return
    assert torch.equal(_limbs(s0, h0, h1), want)


def _carry_case(n: int):
    """a, b [n, 20], zero but for three elements: in tile 0 and in the last
    tile of column 0 one each whose coefficient 0 is 4096 * 8192 (hi 4096,
    so the column's hi sum carries out of its low 13 bits where each
    tile's does not), and in tile 1 one whose coefficients 2..19 are 8191
    (lo), so that the column's carry lands on a run of 8191s."""
    a = np.zeros((n, 20), dtype=np.int32)
    b = np.zeros((n, 20), dtype=np.int32)
    last = (-(-n // TF.IP_LANES) - 1) // TF.IP_COLUMNS * TF.IP_COLUMNS
    for e in (3, last * TF.IP_LANES + 3):
        a[e, 0], b[e, 0] = 4096, 8192
    a[TF.IP_LANES + 5, 0] = 1
    b[TF.IP_LANES + 5, 2:] = 8191
    return a, b


@pytest.mark.parametrize("n", [128 * 256 + 300, 1 << 17])
def test_hi_split_per_tile_changes_the_limbs(n):
    """Torch only: hi split per tile instead of per column changes the
    limbs but not the value mod p, so only the column partition gives the
    JAX package's limbs.  The difference is a carry that the three relax
    passes leave one limb apart, which needs a column whose tiles' hi sums
    carry together and a run of 8191s above it: random limbs rarely have
    one (the edge-row operands of test_lo_partition_is_free do not), so the
    operands are built to (_carry_case)."""
    a, b = _carry_case(n)
    want = TF.inner_product_plain(torch.from_numpy(a), torch.from_numpy(b))
    c = TF.limb_conv(torch.from_numpy(a), torch.from_numpy(b))
    tiles = -(-n // TF.IP_LANES)
    c = torch.nn.functional.pad(c, (0, 0, 0, tiles * TF.IP_LANES - n))
    c = c.reshape(tiles, TF.IP_LANES, 39)
    col = torch.arange(tiles) % TF.IP_COLUMNS
    s0 = (c & TF.MASK).sum((0, 1), dtype=torch.int32)
    hi = (c >> TF.W).sum(1, dtype=torch.int32)
    assert torch.equal(_limbs(s0, *_split(_by_column(hi, col))), want)
    got = _limbs(s0, *_split(hi))
    assert not torch.equal(got, want)
    live = a.any(1)
    assert _value(got.numpy()) == _value(want.numpy()) == _want(a[live],
                                                               b[live])
