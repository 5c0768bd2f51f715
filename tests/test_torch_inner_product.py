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
the column wrap: from 32,768 elements on, several tiles add into one column
of the partial, and only the JAX partition gives the JAX limbs.
"""
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
        cuda_field.inner_product_partial(cpu, cpu, batched=True)
    assert cuda_field.launches == before
    zero = TF.inner_product(cpu[0, :0], cpu[0, :0])
    assert zero.shape == (20,) and not zero.any()
