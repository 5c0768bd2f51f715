"""The sort-plus-scan MSM's layouts give the same points (CPU, no JAX).

The card path runs the bucket fold in its own layout
(``config.MSM_FOLD_LANES_CUDA`` lanes), where the CPU path keeps the JAX
package's (``MSM_FOLD_LANES``; ``tests/test_torch_pippenger.py`` holds it to
the Pallas kernel limb for limb); both scan in ``MSM_SCAN_LANES``.  A
layout regroups a sum of points, and the unified add is associative only
on the group, so these tests feed curve points: multiples of the base, the
identity and the 8-torsion points.  Held against the python-int oracle:

* ``bucket_fold_plain(body, lanes)`` compresses to sum_b b * S_b for every
  lane count, from one lane to more lanes than rows;
* one window of ``msm_pippenger`` (``pippenger._bucket_window``: the sort,
  the scan, the carries and the fold) in the card path's fold layout and in
  the JAX package's equals the oracle's weighted bucket sum of that
  window's digits; the windows' Horner combination does not depend on the
  layout.
"""
import numpy as np
import pytest
import torch

from cudabulletproof_tpu_torch import config
from cudabulletproof_tpu_torch.ops import curve as TC, pippenger as TP
from cudabulletproof_tpu_torch.utils import oracle

ELL = oracle.ELL
TORSION = oracle.small_order_points()


def _points(n: int, seed: int):
    """n curve points in a seeded order: the 8-torsion points (the identity
    among them) and the multiples B, 2B, ...; returns (points, coefficient
    of B of each or None for a torsion point)."""
    tor = TORSION[:n]
    acc, mult = oracle.IDENTITY, []
    for _ in range(n - len(tor)):
        acc = acc + oracle.BASE
        mult.append(acc)
    pts = list(tor) + mult
    coef = [None] * len(tor) + list(range(1, len(mult) + 1))
    perm = np.random.default_rng(seed).permutation(n)
    return [pts[i] for i in perm], [coef[i] for i in perm]


def _weighted(pts, coef, weights) -> oracle.Point:
    """sum_i weights[i] * pts[i]: the multiples of B in one scalar
    multiplication, the torsion points one by one."""
    k = sum(w * c for w, c in zip(weights, coef) if c is not None) % ELL
    want = k * oracle.BASE
    for w, p, c in zip(weights, pts, coef):
        if c is None:
            want = want + (w % 8) * p
    return want


@pytest.mark.parametrize("lanes", [1, 4, 128, 512, 1024])
@pytest.mark.parametrize("m", [1, 100, 2047])
def test_bucket_fold_layouts_give_one_point(m, lanes):
    """The table in descending bucket order, row i the bucket m - i:
    sum_b b * S_b = sum_i (m - i) * row i, at every lane count."""
    torch.set_num_threads(1)
    pts, coef = _points(m, m)
    body = TC.flatten(TC.from_oracle(pts)).reshape(m, 80)
    got = TC.unflatten(TP.bucket_fold_plain(body, lanes))
    want = _weighted(pts, coef, [m - i for i in range(m)])
    assert TC.to_oracle(got) == [want]
    assert bytes(TC.to_bytes(got).tolist()) == want.compress()


@pytest.mark.parametrize("layout", ["jax", "card"])
@pytest.mark.parametrize("n,w,values", [
    (2048, 8, 256),         # chunked at 1024 lanes: 2 steps a lane
    (2048, 5, 3),           # runs of ~700 equal digits across many lanes
    (40, 5, 32)])           # too small to chunk: the unchunked scan
def test_bucket_window_layouts_match_oracle(monkeypatch, layout, n, w,
                                            values):
    """One window's sum_b b * S_b through the CPU twins in the JAX
    package's layouts and in the card path's."""
    torch.set_num_threads(1)
    if layout == "card":
        monkeypatch.setattr(config, "MSM_FOLD_LANES",
                            config.MSM_FOLD_LANES_CUDA)
    pts, coef = _points(n, n + w)
    digits = np.random.default_rng(w).integers(0, values, size=n)
    got = TP._bucket_window(TC.flatten(TC.from_oracle(pts)),
                            torch.from_numpy(digits.astype(np.int32)), w)
    assert TC.to_oracle(got) == [_weighted(pts, coef, digits.tolist())]


def test_fold_layout_by_device():
    """The fold takes a power of two of lanes: the JAX package's 128 on the
    CPU, config.MSM_FOLD_LANES_CUDA on the card."""
    for lanes in (config.MSM_FOLD_LANES, config.MSM_FOLD_LANES_CUDA):
        assert lanes >= 1 and lanes & (lanes - 1) == 0
    assert config.MSM_FOLD_LANES == 128
    assert config.fold_lanes(torch.device("cpu")) == 128
    assert config.fold_lanes(torch.device("cuda")) == \
        config.MSM_FOLD_LANES_CUDA
