"""Port parity: the Hamming core and kernel K1's plain version.

`masked_best2_gated_plain` must equal JAX's `hamming_matrix` +
`masked_best2` under the same gate exactly, including ties (lowest index),
fully masked rows (idx 0, BIG, BIG) and candidates on the window's rim.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.ops import hamming as jham
from orb_slam2_refactored_tpu_torch.ops import hamming as tham
from torch_k1_cases import k1_grid_cases

torch.set_num_threads(1)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _jax_best2(q, t, row_ok, col_ok, gate=None):
    d = jham.hamming_matrix(jnp.asarray(q), jnp.asarray(t))
    mask = jnp.asarray(row_ok)[:, None] & jnp.asarray(col_ok)[None, :]
    if gate is not None:
        uv, r, lr, xy, lc = (jnp.asarray(g) for g in gate)
        d2 = jnp.sum((uv[:, None, :] - xy[None, :, :]) ** 2, axis=-1)
        mask = mask & (d2 <= r[:, None] ** 2) & (
            jnp.abs(lc[None, :] - lr[:, None]) <= 1)
    return [np.asarray(x) for x in jham.masked_best2(d, mask)]


def _case(seed, M=70, N=90, ties=True):
    rng = np.random.default_rng(seed)
    q, t = _desc(rng, M), _desc(rng, N)
    if ties:
        # duplicated targets -> equal minima at two indices
        t[40:50] = t[10:20]
        q[:10] = t[10:20]
        q[10:20] = t[40:50] ^ np.uint32(1)
    row_ok = rng.uniform(size=M) > 0.1
    row_ok[5] = False  # fully masked by row
    col_ok = rng.uniform(size=N) > 0.1
    return rng, q, t, row_ok, col_ok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ungated_matches_jax(seed):
    _, q, t, row_ok, col_ok = _case(seed)
    ref = _jax_best2(q, t, row_ok, col_ok)
    out = tham.masked_best2_gated(_t(q), _t(t), torch.from_numpy(row_ok),
                                  torch.from_numpy(col_ok))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), a)
    assert out[0][5] == 0 and out[1][5] == out[2][5] == tham.BIG
    assert (out[1] == out[2]).any()  # equal minima give second == best


@pytest.mark.parametrize("seed", [3, 4])
def test_window_gate_matches_jax_on_the_rim(seed):
    rng, q, t, row_ok, col_ok = _case(seed)
    M, N = len(q), len(t)
    xy = rng.uniform(0, 60, (N, 2)).astype(np.float32)
    lc = rng.integers(0, 4, N).astype(np.int32)
    lr = rng.integers(0, 4, M).astype(np.int32)
    r = rng.choice([3.0, 3.6, 7.2, 15.0], M).astype(np.float32)
    # half the rows sit exactly r (or r plus an ulp) from one target
    uv = rng.uniform(0, 60, (M, 2)).astype(np.float32)
    for i in range(0, M, 2):
        j = i % N
        ang = rng.uniform(0, 2 * np.pi)
        uv[i] = xy[j] + np.float32(r[i]) * np.array(
            [np.cos(ang), np.sin(ang)], np.float32)
        if i % 4 == 0:
            uv[i, 0], uv[i, 1] = xy[j, 0] + r[i], xy[j, 1]  # exact rim
        lr[i] = lc[j]
    gate = (uv, r, lr, xy, lc)
    ref = _jax_best2(q, t, row_ok, col_ok, gate)
    out = tham.masked_best2_gated(
        _t(q), _t(t), torch.from_numpy(row_ok), torch.from_numpy(col_ok),
        *(torch.from_numpy(g) for g in gate))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), a)
    assert (ref[1] == jham.BIG).any() and (ref[1] < jham.BIG).any()


@pytest.mark.parametrize("seed", [5, 6])
def test_pair_gate_matches_jax(seed):
    """The dense pair gate of triangulation (its epipolar mask) ANDed into
    the row and column gates, as `_triangulate_impl` builds its mask."""
    rng, q, t, row_ok, col_ok = _case(seed)
    pair_ok = rng.uniform(size=(len(q), len(t))) > 0.6
    pair_ok[7] = False  # a row the pair gate masks whole
    d = jham.hamming_matrix(jnp.asarray(q), jnp.asarray(t))
    mask = (jnp.asarray(row_ok)[:, None] & jnp.asarray(col_ok)[None, :]
            & jnp.asarray(pair_ok))
    ref = [np.asarray(x) for x in jham.masked_best2(d, mask)]
    out = tham.masked_best2_gated(_t(q), _t(t), torch.from_numpy(row_ok),
                                  torch.from_numpy(col_ok),
                                  pair_ok=torch.from_numpy(pair_ok))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), a)
    assert out[0][7] == 0 and out[1][7] == out[2][7] == tham.BIG


@pytest.mark.parametrize("name", ["lattice", "chunked", "all_rows_invalid"])
def test_grid_cases_match_jax(name):
    """The inputs that exercise K1's cell scan on the card (cell edges,
    d2 == r2, equal minima in different cells, empty windows, invalid
    blocks, two binning chunks, whole-grid and infinite radii, NaN and
    infinite coordinates): the plain version equals JAX exactly."""
    a = k1_grid_cases()[name]
    gate = tuple(a[k] for k in ("uv", "rad", "lvl_r", "xy", "lvl_c"))
    # JAX takes the descriptors as uint32
    ref = _jax_best2(a["q"].view(np.uint32), a["t"].view(np.uint32),
                     a["row_ok"], a["col_ok"], gate)
    out = tham.masked_best2_gated(**{k: torch.from_numpy(v)
                                     for k, v in a.items()})
    for x, y in zip(ref, out):
        np.testing.assert_array_equal(y.numpy(), x)
    if name == "all_rows_invalid":
        assert (ref[1] == jham.BIG).all() and (ref[0] == 0).all()
    else:
        assert (ref[1] == ref[2]).any()  # equal minima somewhere
        assert (ref[1] == jham.BIG).any() and (ref[1] < jham.BIG).any()


def test_pairwise_and_matrix_popcount():
    rng = np.random.default_rng(7)
    a, b = _desc(rng, 33), _desc(rng, 33)
    np.testing.assert_array_equal(
        tham.hamming_pairwise(_t(a), _t(b)).numpy(),
        np.asarray(jham.hamming_pairwise(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        tham.hamming_matrix(_t(a), _t(b)).numpy(),
        np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_duplicates_and_mutual_filter(seed):
    rng = np.random.default_rng(seed)
    M, N = 200, 40
    tgt = rng.integers(0, N, M).astype(np.int32)
    dist = rng.integers(0, 12, M).astype(np.int32)  # many equal distances
    valid = rng.uniform(size=M) > 0.2
    ref = np.asarray(jham.resolve_duplicates(
        jnp.asarray(tgt), jnp.asarray(dist), jnp.asarray(valid), N))
    out = tham.resolve_duplicates(torch.from_numpy(tgt),
                                  torch.from_numpy(dist),
                                  torch.from_numpy(valid), N)
    np.testing.assert_array_equal(out.numpy(), ref)
    idx_ab = rng.integers(0, N, M).astype(np.int32)
    idx_ba = rng.integers(0, M, N).astype(np.int32)
    np.testing.assert_array_equal(
        tham.mutual_filter(torch.from_numpy(idx_ab),
                           torch.from_numpy(idx_ba)).numpy(),
        np.asarray(jham.mutual_filter(jnp.asarray(idx_ab),
                                      jnp.asarray(idx_ba))))

