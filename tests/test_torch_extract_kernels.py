"""Port parity for the plain sides of extraction's kernels K8 (the pyramid,
`csrc/pyramid.cu`) and K9 (the per-level spread top-k,
`csrc/spread_topk.cu`), which run only on a card.

- K8's tap tables (`ops/image.py::resize_taps`) rebuild the dense weight
  matrices of `_resize_weights_np` exactly, at every level pair of four
  camera sizes; the most taps an output has fits the kernel's
  compile-time limit, and every tile's input span fits the shared memory
  the launch asks for.
- K8's arithmetic: a numpy emulation of the kernel, tile by tile (the
  span staged as the kernel stages it, each `fmaf` an f64 product plus the
  sum, rounded to f32), stays within 1e-4 gray of the plain
  `build_pyramid_plain` (a dense f32 product a pass, summed in the BLAS's
  order) on a bench frame, and within 1e-3 of JAX's jitted `build_pyramid`
  (`test_pyramid_within_c2_tolerance`'s tolerance, hazard C2).
- The split finder: `fmaf_np` is the correctly rounded fused multiply-add
  (held against exact rational arithmetic, ties included), and
  `infer_tap_splits` recovers the sums of a GEMM that splits outputs'
  taps into two partial chains, so K8 can equal the card's GEMM.
- K9's plain version, `spread_topk_levels_plain`, is bit for bit JAX's
  `select_spread_topk` followed by the clamps, the level-0 coordinates and
  the level ids of JAX's `_extract_impl_pyr`, on the same rank rounds.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.ops import image as jimage
from orb_slam2_refactored_tpu.ops import orb as jorb
from fractions import Fraction

from orb_slam2_refactored_tpu_torch import kernels
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.ops import fast as tfast
from orb_slam2_refactored_tpu_torch.ops import image as timage
from orb_slam2_refactored_tpu_torch.ops import orb as torb
from test_torch_rank import CASES, _score

torch.set_num_threads(1)

# camera sizes (h, w): QVGA, the bench's VGA, EuRoC, KITTI
SIZES = [(240, 320), (480, 640), (480, 752), (376, 1241)]


def _constant(name):
    src = open(os.path.join(kernels.CSRC_DIR, "pyramid.cu")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _pairs(h, w, n_levels=8, scale=1.2):
    shapes = timage.pyramid_shapes(h, w, n_levels, scale)
    for (ih, iw), (oh, ow) in zip(shapes[:-1], shapes[1:]):
        yield ih, oh
        yield iw, ow


@pytest.mark.parametrize("h,w", SIZES)
def test_tap_tables_rebuild_the_weight_matrices(h, w):
    assert timage.PYR_MAX_TAPS == _constant("kMaxTaps")
    assert timage.PYR_TILE == (_constant("TY"), _constant("TX"))
    most = 0
    for n_in, n_out in _pairs(h, w):
        idx, taps = timage.resize_taps(n_in, n_out)
        assert idx.dtype == np.int32 and taps.dtype == np.float32
        assert idx.shape == (n_out, _constant("kIdx"))
        np.testing.assert_array_equal(idx[:, 4], idx[:, 1])  # one chain
        dense = np.zeros((n_in, n_out), np.float32)
        for o in range(n_out):
            f, c = idx[o, 0], idx[o, 1]
            dense[f:f + c, o] = taps[o, :c]
            assert not taps[o, c:].any()
        np.testing.assert_array_equal(dense, timage._resize_weights_np(
            n_in, n_out))
        most = max(most, int(idx[:, 1].max()))
    assert 2 <= most <= timage.PYR_MAX_TAPS


def _tile_spans_hold(idx, tile, span):
    """Every tile's outputs read inside [lo of its first, hi of its last),
    and that span fits `span`."""
    n = idx.shape[0]
    for o0 in range(0, n, tile):
        o1 = min(o0 + tile, n) - 1
        lo, hi = idx[o0, 2], idx[o1, 3]
        assert hi - lo <= span
        f, c = idx[o0:o1 + 1, 0], idx[o0:o1 + 1, 1]
        assert (f[c > 0] >= lo).all() and (f + c)[c > 0].max() <= hi


@pytest.mark.parametrize("h,w,n_levels", [(480, 640, 8), (376, 1241, 8),
                                          (37, 23, 8), (9, 5, 6)])
def test_pyramid_plan_layout_and_spans(h, w, n_levels):
    """The buffer's levels start 16 bytes apart at least and do not
    overlap; every tile's taps lie inside its staged span, and the launch's
    shared memory holds the largest span and its vertical sums. Down to
    levels a few pixels wide, where a level keeps a size (one tap of 1.0,
    an exact copy, as the plain version skips the product)."""
    plan = timage._pyramid_plan(h, w, n_levels, 1.2, "cpu")
    shapes = timage.pyramid_shapes(h, w, n_levels, 1.2)
    assert plan.shapes == shapes
    ends = [o + a * b for o, (a, b) in zip(plan.offsets, shapes[1:])]
    assert all(o % 4 == 0 for o in plan.offsets)
    assert all(e <= o for e, o in zip(ends[:-1], plan.offsets[1:]))
    assert ends[-1] <= plan.total
    ty, tx = timage.PYR_TILE
    spans = list(plan.args[3])
    smem = plan.args[4]
    for l, ((ih, iw), (oh, ow)) in enumerate(zip(shapes[:-1], shapes[1:])):
        vi, _ = timage.resize_taps(ih, oh)
        hi, _ = timage.resize_taps(iw, ow)
        _tile_spans_hold(vi, ty, spans[2 * l])
        _tile_spans_hold(hi, tx, spans[2 * l + 1])
        assert 4 * (spans[2 * l] + ty) * spans[2 * l + 1] <= smem
    if (h, w) == (9, 5):
        assert any(a == b for a, b in zip(shapes[:-1], shapes[1:]))


def test_extractor_builds_pyramid_tables_only_for_a_card():
    """`prepare_pyramid` finds the plan `pyramid_levels` looks up (the
    device named as a tensor's device names it); an extractor builds K8's
    tables when it is given a CUDA device, and for no other."""
    plans = timage._pyramid_plan.cache_info
    plan = timage.prepare_pyramid(60, 80, 3, 1.2, torch.device("cpu"))
    hits = plans().hits
    assert timage._pyramid_plan(60, 80, 3, 1.2, "cpu") is plan
    assert plans().hits == hits + 1
    built = plans().misses
    torb.OrbExtractor(64, 88, 200, 1.2, 3)
    torb.OrbExtractor(64, 88, 200, 1.2, 3, device="cpu")
    assert plans().misses == built


def _chain(src, idx, taps):
    """One `fmaf` chain an output over the staged values `src` [taps, m]:
    the first product rounded, then each tap an f64 product plus the sum,
    rounded to f32."""
    acc = None
    for t in range(idx[1]):
        prod = np.float64(taps[t]) * src[t].astype(np.float64)
        acc = (prod if acc is None else prod + acc.astype(np.float64)).astype(
            np.float32)
    return np.zeros(src.shape[1:], np.float32) if acc is None else acc


def _emulate_k8(img, n_levels, scale):
    """Kernel K8 in numpy, tile by tile as `resize_tile` runs it."""
    ty, tx = timage.PYR_TILE
    levels = [img]
    shapes = timage.pyramid_shapes(*img.shape, n_levels, scale)
    for oh, ow in shapes[1:]:
        src = levels[-1]
        vi, vt = timage.resize_taps(src.shape[0], oh)
        hi, ht = timage.resize_taps(src.shape[1], ow)
        out = np.empty((oh, ow), np.float32)
        for oy0 in range(0, oh, ty):
            my = min(ty, oh - oy0)
            ry0, ry1 = vi[oy0, 2], vi[oy0 + my - 1, 3]
            for ox0 in range(0, ow, tx):
                mx = min(tx, ow - ox0)
                rx0, rx1 = hi[ox0, 2], hi[ox0 + mx - 1, 3]
                s_in = src[ry0:ry1, rx0:rx1]
                s_tmp = np.stack([
                    _chain(s_in[vi[oy0 + r, 0] - ry0:], vi[oy0 + r],
                           vt[oy0 + r]) for r in range(my)])
                out[oy0:oy0 + my, ox0:ox0 + mx] = np.stack([
                    _chain(s_tmp.T[hi[ox0 + q, 0] - rx0:], hi[ox0 + q],
                           ht[ox0 + q]) for q in range(mx)], axis=1)
        levels.append(out)
    return levels


@pytest.fixture(scope="module")
def bench_frame():
    """Frame 0 of the bench's VGA box-room orbit, as uint8 gray."""
    planes = box_room(half_x=1.8, half_y=1.4, z_far=3.0, z_near=-3.0)
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           planes=planes)
    img, _ = scene.render(orbit_trajectory(120, radius=0.4, yaw_amp=0.3)[0])
    return np.clip(img, 0, 255).astype(np.uint8)


def test_k8_order_within_plain_and_jax(bench_frame):
    img = bench_frame.astype(np.float32)
    emu = _emulate_k8(img, 8, 1.2)
    plain = timage.build_pyramid_plain(torch.from_numpy(img), 8, 1.2)
    via = timage.build_pyramid(torch.from_numpy(img), 8, 1.2)  # CPU: plain
    lj = jax.jit(lambda x: jimage.build_pyramid(x, 8, 1.2))(jnp.asarray(img))
    for e, p, v, j in zip(emu, plain, via, lj):
        assert e.shape == tuple(p.shape) == np.asarray(j).shape
        assert torch.equal(v, p)
        assert np.abs(e - p.numpy()).max() <= 1e-4
        assert np.abs(e - np.asarray(j)).max() < 1e-3
    np.testing.assert_array_equal(emu[0], img)


# compiled, as the JAX extractor runs it (and op by op it takes ~4x the time)
_select = jax.jit(jorb.select_spread_topk, static_argnums=(1, 2, 3))


def _jax_level(score, k, l, s, rank_rounds, margin=torb.EDGE_MARGIN):
    """JAX's selection of one level as its extractor makes it
    (`ops/orb.py:529-540`): the top-k, the clamps, xy0 and the level id."""
    h, w = score.shape
    ys, xs, resp, valid = _select(jnp.asarray(score), k, 32, rank_rounds)
    ys_c = jnp.clip(ys, margin, h - 1 - margin)
    xs_c = jnp.clip(xs, margin, w - 1 - margin)
    xy0 = jnp.stack([xs_c.astype(jnp.float32), ys_c.astype(jnp.float32)],
                    -1) * s
    return [np.asarray(a) for a in (ys_c, xs_c, xy0,
                                    jnp.full((k,), l, jnp.int32), resp,
                                    valid)]


def _assert_equal_to_jax(levels, rank_rounds=4):
    """`levels`: (score, k, level id, scale) a level."""
    ranked = [tfast.cell_rank_rounds(torch.from_numpy(sc), k, 32, rank_rounds)
              if k > 0 else (torch.empty((0, tfast.n_cells(*sc.shape, 32))),
                             torch.empty((0, tfast.n_cells(*sc.shape, 32)),
                                         dtype=torch.int64))
              for sc, k, _, _ in levels]
    ranked = [(r, p.to(torch.int32)) for r, p in ranked]
    out = torb.spread_topk_levels_plain(
        ranked, [k for _, k, _, _ in levels], [sc.shape for sc, *_ in levels],
        [l for *_, l, _ in levels], [s for *_, s in levels], 32, rank_rounds)
    via = torb.spread_topk_levels(
        ranked, [k for _, k, _, _ in levels], [sc.shape for sc, *_ in levels],
        [l for *_, l, _ in levels], [s for *_, s in levels], 32, rank_rounds)
    ref = [_jax_level(sc, k, l, s, rank_rounds) for sc, k, l, s in levels
           if k > 0]
    dtypes = (torch.int32, torch.int32, torch.float32, torch.int32,
              torch.float32, torch.bool)
    for i, (a, b, dt) in enumerate(zip(out, via, dtypes)):
        assert a.dtype == dt and torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(),
                                      np.concatenate([r[i] for r in ref]))
    return out


@pytest.mark.parametrize("kind,h,w,k,rank_rounds", CASES)
def test_spread_topk_plain_equals_jax(kind, h, w, k, rank_rounds):
    """One level of each of `test_torch_rank.py`'s cases, as the extractor's
    level 3 (scale 1.2^3)."""
    score = _score(kind, h, w, seed=h * w + k)
    _assert_equal_to_jax([(score, k, 3, 1.2 ** 3)], rank_rounds)


def test_spread_topk_plain_over_levels_equals_jax():
    """Several levels in one call, as the extractor makes it: a level with
    budget 0 (skipped, its id missing from the output), a level with fewer
    corners than its budget (the rest invalid, clamped to the margin), an
    all-tie level and a level without any corner."""
    rng = np.random.default_rng(5)
    sparse = np.zeros((134, 179), np.float32)
    sparse[rng.integers(0, 134, 9), rng.integers(0, 179, 9)] = 7.0
    levels = [(_score("ties", 240, 320, 1), 217, 0, 1.0),
              (_score("dense", 200, 267, 2), 0, 1, 1.2),
              (sparse, 60, 2, 1.44),
              (np.full((96, 128), 3.0, np.float32), 40, 3, 1.2 ** 3),
              (np.zeros((64, 96), np.float32), 30, 4, 1.2 ** 4)]
    out = _assert_equal_to_jax(levels)
    assert out.ys.shape == (217 + 60 + 40 + 30,)
    assert int(out.valid[217:277].sum()) <= 9
    assert not bool(out.valid[-30:].any())
    assert 1 not in set(out.level.tolist())


def test_spread_topk_refuses_a_budget_above_its_candidates():
    raw = torch.ones((4, 6))
    pos = torch.zeros((4, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="budget 25"):
        torb.spread_topk_levels_plain([(raw, pos)], [25], [(64, 96)], [0],
                                      [1.0])
    with pytest.raises(ValueError, match="budgets"):
        torb.spread_topk_levels_plain([(raw, pos)], [2, 3], [(64, 96)], [0],
                                      [1.0])


def _exact_fma(a, b, c):
    """f32 round-to-nearest-even of a * b + c, in rational arithmetic."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(x))
    near = [r, np.nextafter(r, np.float32(np.inf)),
            np.nextafter(r, np.float32(-np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(np.float32(v).view(np.int32)) & 1))


def test_fmaf_np_is_correctly_rounded():
    """Random operands, and sums placed next to the midpoint of two f32
    values, where an f64 sum rounded again to f32 can go the wrong way."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-2, 2, 600).astype(np.float32)
    b = rng.uniform(-300, 300, 600).astype(np.float32)
    c = rng.uniform(-300, 300, 600).astype(np.float32)
    p = (a.astype(np.float64) * b)[:300]
    r = p.astype(np.float32)
    mid = (r.astype(np.float64) + np.nextafter(r, np.float32(np.inf))) / 2
    c[:300] = (mid - p).astype(np.float32)
    out = timage.fmaf_np(a, b, c)
    assert [int(x.view(np.int32)) for x in out] == [
        int(_exact_fma(x, y, z).view(np.int32)) for x, y, z in zip(a, b, c)]


def test_split_finder_recovers_a_split_gemm():
    """A GEMM emulated with its taps split at every multiple of 8 of the
    input index (as cuBLAS's FFMA kernels add 8-wide K blocks), and one
    split at slices of 68 (split-K): the splits found from a probe of
    PROBE_COLUMNS columns give the GEMM's sums bit for bit on another
    input, where one chain does not."""
    rng = np.random.default_rng(4)
    for n_in, n_out, block in ((480, 400, 8), (333, 278, 68)):
        idx, taps = timage.resize_taps(n_in, n_out)
        first, count = idx[:, 0], idx[:, 1]
        cut = (first // block + 1) * block  # the first block boundary
        true = np.where(cut < first + count, cut - first, count)
        assert (true < count).any()
        probe = rng.uniform(0, 255, (n_in, timage.PROBE_COLUMNS)).astype(
            np.float32)
        other = rng.uniform(0, 255, (n_in, 256)).astype(np.float32)
        split, misses = timage.infer_tap_splits(
            [probe], [timage.tap_sums_np(probe, idx, taps, true)], idx, taps)
        assert misses == 0
        ref = timage.tap_sums_np(other, idx, taps, true)
        np.testing.assert_array_equal(
            timage.tap_sums_np(other, idx, taps, split), ref)
        assert not np.array_equal(timage.tap_sums_np(other, idx, taps), ref)
