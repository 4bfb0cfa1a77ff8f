"""Port parity for the plain sides of extraction's kernels K8 (the pyramid,
`csrc/pyramid.cu`) and K9 (the per-level spread top-k,
`csrc/spread_topk.cu`), which run only on a card.

- K8's tap tables (`ops/image.py::resize_taps`) rebuild the dense weight
  matrices of `_resize_weights_np` exactly, at every level pair of four
  camera sizes; the most taps an output has fits the kernel's
  compile-time limit; the work split writes every output once and every
  block's regions fit the shared memory the launch asks for.
- K8's arithmetic: a numpy emulation of the kernel, block by block over
  its work split (each region staged from the previous one, the taps
  summed by `tap_sums_np` where this machine's f32 GEMM splits them),
  equals the plain `build_pyramid_plain` (a dense f32 product a pass) on a
  bench frame bit for bit, and stays within 1e-3 of JAX's jitted
  `build_pyramid` (`test_pyramid_within_c2_tolerance`'s tolerance, hazard
  C2).
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
    assert timage.PYR_SMEM == _constant("kMaxSmem")
    most = 0
    for n_in, n_out in _pairs(h, w):
        idx, taps = timage.resize_taps(n_in, n_out)
        assert idx.dtype == np.int32 and taps.dtype == np.float32
        assert idx.shape == (n_out, 5)
        np.testing.assert_array_equal(idx[:, 4], idx[:, 1])  # one chain
        # the kernel's records: first, count, split, a pad, the taps' bits
        rec = timage._tap_records(n_in, n_out, 1, True, "cpu").numpy()
        np.testing.assert_array_equal(rec[:, :3], idx[:, [0, 1, 4]])
        np.testing.assert_array_equal(rec[:, 4:].view(np.float32), taps)
        dense = np.zeros((n_in, n_out), np.float32)
        for o in range(n_out):
            f, c = idx[o, 0], idx[o, 1]
            dense[f:f + c, o] = taps[o, :c]
            assert not taps[o, c:].any()
        np.testing.assert_array_equal(dense, timage._resize_weights_np(
            n_in, n_out))
        most = max(most, int(idx[:, 1].max()))
    assert 2 <= most <= timage.PYR_MAX_TAPS


def _parts_hold(parts, sizes, idxs):
    """One axis of K8's schedule: at every level from 1 the parts' owned
    outputs are consecutive and cover the level once, each inside what the
    part computes; at every level the part computes every input its next
    level's outputs' taps read."""
    for l in range(1, len(sizes)):
        own = parts[:, l, 2:]
        assert own[0, 0] == 0 and own[-1, 1] == sizes[l]
        np.testing.assert_array_equal(own[1:, 0], own[:-1, 1])
        assert (parts[:, l, 0] <= own[:, 0]).all()
        assert (own[:, 1] <= parts[:, l, 1]).all()
    for l in range(len(sizes) - 1):
        idx = idxs[l]
        for (lo, hi), (a, c) in zip(parts[:, l, :2], parts[:, l + 1, :2]):
            f, n = idx[a:c, 0], idx[a:c, 1]
            assert 0 <= lo <= hi <= sizes[l]
            assert (f[n > 0] >= lo).all() and ((f + n)[n > 0] <= hi).all()


@pytest.mark.parametrize("h,w,n_levels", [(480, 640, 8), (376, 1241, 8),
                                          (37, 23, 8), (9, 5, 6)])
def test_pyramid_plan_layout_and_spans(h, w, n_levels):
    """The buffer's levels start 16 bytes apart at least and do not
    overlap; the plan's work split (`pyramid_schedule`) writes every output
    of every level once and computes every input a block's outputs read,
    and the launch's shared memory holds a block's tap records, the
    largest region twice and its vertical sums. Down to levels a few
    pixels wide, where a level keeps a size (one tap of 1.0, an exact
    copy, as the plain version skips the product)."""
    plan = timage._pyramid_plan(h, w, n_levels, 1.2, "cpu")
    shapes = timage.pyramid_shapes(h, w, n_levels, 1.2)
    assert plan.shapes == shapes
    ends = [o + a * b for o, (a, b) in zip(plan.offsets, shapes[1:])]
    assert all(o % 4 == 0 for o in plan.offsets)
    assert all(e <= o for e, o in zip(ends[:-1], plan.offsets[1:]))
    assert ends[-1] <= plan.total
    rows = [s[0] for s in shapes]
    cols = [s[1] for s in shapes]
    _parts_hold(plan.rows, rows, [timage.resize_taps(a, b)[0] for a, b in
                                  zip(rows[:-1], rows[1:])])
    _parts_hold(plan.cols, cols, [timage.resize_taps(a, b)[0] for a, b in
                                  zip(cols[:-1], cols[1:])])
    ny = plan.rows[:, :, 1] - plan.rows[:, :, 0]
    nx = plan.cols[:, :, 1] - plan.cols[:, :, 0]
    records, region, sums = plan.args[-3:]
    assert ny[:, 1:].sum(1).max() + nx[:, 1:].sum(1).max() <= records
    assert (ny.max(0) * nx.max(0)).max() <= region
    assert (ny.max(0)[1:] * nx.max(0)[:-1]).max(initial=0) <= sums
    assert 48 * records + 4 * (2 * region + sums) <= timage.PYR_SMEM
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


def _cpu_splits(n_in, n_out, other, vertical):
    return timage.gemm_tap_splits(n_in, n_out, other, vertical, "cpu")


def _emulate_k8(img, n_levels, scale, splits=_cpu_splits):
    """Kernel K8 in numpy, block by block as `pyramid_kernel` runs it: each
    block stages its level-0 region, then per level its vertical sums and
    its region, from its previous region only, and writes the outputs it
    owns; each output's taps summed as the `splits` of its shape say (by
    default where this machine's f32 GEMM splits them). Returns the levels
    and, per level, how many blocks wrote each output."""
    shapes = timage.pyramid_shapes(*img.shape, n_levels, scale)
    rows, cols, records, region, sums = timage.pyramid_schedule(shapes)
    levels = [img] + [np.full(s, np.nan, np.float32) for s in shapes[1:]]
    writes = [None] + [np.zeros(s, np.int32) for s in shapes[1:]]
    for rp in rows:
        for cp in cols:
            (y0, y1), (x0, x1) = rp[0, :2], cp[0, :2]
            src = img[y0:y1, x0:x1]
            assert src.size <= region
            for l in range(1, n_levels):
                (ih, iw), (oh, ow) = shapes[l - 1], shapes[l]
                ry0, ry1, oy0, oy1 = rp[l]
                rx0, rx1, ox0, ox1 = cp[l]
                assert ry0 <= oy0 <= oy1 <= ry1 and rx0 <= ox0 <= ox1 <= rx1
                vi, vt = timage.resize_taps(ih, oh)
                hi, ht = timage.resize_taps(iw, ow)
                v = vi[ry0:ry1].copy()
                h = hi[rx0:rx1].copy()
                v[:, 0] -= y0
                h[:, 0] -= x0
                # the region's outputs read inside the previous region
                for t, n_src in ((v, src.shape[0]), (h, src.shape[1])):
                    tapped = t[:, 1] > 0
                    assert (t[tapped, 0] >= 0).all()
                    assert (t[tapped, 0] + t[tapped, 1] <= n_src).all()
                tmp = timage.tap_sums_np(src, v, vt[ry0:ry1],
                                         splits(ih, oh, iw, True)[ry0:ry1])
                assert tmp.size <= sums
                dst = timage.tap_sums_np(
                    np.ascontiguousarray(tmp.T), h, ht[rx0:rx1],
                    splits(iw, ow, oh, False)[rx0:rx1]).T
                assert dst.size <= region
                levels[l][oy0:oy1, ox0:ox1] = dst[oy0 - ry0:oy1 - ry0,
                                                  ox0 - rx0:ox1 - rx0]
                writes[l][oy0:oy1, ox0:ox1] += 1
                src, y0, x0 = dst, ry0, rx0
    return levels, writes


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
    emu, writes = _emulate_k8(img, 8, 1.2)
    assert all((x == 1).all() for x in writes[1:])
    plain = timage.build_pyramid_plain(torch.from_numpy(img), 8, 1.2)
    via = timage.build_pyramid(torch.from_numpy(img), 8, 1.2)  # CPU: plain
    lj = jax.jit(lambda x: jimage.build_pyramid(x, 8, 1.2))(jnp.asarray(img))
    for e, p, v, j in zip(emu, plain, via, lj):
        assert e.shape == tuple(p.shape) == np.asarray(j).shape
        assert torch.equal(v, p)
        np.testing.assert_array_equal(e, p.numpy())
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
