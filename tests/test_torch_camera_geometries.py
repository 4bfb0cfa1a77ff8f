"""The card's launch plans at every camera geometry the JAX package runs,
built on the host as an extractor on the card builds them (pure host; no
card needed):

- K9's launch table (`ops/orb.py::prepare_spread_topk`) and K8's work split
  (`ops/image.py::pyramid_schedule`) build for 1920x1200, 2048x1088 and
  3840x2160 at 1000 features, and 1920x1200 at 6,000 (8 levels, 1.2).
  Levels past SPREAD_MAX_KEYS candidates take K9's large kernel, a second
  launch; K8's search goes past 4 x 132 blocks only where no grid under
  that cap fits a block's shared memory.
- VGA's and QVGA's plans, which every cell of `chip_smoke.py` runs, are
  those of the kernels before the large paths: one K9 launch, and the same
  grid, records, region and sums (pinned here).
- The limits that remain raise, naming themselves.
"""

import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu_torch.ops import fast
from orb_slam2_refactored_tpu_torch.ops import image
from orb_slam2_refactored_tpu_torch.ops import orb

torch.set_num_threads(1)


def _schedule(h, w, n_levels=8):
    return image.pyramid_schedule(image.pyramid_shapes(h, w, n_levels, 1.2))


def _fits(records, region, sums):
    return 48 * records + 4 * (2 * region + sums) <= image.PYR_SMEM


@pytest.mark.parametrize("h,w,n,keys,launches", [
    (1200, 1920, 1000, 9120, ("spread_topk", "spread_topk_large")),
    (1088, 2048, 1000, 8704, ("spread_topk", "spread_topk_large")),
    (2160, 3840, 1000, 32640, ("spread_topk", "spread_topk_large")),
    (1200, 1920, 6000, 9120, ("spread_topk", "spread_topk_large")),
])
def test_k9_plan_builds_past_its_register_limit(h, w, n, keys, launches):
    plan = orb.prepare_spread_topk(h, w, n, 1.2, 8)
    cand = [r * c for r, c in plan.shapes]
    assert cand[0] == keys > orb.SPREAD_MAX_KEYS
    assert plan.launches == launches and plan.K == n
    budgets = orb.features_per_level(n, 8, 1.2)
    assert plan.smem == 8 * max(k if k <= orb.SPREAD_RANK_MAX
                                else 1 << (k - 1).bit_length()
                                for k in budgets)
    params = np.array(plan.params, np.int32).reshape(-1, orb.SPREAD_PARAMS)
    shapes = image.pyramid_shapes(h, w, 8, 1.2)
    assert [tuple(p[1:3]) for p in params] == [tuple(s) for s in shapes]
    assert [int(p[4]) * int(p[5]) for p in params] == cand
    assert list(params[:, 0]) == list(plan.offsets)


@pytest.mark.parametrize("h,w,grid", [(1200, 1920, (24, 11)),
                                      (1088, 2048, (11, 24)),
                                      (2160, 3840, (21, 37))])
def test_k8_schedule_builds_at_large_geometries(h, w, grid):
    rows, cols, records, region, sums = _schedule(h, w)
    assert (rows.shape[0], cols.shape[0]) == grid
    assert _fits(records, region, sums)
    shapes = image.pyramid_shapes(h, w, 8, 1.2)
    # the parts own every output of levels 1-7 once, on both axes
    for parts, sizes in ((rows, [s[0] for s in shapes]),
                         (cols, [s[1] for s in shapes])):
        for lvl in range(1, 8):
            own = parts[:, lvl, 2:]
            assert own[0, 0] == 0 and own[-1, 1] == sizes[lvl]
            assert (own[1:, 0] == own[:-1, 1]).all()
    if (h, w) == (2160, 3840):  # no grid of at most 4 x 132 blocks fits
        assert grid[0] * grid[1] > 4 * image.PYR_SMS


@pytest.mark.parametrize("h,w,n_levels,want", [
    (480, 640, 8, (11, 12, 430, 4270, 3500, 42696, 62344)),
    (240, 320, 4, (13, 10, 118, 912, 722, 16123, 16606)),
    (240, 320, 8, (6, 22, 272, 1870, 1530, 11522, 56449)),
])
def test_k8_schedule_unchanged_at_vga_and_qvga(h, w, n_levels, want):
    rows, cols, records, region, sums = _schedule(h, w, n_levels)
    assert (rows.shape[0], cols.shape[0], records, region, sums,
            int(rows.sum()), int(cols.sum())) == want


@pytest.mark.parametrize("h,w,n,n_levels,cand,smem", [
    (480, 640, 1000, 8, [1200, 884, 770, 756, 560, 504, 420, 360], 1736),
    (240, 320, 600, 4, [1120, 945, 798, 660], 1544),
    (240, 320, 900, 4, [1680, 1386, 1176, 990], 2320),
])
def test_k9_plan_unchanged_at_vga_and_qvga(h, w, n, n_levels, cand, smem):
    plan = orb.prepare_spread_topk(h, w, n, 1.2, n_levels)
    assert plan.launches == ("spread_topk",)
    assert [r * c for r, c in plan.shapes] == cand
    assert plan.smem == smem and plan.K == n
    assert plan.offsets == tuple(np.cumsum([0] + cand)[:-1])


def test_remaining_limits_raise_with_their_message(monkeypatch):
    C = fast.n_cells(4096, 4096, 32)
    with pytest.raises(ValueError, match=str(orb.SPREAD_MAX_BUDGET)):
        orb._spread_plan(((4096, 4096),), (orb.SPREAD_MAX_BUDGET + 1,),
                         (0,), (1.0,), (2 * (orb.SPREAD_MAX_BUDGET + 1)
                                        // C + 1,), 32)
    rounds = orb.SPREAD_MAX_KEYS_LARGE // C + 1
    with pytest.raises(ValueError, match=str(orb.SPREAD_MAX_KEYS_LARGE)):
        orb._spread_plan(((4096, 4096),), (1000,), (0,), (1.0,), (rounds,),
                         32)
    # the largest level K9 takes still builds
    orb._spread_plan(((4096, 4096),), (orb.SPREAD_MAX_BUDGET,), (0,), (1.0,),
                     (orb.SPREAD_MAX_KEYS_LARGE // C,), 32)
    # no block holds even one row's and one column's records a level
    monkeypatch.setattr(image, "PYR_SMEM", 100)
    with pytest.raises(ValueError, match="fits a block's shared memory, up "
                       "to a grid of"):
        _schedule(120, 160, 3)
