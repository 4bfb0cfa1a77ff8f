"""Port parity: the per-level keypoint selection split into the rank rounds
(`cell_rank_rounds`, which kernel K2 now runs) and the global top-k
(`topk_from_ranks`), against the JAX package's `select_spread_topk`; and
the multi-level plain versions of K2 and K3 against their one-level plain
versions applied level by level.

Exact equality throughout: a rank round is an argmax whose ties go to the
lowest in-cell index, the keys add exact f32 values, and the top-k lists
equal keys lowest index first on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.ops import orb as jorb
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.ops import fast as tfast
from orb_slam2_refactored_tpu_torch.ops import image as timage
from orb_slam2_refactored_tpu_torch.ops import orb as torb

torch.set_num_threads(1)


def _score(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":  # integer responses, most of them equal to another
        s = rng.integers(1, 4, (h, w)) * (rng.uniform(size=(h, w)) < 0.05)
    elif kind == "empty_cells":  # the left half and a band hold no corner
        s = rng.uniform(0.5, 40.0, (h, w)) * (rng.uniform(size=(h, w)) < 0.02)
        s[:, : w // 2] = 0.0
        s[h // 3: h // 3 + 40] = 0.0
    else:  # "dense": fractional responses, as the upper levels give them
        s = rng.uniform(0.0, 30.0, (h, w)) * (rng.uniform(size=(h, w)) < 0.3)
    return s.astype(np.float32)


# (score map, h, w, budget, rank_rounds): QVGA level 0, the ragged VGA
# level 7 (134x179) and level 5 (193x257), cells without a corner, and
# budgets that need more rounds than `rank_rounds` (C = 6 cells at 64x96)
CASES = [
    ("ties", 240, 320, 217, 4),
    ("ties", 134, 179, 60, 4),
    ("dense", 193, 257, 87, 4),
    ("empty_cells", 240, 320, 150, 4),
    ("ties", 64, 96, 40, 4),
    ("dense", 134, 179, 60, 2),
]


@pytest.mark.parametrize("kind,h,w,k,rank_rounds", CASES)
def test_split_selection_equals_jax(kind, h, w, k, rank_rounds):
    score = _score(kind, h, w, seed=h * w + k)
    ref = jorb.select_spread_topk(jnp.asarray(score), k, 32, rank_rounds)
    raw, pos = tfast.cell_rank_rounds(torch.from_numpy(score), k, 32,
                                      rank_rounds)
    C = -(-h // 32) * -(-w // 32)
    assert raw.shape == pos.shape == (
        tfast.n_rank_rounds(h, w, k, 32, rank_rounds), C)
    out = torb.topk_from_ranks(raw, pos, k, h, w, 32, rank_rounds)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    whole = torb.select_spread_topk(torch.from_numpy(score), k, 32,
                                    rank_rounds)
    for a, b in zip(whole, out):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def pyramid():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    img, _ = scene.render(orbit_trajectory(6)[3])
    img = torch.from_numpy(np.clip(img, 0, 255).astype(np.float32))
    return timage.build_pyramid(img, 4, 1.2)


def test_multilevel_plain_k2_equals_one_level(pyramid):
    """K2's plain version over the 4-level QVGA pyramid equals FAST + NMS +
    margin and the rank rounds applied level by level; a level with no
    budget gets no rounds; the CPU wrappers run the plain versions."""
    ks = torb.features_per_level(500, 4, 1.2)
    ks[2] = 0
    outs = tfast.detect_and_rank_plain(pyramid, 20.0, 7.0, ks, margin=19)
    assert len(outs) == 4
    for lvl, k, (score, raw, pos) in zip(pyramid, ks, outs):
        ref = tfast.detect_two_threshold_plain(lvl, 20.0, 7.0, margin=19)
        assert torch.equal(score, ref)
        assert pos.dtype == torch.int32
        if k == 0:
            assert raw.shape[0] == pos.shape[0] == 0
            continue
        rr, rp = tfast.cell_rank_rounds(ref, k)
        assert torch.equal(raw, rr) and torch.equal(pos.long(), rp)
    for a, b in zip(tfast.detect_and_rank(pyramid, 20.0, 7.0, ks, margin=19),
                    outs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(
        tfast.detect_two_threshold(pyramid[1], 20.0, 7.0, margin=19),
        outs[1][0])


def test_multilevel_plain_k3_equals_one_level(pyramid):
    """K3's plain version over the concatenated keypoints of the 4 levels
    equals the one-level plain version on each level's slice."""
    ks = torb.features_per_level(500, 4, 1.2)
    ranked = tfast.detect_and_rank_plain(pyramid, 20.0, 7.0, ks, margin=19)
    ys_all, xs_all = [], []
    for lvl, k, (_, raw, pos) in zip(pyramid, ks, ranked):
        h, w = lvl.shape
        ys, xs, _, _ = torb.topk_from_ranks(raw, pos, k, h, w)
        ys_all.append(torch.clamp(ys, 19, h - 20).to(torch.int32))
        xs_all.append(torch.clamp(xs, 19, w - 20).to(torch.int32))
    ang, desc = torb.angles_and_descriptors_levels_plain(
        pyramid, torch.cat(ys_all), torch.cat(xs_all), ks)
    assert ang.shape == (sum(ks),) and desc.shape == (sum(ks), 8)
    start = 0
    for lvl, k, ys, xs in zip(pyramid, ks, ys_all, xs_all):
        a, d = torb.angles_and_descriptors_plain(lvl, ys, xs)
        assert torch.equal(ang[start:start + k], a)
        assert torch.equal(desc[start:start + k], d)
        start += k
    a2, d2 = torb.angles_and_descriptors_levels(
        pyramid, torch.cat(ys_all), torch.cat(xs_all), ks)
    assert torch.equal(a2, ang) and torch.equal(d2, desc)
