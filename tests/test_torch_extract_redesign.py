"""Port parity for the designs of extraction's kernels K8 (the pyramid,
`csrc/pyramid.cu`) and K9 (the per-level spread top-k,
`csrc/spread_topk.cu`), emulated in numpy on the CPU: the kernels run only
on a card.

- K8 has no barrier between levels: each block takes a part of the deepest
  level and computes, from level 0, the region of every level its part
  needs (`ops/image.py::pyramid_schedule`, `axis_parts`). The emulation
  runs that schedule block by block, each region from the previous one,
  with `tap_sums_np` and the splits of this machine's f32 GEMM
  (`gemm_tap_splits` on the CPU). Every output of every level is written
  by exactly one block, each block's level-(l-1) region holds every input
  its level-l outputs' taps read, and the pyramid equals
  `build_pyramid_plain` bit for bit and JAX's `build_pyramid` within
  hazard C2's 1e-3 gray (`test_torch_orb.py::test_pyramid_within_c2_tolerance`;
  VGA's levels 4-7 sit up to 5.3e-4 from JAX's on the CPU).
- K9 selects, then orders only what it selected: a radix select of the
  k-th largest key over its 32 order-preserving bits, 8 bits a pass; the
  selected compacted in index order by a scan of two counts a thread;
  each selected word put at its rank (the count of selected words above
  it), or sorted past SPREAD_RANK_MAX. The emulation, through the launch
  table `_spread_plan` caches, equals `spread_topk_levels_plain` bit for
  bit and JAX's `select_spread_topk` with the extractor's clamps, on
  tie-heavy levels: equal raws within a round, every candidate a
  non-corner, k = 1, k equal to the candidates, a level of exactly
  SPREAD_MAX_KEYS candidates, and a level of 9,120 (1920x1200's level 0),
  which takes K9's large kernel: the same select and order, its two
  counts scanned 32 bits each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.ops import image as jimage
from orb_slam2_refactored_tpu_torch.ops import fast as tfast
from orb_slam2_refactored_tpu_torch.ops import image as timage
from orb_slam2_refactored_tpu_torch.ops import orb as torb
from test_torch_extract_kernels import _emulate_k8, _jax_level

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# K8: a block a part of the deepest level, every level from level 0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,n_levels", [(480, 640, 8), (240, 320, 4),
                                          (37, 23, 8), (9, 5, 6)])
def test_k8_schedule_equals_plain_and_jax(h, w, n_levels):
    """The bench's VGA (8 levels), QVGA with 4, and two odd sizes down to
    levels a few pixels wide (9x5: a level keeps its size)."""
    img = np.random.default_rng(h * w).uniform(0, 255, (h, w)).astype(
        np.float32)
    emu, writes = _emulate_k8(img, n_levels, 1.2)
    assert all((x == 1).all() for x in writes[1:])
    plain = timage.build_pyramid_plain(torch.from_numpy(img), n_levels, 1.2)
    assert not any(m for (n_in, n_out, other, v, dev), m in
                   timage.SPLIT_MISSES.items() if dev == "cpu")
    lj = jax.jit(lambda x: jimage.build_pyramid(x, n_levels, 1.2))(
        jnp.asarray(img))
    for e, p, j in zip(emu, plain, lj):
        np.testing.assert_array_equal(e, p.numpy())
        assert np.abs(e - np.asarray(j)).max() < 1e-3


@pytest.mark.parametrize("h,w,n_levels", [(480, 640, 8), (376, 1241, 8),
                                          (1, 97, 4)])
def test_k8_schedule_fits_the_card(h, w, n_levels):
    """One wave of at most 132 blocks (an SM each on the H100) for the
    camera sizes, the shared memory a block asks for (its records of every
    level, two regions, the vertical sums) under the H100's limit, and the
    plan's uploaded schedule the one emulated."""
    shapes = timage.pyramid_shapes(h, w, n_levels, 1.2)
    rows, cols, records, region, sums = timage.pyramid_schedule(shapes)
    assert rows.shape[0] * cols.shape[0] <= timage.PYR_SMS
    assert 48 * records + 4 * (2 * region + sums) <= timage.PYR_SMEM
    ny = rows[:, 1:, 1] - rows[:, 1:, 0]
    nx = cols[:, 1:, 1] - cols[:, 1:, 0]
    assert records == ny.sum(1).max() + nx.sum(1).max()
    plan = timage._pyramid_plan(h, w, n_levels, 1.2, "cpu")
    np.testing.assert_array_equal(plan.rows, rows)
    np.testing.assert_array_equal(plan.tables[-2].numpy(), rows)
    np.testing.assert_array_equal(plan.tables[-1].numpy(), cols)
    assert list(plan.args[5:]) == [rows.shape[0], cols.shape[0], records,
                                   region, sums]


# ---------------------------------------------------------------------------
# K9: radix select, compaction in index order, rank placement
# ---------------------------------------------------------------------------

THREADS = 1024  # `kThreads` in csrc/spread_topk.cu


def _ordered_bits(key):
    u = key.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _select_level(raw, pos, k, C, rank_rounds):
    """One level's selected words in output order, as K9's block makes
    them."""
    n = raw.size
    r = np.arange(n) // C
    boost = np.float32(1e6) * np.maximum(rank_rounds - r, 0).astype(
        np.float32)
    bits = _ordered_bits(np.where(raw > 0, boost + raw, np.float32(-1.0))
                         .astype(np.float32))
    # radix select: 4 passes of 8 bits from the top
    prefix, kk = 0, k
    for p in range(4):
        shift = 24 - 8 * p
        high = 0 if p == 0 else (0xffffffff << (shift + 8)) & 0xffffffff
        live = (bits & high) == prefix
        hist = np.bincount((bits[live] >> shift) & 255, minlength=256)
        from_top = np.cumsum(hist[::-1])
        t = int(np.searchsorted(from_top, kk))  # first bin reaching kk
        d = 255 - t
        kk -= int(from_top[t] - hist[d])
        prefix |= d << shift
    above, ties = bits > prefix, bits == prefix
    assert int(above.sum()) == k - kk and 1 <= kk <= int(ties.sum())
    # the block scan: a contiguous run of `per` candidates a thread, its two
    # counts packed in one word (16 bits each in registers, 32 bits each
    # in the large kernel past SPREAD_MAX_KEYS)
    half = 16 if n <= torb.SPREAD_MAX_KEYS else 32
    per = -(-n // THREADS)
    runs = np.zeros((THREADS, per), np.int64)
    runs.reshape(-1)[:n] = (above.astype(np.int64) << half) | ties
    mine = runs.sum(1)
    before = np.cumsum(mine) - mine
    within = np.cumsum(runs, 1) - runs
    prior = (before[:, None] + within).reshape(-1)[:n]
    a_before, t_before = prior >> half, prior & ((1 << half) - 1)
    slot = np.where(above, a_before + np.minimum(t_before, kk),
                    a_before + t_before)
    take = above | (ties & (t_before < kk))
    words = (bits.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xffffffff) - np.arange(n, dtype=np.uint64))
    sel = np.zeros(k, np.uint64)
    sel[slot[take]] = words[take]
    assert np.array_equal(np.sort(slot[take]), np.arange(k))
    if k <= torb.SPREAD_RANK_MAX:
        rank = (sel[None, :] > sel[:, None]).sum(1)
        out = np.zeros(k, np.uint64)
        out[rank] = sel
        assert np.array_equal(np.sort(rank), np.arange(k))
        return out
    return np.sort(sel)[::-1]


def _emulate_k9(ranked, ks, shapes, level_ids, scales, cell=32,
                rank_rounds=4, margin=torb.EDGE_MARGIN):
    """Kernel K9 in numpy over the launch table `_spread_plan` makes: the
    rank rounds read at the table's offsets of K2's two buffers."""
    plan = torb._spread_plan(tuple(map(tuple, shapes)), tuple(ks),
                             tuple(level_ids), tuple(map(float, scales)),
                             tuple(r.shape[0] for r, _ in ranked), cell)
    raws = np.concatenate([r.numpy().reshape(-1) for r, _ in ranked])
    poss = np.concatenate([p.numpy().reshape(-1) for _, p in ranked])
    params = np.array(plan.params, np.int32).reshape(-1, torb.SPREAD_PARAMS)
    parts = []
    for off, h, w, k, rounds, C, l, sc in params:
        if k <= 0:
            continue
        raw = raws[off:off + rounds * C]
        pos = poss[off:off + rounds * C]
        words = _select_level(raw, pos, k, C, rank_rounds)
        i = (np.uint64(0xffffffff) - (words & np.uint64(0xffffffff))).astype(
            np.int64)
        bits = (words >> np.uint64(32)).astype(np.uint32)
        key = np.where(bits & 0x80000000, bits & 0x7fffffff, ~bits).astype(
            np.uint32).view(np.float32)
        c, p = i % C, pos[i]
        wc = -(-w // cell)
        y = np.minimum((c // wc) * cell + p // cell, h - 1)
        x = np.minimum((c % wc) * cell + p % cell, w - 1)
        y = np.clip(y, margin, h - 1 - margin).astype(np.int32)
        x = np.clip(x, margin, w - 1 - margin).astype(np.int32)
        s = np.int32(sc).view(np.float32)
        xy = np.stack([x.astype(np.float32) * s, y.astype(np.float32) * s], 1)
        parts.append((y, x, xy.astype(np.float32), np.full(k, l, np.int32),
                      raw[i], key > 0))
    return [np.concatenate(f) for f in zip(*parts)]


def _ranked_from_scores(scores, ks, rank_rounds=4):
    out = []
    for sc, k in zip(scores, ks):
        C = tfast.n_cells(*sc.shape, 32)
        if k == 0:
            out.append((torch.empty((0, C)),
                        torch.empty((0, C), dtype=torch.int32)))
            continue
        raw, pos = tfast.cell_rank_rounds(torch.from_numpy(sc), k, 32,
                                          rank_rounds)
        out.append((raw, pos.to(torch.int32)))
    return out


def _k9_case(name):
    """(scores or None, ranked, ks, level ids): tie-heavy levels."""
    rng = np.random.default_rng(len(name))
    if name == "ties_in_rounds":  # every pixel of a level equal
        scores = [np.full((240, 320), 3.0, np.float32),
                  np.full((134, 179), 7.0, np.float32)]
        ks, ids = [217, 60], [0, 7]
    elif name == "no_corners":  # every key -1 on one level
        scores = [np.zeros((96, 128), np.float32),
                  (rng.integers(1, 3, (64, 96)) *
                   (rng.uniform(size=(64, 96)) < 0.1)).astype(np.float32)]
        ks, ids = [40, 30], [0, 1]
    elif name == "k_one":
        scores = [(rng.integers(1, 3, (134, 179)) *
                   (rng.uniform(size=(134, 179)) < 0.2)).astype(np.float32),
                  np.full((64, 96), 2.0, np.float32)]
        ks, ids = [1, 1], [2, 3]
    elif name == "max_keys":  # 32 rounds x 256 cells = SPREAD_MAX_KEYS,
        # k past SPREAD_RANK_MAX (the sorted branch)
        scores = [(rng.integers(1, 4, (512, 512)) *
                   (rng.uniform(size=(512, 512)) < 0.3)).astype(np.float32)]
        ks, ids = [1400], [0]
    elif name == "large_keys":  # the large kernel: 9,120 candidates on
        # 1920x1200's level 0 at 1000 features, tie-heavy, beside a level
        # of the register kernel with k past SPREAD_RANK_MAX
        scores = [(rng.integers(1, 3, (1200, 1920)) *
                   (rng.uniform(size=(1200, 1920)) < 0.05)).astype(
                       np.float32),
                  (rng.integers(1, 4, (512, 512)) *
                   (rng.uniform(size=(512, 512)) < 0.3)).astype(np.float32)]
        ks, ids = [217, 1400], [0, 1]
    else:  # "k_all": k equal to the candidates, rank rounds given as is
        C = tfast.n_cells(64, 96, 32)
        raw = (rng.integers(0, 3, (4, C)) * 5.0).astype(np.float32)
        raw[1] = 5.0  # a whole round of ties
        pos = rng.integers(0, 1024, (4, C)).astype(np.int32)
        return (None, [(torch.from_numpy(raw), torch.from_numpy(pos))],
                [4 * C], [4], [(64, 96)])
    return (scores, _ranked_from_scores(scores, ks), ks, ids,
            [s.shape for s in scores])


@pytest.mark.parametrize("name", ["ties_in_rounds", "no_corners", "k_one",
                                  "max_keys", "k_all", "large_keys"])
def test_k9_select_then_order_equals_plain_and_jax(name):
    scores, ranked, ks, ids, shapes = _k9_case(name)
    scales = [1.2 ** l for l in ids]
    n_keys = [r.numel() for r, _ in ranked]
    if name == "max_keys":
        assert n_keys == [torb.SPREAD_MAX_KEYS]
    if name == "large_keys":
        assert n_keys == [9120, torb.SPREAD_MAX_KEYS]
        assert torb._spread_plan(
            tuple(shapes), tuple(ks), tuple(ids), tuple(scales),
            tuple(r.shape[0] for r, _ in ranked), 32).launches == (
                "spread_topk", "spread_topk_large")
    if name == "k_all":
        assert n_keys == ks
    emu = _emulate_k9(ranked, ks, shapes, ids, scales)
    plain = torb.spread_topk_levels_plain(ranked, ks, shapes, ids, scales)
    for e, p in zip(emu, plain):
        assert e.dtype == p.numpy().dtype
        np.testing.assert_array_equal(e, p.numpy())
    if scores is not None:
        ref = [_jax_level(sc, k, l, s, 4) for sc, k, l, s in
               zip(scores, ks, ids, scales)]
        for i, e in enumerate(emu):
            np.testing.assert_array_equal(e, np.concatenate([r[i] for r in
                                                             ref]))


def test_k9_plan_is_built_by_the_extractor_on_a_card_only():
    """`prepare_spread_topk` makes the table a frame of the extractor's
    geometry looks up (its levels' rank rounds as K2 lays them out, the
    budgets' sum, the selected words' shared memory), and an extractor
    off the card builds none."""
    plans = torb._spread_plan.cache_info
    plan = torb.prepare_spread_topk(480, 640, 1000, 1.2, 8)
    budgets = torb.features_per_level(1000, 8, 1.2)
    shapes = timage.pyramid_shapes(480, 640, 8, 1.2)
    rounds = [tfast.n_rank_rounds(*s, k) for s, k in zip(shapes, budgets)]
    hits = plans().hits
    assert torb._spread_plan(tuple(shapes), tuple(budgets), tuple(range(8)),
                             tuple(1.2 ** l for l in range(8)),
                             tuple(rounds), 32) is plan
    assert plans().hits == hits + 1
    C = [tfast.n_cells(*s, 32) for s in shapes]
    assert plan.shapes == tuple(zip(rounds, C))
    assert plan.offsets == tuple(np.cumsum([0] + [r * c for r, c in zip(
        rounds, C)])[:-1])
    assert plan.K == 1000 and plan.smem == 8 * max(budgets)
    built = plans().misses
    torb.OrbExtractor(64, 88, 200, 1.2, 3, device="cpu")
    assert plans().misses == built
    with pytest.raises(ValueError, match=str(torb.SPREAD_MAX_BUDGET)):
        torb._spread_plan(((4096, 4096),), (16385,), (0,), (1.0,), (33,), 32)
    with pytest.raises(ValueError, match="budget 30"):
        torb._spread_plan(((64, 96),), (30,), (0,), (1.0,), (4,), 32)
