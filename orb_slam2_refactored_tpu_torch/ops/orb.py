"""Multi-scale ORB feature extraction.

Port of `orb_slam2_refactored_tpu/ops/orb.py`. On the card a frame's
extraction is four launches: the 8-level pyramid (kernel K8,
`ops/image.py::build_pyramid`), one call of kernel K2 (`ops/fast.py`:
two-threshold FAST, NMS and the per-cell rank rounds of every level), the
rank-boosted global top-k of every level in one launch of kernel K9
(`csrc/spread_topk.cu`, wrapper `spread_topk_levels`; two where a level
has more than 8,192 candidates, past ~1920x1080), and one call of
kernel K3 (the fused in-window blur + IC angle + steered BRIEF of every
level's keypoints, `csrc/orb_desc.cu`, wrapper
`angles_and_descriptors_levels`). Descriptors are int32[K,8],
bit-identical to the JAX package's uint32.

Both BRIEF test tables are ported. The "fresh" pattern fits K3's 31x31
window; the "learned" table (OpenCV's `bit_pattern_31_`, `orb_pattern_cv.npy`)
reaches 18 px once rotated, so, as in the JAX package, it takes the
full-image path: the level blurred with reflected borders, the IC angle of
the raw level and the continuously rotated tests, here kernel K7
(`csrc/orb_desc_learned.cu`, wrapper `angles_and_descriptors_learned_levels`).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from . import fast as fast_ops
from . import image as image_ops
from .fast import cell_rank_rounds

PATCH_SIZE = 31
HALF_PATCH = 15
EDGE_MARGIN = 19
PATTERN_RADIUS = 13
N_ANGLE_BINS = 64
_HALO = 3  # 7-tap blur kernel
_RAW = PATCH_SIZE + 2 * _HALO  # 37


# ---------------------------------------------------------------------------
# Constant tables (copies of the JAX package's builders)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256,2,2] int32: 256 (pointA, pointB) pairs, deterministic (seeded
    isotropic Gaussian clipped to PATTERN_RADIUS)."""
    rng = np.random.default_rng(20260817)
    pts = []
    while len(pts) < 512:
        p = rng.normal(0.0, PATCH_SIZE / 5.0, size=2)
        p = np.round(p).astype(np.int32)
        if p[0] ** 2 + p[1] ** 2 <= PATTERN_RADIUS ** 2:
            pts.append(p)
    pat = np.stack(pts).reshape(256, 2, 2)
    same = np.all(pat[:, 0] == pat[:, 1], axis=-1)
    pat[same, 1, 0] = np.clip(pat[same, 1, 0] + 1, -PATTERN_RADIUS,
                              PATTERN_RADIUS)
    return pat


@functools.lru_cache(maxsize=1)
def learned_pattern() -> np.ndarray:
    """[256,2,2] int32: the learned ORB test-pair table of the ORB paper
    (Rublee et al. 2011), OpenCV's `bit_pattern_31_` and the reference's
    (`src/ORBextractor.cc:142`), a byte-for-byte copy of the JAX package's
    `orb_pattern_cv.npy`. Layout [pair, (A, B), (x, y)]; coordinates within
    13, radius up to 18.4. Descriptors computed with it live in the bit
    space of externally trained vocabularies."""
    pat = np.load(os.path.join(os.path.dirname(__file__),
                               "orb_pattern_cv.npy"))
    assert pat.shape == (256, 2, 2)
    return pat.astype(np.int32)


def get_pattern(name: str) -> np.ndarray:
    if name == "fresh":
        return brief_pattern()
    if name == "learned":
        return learned_pattern()
    raise ValueError(f"unknown BRIEF pattern {name!r} (fresh|learned)")


@functools.lru_cache(maxsize=1)
def _umax_table() -> np.ndarray:
    """The reference's circular-patch rim table (cvRound + symmetry fix)."""
    half = HALF_PATCH
    umax = np.zeros(half + 2, np.int64)
    vmax = int(np.floor(half * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: half + 1]


@functools.lru_cache(maxsize=1)
def circular_patch_masks() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mask, x*mask, y*mask) over the 31x31 patch: the IC moment weights."""
    umax = _umax_table()
    ys, xs = np.mgrid[-HALF_PATCH: HALF_PATCH + 1, -HALF_PATCH: HALF_PATCH + 1]
    mask = (np.abs(xs) <= umax[np.abs(ys)]).astype(np.float32)
    return mask, (xs * mask).astype(np.float32), (ys * mask).astype(np.float32)


def pattern_fits_window(pattern: str) -> bool:
    """True when every rotated and rounded test point stays inside the
    31x31 patch (radius <= 14): the fresh pattern (radius 13) does and runs
    on K3; the learned table (radius 18.4) does not and runs on K7."""
    pat = get_pattern(pattern).astype(np.float64)
    return float(np.sqrt((pat ** 2).sum(-1)).max()) <= HALF_PATCH - 1


def features_per_level(n_features: int, n_levels: int,
                       scale_factor: float) -> List[int]:
    """Per-level budgets, geometric decay."""
    f = 1.0 / scale_factor
    first = n_features * (1.0 - f) / (1.0 - f ** n_levels)
    counts, total = [], 0
    for l in range(n_levels - 1):
        c = int(round(first * f ** l))
        counts.append(c)
        total += c
    counts.append(max(n_features - total, 0))
    return counts


@functools.lru_cache(maxsize=1)
def steered_pairs() -> np.ndarray:
    """int32[64,256,2]: per angle bin and test, the flat offsets of points A
    and B inside the 31x31 blurred window.

    The rotation and rounding are those of the JAX package's `diff_tables`
    (bin centre angle, Python `round`), which puts +1 at A and -1 at B of a
    dense difference table; `w[A] - w[B]` is the same test. The rotated
    support is 27x27 for the fresh pattern and sits at the window's
    centre."""
    pat = brief_pattern()
    out = np.zeros((N_ANGLE_BINS, 256, 2), np.int32)
    for b in range(N_ANGLE_BINS):
        th = (b + 0.5) * 2 * np.pi / N_ANGLE_BINS - np.pi
        c, s = np.cos(th), np.sin(th)
        for i in range(256):
            for j in range(2):
                x, y = pat[i, j]
                rx = int(round(x * c - y * s))
                ry = int(round(x * s + y * c))
                assert max(abs(rx), abs(ry)) <= HALF_PATCH
                out[b, i, j] = (ry + HALF_PATCH) * PATCH_SIZE + (rx + HALF_PATCH)
    return out


@functools.lru_cache(maxsize=2)
def _blur31_matrix(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """[37,31] band matrix: B^T raw37 B is the 7-tap Gaussian of the
    interior 31x31 window."""
    k = image_ops._gaussian_kernel(ksize, sigma)
    B = np.zeros((PATCH_SIZE + 2 * (ksize // 2), PATCH_SIZE), np.float32)
    for c in range(PATCH_SIZE):
        B[c: c + ksize, c] = k
    return B


@functools.lru_cache(maxsize=4)
def _device_tables(device_str: str):
    dev = torch.device(device_str)
    _, xm, ym = circular_patch_masks()
    return {
        "gk": torch.as_tensor(image_ops._gaussian_kernel(7, 2.0), device=dev),
        "xm": torch.as_tensor(xm.reshape(-1), device=dev),
        "ym": torch.as_tensor(ym.reshape(-1), device=dev),
        "mom": torch.as_tensor(np.stack([xm.reshape(-1), ym.reshape(-1)], 1),
                               device=dev),
        "pairs": torch.as_tensor(steered_pairs(), device=dev),
        "blur": torch.as_tensor(_blur31_matrix(), device=dev),
        "shifts": torch.arange(32, dtype=torch.int64, device=dev),
    }


def _tables(device):
    return _device_tables(str(torch.device(device)))


# ---------------------------------------------------------------------------
# Per-level selection: rank-in-cell boosted top-k (kernel K9)
# ---------------------------------------------------------------------------

def _topk_lowest_index(key, k: int):
    """(values, indices) of the k largest keys, equal keys lowest index
    first, as `jax.lax.top_k` orders them (`torch.topk` does not)."""
    order = torch.sort(-key, stable=True).indices[:k]
    return key[order], order


@functools.lru_cache(maxsize=64)
def _round_boost(rounds: int, rank_rounds: int, device_str: str):
    """f32[rounds,1]: BIG x max(rank_rounds - r, 0), exact in f32; cached
    so that a frame uploads nothing for it."""
    b = [1e6 * float(max(rank_rounds - r, 0)) for r in range(rounds)]
    return torch.tensor(b, dtype=torch.float32,
                        device=torch.device(device_str))[:, None]


def topk_from_ranks(raw, pos, k: int, h: int, w: int, cell: int = 32,
                    rank_rounds: int = 4):
    """The global top-k of `select_spread_topk` over the rank rounds'
    candidates: key = BIG x (rank_rounds - r) + score for a corner of round
    r (no boost past `rank_rounds`), -1 for a non-corner; the k largest
    keys, equal keys lowest index first. Returns (ys, xs, scores, valid) of
    length k; coordinates clamped into the level."""
    C = raw.shape[1]
    wc = -(-w // cell)
    boost = _round_boost(raw.shape[0], rank_rounds, str(raw.device))
    key = torch.where(raw > 0, boost + raw, torch.full_like(raw, -1.0))
    topv, topi = _topk_lowest_index(key.reshape(-1), k)
    c = topi % C
    p = pos.reshape(-1)[topi].long()
    ys = (c // wc) * cell + p // cell
    xs = (c % wc) * cell + p % cell
    return (torch.clamp(ys, max=h - 1), torch.clamp(xs, max=w - 1),
            raw.reshape(-1)[topi], topv > 0)


def select_spread_topk(score, k: int, cell: int = 32, rank_rounds: int = 4):
    """Pick k maxima of `score` [H,W] with spatial spread. Returns (ys, xs,
    scores, valid) of length k."""
    h, w = score.shape
    raw, pos = cell_rank_rounds(score, k, cell, rank_rounds)
    return topk_from_ranks(raw, pos, k, h, w, cell, rank_rounds)


class SpreadTopk(NamedTuple):
    """The selected keypoints of every level, concatenated in level order."""
    ys: torch.Tensor        # i32[K] level row, clamped to the edge margin
    xs: torch.Tensor        # i32[K] level column, clamped likewise
    xy: torch.Tensor        # f32[K,2] level-0 coords: (xs, ys) x scale
    level: torch.Tensor     # i32[K]
    response: torch.Tensor  # f32[K]
    valid: torch.Tensor     # bool[K]


def _check_spread_args(ranked, ks, shapes, level_ids, scales):
    n = len(ranked)
    if not len(ks) == len(shapes) == len(level_ids) == len(scales) == n:
        raise ValueError(f"spread_topk: {n} levels of rank rounds, "
                         f"{len(ks)} budgets, {len(shapes)} shapes, "
                         f"{len(level_ids)} level ids, {len(scales)} scales")
    for (raw, pos), k in zip(ranked, ks):
        if raw.shape != pos.shape or raw.dim() != 2:
            raise ValueError("spread_topk: raw and pos must be [rounds, C] "
                             "each")
        if k < 0 or (k > 0 and raw.numel() < k):
            raise ValueError(f"spread_topk: budget {k} from "
                             f"{raw.numel()} candidates")


def spread_topk_levels_plain(ranked, ks, shapes, level_ids, scales,
                             cell: int = 32, rank_rounds: int = 4,
                             margin: int = EDGE_MARGIN,
                             buffers=None) -> SpreadTopk:
    """Plain PyTorch version of kernel K9 (same signature; it reads
    `ranked` and ignores `buffers`): for each level its global top-k over
    the rank rounds (`topk_from_ranks`), the coordinates clamped to the
    edge margin, the level-0 coordinates and the level id, as the JAX
    extractor makes them (`orb_slam2_refactored_tpu/ops/orb.py:520-540`)."""
    _check_spread_args(ranked, ks, shapes, level_ids, scales)
    parts = []
    for (raw, pos), k, (h, w), l, s in zip(ranked, ks, shapes, level_ids,
                                           scales):
        if k <= 0:
            continue
        ys, xs, resp, valid = topk_from_ranks(raw, pos, k, h, w, cell,
                                              rank_rounds)
        ys_c = torch.clamp(ys, margin, h - 1 - margin).to(torch.int32)
        xs_c = torch.clamp(xs, margin, w - 1 - margin).to(torch.int32)
        xy0 = torch.stack([xs_c.to(torch.float32),
                           ys_c.to(torch.float32)], -1) * s
        parts.append((ys_c, xs_c, xy0, torch.full(
            (k,), l, dtype=torch.int32, device=raw.device), resp, valid))
    return SpreadTopk(*(torch.cat(f) for f in zip(*parts)))


SPREAD_MAX_KEYS = 8192  # candidates a level in registers (`kMaxKeys` in K9)
SPREAD_MAX_KEYS_LARGE = 1 << 24  # candidates a level (`kMaxKeysLarge`)
SPREAD_MAX_BUDGET = 16384  # a level's words fill <= 128 KB of shared memory
SPREAD_RANK_MAX = 1024  # selected a level K9 ranks by counting (`kRankMax`)
SPREAD_PARAMS = 8  # ints a level in K9's table (`kParams`)


class SpreadPlan(NamedTuple):
    """Kernel K9's launch table of one extraction geometry: each level's
    rank rounds [rounds, C] at `offsets` of one raw and one pos buffer, as
    kernel K2 lays them out (`ops/fast.py::detect_and_rank`)."""
    shapes: Tuple[Tuple[int, int], ...]  # per level (rounds, C)
    offsets: Tuple[int, ...]  # per level its first element in the buffers
    total: int             # elements of each buffer
    K: int                 # the sum of the budgets
    smem: int              # bytes of the largest level's selected words
    params: object         # the C table: SPREAD_PARAMS ints a level
    launches: Tuple[str, ...]  # the kernels a call launches, in order: the
    # register kernel ("spread_topk") for levels of at most SPREAD_MAX_KEYS
    # candidates, the large one ("spread_topk_large") for the others


@functools.lru_cache(maxsize=64)
def _spread_plan(shapes, ks, level_ids, scales, rounds, cell: int
                 ) -> SpreadPlan:
    """K9's table for levels of `shapes` [h, w] with budgets `ks`, ids
    `level_ids`, level-0 scales `scales` and `rounds` rank rounds each;
    raises where the kernel does not take them. Built once a geometry."""
    n = len(shapes)
    if not len(ks) == len(level_ids) == len(scales) == len(rounds) == n:
        raise ValueError(f"spread_topk: {n} shapes, {len(ks)} budgets, "
                         f"{len(level_ids)} level ids, {len(scales)} scales, "
                         f"{len(rounds)} levels of rank rounds")
    if n > kernels.MAX_LEVELS:
        raise ValueError(f"spread_topk: {n} levels, the kernel takes at most "
                         f"{kernels.MAX_LEVELS}")
    rc, offsets, params, off, smem = [], [], [], 0, 0
    small = large = False
    for (h, w), k, l, sc, r in zip(shapes, ks, level_ids, scales, rounds):
        C = fast_ops.n_cells(h, w, cell)
        if k < 0 or (k > 0 and r * C < k):
            raise ValueError(f"spread_topk: budget {k} from {r * C} "
                             f"candidates")
        if k > 0 and r * C > SPREAD_MAX_KEYS_LARGE:
            raise ValueError(f"spread_topk: {r * C} candidates on a level, "
                             f"kernel K9 takes at most "
                             f"{SPREAD_MAX_KEYS_LARGE}")
        if k > SPREAD_MAX_BUDGET:
            raise ValueError(f"spread_topk: budget {k} on a level, kernel K9 "
                             f"orders at most {SPREAD_MAX_BUDGET} in shared "
                             f"memory")
        small |= 0 < k and r * C <= SPREAD_MAX_KEYS
        large |= 0 < k and r * C > SPREAD_MAX_KEYS
        rc.append((r, C))
        offsets.append(off)
        params += [off, h, w, k, r, C, l,
                   int(np.float32(sc).view(np.int32))]
        off += r * C
        smem = max(smem, 8 * (k if k <= SPREAD_RANK_MAX
                              else 1 << (k - 1).bit_length()))
    return SpreadPlan(tuple(rc), tuple(offsets), off, sum(ks), smem,
                      kernels.int_array(params),
                      ("spread_topk",) * small
                      + ("spread_topk_large",) * large)


def prepare_spread_topk(height: int, width: int, n_features: int,
                        scale_factor: float, n_levels: int, cell: int = 32,
                        rank_rounds: int = 4) -> SpreadPlan:
    """Build K9's table of an extractor's geometry now, as
    `spread_topk_levels` finds it on the extractor's frames (the levels
    with a budget, K2's rank rounds), so that no frame builds it."""
    budgets = features_per_level(n_features, n_levels, scale_factor)
    shapes = image_ops.pyramid_shapes(height, width, n_levels, scale_factor)
    used = [l for l in range(n_levels) if budgets[l] > 0]
    return _spread_plan(
        tuple(shapes[l] for l in used), tuple(budgets[l] for l in used),
        tuple(used), tuple(float(scale_factor ** l) for l in used),
        tuple(fast_ops.n_rank_rounds(*shapes[l], budgets[l], cell,
                                     rank_rounds) for l in used), cell)


def _rank_buffers(ranked, plan: SpreadPlan):
    """The two flat buffers (raw f32, pos int32) holding every level's rank
    rounds at the plan's offsets: those the levels are views of where they
    lie as kernel K2 lays them out, else copies packed so. Raises where a
    level is not CUDA rank rounds of the plan's shape."""
    raw0, pos0 = ranked[0]
    raw_p, pos_p = raw0.data_ptr(), pos0.data_ptr()
    laid = True
    for (raw, pos), shape, off in zip(ranked, plan.shapes, plan.offsets):
        if not (raw.shape == pos.shape == shape and raw.is_cuda
                and pos.is_cuda and raw.dtype == torch.float32
                and pos.dtype == torch.int32 and raw.is_contiguous()
                and pos.is_contiguous()):
            raise ValueError(f"spread_topk: expected CUDA rank rounds f32 and "
                             f"int32 {shape}, got {raw.dtype} and "
                             f"{pos.dtype} {tuple(raw.shape)}, "
                             f"{tuple(pos.shape)}")
        laid = (laid and raw.data_ptr() == raw_p + 4 * off
                and pos.data_ptr() == pos_p + 4 * off)
    if laid:
        return raw0, pos0
    return (torch.cat([r.reshape(-1) for r, _ in ranked]),
            torch.cat([p.reshape(-1) for _, p in ranked]))


def spread_topk_levels(ranked, ks, shapes, level_ids, scales,
                       cell: int = 32, rank_rounds: int = 4,
                       margin: int = EDGE_MARGIN,
                       buffers=None) -> SpreadTopk:
    """The keypoints of every level from the rank rounds that one K2 call
    left (`ranked`: per level (raw f32[rounds, C], pos int32[rounds, C])):
    per level the k = `ks[i]` largest keys, a corner of round r keyed
    1e6 x max(rank_rounds - r, 0) + raw and a non-corner -1, equal keys
    lowest flat index first (`jax.lax.top_k`'s order), decoded to (ys, xs)
    clamped into the level, then to the edge margin; the level-0
    coordinates (xs, ys) x scales[i], level_ids[i], the response and
    key > 0 as valid. `shapes` are the levels' [h, w]. On CUDA tensors
    kernel K9 (`csrc/spread_topk.cu`, a block a level): one launch for the
    levels of at most SPREAD_MAX_KEYS candidates, keys in registers, and
    one of its large kernel after it for the larger levels, if any; it
    raises past SPREAD_MAX_KEYS_LARGE candidates or a budget of
    SPREAD_MAX_BUDGET on a level. The plain version on CPU tensors. K9
    reads two flat buffers through the launch table `_spread_plan` caches
    per geometry: `buffers`, K2's own (`ops/fast.py::RankRounds.buffers`,
    of which `ranked` are the views), or else those `_rank_buffers` finds
    or packs."""
    raw0 = ranked[0][0]
    if not raw0.is_cuda:
        return spread_topk_levels_plain(ranked, ks, shapes, level_ids, scales,
                                        cell, rank_rounds, margin)
    plan = _spread_plan(tuple(map(tuple, shapes)), tuple(ks),
                        tuple(level_ids), tuple(map(float, scales)),
                        tuple([r.shape[0] for r, _ in ranked]), cell)
    if buffers is None:
        raw, pos = _rank_buffers(ranked, plan)
    else:
        raw, pos = buffers
        kernels.require(raw, "spread_topk raw", torch.float32,
                        (plan.total,))
        kernels.require(pos, "spread_topk pos", torch.int32, (plan.total,))
    # the outputs are views of one allocation (ys, xs, level ids, xy,
    # responses, valid bytes): six allocations took 13 us more host time
    # a call on the H100's host (`extract_probe.py`)
    K = plan.K
    buf = torch.empty((6 * K + -(-K // 4),), dtype=torch.int32,
                      device=raw0.device)
    ys, xs, level, xy, resp, valid = buf.split(
        [K, K, K, 2 * K, K, -(-K // 4)])
    fn = kernels.bind("spread_topk", "spread_topk_levels",
                      [kernels.CI] + [kernels.VP] * 3 + [kernels.CI] * 4
                      + [kernels.VP, kernels.CI, kernels.VP])
    for name in plan.launches:
        kernels.LAUNCHES[name] += 1
    kernels.check(fn(len(ranked), raw.data_ptr(), pos.data_ptr(), plan.params,
                     cell, rank_rounds, margin, K, buf.data_ptr(), plan.smem,
                     kernels.stream_of(raw0)), "spread_topk_levels")
    return SpreadTopk(ys, xs, xy.view(torch.float32).view(K, 2), level,
                      resp.view(torch.float32), valid.view(torch.bool)[:K])


# ---------------------------------------------------------------------------
# Fused blur + IC angle + steered BRIEF (kernel K3)
# ---------------------------------------------------------------------------

def pack_bits(bits):
    """bool[K,256] -> int32[K,8]: bit i in word i/32 at bit i%32."""
    shifts = _tables(bits.device)["shifts"]
    w = (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def angles_and_descriptors_plain(lvl, ys, xs):
    """Plain PyTorch version of kernel K3 (same signature)."""
    tb = _tables(lvl.device)
    d = torch.arange(-(HALF_PATCH + _HALO), HALF_PATCH + _HALO + 1,
                     device=lvl.device)
    rows = ys.long()[:, None] + d[None, :]
    cols = xs.long()[:, None] + d[None, :]
    raw = lvl[rows[:, :, None], cols[:, None, :]]  # [K,37,37]
    B = tb["blur"]
    win = torch.einsum("ac,kab,bd->kcd", B, raw.to(torch.float32), B)
    win = win.reshape(-1, PATCH_SIZE * PATCH_SIZE)
    m = win @ tb["mom"]
    ang = torch.atan2(m[:, 1], m[:, 0])
    bin_ = torch.floor((ang + np.pi) * (N_ANGLE_BINS / (2 * np.pi))).to(
        torch.int32) % N_ANGLE_BINS
    pairs = tb["pairs"][bin_.long()].long()  # [K,256,2]
    wb = win.to(torch.bfloat16).to(torch.float32)
    va = torch.gather(wb, 1, pairs[:, :, 0])
    vb = torch.gather(wb, 1, pairs[:, :, 1])
    return ang, pack_bits((va - vb) < 0)


def angles_and_descriptors_levels_plain(levels, ys, xs, counts):
    """Plain PyTorch version of kernel K3 over several levels: the
    one-level plain version on each level's slice of (ys, xs)."""
    outs = [angles_and_descriptors_plain(lvl, y, x) for lvl, y, x in
            zip(levels, ys.split(list(counts)), xs.split(list(counts)))]
    return torch.cat([a for a, _ in outs]), torch.cat([d for _, d in outs])


def angles_and_descriptors_levels(levels, ys, xs, counts):
    """IC angle f32[K] and steered-BRIEF int32[K,8] for keypoints at
    integer (ys, xs) of several pyramid levels, from a 37x37 raw window
    blurred in-window. (ys, xs) are int32[K], grouped by level: the first
    counts[0] lie on levels[0], and so on. One launch of kernel
    `csrc/orb_desc.cu` for every level on CUDA tensors; the plain version
    on CPU tensors. The level tensors are held by the caller until the
    kernel has run (it runs on their stream)."""
    if not levels[0].is_cuda:
        return angles_and_descriptors_levels_plain(levels, ys, xs, counts)
    K = ys.shape[0]
    n = len(levels)
    if len(counts) != n or sum(counts) != K:
        raise ValueError(f"orb: counts {list(counts)} do not split {K} "
                         f"keypoints over {n} levels")
    if n > kernels.MAX_LEVELS:
        raise ValueError(f"orb: {n} levels, the kernel takes at most "
                         f"{kernels.MAX_LEVELS}")
    for lvl in levels:
        kernels.require(lvl, "orb level", torch.float32)
    kernels.require(ys, "orb ys", torch.int32, (K,))
    kernels.require(xs, "orb xs", torch.int32, (K,))
    dev = levels[0].device
    tb = _tables(dev)
    ang = torch.empty((K,), dtype=torch.float32, device=dev)
    desc = torch.empty((K, 8), dtype=torch.int32, device=dev)
    fn = kernels.bind("orb_desc", "orb_angles_desc_levels",
                      [kernels.CI, kernels.VP, kernels.VP, kernels.VP,
                       kernels.VP, kernels.CI] + [kernels.VP] * 7)
    kernels.LAUNCHES["orb_desc"] += 1
    kernels.check(fn(n, kernels.ptr_array(levels),
                     kernels.int_array([d for lvl in levels for d in lvl.shape]
                                       + list(counts)),
                     kernels.ptr(ys), kernels.ptr(xs), K,
                     kernels.ptr(tb["gk"]), kernels.ptr(tb["xm"]),
                     kernels.ptr(tb["ym"]), kernels.ptr(tb["pairs"]),
                     kernels.ptr(ang), kernels.ptr(desc),
                     kernels.stream_of(levels[0])), "orb_angles_desc_levels")
    return ang, desc


def angles_and_descriptors_raw(lvl, ys, xs):
    """IC angle f32[K] and steered-BRIEF int32[K,8] for keypoints at integer
    (ys, xs) of one pyramid level: `angles_and_descriptors_levels` with a
    list of one (kernel `csrc/orb_desc.cu` on CUDA, plain on CPU)."""
    if not lvl.is_cuda:
        return angles_and_descriptors_plain(lvl, ys, xs)
    return angles_and_descriptors_levels([lvl], ys, xs, [ys.shape[0]])


# ---------------------------------------------------------------------------
# The learned pattern: raw-level IC angle, blurred level, rotated tests (K7)
# ---------------------------------------------------------------------------

LEARNED_REACH = 18  # |rotated, rounded offset| of a point within radius 18.5
LEARNED_ARGS = [kernels.VP] * 5 + [kernels.CI] + [kernels.VP] * 4


def _pattern_table(pattern, device) -> torch.Tensor:
    """int32[256, 4] (ax, ay, bx, by) of a pattern name or a [256, 2, 2]
    table on `device`."""
    pat = get_pattern(pattern) if isinstance(pattern, str) else pattern
    return torch.as_tensor(np.asarray(pat, np.int32).reshape(256, 4),
                           device=device).contiguous()


def ic_angles(img, ys, xs):
    """Intensity-centroid orientation f32[K] of keypoints at integer
    (ys, xs), from the 31x31 circular patch of the (raw) level `img`."""
    tb = _tables(img.device)
    d = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device)
    patches = img[(ys.long()[:, None] + d)[:, :, None],
                  (xs.long()[:, None] + d)[:, None, :]]  # [K,31,31]
    m10 = torch.sum(patches * tb["xm"].reshape(PATCH_SIZE, PATCH_SIZE),
                    dim=(1, 2))
    m01 = torch.sum(patches * tb["ym"].reshape(PATCH_SIZE, PATCH_SIZE),
                    dim=(1, 2))
    return torch.atan2(m01, m10)


def brief_descriptors(blurred, ys, xs, angles, pattern="fresh"):
    """Steered BRIEF int32[K,8] sampled from the blurred level at the
    pattern's offsets rotated by the exact angle: x c - y s and x s + y c,
    each product and the sum rounded apart, then rounded half to even
    (`ComputeOrbDescriptor`, `src/ORBextractor.cc:103-140`); bit = A < B.
    `pattern` is a name or a [256, 2, 2] table."""
    pat = _pattern_table(pattern, blurred.device).to(torch.float32)
    c = torch.cos(angles)[:, None]
    s = torch.sin(angles)[:, None]
    px, py = pat[None, :, 0::2], pat[None, :, 1::2]  # [1,256,2]: A, B
    c, s = c[..., None], s[..., None]
    rx = torch.round(px * c - py * s).long()
    ry = torch.round(px * s + py * c).long()
    w = blurred.shape[1]
    flat = (ys.long()[:, None, None] + ry) * w + xs.long()[:, None, None] + rx
    samples = blurred.reshape(-1)[flat]  # [K,256,2]
    return pack_bits(samples[..., 0] < samples[..., 1])


def angles_and_descriptors_learned_plain(levels, ys, xs, counts, angles=None,
                                         pattern="learned"):
    """Plain PyTorch version of kernel K7 (same signature): each level
    blurred whole (`ops/image.py::gaussian_blur`), the IC angle of its raw
    pixels (unless `angles` are given), the rotated tests on the blurred
    level."""
    splits = list(counts)
    angs, descs = [], []
    given = angles.split(splits) if angles is not None else [None] * len(
        splits)
    for lvl, y, x, a in zip(levels, ys.split(splits), xs.split(splits),
                            given):
        if a is None:
            a = ic_angles(lvl, y, x)
        angs.append(a)
        descs.append(brief_descriptors(image_ops.gaussian_blur(lvl, 7, 2.0),
                                       y, x, a, pattern))
    return torch.cat(angs), torch.cat(descs)


def learned_tie_gate(levels, ys, xs, counts, angles, pattern="learned",
                     half_tol=1e-4, gray_tol=1e-3):
    """bool[K,256]: the tests whose bit two correct implementations may
    set apart: a rotated coordinate within `half_tol` (a float, or one a
    keypoint) of a half-integer in f64, where the f32 rounding of
    x c - y s may go either way, or the two blurred samples within
    `gray_tol` gray. K7 is held against its plain version, and the plain
    version against JAX's, on the tests outside it; the tracking path
    never asks for it."""
    pat = _pattern_table(pattern, ys.device).to(torch.float64)
    ht = torch.as_tensor(half_tol, dtype=torch.float64,
                         device=ys.device).expand(ys.shape[0])
    out, start = [], 0
    for lvl, k in zip(levels, counts):
        sl = slice(start, start + k)
        start += k
        blur = image_ops.gaussian_blur(lvl, 7, 2.0)
        a = angles[sl].to(torch.float64)[:, None, None]
        px, py = pat[None, :, 0::2], pat[None, :, 1::2]
        rx = px * torch.cos(a) - py * torch.sin(a)
        ry = px * torch.sin(a) + py * torch.cos(a)
        tol = ht[sl, None, None]
        near = ((torch.abs(rx - torch.floor(rx) - 0.5) < tol)
                | (torch.abs(ry - torch.floor(ry) - 0.5) < tol)).any(-1)
        w = blur.shape[1]
        flat = ((ys[sl].long()[:, None, None] + torch.round(ry).long()) * w
                + xs[sl].long()[:, None, None] + torch.round(rx).long())
        smp = blur.reshape(-1)[flat]
        out.append(near | (torch.abs(smp[..., 0] - smp[..., 1]) < gray_tol))
    return torch.cat(out)


class _K7Table(ctypes.Structure):
    """Kernel K7's launch table (`K7Table` in `csrc/orb_desc_learned.cu`):
    level l's image is the launch's `img0` + off[l] bytes where
    from_base[l] is 0, else its `base` + off[l] bytes."""
    _fields_ = [("n", ctypes.c_int), ("K", ctypes.c_int),
                ("h", ctypes.c_int * kernels.MAX_LEVELS),
                ("w", ctypes.c_int * kernels.MAX_LEVELS),
                ("k0", ctypes.c_int * kernels.MAX_LEVELS),
                ("from_base", ctypes.c_int * kernels.MAX_LEVELS),
                ("off", ctypes.c_longlong * kernels.MAX_LEVELS),
                ("gk", ctypes.c_void_p), ("mom", ctypes.c_void_p),
                ("pattern", ctypes.c_void_p)]


class LearnedPlan(NamedTuple):
    """Kernel K7's launch table of one geometry, device and pattern."""
    K: int
    offsets: Tuple[int, ...]  # levels 1.. in K8's buffer: bytes from level 1
    pattern: torch.Tensor     # int8[256, 4] on the device
    table: _K7Table           # level 0 the image, the others at `offsets`
    address: int              # of `table`


def _pattern_key(pattern):
    """A pattern name as it is; a [256, 2, 2] table as its int32 bytes."""
    if isinstance(pattern, str):
        return pattern
    return np.ascontiguousarray(pattern, np.int32).tobytes()


@functools.lru_cache(maxsize=64)
def _learned_plan(shapes, counts, device_index: int, pattern) -> LearnedPlan:
    """K7's table for levels of `shapes` [h, w] holding `counts` keypoints
    each, on the CUDA device `device_index` (the CPU for -1), with the
    pattern `_pattern_key` names; raises where the kernel does not take
    them. Built once a geometry: the pattern is uploaded and its radius
    checked here, and the levels are placed as kernel K8 lays them out
    (level 0 the frame, the others in one buffer,
    `image_ops.buffer_offsets`)."""
    n = len(shapes)
    if len(counts) != n:
        raise ValueError(f"orb: counts {list(counts)} do not split the "
                         f"keypoints over {n} levels")
    if not 1 <= n <= kernels.MAX_LEVELS:
        raise ValueError(f"orb: {n} levels, the kernel takes 1 to "
                         f"{kernels.MAX_LEVELS}")
    for (h, w), k in zip(shapes, counts):
        if k < 0 or (k > 0 and min(h, w) < 2 * EDGE_MARGIN + 1):
            raise ValueError(f"orb: {k} keypoints on a {h}x{w} level; the "
                             f"kernel takes levels of {2 * EDGE_MARGIN + 1} "
                             f"px and more")
    pat_np = (get_pattern(pattern) if isinstance(pattern, str) else
              np.frombuffer(pattern, np.int32).reshape(256, 2, 2).copy())
    radius = float(np.sqrt((pat_np.astype(np.float64) ** 2).sum(-1)).max())
    if radius >= LEARNED_REACH + 0.5:
        raise ValueError(f"orb: a test point at radius {radius:.2f} leaves "
                         f"the kernel's {LEARNED_REACH}-px window")
    dev = (torch.device("cpu") if device_index < 0
           else torch.device("cuda", device_index))
    pat = torch.as_tensor(pat_np.reshape(256, 4).astype(np.int8),
                          device=dev)
    offsets = tuple(4 * o for o in image_ops.buffer_offsets(shapes[1:])[0])
    t = _K7Table(n=n, K=sum(counts))
    k0 = 0
    for l, ((h, w), k) in enumerate(zip(shapes, counts)):
        t.h[l], t.w[l], t.k0[l] = h, w, k0
        t.from_base[l] = int(l > 0)
        t.off[l] = offsets[l - 1] if l > 0 else 0
        k0 += k
    tb = _tables(dev)
    t.gk, t.mom = tb["gk"].data_ptr(), tb["mom"].data_ptr()
    t.pattern = pat.data_ptr()
    return LearnedPlan(t.K, offsets, pat, t, ctypes.addressof(t))


def prepare_learned(height: int, width: int, n_features: int,
                    scale_factor: float, n_levels: int, pattern, device
                    ) -> LearnedPlan:
    """Build K7's table of an extractor's geometry now, as
    `angles_and_descriptors_learned_levels` finds it on the extractor's
    frames (the levels with a budget), so that no frame builds it."""
    budgets = features_per_level(n_features, n_levels, scale_factor)
    shapes = image_ops.pyramid_shapes(height, width, n_levels, scale_factor)
    used = [l for l in range(n_levels) if budgets[l] > 0]
    dev = torch.empty(0, device=device).device
    return _learned_plan(tuple(shapes[l] for l in used),
                         tuple(budgets[l] for l in used),
                         -1 if dev.index is None else dev.index,
                         _pattern_key(pattern))


def _learned_call_table(plan: LearnedPlan, ptrs) -> _K7Table:
    """A table of `plan` for levels at the addresses `ptrs`, laid out
    otherwise than kernel K8 lays them: built on the call."""
    t = _K7Table.from_buffer_copy(plan.table)
    for l, p in enumerate(ptrs):
        t.from_base[l], t.off[l] = 1, p
    return t


def learned_sources(levels, plan: LearnedPlan):
    """(img0, base, table address, table) of a K7 launch over `levels`:
    the plan's own table where levels 1.. lie at its offsets of one
    buffer, as kernel K8 writes them (`image_ops.pyramid_levels`), else a
    table of their addresses built on this call (`_learned_call_table`),
    which the caller holds until the launch."""
    ptrs = [lvl.data_ptr() for lvl in levels]
    base = ptrs[1] if len(ptrs) > 1 else 0
    if all(p == base + o for p, o in zip(ptrs[1:], plan.offsets)):
        return ptrs[0], base, plan.address, plan.table
    t = _learned_call_table(plan, ptrs)
    return 0, 0, ctypes.addressof(t), t


def angles_and_descriptors_learned_levels(levels, ys, xs, counts,
                                          angles=None, pattern="learned"):
    """IC angle f32[K] and steered-BRIEF int32[K,8] with a test table that
    does not fit the 31x31 window (the learned one), for keypoints at
    integer (ys, xs) of several pyramid levels, grouped by level as for
    `angles_and_descriptors_levels`. With `angles` given, the descriptors
    are steered by them and they are returned as they are. `pattern` is a
    name or a numpy [256, 2, 2] table whose points lie within radius 18.5
    (a swapped pair makes a control that must disagree). One launch of
    kernel `csrc/orb_desc_learned.cu` for every level on CUDA tensors,
    through the launch table `_learned_plan` caches per geometry, device
    and pattern (built with the extractor: `prepare_learned`); the plain
    version on CPU tensors."""
    lvl0 = levels[0]
    if not lvl0.is_cuda:
        return angles_and_descriptors_learned_plain(levels, ys, xs, counts,
                                                    angles, pattern)
    plan = _learned_plan(tuple([tuple(lvl.shape) for lvl in levels]),
                         tuple(counts), lvl0.get_device(),
                         _pattern_key(pattern))
    K = plan.K
    for lvl in levels:
        kernels.require(lvl, "orb level", torch.float32)
    kernels.require(ys, "orb ys", torch.int32, (K,))
    kernels.require(xs, "orb xs", torch.int32, (K,))
    if angles is not None:
        kernels.require(angles, "orb angles", torch.float32, (K,))
    # `new_empty`: the cheapest allocation on the H100's host
    # (`extract_probe.py`)
    ang, desc = lvl0.new_empty((K,)), ys.new_empty((K, 8))
    if K == 0:
        return ang, desc
    img0, base, table, held = learned_sources(levels, plan)
    fn = kernels.bind("orb_desc_learned", "orb_learned_levels", LEARNED_ARGS)
    kernels.LAUNCHES["orb_desc_learned"] += 1
    kernels.check(fn(img0, base, table, ys.data_ptr(), xs.data_ptr(), K,
                     None if angles is None else angles.data_ptr(),
                     ang.data_ptr(), desc.data_ptr(), kernels.stream_of(lvl0)),
                  "orb_learned_levels")
    del held  # the table the launch read
    return ang, desc


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

class OrbFeatures(NamedTuple):
    xy: torch.Tensor        # f32[K,2] level-0 coords
    level: torch.Tensor     # i32[K]
    angle: torch.Tensor     # f32[K]
    response: torch.Tensor  # f32[K]
    desc: torch.Tensor      # i32[K,8]
    valid: torch.Tensor     # bool[K]


class OrbExtractor:
    """ORB pipeline for a fixed image geometry (reference defaults:
    scaleFactor=1.2, nlevels=8, iniThFAST=20, minThFAST=7). Given a CUDA
    `device`, it builds the launch tables of the geometry there at once
    (kernel K8's, `image_ops.prepare_pyramid`; K9's, `prepare_spread_topk`;
    K7's with the learned pattern, `prepare_learned`), so that no frame
    pays for them."""

    def __init__(self, height: int, width: int, n_features: int = 1000,
                 scale_factor: float = 1.2, n_levels: int = 8,
                 ini_th_fast: float = 20.0, min_th_fast: float = 7.0,
                 cell: int = 32, pattern: str = "fresh", device=None):
        self.pattern = pattern
        # an unknown name raises ValueError; the learned table runs on K7
        self.full_image_path = not pattern_fits_window(pattern)
        self.height, self.width = height, width
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th, self.min_th = float(ini_th_fast), float(min_th_fast)
        self.cell = cell
        self.budgets = features_per_level(n_features, n_levels, scale_factor)
        self.level_scales = [scale_factor ** l for l in range(n_levels)]
        if device is not None and torch.device(device).type == "cuda":
            image_ops.prepare_pyramid(height, width, n_levels, scale_factor,
                                      device)
            prepare_spread_topk(height, width, n_features, scale_factor,
                                n_levels, cell)
            if self.full_image_path:
                prepare_learned(height, width, n_features, scale_factor,
                                n_levels, pattern, device)

    def __call__(self, img) -> OrbFeatures:
        return self._extract_impl_pyr(img)[0]

    def _extract_impl_pyr(self, img) -> Tuple[OrbFeatures, List]:
        """Pyramid (one K8 launch), one K2 call (FAST, NMS, edge margin and
        the per-cell rank rounds of every level), one K9 launch (the global
        top-k of every level, the clamps and the level-0 coordinates), then
        one K3 call for every level's keypoints, or one K7 call when the
        pattern does not fit K3's window (the learned table), as the JAX
        package branches; the plain versions on a CPU image."""
        img = image_ops.to_gray(img)
        levels = image_ops.build_pyramid(img, self.n_levels, self.scale_factor)
        used = [l for l in range(self.n_levels) if self.budgets[l] > 0]
        lv = [levels[l] for l in used]
        ks = [self.budgets[l] for l in used]
        ranked = fast_ops.detect_and_rank(lv, self.ini_th, self.min_th, ks,
                                          margin=EDGE_MARGIN,
                                          rank_cell=self.cell)
        sel = spread_topk_levels(
            [(raw, pos) for _, raw, pos in ranked], ks,
            [tuple(lvl.shape) for lvl in lv], used,
            [self.level_scales[l] for l in used], self.cell,
            buffers=ranked.buffers)
        if self.full_image_path:
            ang, desc = angles_and_descriptors_learned_levels(
                lv, sel.ys, sel.xs, ks, pattern=self.pattern)
        else:
            ang, desc = angles_and_descriptors_levels(lv, sel.ys, sel.xs, ks)
        return OrbFeatures(xy=sel.xy, level=sel.level, angle=ang,
                           response=sel.response, desc=desc,
                           valid=sel.valid), levels
