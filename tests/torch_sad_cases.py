"""Constructed inputs for the stereo SAD refinement (kernel B9) and a numpy
loop that computes what it must give.

A right image that is the left one shifted by `s` px puts the exact match
(SAD 0) of a keypoint at column x in the window centred on x - s, so the
argmin is chosen by the coordinates: a tie between two windows (columns
that repeat every 4 px; the lowest index must win), an argmin at r = 0 and
at r = 10 (rejected), an interior one, a flat SAD row (a constant image:
rejected), keypoints at a level's rim (coordinates beyond the level,
clipped by `level_coordinates`) and keypoints on the top level (whose
pixels, as the pyramid makes them, are not integers).

`assoc_case` builds the inputs of the whole association after K1's
best-2 (`stereo.associate_from_best2`): keypoints at every level whose
matched right keypoint lies 3 px to the left at their level, on a right
pyramid that is the left one shifted, plus a checkerboard of +-1 (every
exact match then has the SAD 120 at levels with integer pixels, so the
SAD median is a tie) or plus random noise (distinct SADs), with some wrong
matches and far distances for the two filters to reject. The cases cover
the two medians: every match missed (the distance median over BIG), no
good SAD (the SAD median inf, no filter), even and odd counts, tied
distance and SAD medians, 600 keypoints with crowded distances, N not a
multiple of 8, N = 1 and N = 0.

Used by tests/test_torch_stereo.py (plain version, on the CPU) and
tests/test_torch_kernels_gpu.py (kernel against plain version, on the
card). Plain numpy and torch, no JAX import.
"""

import numpy as np
import torch

from orb_slam2_refactored_tpu_torch.ops import stereo

SAD_CASES = ["tie_lowest_index", "argmin_at_0", "argmin_at_10", "interior",
             "flat", "rim", "top_level"]
QVGA_SHAPES = [(240, 320), (200, 267), (167, 222), (139, 185)]


def sad_ref(levels_l, levels_r, lvl, yl, xl, ur0):
    """A numpy loop over each keypoint: the 11 SADs in f32, summed in
    row-major order, the first argmin, the parabola and its gates. Returns
    (ur_lvl, sad_best, delta_ok, argmin)."""
    f32 = np.float32
    out = []
    for l, y, x, u in zip(lvl, yl, xl, ur0):
        L, R = levels_l[l], levels_r[l]
        patch = L[y - 5:y + 6, x - 5:x + 6]
        strip = R[y - 5:y + 6, u - 10:u + 11]
        sads = np.zeros(11, f32)
        for r in range(11):
            win = strip[:, r:r + 11]
            s = f32(0)
            for dy in range(11):
                for dx in range(11):
                    s = f32(s + abs(f32(patch[dy, dx] - patch[5, 5])
                                    - f32(win[dy, dx] - win[5, 5])))
            sads[r] = s
        best = int(np.argmin(sads))
        bi = min(max(best, 1), 9)
        sm, s0, sp = sads[bi - 1], sads[bi], sads[bi + 1]
        denom = f32(f32(sm + sp) - f32(2) * s0)
        if abs(denom) > f32(1e-6):
            delta = f32(f32(0.5) * f32(sm - sp)) / denom
        else:
            delta = f32(2)
        ur = f32(f32(u) + f32(bi - 5)) + f32(min(max(delta, -1), 1))
        ok = abs(delta) <= 1 and best not in (0, 10)
        out.append((ur, s0, ok, best))
    return [np.array(c) for c in zip(*out)]


def sad_case(name, shapes=QVGA_SHAPES):
    """(levels_l, levels_r, lvl, yl, xl, ur0, expected argmins or None) for
    a pyramid of `shapes` (f32 numpy levels; int32 coordinates)."""
    rng = np.random.default_rng(11)
    L = len(shapes)
    rand = [rng.integers(0, 256, s).astype(np.float32) for s in shapes]
    rand[-1] = (rand[-1] * np.float32(0.8333)).astype(np.float32)

    def shifted(levels, s):
        return [np.roll(a, -s, axis=1) for a in levels]

    lvl = np.zeros(4, np.int32)
    yl = np.array([20, 25, 30, 35], np.int32)
    xl = np.array([30, 35, 40, 45], np.int32)
    if name == "tie_lowest_index":
        # columns repeat every 4 px: windows r = 3 and 7 both match exactly
        period = [np.tile(a[:, :4], (1, a.shape[1] // 4 + 1))[:, :a.shape[1]]
                  for a in rand]
        return period, period, lvl, yl, xl, xl + 2, [3] * 4
    if name in ("argmin_at_0", "argmin_at_10", "interior"):
        r_star = {"argmin_at_0": 0, "argmin_at_10": 10, "interior": 6}[name]
        s = 3
        return (rand, shifted(rand, s), lvl, yl, xl, xl - s + 5 - r_star,
                [r_star] * 4)
    if name == "flat":
        flat = [np.full(s, 77.0, np.float32) for s in shapes]
        return flat, flat, lvl, yl, xl, xl, [0] * 4
    if name == "rim":
        # level-0 coordinates beyond each level's edges (and an unmatched
        # u_right = -1), clipped by `level_coordinates` to the bounds
        lvl = np.array([0, 1, L - 2, L - 1], np.int32)
        sf = torch.tensor([1.2 ** k for k in range(L)], dtype=torch.float32)
        xy = torch.tensor([[0.0, 0.0], [5000.0, 5000.0], [5000.0, -9.0],
                           [-3.0, 4000.0]])
        u_right = torch.tensor([-1.0, 9000.0, 1.0, 6000.0])
        h = np.array([shapes[k][0] for k in lvl])
        w = np.array([shapes[k][1] for k in lvl])
        want = (lvl, np.array([5, h[1] - 6, 5, h[3] - 6], np.int32),
                np.array([5, w[1] - 6, w[2] - 6, 5], np.int32),
                np.array([10, w[1] - 11, 10, w[3] - 11], np.int32))
        got = stereo.level_coordinates([torch.from_numpy(a) for a in rand],
                                       xy, torch.from_numpy(lvl), u_right, sf)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        return (rand, shifted(rand, 2)) + want + (None,)
    if name == "top_level":
        lvl = np.full(4, L - 1, np.int32)
        yl = np.array([10, 15, 20, 24], np.int32)
        xl = np.array([15, 20, 25, 34], np.int32)
        return rand, shifted(rand, 4), lvl, yl, xl, xl - 4 + 5 - 4, [4] * 4
    raise KeyError(name)


def as_tensors(case, device="cpu"):
    """The case's levels and coordinates as the wrapper takes them."""
    levels_l, levels_r, lvl, yl, xl, ur0 = case[:6]
    lv = lambda ls: [torch.from_numpy(a).to(device) for a in ls]
    ints = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in (lvl, yl, xl, ur0)]
    return [lv(levels_l), lv(levels_r)] + ints


ASSOC_CASES = ["mixed_even", "mixed_odd", "all_missed", "no_good_sad",
               "tied_medians", "crowded", "n13", "n1", "n0"]
BF = np.float32(41.6)
BIG = 10_000  # K1's distance of a row with no candidate (`hamming.BIG`)


def assoc_case(name, shapes=QVGA_SHAPES):
    """The arguments of `stereo.associate_from_best2` (numpy; `bf` and
    `max_dist` as Python numbers) for the case `name`."""
    rng = np.random.default_rng(5)
    L = len(shapes)
    sf = np.array([1.2 ** k for k in range(L)], np.float32)
    left = [rng.integers(0, 256, s).astype(np.float32) for s in shapes]
    left[-1] = (left[-1] * np.float32(0.8333)).astype(np.float32)
    if name in ("mixed_even", "mixed_odd", "n13"):
        noise = [rng.integers(-4, 5, s).astype(np.float32) for s in shapes]
    else:
        noise = [np.indices(s).sum(0) % 2 * np.float32(2) - 1
                 for s in shapes]
    right = [(np.roll(a, -3, axis=1) + b).astype(np.float32)
             for a, b in zip(left, noise)]
    n = {"mixed_odd": 15, "n13": 13, "n1": 1, "n0": 0,
         "crowded": 600}.get(name, 16)
    lvl = (np.arange(n) % L).astype(np.int32)
    h = np.array([shapes[k][0] for k in lvl])
    w = np.array([shapes[k][1] for k in lvl])
    yk = rng.integers(6, h - 6) if n else np.zeros(0, np.int64)
    xk = rng.integers(20, w - 12) if n else np.zeros(0, np.int64)
    l_xy = np.stack([(xk + rng.uniform(-0.3, 0.3, n)) * sf[lvl],
                     (yk + rng.uniform(-0.3, 0.3, n)) * sf[lvl]],
                    1).astype(np.float32).reshape(n, 2)
    M = n + 5
    r_xy = rng.uniform(0, 600, (M, 2)).astype(np.float32)
    idx = rng.permutation(M)[:n].astype(np.int32)
    r_xy[idx, 0] = (xk - 3 + rng.uniform(-0.3, 0.3, n)) * sf[lvl]
    if name in ("mixed_even", "mixed_odd", "n13"):
        # wrong matches 15 px further left: large SADs, over the SAD median
        wrong = rng.uniform(size=n) < 0.25
        r_xy[idx[wrong], 0] -= 15 * sf[lvl[wrong]]
    best = rng.integers(5, 35, n).astype(np.int32)
    far = rng.uniform(size=n) < 0.2  # over the distance median's bound
    best[far] = rng.integers(60, 100, int(far.sum()))
    best[rng.uniform(size=n) < 0.15] = BIG
    best[rng.uniform(size=n) < 0.1] = 130  # a candidate above max_dist
    if name == "all_missed":
        best = np.where(rng.uniform(size=n) < 0.5, BIG, 150).astype(np.int32)
    if name == "no_good_sad":
        # every right keypoint right of its left one: no positive disparity
        r_xy[idx, 0] = l_xy[:, 0] + 2 * sf[lvl]
    if name == "tied_medians":
        best = np.where(np.arange(n) % 5 == 0, BIG, 40).astype(np.int32)
    if name == "crowded":
        # 540 distances within 8 of each other beside misses at BIG: more
        # keys in one of the kernel's median buckets than it has threads
        best = np.where(rng.uniform(size=n) < 0.1, BIG,
                        rng.integers(20, 28, n)).astype(np.int32)
    if name == "n1":
        best[:] = 20  # one accepted match: both medians are its own values
    return {"levels_l": left, "levels_r": right, "l_xy": l_xy,
            "l_level": lvl, "r_xy": r_xy, "idx": idx, "best": best,
            "scale_factors": sf, "bf": float(BF), "max_dist": 100}


def assoc_tensors(case, device="cpu"):
    """The case's arguments as `stereo.associate_from_best2` takes them."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {k: ([t(a) for a in v] if isinstance(v, list)
                else t(v) if isinstance(v, np.ndarray) else v)
            for k, v in case.items()}
