"""Inputs that exercise kernel K1's window search over its coarse grid of
targets (32-px cells over the valid targets' bounding box, 2048 targets
binned at a time): targets on cell boundaries and on the grid's far edge,
windows whose rim passes exactly through a target (d2 == r2), equal
distances in different cells (the lowest index must win whatever the scan
order), rows whose window holds nothing, a block of rows that are all
invalid, N above one binning chunk and not a multiple of 256, radii that
span the whole grid (finite and infinite), NaN and infinite coordinates.

Used by tests/test_torch_hamming.py (plain version against JAX, on the CPU)
and tests/test_torch_kernels_gpu.py (kernel against plain version, on the
card). Plain numpy, no JAX import.
"""

import numpy as np


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def _lattice_case(rng):
    """Targets on the cells' edges: the bounding box starts at (5, 7), so
    the grid's cell boundaries lie at 5 + 32 i and 7 + 32 k."""
    x0, y0 = np.float32(5.0), np.float32(7.0)
    gx, gy = np.meshgrid(np.arange(15), np.arange(11))
    lattice = np.stack([x0 + 32 * gx.ravel(), y0 + 32 * gy.ravel()],
                       -1).astype(np.float32)  # 165 points, both far edges
    N = 300
    xy = np.concatenate([lattice, rng.uniform(5, 453, (N - len(lattice), 2))
                         .astype(np.float32)])
    xy[len(lattice):, 1] = np.minimum(xy[len(lattice):, 1], y0 + 320)
    t = _desc(rng, N)
    lvl_c = rng.integers(0, 4, N).astype(np.int32)
    col_ok = rng.uniform(size=N) > 0.1
    M = 240
    q = _desc(rng, M)
    uv = rng.uniform(0, 470, (M, 2)).astype(np.float32)
    r = rng.choice([3.0, 4.8, 14.4, 32.0], M).astype(np.float32)
    lvl_r = rng.integers(0, 4, M).astype(np.int32)
    for i in range(0, 120):
        j = int(rng.integers(0, len(lattice)))
        lvl_r[i] = lvl_c[j]
        if i % 3 == 0:  # the rim through a lattice target: d2 == r2 exactly
            uv[i] = xy[j] + np.array([3.0, 4.0], np.float32) * (1 - 2 * (i % 2))
            r[i] = 5.0
        elif i % 3 == 1:  # the rim through it along an axis, one cell wide
            uv[i] = xy[j] + np.array([32.0, 0.0], np.float32)
            r[i] = 32.0
        else:  # on the lattice point itself: the window straddles 4 cells
            uv[i] = xy[j]
        q[i] = t[j] ^ np.int32(1 << (i % 31))
    # equal distances in different cells: target b (higher index, lower
    # cell) duplicates target a; one row sees both
    for k, (a, b) in enumerate([(40, 250), (120, 260), (20, 270)]):
        t[b] = t[a]
        xy[b] = xy[a] - np.array([0.0, 40.0], np.float32)
        col_ok[a] = col_ok[b] = True
        lvl_c[b] = lvl_c[a]
        i = 120 + k
        q[i] = t[a] ^ np.int32(3)
        uv[i] = xy[a] - np.array([0.0, 20.0], np.float32)
        r[i] = 25.0
        lvl_r[i] = lvl_c[a]
    # windows that hold nothing: far outside the grid, or between targets
    uv[130:140] = np.array([2000.0, -900.0], np.float32)
    uv[140:150] = xy[:10] + np.array([16.0, 16.0], np.float32)
    r[140:150] = 0.5
    # radii that span the whole grid
    r[150:155] = 1e4
    r[155:158] = np.inf
    row_ok = rng.uniform(size=M) > 0.1
    row_ok[120:123] = True
    row_ok[200:240] = False  # five blocks of 8 rows, all invalid
    return dict(q=q, t=t, row_ok=row_ok, col_ok=col_ok, uv=uv, rad=r,
                lvl_r=lvl_r, xy=xy, lvl_c=lvl_c)


def _chunked_case(rng):
    """N = 2050: two binning chunks, the second of 2 targets; a VGA frame's
    spread; NaN and infinite coordinates; a row at NaN."""
    N, M = 2050, 300
    xy = rng.uniform(0, [640, 480], (N, 2)).astype(np.float32)
    xy[7] = [np.nan, 100.0]
    xy[8] = [np.inf, 100.0]
    xy[2049] = [-np.inf, 50.0]  # alone in the last chunk, with xy[2048]
    t = _desc(rng, N)
    t[2049] = t[3]  # equal minima across the two chunks
    lvl_c = rng.integers(0, 8, N).astype(np.int32)
    col_ok = rng.uniform(size=N) > 0.05
    col_ok[[3, 7, 8, 2049]] = True
    q = _desc(rng, M)
    uv = xy[rng.integers(0, N, M)] + rng.normal(0, 4, (M, 2)).astype(
        np.float32)
    r = rng.choice([4.0, 14.3, 25.0], M).astype(np.float32)
    lvl_r = rng.integers(0, 8, M).astype(np.int32)
    r[:4] = np.inf  # reach the infinite targets too
    q[:4] = t[3]
    lvl_r[:4] = lvl_c[3]
    lvl_c[[8, 2049]] = lvl_c[3]
    uv[4] = [np.nan, 10.0]
    r[5:9] = 1e4
    row_ok = rng.uniform(size=M) > 0.2
    row_ok[:5] = True
    return dict(q=q, t=t, row_ok=row_ok, col_ok=col_ok, uv=uv, rad=r,
                lvl_r=lvl_r, xy=xy, lvl_c=lvl_c)


def _all_invalid_case(rng):
    case = _chunked_case(rng)
    case["row_ok"] = np.zeros_like(case["row_ok"])
    return case


def k1_grid_cases(seed=11):
    """name -> keyword arguments of `masked_best2_gated` (numpy arrays)."""
    rng = np.random.default_rng(seed)
    return {"lattice": _lattice_case(rng), "chunked": _chunked_case(rng),
            "all_rows_invalid": _all_invalid_case(rng)}
