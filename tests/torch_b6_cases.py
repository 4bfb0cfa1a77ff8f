"""Inputs for the projection search's gates and compaction (kernel B6)
and the claim resolution (kernel R): map points and a frame at QVGA
(4 levels), in cases that put the compaction at its edges (no point
passes, every point passes, exactly `cap` pass, more than `cap` pass,
`cap >= P` and `cap = 0`, no image bounds and no view-angle gate), at the
bench's size (P = 32,768, cap = 8,192), and claimant rows that tie, claim
one target many times, or are all invalid.

Used by tests/test_torch_project_search.py (plain versions against JAX,
on the CPU) and tests/test_torch_kernels_gpu.py (kernels against plain
versions, on the card). Plain numpy, no JAX import.
"""

import numpy as np

FX, CX, CY, W, H = 260.0, 160.0, 120.0, 320, 240
SF = (1.2 ** np.arange(4, dtype=np.float32)).astype(np.float32)
BOUNDS = (0.0, float(W), 0.0, float(H))
BIG = 10_000

# name -> (P, cap, which points pass, image bounds, view-angle gate)
B6_CASES = {
    "mixed": (2048, 512, "mixed", True, True),
    "none_pass": (2048, 512, "none", True, True),
    "all_pass": (2048, 512, "all", True, True),
    "exactly_cap": (2048, 512, "cap", True, True),
    "cap_ge_p": (2048, 2048, "mixed", True, True),
    "cap_0": (2048, 0, "mixed", True, True),
    "no_bounds_no_angle": (2048, 512, "mixed", False, False),
    # P not a multiple of a block's 1024 threads
    "ragged": (5003, 1024, "mixed", True, True),
}
# the card's cases beside those: the bench's size, and P past 16 blocks of
# 1024 threads and not a multiple of them (two points a thread)
CARD_CASES = {"bench": (32768, 8192, "mixed", True, True),
              "ragged_two_a_thread": (20001, 4096, "mixed", True, True)}


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def _flip(rng, d, nbits):
    d = d.copy()
    for _ in range(nbits):
        w = rng.integers(0, 8, len(d))
        d[np.arange(len(d)), w] ^= (np.uint32(1) << rng.integers(
            0, 32, len(d)).astype(np.uint32))
    return d


def as_torch(arrays):
    """numpy arrays to tensors, uint32 descriptors as the port's int32."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(
        v.view(np.int32) if v.dtype == np.uint32 else v))
        for k, v in arrays.items()}


def _pose(rng):
    q = np.array([1.0, *rng.normal(0, 0.01, 3)])
    q /= np.linalg.norm(q)
    return np.concatenate([q, rng.normal(0, 0.02, 3)]).astype(np.float32)


def _rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def b6_case(name, seed=0):
    """(map arrays, frame arrays, pose, keyword arguments) of one case:
    numpy arrays, descriptors as uint32 (the JAX package's)."""
    P, cap, passing, bounds, angle = {**B6_CASES, **CARD_CASES}[name]
    rng = np.random.default_rng(seed)
    pose = _pose(rng)
    Rcw, t = _rot(pose[:4].astype(np.float64)), pose[4:].astype(np.float64)
    # points in the camera's frame, well inside the image, then to the world
    uv = np.stack([rng.uniform(8, W - 8, P), rng.uniform(8, H - 8, P)], -1)
    z = rng.uniform(0.8, 5.0, P)
    xc = np.stack([(uv[:, 0] - CX) / FX * z, (uv[:, 1] - CY) / FX * z, z],
                  -1)
    pos = (xc - t) @ Rcw  # Rcw^T (xc - t)
    cc = -(Rcw.T @ t)
    dist = np.linalg.norm(pos - cc, axis=-1)
    normal = (pos - cc) / dist[:, None]
    min_d, max_d = dist / 1.2 ** 3 / 1.1, dist * 1.1
    valid = np.ones(P, bool)
    if passing == "none":
        valid[:] = False
    elif passing == "cap":
        valid[:] = False
        valid[rng.permutation(P)[:cap]] = True
    elif passing == "mixed":
        k = rng.integers(0, 12, P)  # one failure each (1-5), or none
        valid[k == 1] = False
        pos[k == 2] = (np.stack([xc[k == 2, 0], xc[k == 2, 1],
                                 -xc[k == 2, 2]], -1) - t) @ Rcw  # behind
        far = k == 3  # outside the image
        pos[far] = (np.stack([xc[far, 0] + 2.0 * xc[far, 2], xc[far, 1],
                              xc[far, 2]], -1) - t) @ Rcw
        max_d[k == 4] = dist[k == 4] * 0.7  # outside the distance band
        if angle:
            normal[k == 5] = -normal[k == 5]  # seen from behind
        # points exactly on a gate's edge in f32
        edge = rng.permutation(P)[:32]
        max_d[edge[:16]] = (dist[edge[:16]] / 1.2).astype(np.float32)
    pos = pos.astype(np.float32)
    desc = _desc(rng, P)
    desc[100:140] = desc[60:100]  # equal distances from different points
    mp = dict(mp_pos=pos, mp_desc=desc, mp_normal=normal.astype(np.float32),
              mp_min_dist=min_d.astype(np.float32),
              mp_max_dist=max_d.astype(np.float32), mp_valid=valid)
    # the frame: features at half of the first 300 points' projections
    N = 300
    seen = rng.permutation(min(P, 600))[:N // 2]
    f_xy = np.concatenate([uv[seen] + rng.normal(0, 0.8, (len(seen), 2)),
                           rng.uniform(0, W, (N - len(seen), 2))]).astype(
        np.float32)
    lvl = rng.integers(0, 4, N).astype(np.int32)
    f_desc = np.concatenate([_flip(rng, desc[seen], 6),
                             _desc(rng, N - len(seen))])
    frame = dict(frame_xy=f_xy, frame_level=lvl, frame_desc=f_desc,
                 frame_valid=rng.uniform(size=N) > 0.05)
    kw = dict(radius=4.0, candidate_cap=cap, check_view_angle=angle,
              image_bounds=BOUNDS if bounds else None)
    return mp, frame, pose, kw


# name -> (M rows, N targets)
R_CASES = {"ties": (600, 50), "many_claimants": (2000, 1000),
           "all_invalid": (500, 100), "k1_rows": (8192, 1000),
           "one_row": (1, 50), "ragged": (3001, 997)}


def r_case(name, seed=0, size=None):
    """(target_idx i32[M], dist i32[M], valid bool[M], N) of one case (or
    of random rows at `size` = (M, N)). The target of an invalid row is
    what K1 leaves there (0), its distance BIG in "k1_rows"."""
    M, N = R_CASES[name] if size is None else size
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, M).astype(np.int32)
    dist = rng.integers(0, 101, M).astype(np.int32)
    valid = rng.uniform(size=M) > 0.2
    if name == "ties":  # few distances: many equal minima a target
        dist = rng.integers(20, 23, M).astype(np.int32)
    elif name == "many_claimants":  # one target claimed by 500 rows
        idx[:500] = 7
        dist[:500] = rng.integers(10, 14, 500)
        dist[250] = 3  # one lowest row in the middle, one valid copy late
        dist[400] = 3
        valid[250] = False
    elif name == "all_invalid":
        valid[:] = False
    elif name == "k1_rows":  # K1 leaves idx 0 and BIG on unsearched rows
        idx[~valid] = 0
        dist[~valid] = BIG
        valid[:16] = True
        dist[:16] = BIG  # valid rows at BIG
    return idx, dist, valid, N


# name -> (N features, Q map points, what passes); the motion-model
# search's gates (B6's feature mode)
FEATURE_CASES = {"mixed": (1000, 4096, "mixed"), "none_pass": (1000, 4096,
                                                                "none"),
                 "ragged": (777, 2048, "mixed"), "one": (1, 64, "mixed")}


def feature_case(name, seed=0):
    """The last frame's features and the map of one case, numpy arrays:
    map points `mp_pos` f32[Q, 3] and `mp_valid` bool[Q]; per feature its
    map point `last_mp` i32[N] (-1 for none), `last_level` i32[N],
    `last_desc` uint32[N, 8], `last_valid` bool[N]; the current frame
    (`curr_*`, half of its features near the features' projections); and
    the predicted pose. In "mixed" a feature has no point, an invalid
    point, a point behind the camera, or none of these; in "none_pass"
    every feature fails."""
    N, Q, passing = FEATURE_CASES[name]
    rng = np.random.default_rng(seed)
    pose = _pose(rng)
    Rcw, t = _rot(pose[:4].astype(np.float64)), pose[4:].astype(np.float64)
    uv = np.stack([rng.uniform(8, W - 8, Q), rng.uniform(8, H - 8, Q)], -1)
    z = rng.uniform(0.8, 5.0, Q)
    z[rng.uniform(size=Q) < 0.1] *= -1.0  # behind the camera
    z[:4] = [0.05, -0.05, 1e-10, 0.0500001]  # at the depth gate's edge
    xc = np.stack([(uv[:, 0] - CX) / FX * z, (uv[:, 1] - CY) / FX * z, z],
                  -1)
    mp_pos = ((xc - t) @ Rcw).astype(np.float32)
    mp_valid = rng.uniform(size=Q) > 0.1
    last_mp = rng.integers(0, Q, N).astype(np.int32)
    last_mp[rng.uniform(size=N) < 0.2] = -1
    if N > 4:
        last_mp[:4] = np.arange(4)
    last_valid = rng.uniform(size=N) > 0.05
    if passing == "none":
        last_mp[:] = -1
    last_level = rng.integers(0, 4, N).astype(np.int32)
    last_desc = _desc(rng, N)
    # the current frame: features near half of the last ones' projections
    M = max(N, 8)
    seen = rng.permutation(N)[:max(N // 2, 1)]
    near = uv[np.clip(last_mp[seen], 0, Q - 1)]
    curr_xy = np.concatenate([near + rng.normal(0, 1.5, near.shape),
                              rng.uniform(0, W, (M - len(seen), 2))]).astype(
        np.float32)
    curr_desc = np.concatenate([_flip(rng, last_desc[seen], 6),
                                _desc(rng, M - len(seen))])
    curr_level = np.concatenate([last_level[seen],
                                 rng.integers(0, 4, M - len(seen))]).astype(
        np.int32)
    return dict(mp_pos=mp_pos, mp_valid=mp_valid, last_mp=last_mp,
                last_level=last_level, last_desc=last_desc,
                last_valid=last_valid, curr_xy=curr_xy,
                curr_level=curr_level, curr_desc=curr_desc,
                curr_valid=rng.uniform(size=M) > 0.05), pose
