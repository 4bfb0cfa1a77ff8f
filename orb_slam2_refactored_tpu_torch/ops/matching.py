"""Matcher variants over the Hamming core: projection-guided, descriptor-NN,
rotation-consistency.

Port of `orb_slam2_refactored_tpu/ops/matching.py` (the tracking subset).
Every matcher here reduces to one gated best-2 call
(`hamming.masked_best2_gated`, kernel K1 on the card) plus cheap per-row
work and the claim resolution (kernel R); the projection search's
per-point gates and compaction are kernel B6 (`project_candidates`).
Orderings that decide ties follow `jax.lax.top_k`: equal keys come lowest
index first.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..geometry import projection as proj
from ..geometry import se3
from . import hamming

HISTO_BINS = 30


class Matches(NamedTuple):
    idx: torch.Tensor    # i32[M] target index per query row (-1 = none)
    dist: torch.Tensor   # i32[M]
    valid: torch.Tensor  # bool[M]


def _neg1(x):
    return torch.full_like(x, -1)


def match_descriptors(desc_a, desc_b, valid_a, valid_b,
                      max_dist: int = hamming.TH_LOW, nn_ratio: float = 0.9,
                      mutual: bool = True, extra_mask=None) -> Matches:
    """Best-match a->b with distance threshold + Lowe ratio + optional
    mutual-NN check (the b->a pass is a second launch with roles swapped).
    extra_mask: bool[M,N] candidate gate (the mono initializer's window),
    K1's dense pair gate; the b->a pass takes its transpose."""
    idx, best, second = hamming.masked_best2_gated(
        desc_a, desc_b, valid_a, valid_b, pair_ok=extra_mask)
    ok = (best <= max_dist) & (best.to(torch.float32)
                               <= nn_ratio * second.to(torch.float32))
    if mutual:
        idx_b, _, _ = hamming.masked_best2_gated(
            desc_b, desc_a, valid_b, valid_a,
            pair_ok=None if extra_mask is None else extra_mask.T.contiguous())
        ok = ok & hamming.mutual_filter(idx, idx_b)
    keep = hamming.resolve_duplicates(idx, best, ok, desc_b.shape[0])
    return Matches(torch.where(keep, idx, _neg1(idx)), best, keep)


def _mod_two_pi(x):
    """`jnp.mod(x, 2*pi)`: C fmod, then shifted into the divisor's sign."""
    two_pi = 2.0 * math.pi
    r = torch.fmod(x, two_pi)
    return torch.where((r != 0) & (r < 0), r + two_pi, r)


def rotation_consistency(angle_a, angle_b, valid):
    """Keep only matches whose angular difference falls in the 3 dominant
    30-bin histogram bins (CheckOrientation semantics)."""
    two_pi = 2.0 * math.pi
    diff = _mod_two_pi(angle_a - angle_b)
    bins = torch.clamp((diff * (HISTO_BINS / two_pi)).to(torch.int32), 0,
                       HISTO_BINS - 1).long()
    counts = torch.zeros((HISTO_BINS,), dtype=torch.int32,
                         device=angle_a.device).index_add_(
        0, bins, valid.to(torch.int32))
    top_i = torch.sort(-counts, stable=True).indices[:3]
    top_c = counts[top_i].to(torch.float32)
    keep2 = top_c[1] > 0.1 * top_c[0]
    keep3 = top_c[2] > 0.1 * top_c[0]
    good = torch.zeros((HISTO_BINS,), dtype=torch.bool, device=angle_a.device)
    good[top_i[0]] = True
    good[top_i[1]] = keep2 | good[top_i[1]]
    good[top_i[2]] = keep3 | good[top_i[2]]
    return valid & good[bins]


def _frustum(mp_pos, mp_valid, pose_cw, cam, image_bounds):
    """(uv, visible-in-image-and-front, po, dist) of every map point."""
    xc = se3.transform(pose_cw, mp_pos)
    uv = proj.project(cam, xc)
    vis = mp_valid & (xc[..., 2] > 0.05)
    if image_bounds is not None:
        min_x, max_x, min_y, max_y = image_bounds
        vis = vis & ((uv[..., 0] >= min_x) & (uv[..., 0] < max_x)
                     & (uv[..., 1] >= min_y) & (uv[..., 1] < max_y))
    cam_center = se3.translation(se3.inverse(pose_cw))
    po = mp_pos - cam_center[None, :]
    dist = torch.sqrt(torch.sum(po * po, dim=-1))
    return uv, vis, po, dist


class Candidates(NamedTuple):
    """The rows kernel K1 searches in the projection search, and what the
    per-point results need (kernel B6's outputs)."""
    uv: torch.Tensor     # f32[R,2] each row's projection
    rad: torch.Tensor    # f32[R] search radius at the predicted level
    lvl: torch.Tensor    # i32[R] predicted level
    ok: torch.Tensor     # bool[R] the row's point passed every gate
    desc: torch.Tensor   # i32[R,8]
    cand: torch.Tensor   # [R] the row's point (i64 plain, i32 kernel)
    vis: torch.Tensor    # bool[P] in view and in the distance band
    slot: torch.Tensor   # i32[P] each point's row, -1 for none


def project_candidates_plain(mp_pos, mp_desc, mp_normal, mp_min_dist,
                             mp_max_dist, mp_valid, pose_cw,
                             cam: proj.CameraIntrinsics, scale_factors,
                             radius: float = 4.0,
                             check_view_angle: bool = True,
                             image_bounds=None, candidate_cap: int = 8192):
    """Plain PyTorch version of kernel B6 (`project_candidates`): the
    per-point gates and, when the point capacity exceeds `candidate_cap`,
    the compaction into `candidate_cap` rows (the frustum-passing points
    lowest index first, then the failing ones lowest index first: the
    order `jax.lax.top_k` gives the JAX package, which decides which row
    `resolve_duplicates` keeps on equal distances); else row p is point p."""
    n_levels = scale_factors.shape[0]
    log_sf = torch.log(scale_factors[1] / scale_factors[0])
    uv, in_view, po, dist = _frustum(mp_pos, mp_valid, pose_cw, cam,
                                     image_bounds)
    in_band = (dist >= mp_min_dist * 0.8) & (dist <= mp_max_dist * 1.2)
    vis = in_view & in_band
    pred_level = torch.clamp(
        torch.ceil(torch.log(torch.clamp(mp_max_dist, min=1e-6)
                             / torch.clamp(dist, min=1e-6)) / log_sf),
        0, n_levels - 1,
    ).to(torch.int32)
    point_ok = vis
    if check_view_angle:
        nrm = torch.sqrt(torch.sum(mp_normal * mp_normal, dim=-1))
        cosang = torch.sum(po * mp_normal, dim=-1) / torch.clamp(
            dist * nrm, min=1e-6)
        point_ok = point_ok & (cosang > 0.5)
    r = radius * scale_factors[pred_level.long()]

    P = mp_pos.shape[0]
    if bool(candidate_cap) and candidate_cap < P:
        cand = torch.sort((~point_ok).to(torch.uint8), stable=True).indices[
            :candidate_cap]
        slot = torch.full((P,), -1, dtype=torch.int32, device=uv.device)
        slot[cand] = torch.arange(candidate_cap, dtype=torch.int32,
                                  device=uv.device)
        return Candidates(uv[cand], r[cand], pred_level[cand],
                          point_ok[cand], mp_desc[cand], cand, vis, slot)
    rows = torch.arange(P, dtype=torch.int32, device=uv.device)
    return Candidates(uv, r, pred_level, point_ok, mp_desc, rows, vis, rows)


def project_candidates(mp_pos, mp_desc, mp_normal, mp_min_dist,
                       mp_max_dist, mp_valid, pose_cw,
                       cam: proj.CameraIntrinsics, scale_factors,
                       radius: float = 4.0, check_view_angle: bool = True,
                       image_bounds=None, candidate_cap: int = 8192):
    """The projection search's per-point gates and candidate compaction
    (same signature and results as `project_candidates_plain`).
    CUDA tensors -> kernel B6 (`csrc/project_search.cu`, one launch);
    CPU -> plain version."""
    if not mp_pos.is_cuda:
        return project_candidates_plain(
            mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
            pose_cw, cam, scale_factors, radius, check_view_angle,
            image_bounds, candidate_cap)
    P, L = mp_pos.shape[0], scale_factors.shape[0]
    for t, what, dtype, shape in (
            (mp_pos, "mp_pos", torch.float32, (P, 3)),
            (mp_desc, "mp_desc", torch.int32, (P, 8)),
            (mp_normal, "mp_normal", torch.float32, (P, 3)),
            (mp_min_dist, "mp_min_dist", torch.float32, (P,)),
            (mp_max_dist, "mp_max_dist", torch.float32, (P,)),
            (mp_valid, "mp_valid", torch.bool, (P,)),
            (pose_cw, "pose_cw", torch.float32, (7,)),
            (scale_factors, "scale_factors", torch.float32, (L,))):
        kernels.require(t, "project_search " + what, dtype, shape)
    if mp_desc.data_ptr() % 16:
        mp_desc = mp_desc.clone()  # read 16 bytes at a time
    compact = bool(candidate_cap) and candidate_cap < P
    R = candidate_cap if compact else P
    blocks = _b6_blocks(P)
    if blocks <= 0:
        raise ValueError(f"project_search: {P} points, past what one "
                         "launch takes")
    # one allocation: the rows' i32 words (desc 16-byte aligned first),
    # the points' slots, the scratch, then the bytes
    i32 = torch.empty((13 * R + P + blocks + (R + P + 3) // 4,),
                      dtype=torch.int32, device=mp_pos.device)
    desc_r = i32[:8 * R].view(R, 8)
    uv_r = i32[8 * R:10 * R].view(torch.float32).view(R, 2)
    r_r = i32[10 * R:11 * R].view(torch.float32)
    lvl_r = i32[11 * R:12 * R]
    cand = i32[12 * R:13 * R]
    slot = i32[13 * R:13 * R + P]
    scratch = i32[13 * R + P:13 * R + P + blocks]
    tail = i32[13 * R + P + blocks:].view(torch.uint8)
    ok_r, vis = tail[:R].view(torch.bool), tail[R:R + P].view(torch.bool)
    if image_bounds is None:
        bounds = (0.0, 0.0, 0.0, 0.0)
    else:
        bounds = tuple(float(np.float32(b)) for b in image_bounds)
    fn = kernels.bind("project_search", "project_search",
                      [kernels.VP] * 8 + [kernels.CI] + [kernels.CF] * 5
                      + [kernels.CI] + [kernels.CF] * 4 + [kernels.CI] * 4
                      + [kernels.VP] * 10)
    kernels.LAUNCHES["project_search"] += 1
    kernels.check(fn(
        *(kernels.ptr(t) for t in (mp_pos, mp_normal, mp_min_dist,
                                   mp_max_dist, mp_valid, mp_desc, pose_cw,
                                   scale_factors)),
        L, cam.fx, cam.fy, cam.cx, cam.cy, float(np.float32(radius)),
        int(image_bounds is not None), *bounds, int(check_view_angle), P,
        R, int(compact),
        *(kernels.ptr(t) for t in (uv_r, r_r, lvl_r, ok_r, desc_r, cand, vis,
                                   slot, scratch)),
        kernels.stream_of(mp_pos)), "project_search")
    return Candidates(uv_r, r_r, lvl_r, ok_r, desc_r, cand, vis, slot)


@functools.lru_cache(maxsize=None)
def _b6_blocks(P: int) -> int:
    fn = kernels.bind("project_search", "project_search_blocks",
                      [kernels.CI])
    return fn(P)


def _search(find, resolve, frame_xy, frame_level, frame_desc, frame_valid,
            mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
            pose_cw, cam, scale_factors, radius, max_dist, check_view_angle,
            image_bounds, candidate_cap):
    """The projection search with B6's version `find` and R's `resolve`
    around the gated best-2 (K1 on CUDA tensors, its plain version on the
    CPU)."""
    c = find(mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
             pose_cw, cam, scale_factors, radius, check_view_angle,
             image_bounds, candidate_cap)
    idx, best, _ = hamming.masked_best2_gated(
        c.desc, frame_desc, c.ok, frame_valid, c.uv, c.rad, c.lvl, frame_xy,
        frame_level)
    return Matches(*resolve(idx, best, c.ok, max_dist, frame_desc.shape[0],
                            c.slot)), c.vis


def search_by_projection_with_vis_plain(
    frame_xy, frame_level, frame_desc, frame_valid,
    mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    pose_cw, cam: proj.CameraIntrinsics, scale_factors,
    radius: float = 4.0, max_dist: int = hamming.TH_HIGH,
    check_view_angle: bool = True, image_bounds=None,
    candidate_cap: int = 8192,
):
    """Plain PyTorch version of `search_by_projection_with_vis` (same
    signature and results): B6's and R's plain versions around K1."""
    return _search(project_candidates_plain, hamming.resolve_to_points_plain,
                   frame_xy, frame_level, frame_desc, frame_valid, mp_pos,
                   mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
                   pose_cw, cam, scale_factors, radius, max_dist,
                   check_view_angle, image_bounds, candidate_cap)


def search_by_projection_with_vis(
    frame_xy, frame_level, frame_desc, frame_valid,
    mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    pose_cw, cam: proj.CameraIntrinsics, scale_factors,
    radius: float = 4.0, max_dist: int = hamming.TH_HIGH,
    check_view_angle: bool = True, image_bounds=None,
    candidate_cap: int = 8192,
):
    """Match map points into a frame by projecting them and searching a
    radius window at the predicted scale. Returns (per-POINT Matches, the
    per-point frustum-visibility mask).

    candidate_cap: when the point capacity exceeds it, the gated best-2 runs
    only over `candidate_cap` rows (`project_candidates_plain`).
    CUDA tensors -> three launches: B6 (the gates and the compaction), K1
    (the gated best-2) and R (the claims, back per point); CPU -> their
    plain versions."""
    return _search(project_candidates, hamming.resolve_to_points, frame_xy,
                   frame_level, frame_desc, frame_valid, mp_pos, mp_desc,
                   mp_normal, mp_min_dist, mp_max_dist, mp_valid, pose_cw,
                   cam, scale_factors, radius, max_dist, check_view_angle,
                   image_bounds, candidate_cap)


def search_by_projection(*args, **kwargs) -> Matches:
    """`search_by_projection_with_vis` without the visibility mask."""
    return search_by_projection_with_vis(*args, **kwargs)[0]


def search_last_frame(
    curr_xy, curr_level, curr_desc, curr_valid,
    last_xy, last_level, last_desc, last_valid, last_has_point,
    last_point_xc, pose_cw, cam: proj.CameraIntrinsics, scale_factors,
    radius: float = 7.0, max_dist: int = hamming.TH_HIGH,
) -> Matches:
    """Motion-model matching: project the last frame's map points into the
    predicted pose and search a window at each feature's own level. Returns
    per-LAST-FEATURE match indices into the current frame."""
    xc = se3.transform(pose_cw, last_point_xc)
    uv = proj.project(cam, xc)
    ok_pt = last_valid & last_has_point & (xc[..., 2] > 0.05)
    r = radius * scale_factors[last_level.long()]
    idx, best, _ = hamming.masked_best2_gated(
        last_desc, curr_desc, ok_pt, curr_valid, uv.contiguous(), r,
        last_level, curr_xy, curr_level)
    ok = ok_pt & (best <= max_dist)
    keep = hamming.resolve_duplicates(idx, best, ok, curr_desc.shape[0])
    return Matches(torch.where(keep, idx, _neg1(idx)), best, keep)
