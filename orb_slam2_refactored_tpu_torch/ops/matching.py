"""Matcher variants over the Hamming core: projection-guided, descriptor-NN,
rotation-consistency.

Port of `orb_slam2_refactored_tpu/ops/matching.py` (the tracking subset).
Every matcher here reduces to one gated best-2 call
(`hamming.masked_best2_gated`, kernel K1 on the card) plus cheap per-row
work. Orderings that decide ties follow `jax.lax.top_k`: equal keys come
lowest index first.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

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
    only over `candidate_cap` rows: the frustum-passing points lowest index
    first, then the failing ones lowest index first (the order
    `jax.lax.top_k` gives the JAX package, which decides which row
    `resolve_duplicates` keeps on equal distances)."""
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
    compact = bool(candidate_cap) and candidate_cap < P
    if compact:
        cand = torch.sort((~point_ok).to(torch.uint8), stable=True).indices[
            :candidate_cap]
        uv_r, r_r, lvl_r = uv[cand], r[cand], pred_level[cand]
        ok_r, desc_r = point_ok[cand], mp_desc[cand]
    else:
        uv_r, r_r, lvl_r, ok_r, desc_r = uv, r, pred_level, point_ok, mp_desc

    idx, best, _ = hamming.masked_best2_gated(
        desc_r.contiguous(), frame_desc, ok_r.contiguous(), frame_valid,
        uv_r.contiguous(), r_r.contiguous(), lvl_r.contiguous(), frame_xy,
        frame_level)
    ok = ok_r & (best <= max_dist)
    keep = hamming.resolve_duplicates(idx, best, ok, frame_desc.shape[0])
    if compact:
        idx_p = torch.full((P,), -1, dtype=idx.dtype, device=idx.device)
        idx_p[cand] = torch.where(keep, idx, _neg1(idx))
        best_p = torch.full((P,), hamming.BIG, dtype=best.dtype,
                            device=best.device)
        best_p[cand] = best
        keep_p = torch.zeros((P,), dtype=torch.bool, device=keep.device)
        keep_p[cand] = keep
        return Matches(idx_p, best_p, keep_p), vis
    return Matches(torch.where(keep, idx, _neg1(idx)), best, keep), vis


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
