"""Matcher variants over the Hamming core: projection-guided, descriptor-NN,
rotation-consistency.

Port of `orb_slam2_refactored_tpu/ops/matching.py` (the tracking subset).
Every matcher here reduces to one gated best-2 call
(`hamming.masked_best2_gated`, kernel K1 on the card) plus cheap per-row
work and the claim resolution (kernel R); the projection search's
per-point gates and compaction are kernel B6 (`project_candidates`), the
motion-model search's per-feature gates its feature mode
(`project_features`).
Orderings that decide ties follow `jax.lax.top_k`: equal keys come lowest
index first.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
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
    idx_k, keep = hamming.resolve_rows(idx, best, ok, hamming.NO_GATE,
                                       desc_b.shape[0])
    return Matches(idx_k, best, keep)


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


_B6_PTRS = ("pos", "normal", "min_dist", "max_dist", "valid", "desc",
            "pose", "sf", "feat_idx", "feat_level", "feat_valid", "uv_r",
            "r_r", "lvl_r", "ok_r", "desc_r", "cand", "vis", "slot",
            "block_pass")


class _B6Record(ctypes.Structure):
    """Kernel B6's launch record (`B6Args` in `csrc/project_search.cu`):
    the geometry (P, cap, L, the camera, radius, bounds, gates) set once,
    the pointers written on every call."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _B6_PTRS]
                + [("L", ctypes.c_int)]
                + [(n, ctypes.c_float) for n in ("fx", "fy", "cx", "cy",
                                                 "radius")]
                + [("bounds", ctypes.c_int)]
                + [(n, ctypes.c_float) for n in ("min_x", "max_x", "min_y",
                                                 "max_y")]
                + [(n, ctypes.c_int) for n in ("view_angle", "P", "rows",
                                               "compact", "Q")])


class _B6Plan(NamedTuple):
    """A geometry's launch record and row workspace (`_b6_plan`)."""
    record: _B6Record
    rows: tuple   # the row views handed to K1 and R
    ptrs: tuple   # their data pointers, and the scratch's (points mode)


_b6_plans: dict = {}


def _f32(x) -> float:
    return float(np.float32(x))


def _b6_plan(key) -> _B6Plan:
    """The launch record and the row workspace of one geometry, built once:
    `key` = (host thread, device, stream, mode, P, rows, L, Q, camera,
    radius, image bounds, view-angle gate).

    Why a workspace cached by stream is safe: B6's rows (and `slot`) are
    read only by the K1 and R launches of the same search, which are
    enqueued on the same stream right after B6; the next B6 launch of this
    geometry on that stream (from this host thread: the key holds it) is
    enqueued after them, so the card runs it only once they have read the
    rows. Results that outlive the search (`vis`, R's outputs) are
    allocated fresh on every call. A caller that keeps B6's rows past the
    next search clones them."""
    plan = _b6_plans.get(key)
    if plan is not None:
        return plan
    _, dev, _, mode, P, R, L, Q, cam, radius, bounds, angle = key
    device = torch.device("cuda", dev)
    # torch casts a Python scalar to the tensor's f32 before it compares
    # or multiplies: the kernel takes them as f32
    fx, fy, cx, cy = (_f32(v) for v in cam)
    rec = _B6Record(L=L, fx=fx, fy=fy, cx=cx, cy=cy, radius=_f32(radius),
                    bounds=int(bounds is not None), view_angle=int(angle),
                    P=P, rows=R, compact=int(R < P), Q=Q)
    if bounds is not None:
        rec.min_x, rec.max_x, rec.min_y, rec.max_y = (_f32(b)
                                                      for b in bounds)
    extra = ()
    if mode == "points":
        # one allocation: the rows' i32 words (desc 16-byte aligned
        # first), the points' slots, the scratch, then the bytes
        blocks = _b6_blocks(P)
        i32 = torch.empty((13 * R + P + blocks + (R + 3) // 4,),
                          dtype=torch.int32, device=device)
        rows = (i32[8 * R:10 * R].view(torch.float32).view(R, 2),
                i32[10 * R:11 * R].view(torch.float32), i32[11 * R:12 * R],
                i32[13 * R + P + blocks:].view(torch.uint8)[:R].view(
                    torch.bool),
                i32[:8 * R].view(R, 8), i32[12 * R:13 * R],
                i32[13 * R:13 * R + P])
        extra = (i32[13 * R + P:13 * R + P + blocks].data_ptr(),)
    else:
        # the feature mode: uv, radius, ok a feature
        i32 = torch.empty((3 * P + (P + 3) // 4,), dtype=torch.int32,
                          device=device)
        rows = (i32[:2 * P].view(torch.float32).view(P, 2),
                i32[2 * P:3 * P].view(torch.float32),
                i32[3 * P:].view(torch.uint8)[:P].view(torch.bool))
    plan = _B6Plan(rec, rows, tuple(t.data_ptr() for t in rows) + extra)
    _b6_plans[key] = plan
    return plan


def project_candidates(mp_pos, mp_desc, mp_normal, mp_min_dist,
                       mp_max_dist, mp_valid, pose_cw,
                       cam: proj.CameraIntrinsics, scale_factors,
                       radius: float = 4.0, check_view_angle: bool = True,
                       image_bounds=None, candidate_cap: int = 8192):
    """The projection search's per-point gates and candidate compaction
    (same signature and results as `project_candidates_plain`).
    CUDA tensors -> kernel B6 (`csrc/project_search.cu`, one launch): the
    rows (uv, rad, lvl, ok, desc, cand) and `slot` are views of the
    geometry's workspace (`_b6_plan`: valid until the next search of this
    geometry on the stream), `vis` is fresh; CPU -> plain version."""
    if not mp_pos.is_cuda:
        return project_candidates_plain(
            mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
            pose_cw, cam, scale_factors, radius, check_view_angle,
            image_bounds, candidate_cap)
    P, L = mp_pos.shape[0], scale_factors.shape[0]
    dev = mp_pos.get_device()
    kernels.require_on(dev, (
        ("mp_pos", mp_pos, torch.float32, (P, 3)),
        ("mp_desc", mp_desc, torch.int32, (P, 8)),
        ("mp_normal", mp_normal, torch.float32, (P, 3)),
        ("mp_min_dist", mp_min_dist, torch.float32, (P,)),
        ("mp_max_dist", mp_max_dist, torch.float32, (P,)),
        ("mp_valid", mp_valid, torch.bool, (P,)),
        ("pose_cw", pose_cw, torch.float32, (7,)),
        ("scale_factors", scale_factors, torch.float32, (L,))),
        "project_search")
    if mp_desc.data_ptr() % 16:
        mp_desc = mp_desc.clone()  # read 16 bytes at a time
    if _b6_blocks(P) <= 0:
        raise ValueError(f"project_search: {P} points, past what one "
                         "launch takes")
    R = candidate_cap if bool(candidate_cap) and candidate_cap < P else P
    stream = kernels.stream_of(mp_pos)
    plan = _b6_plan((threading.get_ident(), dev, stream.value, "points",
                     P, R, L, 0, (cam.fx, cam.fy, cam.cx, cam.cy), radius,
                     None if image_bounds is None else tuple(image_bounds),
                     bool(check_view_angle)))
    vis = torch.empty((P,), dtype=torch.bool, device=mp_pos.device)
    rec = plan.record
    (rec.pos, rec.normal, rec.min_dist, rec.max_dist, rec.valid, rec.desc,
     rec.pose, rec.sf) = (t.data_ptr() for t in (
         mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_valid, mp_desc,
         pose_cw, scale_factors))
    (rec.uv_r, rec.r_r, rec.lvl_r, rec.ok_r, rec.desc_r, rec.cand,
     rec.slot, rec.block_pass) = plan.ptrs
    rec.vis = vis.data_ptr()
    fn = kernels.bind("project_search", "project_search",
                      [ctypes.POINTER(_B6Record), kernels.VP])
    kernels.LAUNCHES["project_search"] += 1
    kernels.check(fn(ctypes.byref(rec), stream), "project_search")
    uv, rad, lvl, ok, desc, cand, slot = plan.rows
    return Candidates(uv, rad, lvl, ok, desc, cand, vis, slot)


@functools.lru_cache(maxsize=None)
def _b6_blocks(P: int) -> int:
    fn = kernels.bind("project_search", "project_search_blocks",
                      [kernels.CI])
    return fn(P)


def project_features_plain(pos, level, pose_cw, cam: proj.CameraIntrinsics,
                           scale_factors, radius: float = 7.0,
                           feat_idx=None, pos_valid=None, feat_valid=None):
    """Plain PyTorch version of kernel B6's feature mode
    (`project_features`): the motion-model search's gates for N features,
    row = feature. The point of feature i is pos[i], or with `feat_idx`
    the map point pos[clamp(feat_idx[i], 0, Q - 1)] (absent where
    feat_idx[i] < 0) with validity `pos_valid` of it (the tracker's
    gather). Returns (uv f32[N, 2], the projection by `pose_cw`; rad
    f32[N], radius * scale_factors[level]; ok bool[N], every validity
    given & z > 0.05)."""
    ok = feat_valid
    if feat_idx is not None:
        q = torch.clamp(feat_idx, 0, pos.shape[0] - 1).long()
        pos = pos[q]
        ok = feat_idx >= 0 if ok is None else ok & (feat_idx >= 0)
        if pos_valid is not None:
            ok = ok & pos_valid[q]
    xc = se3.transform(pose_cw, pos)
    uv = proj.project(cam, xc)
    front = xc[..., 2] > 0.05
    ok = front if ok is None else ok & front
    return uv, radius * scale_factors[level.long()], ok


def project_features(pos, level, pose_cw, cam: proj.CameraIntrinsics,
                     scale_factors, radius: float = 7.0, feat_idx=None,
                     pos_valid=None, feat_valid=None):
    """Kernel B6's feature mode (same signature and results as
    `project_features_plain`). CUDA tensors -> one launch
    (`csrc/project_search.cu::project_features`), the three outputs views
    of the geometry's workspace (valid until the next call of this geometry
    on the stream, `_b6_plan`); CPU -> plain version."""
    if not pos.is_cuda:
        return project_features_plain(pos, level, pose_cw, cam,
                                      scale_factors, radius, feat_idx,
                                      pos_valid, feat_valid)
    N, Q, L = level.shape[0], pos.shape[0], scale_factors.shape[0]
    dev = pos.get_device()
    specs = [("pos", pos, torch.float32, (Q, 3)),
             ("level", level, torch.int32, (N,)),
             ("pose_cw", pose_cw, torch.float32, (7,)),
             ("scale_factors", scale_factors, torch.float32, (L,))]
    if feat_idx is None and Q != N:
        raise ValueError(f"project_features: {Q} positions for {N} "
                         "features")
    for name, t, size in (("feat_idx", feat_idx, N),
                          ("pos_valid", pos_valid, Q),
                          ("feat_valid", feat_valid, N)):
        if t is not None:
            specs.append((name, t, torch.int32 if name == "feat_idx"
                          else torch.bool, (size,)))
    kernels.require_on(dev, specs, "project_features")
    stream = kernels.stream_of(pos)
    plan = _b6_plan((threading.get_ident(), dev, stream.value, "features",
                     N, N, L, Q, (cam.fx, cam.fy, cam.cx, cam.cy), radius,
                     None, False))
    rec = plan.record
    rec.pos, rec.feat_level, rec.pose, rec.sf = (
        pos.data_ptr(), level.data_ptr(), pose_cw.data_ptr(),
        scale_factors.data_ptr())
    rec.feat_idx, rec.valid, rec.feat_valid = (
        None if t is None else t.data_ptr()
        for t in (feat_idx, pos_valid, feat_valid))
    rec.uv_r, rec.r_r, rec.ok_r = plan.ptrs
    fn = kernels.bind("project_search", "project_features",
                      [ctypes.POINTER(_B6Record), kernels.VP])
    kernels.LAUNCHES["project_features"] += 1
    kernels.check(fn(ctypes.byref(rec), stream), "project_features")
    return plan.rows


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


def _last_frame(gates, curr_xy, curr_level, curr_desc, curr_valid,
                last_level, last_desc, pose_cw, cam, scale_factors, radius,
                max_dist, resolve, **where) -> Matches:
    """The motion-model search with B6's feature mode `gates` and R's rows
    mode `resolve` around the gated best-2 (K1 on CUDA tensors)."""
    uv, r, ok_pt = gates(where.pop("pos"), last_level, pose_cw, cam,
                         scale_factors, radius, **where)
    idx, best, _ = hamming.masked_best2_gated(
        last_desc, curr_desc, ok_pt, curr_valid, uv, r, last_level, curr_xy,
        curr_level)
    idx_k, keep = resolve(idx, best, ok_pt, max_dist, curr_desc.shape[0])
    return Matches(idx_k, best, keep)


def search_last_frame(
    curr_xy, curr_level, curr_desc, curr_valid,
    last_xy, last_level, last_desc, last_valid, last_has_point,
    last_point_xc, pose_cw, cam: proj.CameraIntrinsics, scale_factors,
    radius: float = 7.0, max_dist: int = hamming.TH_HIGH,
) -> Matches:
    """Motion-model matching: project the last frame's map points into the
    predicted pose and search a window at each feature's own level. Returns
    per-LAST-FEATURE match indices into the current frame.
    CUDA tensors -> three launches: B6's feature mode (the gates), K1 and
    R's rows mode (the claims and the -1s); CPU -> their plain versions."""
    return _last_frame(project_features, curr_xy, curr_level, curr_desc,
                       curr_valid, last_level, last_desc, pose_cw, cam,
                       scale_factors, radius, max_dist, hamming.resolve_rows,
                       pos=last_point_xc,
                       feat_valid=last_valid & last_has_point)


def search_last_frame_mapped_plain(
    curr_xy, curr_level, curr_desc, curr_valid, last_level, last_desc,
    last_mp, mp_pos, mp_valid, pose_cw, cam: proj.CameraIntrinsics,
    scale_factors, radius: float = 7.0, max_dist: int = hamming.TH_HIGH,
) -> Matches:
    """Plain PyTorch version of `search_last_frame_mapped` (same signature
    and results)."""
    return _last_frame(project_features_plain, curr_xy, curr_level,
                       curr_desc, curr_valid, last_level, last_desc,
                       pose_cw, cam, scale_factors, radius, max_dist,
                       hamming.resolve_rows_plain, pos=mp_pos,
                       feat_idx=last_mp, pos_valid=mp_valid)


def search_last_frame_mapped(
    curr_xy, curr_level, curr_desc, curr_valid, last_level, last_desc,
    last_mp, mp_pos, mp_valid, pose_cw, cam: proj.CameraIntrinsics,
    scale_factors, radius: float = 7.0, max_dist: int = hamming.TH_HIGH,
) -> Matches:
    """`search_last_frame` as the tracker calls it: the last frame's
    feature i sees map point `last_mp[i]` (none where negative), whose
    position and validity B6 reads from the map's arrays (`mp_pos`,
    `mp_valid`), the validity standing for both `last_valid` and
    `last_has_point`. CUDA tensors -> B6's feature mode, K1 and R's rows
    mode: three launches; CPU -> their plain versions."""
    return _last_frame(project_features, curr_xy, curr_level, curr_desc,
                       curr_valid, last_level, last_desc, pose_cw, cam,
                       scale_factors, radius, max_dist, hamming.resolve_rows,
                       pos=mp_pos, feat_idx=last_mp, pos_valid=mp_valid)
