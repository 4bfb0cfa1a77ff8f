"""Local mapping stage: triangulation, landmark fusion, culling and window
bundle adjustment.

Port of `orb_slam2_refactored_tpu/slam/local_mapping.py` (the reference's
`LocalMapping`, `src/LocalMapping.cc:93-130`). The device
programs (`_ba_impl`, `_cull_impl`, `_triangulate_impl`, `_tri_insert_impl`,
`_fuse_pair_impl`, `_kill_kf_impl`, `_fuse_apply_impl`,
`_refresh_points_impl`) take and return `MapArrays` functionally, as the
JAX programs do; the host orchestration keeps the JAX package's stage
order and its one-keyframe lags (triangulation, fusion, ratio culling and
the BA outlier erasure all drain at the next keyframe's `drain_pending`).

Every read the host waits for at a drain is started when its product is
made, as `utils/readback.py::Readback` (the JAX package's `_fetch`: an
async copy, a future), so the tracker's staged pump can ask whether it
has landed: `tri_ready`, `fuse_ready` and `ratio_ready`, as in JAX.

Differences of form from the JAX package:
- there is no fetch thread: on the card a read is a copy into a pinned
  buffer and a CUDA event; on the CPU it is resolved at once, so there
  every stage is ready when the tracker pumps it;
- index lists go to the device at their exact length (JAX pads them to
  bucketed lengths only to bound its compiles); out-of-range indices are
  still dropped, never clamped, exactly as `mode="drop"` does;
- the triangulation and fusion pairs run one call per pair (JAX vmaps them
  and pads with self-pairs, which its drains skip); the self-pairs are not
  computed;
- triangulation passes its epipolar mask to kernel K1 as a dense pair gate,
  and fusion calls K1 with its window gate (`ops/hamming.py`).

The window BA's point bucket Q (`BA_POINT_BUCKETS`) and its overflow cut
are part of the result, not compile hygiene, and are kept.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..geometry import projection as proj
from ..geometry import se3
from ..ops import hamming
from ..optim.ba import BAProblem, ba_solve, highest_precision
from ..utils.readback import Readback
from .frame import scale_factors
from .map_state import INVALID, MapArrays, MapGraph


def _in_range(idx, n):
    """JAX's index rule for `mode="drop"`: an index in [-n, 0) counts from
    the end, one outside [-n, n) is dropped. Returns (index, keep)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def _set_drop(field, idx, val):
    """`field.at[idx].set(val, mode="drop")`: rows whose index is out of
    range are dropped, never clamped. Returns a new tensor."""
    idx, keep = _in_range(idx, field.shape[0])
    out = field.clone()
    out[idx[keep]] = val.to(field.dtype)[keep] if val.dim() else val
    return out


def _max_drop(field, idx, val):
    """`field.at[idx].max(val, mode="drop")` on a 1-D integer tensor."""
    idx, keep = _in_range(idx, field.shape[0])
    return field.scatter_reduce(0, idx[keep], val.to(field.dtype)[keep],
                                "amax", include_self=True)


def _flat_cells(kf, feat, K, N):
    """Flat indices of the [K, N] cells (kf, feat) under the same rule; a
    cell with either index out of range maps to K * N, which `_set_drop` /
    `_max_drop` drop."""
    kf, ok_k = _in_range(kf, K)
    feat, ok_f = _in_range(feat, N)
    return torch.where(ok_k & ok_f, kf * N + feat, torch.full_like(kf, K * N))


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


class LocalMapper:
    # total window rows in the compacted local-BA problem: free KFs
    # (1 + `window` covisibles) + fixed frontier, padded to a static shape
    BA_WINDOW = 32
    # compacted point capacities of the window solve (local ids; the last id
    # of the chosen bucket is the "not selected" sentinel). Overflow beyond
    # the largest bucket drops the extras from THIS solve only.
    BA_POINT_BUCKETS = (2048, 4096, 8192)
    MAXOBS = 8  # observers considered per point for descriptor/normal refresh

    def __init__(self, cam: proj.CameraIntrinsics, n_levels: int,
                 scale_factor: float, ba_iters: int = 6, cg_iters: int = 30,
                 window: int = 12, lambda0: float = 1e-4, min_kfs: int = 2,
                 tri_neighbors: int = 6, device=None):
        """`cg_iters` is accepted and unused, as in the JAX package: the
        window BA solves its reduced camera system densely (Schur). The
        mapper runs on `cuda:0` unless `device` says otherwise
        (`resolve_device`: with no card and no device it raises)."""
        self.cam = cam
        self.window = window
        self.min_kfs = min_kfs
        self.tri_neighbors = tri_neighbors
        self.ba_iters = ba_iters
        self.lambda0 = lambda0
        self.device = resolve_device(device)
        self.sf, _, self.inv_sigma2 = scale_factors(n_levels, scale_factor,
                                                    device=self.device)
        self.n_ba = 0  # window BA solves run
        self.clear_pending()

    def clear_pending(self):
        """Forget every deferred product (map reset)."""
        self._pending_tri = None
        self._pending_fuse = None
        self._pending_ratio = None
        self._pending_ba_erase = None
        self._pending_tcp = None

    def tri_ready(self) -> bool:
        p = self._pending_tri
        return p is None or p[3].done()

    def fuse_ready(self) -> bool:
        p = self._pending_fuse
        return p is None or p[2].done()

    def ratio_ready(self) -> bool:
        p = self._pending_ratio
        return p is None or p[1].done()

    def _t(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- device programs -------------------------------------------------

    def _ba_impl(self, m: MapArrays, win_idx, win_free, win_valid, pt_lut,
                 pts_local, iters, lambda0):
        """Window-compacted local BA with fused write-back.

        win_idx: i32[W] keyframe slots; padding rows use slot=K (dropped on
        scatter) with win_valid False. win_free: rows optimized; fixed rows
        are the frontier. pt_lut: i32[P] point slot -> local id (Q-1 = "not
        selected"); pts_local: i32[Q] local id -> point slot (padding = P).
        Points observed by any valid KF outside the window are frozen.
        Returns (new_map, outlier_mask[K,N], cost0, cost1)."""
        K, N = m.kf_mp.shape
        P = m.point_capacity
        Q = pts_local.shape[0]
        dev = m.kf_mp.device
        gather = torch.clamp(win_idx, 0, K - 1).long()
        neg = torch.full_like(m.kf_mp[gather], INVALID)
        obs_pt_g = torch.where(win_valid[:, None], m.kf_mp[gather], neg)

        in_win = torch.zeros((K,), dtype=torch.int32, device=dev)
        in_win = in_win.scatter_reduce(0, gather, win_valid.to(torch.int32),
                                       "amax", include_self=True) > 0
        outside_obs = (m.kf_mp >= 0) & (~in_win & m.kf_valid)[:, None]
        pt_frozen = torch.zeros((P,), dtype=torch.int32, device=dev)
        pt_frozen = pt_frozen.scatter_reduce(
            0, torch.clamp(m.kf_mp, 0, P - 1).long().reshape(-1),
            outside_obs.reshape(-1).to(torch.int32), "amax",
            include_self=True) > 0

        local = pt_lut[torch.clamp(obs_pt_g, 0, P - 1).long()]
        obs_pt = torch.where((obs_pt_g >= 0) & (local < Q - 1), local, neg)
        pl = torch.clamp(pts_local, 0, P - 1).long()
        pl_ok = pts_local < P
        pt_pos_l = m.mp_pos[pl]
        pt_valid_l = m.mp_valid[pl] & pl_ok
        pt_frozen_l = pt_frozen[pl] | ~pl_ok

        prob = BAProblem(
            kf_pose=m.kf_pose[gather],
            kf_fixed=~(win_free & win_valid),
            obs_uv=m.kf_xy[gather],
            obs_ur=m.kf_uright[gather],
            obs_pt=obs_pt.to(torch.int32),
            obs_inv_s2=self.inv_sigma2[m.kf_level[gather].long()],
            pt_pos=pt_pos_l,
            pt_valid=pt_valid_l,
            pt_frozen=pt_frozen_l,
        )
        res = ba_solve(prob, self.cam, iters=iters, lambda0=lambda0,
                       dense_schur=True)

        # scatter window poses back (padding scatters to row K -> dropped)
        scatter = torch.where(win_valid & win_free, win_idx,
                              torch.full_like(win_idx, K))
        new_kf_pose = _set_drop(m.kf_pose, scatter, res.kf_pose)
        out_w = (obs_pt >= 0) & ~res.obs_inlier & win_free[:, None]
        outlier = _set_drop(torch.zeros((K, N), dtype=torch.bool, device=dev),
                            scatter, out_w)
        # refined landmark positions back (frozen rows carry their original
        # values; padding rows target P -> dropped)
        upd = torch.where(pt_valid_l[:, None], res.pt_pos, pt_pos_l)
        new_mp_pos = _set_drop(m.mp_pos, pts_local, upd)
        m = m._replace(
            kf_pose=new_kf_pose,
            mp_pos=new_mp_pos,
            kf_mp=torch.where(outlier, torch.full_like(m.kf_mp, INVALID),
                              m.kf_mp),
        )
        return m, outlier, res.initial_cost, res.final_cost

    def _cull_impl(self, m: MapArrays, kill, pair_kf, pair_feat):
        """kill: i32[B] point slots; (pair_kf, pair_feat): observation cells
        to clear. Out-of-range entries are dropped."""
        K, N = m.kf_mp.shape
        flat = _flat_cells(pair_kf, pair_feat, K, N)
        kf_mp = _set_drop(m.kf_mp.reshape(-1), flat,
                          torch.full_like(flat, INVALID)).reshape(K, N)
        return m._replace(
            mp_valid=_set_drop(m.mp_valid, kill,
                               torch.zeros_like(kill, dtype=torch.bool)),
            kf_mp=kf_mp)

    def _triangulate_impl(self, m: MapArrays, kf_a: int, kf_b: int):
        """Two-view triangulation candidates between keyframes a and b
        (CreateNewMapPoints, `src/LocalMapping.cc:380-578`): epipolar-gated
        descriptor matching of landmark-free features, midpoint
        triangulation, cheirality + reprojection + parallax +
        scale-consistency gates. Returns per-feature-of-a:
        (xw[N,3], idx_b[N], good[N])."""
        cam = self.cam
        pose_a = m.kf_pose[kf_a]
        pose_b = m.kf_pose[kf_b]
        xy_a, xy_b = m.kf_xy[kf_a], m.kf_xy[kf_b]
        lvl_a, lvl_b = m.kf_level[kf_a].long(), m.kf_level[kf_b].long()
        free_a = m.kf_feat_valid[kf_a] & (m.kf_mp[kf_a] < 0)
        free_b = m.kf_feat_valid[kf_b] & (m.kf_mp[kf_b] < 0)
        dev = xy_a.device

        with highest_precision():
            # fundamental matrix F_ab from the relative pose (ComputeF12)
            T_ab = se3.compose(pose_a, se3.inverse(pose_b))
            R = se3.quat_to_matrix(se3.rotation(T_ab))
            t = se3.translation(T_ab)
            z = torch.zeros((), dtype=torch.float32, device=dev)
            tx = torch.stack([torch.stack([z, -t[2], t[1]]),
                              torch.stack([t[2], z, -t[0]]),
                              torch.stack([-t[1], t[0], z])])
            Km = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                           [0, 0, 1.0]], np.float32)
            Kinv = torch.as_tensor(np.linalg.inv(Km).astype(np.float32),
                                   device=dev)
            F = Kinv.T @ tx @ R @ Kinv
            ones = torch.ones_like(xy_a[:, :1])
            pa = torch.cat([xy_a, ones], -1)
            pb = torch.cat([xy_b, ones], -1)
            # line in b for each a-feature: l_b = F^T p_a; distance^2 of each
            # b to each a's line, [Nb, Na]
            lb = pa @ F
            d = (pb @ lb.T) ** 2 / torch.clamp(
                (lb[:, 0] ** 2 + lb[:, 1] ** 2)[None, :], min=1e-12)
        epi_ok = (d.T < 3.84 * (self.sf[lvl_b] ** 2)[None, :]).contiguous()

        idx_b, best, _ = hamming.masked_best2_gated(
            m.kf_desc[kf_a], m.kf_desc[kf_b], free_a, free_b,
            pair_ok=epi_ok)
        matched = free_a & (best <= hamming.TH_LOW)
        keep = hamming.resolve_duplicates(idx_b, best, matched,
                                          xy_b.shape[0])

        # midpoint triangulation: intersect the two viewing rays
        ib = torch.clamp(idx_b, 0, xy_b.shape[0] - 1).long()
        xb = xy_b[ib]
        pose_a_wc = se3.inverse(pose_a)
        pose_b_wc = se3.inverse(pose_b)
        ca = se3.translation(pose_a_wc)
        cb_c = se3.translation(pose_b_wc)

        def rays(xy, pose_wc):
            xn = torch.stack([(xy[:, 0] - cam.cx) / cam.fx,
                              (xy[:, 1] - cam.cy) / cam.fy,
                              torch.ones_like(xy[:, 0])], -1)
            dr = se3.quat_rotate(se3.rotation(pose_wc)[None, :], xn)
            return dr / torch.clamp(_norm(dr)[:, None], min=1e-12)

        da = rays(xy_a, pose_a_wc)
        db = rays(xb, pose_b_wc)
        w0 = cb_c[None, :] - ca[None, :]
        dd = torch.sum(da * db, -1)
        da_w = torch.sum(da * w0, -1)
        db_w = torch.sum(db * w0, -1)
        denom = torch.clamp(1.0 - dd * dd, min=1e-9)
        s_par = (da_w - dd * db_w) / denom
        t_par = (dd * da_w - db_w) / denom
        pa_pt = ca[None, :] + s_par[:, None] * da
        pb_pt = cb_c[None, :] + t_par[:, None] * db
        xw = 0.5 * (pa_pt + pb_pt)

        # gates
        xca = se3.transform(pose_a, xw)
        xcb = se3.transform(pose_b, xw)
        za, zb = xca[:, 2], xcb[:, 2]
        ra = proj.project(cam, xca) - xy_a
        rb = proj.project(cam, xcb) - xb
        s2a = self.sf[lvl_a] ** 2
        lvl_bm = torch.clamp(lvl_b[ib], min=0)
        s2b = self.sf[lvl_bm] ** 2
        reproj_ok = ((torch.sum(ra * ra, -1) < 5.991 * s2a)
                     & (torch.sum(rb * rb, -1) < 5.991 * s2b))
        # parallax between rays
        va = xw - ca[None]
        vb = xw - cb_c[None]
        na = _norm(va)
        nb = _norm(vb)
        cosp = torch.sum(va * vb, -1) / torch.clamp(na * nb, min=1e-12)
        # scale consistency: distance ratio within the octave ratio * 1.5
        ratio_dist = na / torch.clamp(nb, min=1e-9)
        ratio_octave = self.sf[lvl_a] / self.sf[lvl_bm]
        scale_ok = ((ratio_dist < ratio_octave * 1.5)
                    & (ratio_dist * 1.5 > ratio_octave))
        finite = torch.all(torch.isfinite(xw), -1)
        good = (keep & finite & (za > 0) & (zb > 0) & (cosp < 0.9998)
                & reproj_ok & scale_ok)
        return xw, idx_b, good

    def _tri_insert_impl(self, m: MapArrays, kf_a: int, kf_b: int, slots,
                         idx_b, xw):
        """Scatter triangulated points (slot<0 = skip) + both observations."""
        create = slots >= 0
        P = m.point_capacity
        tgt = torch.where(create, slots, torch.full_like(slots, P))
        lvl = m.kf_level[kf_a].long()
        ca = se3.translation(se3.inverse(m.kf_pose[kf_a]))
        view = xw - ca[None]
        dist = _norm(view)
        max_dist = dist * self.sf[lvl]
        min_dist = max_dist / self.sf[-1]
        m = m._replace(
            mp_pos=_set_drop(m.mp_pos, tgt, xw),
            mp_valid=_set_drop(m.mp_valid, tgt, torch.ones_like(create)),
            mp_desc=_set_drop(m.mp_desc, tgt, m.kf_desc[kf_a]),
            mp_normal=_set_drop(m.mp_normal, tgt,
                                view / torch.clamp(dist, min=1e-6)[:, None]),
            mp_min_dist=_set_drop(m.mp_min_dist, tgt, min_dist),
            mp_max_dist=_set_drop(m.mp_max_dist, tgt, max_dist),
        )
        val = torch.where(create, slots, torch.full_like(slots, INVALID))
        kf_mp = m.kf_mp.clone()
        kf_mp[kf_a] = torch.maximum(kf_mp[kf_a], val.to(kf_mp.dtype))
        safe_b = torch.where(create, idx_b, torch.zeros_like(idx_b)).long()
        kf_mp[kf_b] = kf_mp[kf_b].scatter_reduce(
            0, safe_b, val.to(kf_mp.dtype), "amax", include_self=True)
        return m._replace(kf_mp=kf_mp)

    def _fuse_pair_impl(self, m: MapArrays, kf_src: int, kf_dst: int):
        """Project kf_src's landmarks into kf_dst and find feature matches
        (ORBmatcher::Fuse, `src/ORBmatcher.cc:868-980`): radius search at
        the source scale + Hamming gate, through K1's window gate. Returns
        per-src-feature: (dst_feature_idx, dst_point, keep, src_point)."""
        mp = m.kf_mp[kf_src]
        pt = torch.clamp(mp, 0, m.point_capacity - 1).long()
        src_ok = (mp >= 0) & m.mp_valid[pt]
        xc = se3.transform(m.kf_pose[kf_dst], m.mp_pos[pt])
        uv = proj.project(self.cam, xc)
        in_front = xc[:, 2] > 0.05
        dst_xy = m.kf_xy[kf_dst]
        src_lvl = m.kf_level[kf_src]
        r = 3.0 * self.sf[src_lvl.long()]
        idx, best, _ = hamming.masked_best2_gated(
            m.mp_desc[pt], m.kf_desc[kf_dst], src_ok & in_front,
            m.kf_feat_valid[kf_dst], uv.contiguous(), r.contiguous(),
            src_lvl.contiguous(), dst_xy.contiguous(),
            m.kf_level[kf_dst].contiguous())
        ok = src_ok & (best <= hamming.TH_LOW)
        keep = hamming.resolve_duplicates(idx, best, ok, dst_xy.shape[0])
        safe_idx = torch.clamp(idx, 0, dst_xy.shape[0] - 1).long()
        dst_pt = m.kf_mp[kf_dst][safe_idx]
        return (torch.where(keep, idx, torch.full_like(idx, INVALID)), dst_pt,
                keep, mp)

    def _kill_kf_impl(self, m: MapArrays, kf: int):
        kf_valid = m.kf_valid.clone()
        kf_feat_valid = m.kf_feat_valid.clone()
        kf_mp = m.kf_mp.clone()
        kf_valid[kf] = False
        kf_feat_valid[kf] = False
        kf_mp[kf] = INVALID
        return m._replace(kf_valid=kf_valid, kf_feat_valid=kf_feat_valid,
                          kf_mp=kf_mp)

    def _fuse_apply_impl(self, m: MapArrays, add_kf, add_feat, add_pt,
                         rm_src, rm_dst):
        """Apply ALL fusion results: new observations (kf_mp[add_kf,
        add_feat] = max(., add_pt)) and duplicate-landmark merges (every
        reference to rm_src becomes rm_dst; rm_src dies). Out-of-range
        entries are dropped. rm_dst must be chain-resolved by the caller."""
        K, N = m.kf_mp.shape
        P = m.point_capacity
        flat = _flat_cells(add_kf, add_feat, K, N)
        kf_mp = _max_drop(m.kf_mp.reshape(-1), flat, add_pt).reshape(K, N)
        lut = torch.arange(P, dtype=torch.int32, device=kf_mp.device)
        lut = _set_drop(lut, rm_src, rm_dst)
        kf_mp = torch.where(kf_mp >= 0,
                            lut[torch.clamp(kf_mp, 0, P - 1).long()], kf_mp)
        mp_valid = _set_drop(m.mp_valid, rm_src,
                             torch.zeros_like(rm_src, dtype=torch.bool))
        return m._replace(kf_mp=kf_mp, mp_valid=mp_valid)

    def _refresh_points_impl(self, m: MapArrays, pts, obs_kf, obs_feat,
                             n_obs):
        """Recompute distinctive descriptors + viewing normals + scale bands
        for a batch of points from their observer lists
        (ComputeDistinctiveDescriptors, `src/MapPoint.cc:257-320`;
        UpdateNormalAndDepth, `:341-392`). pts: i32[B] (point_capacity =
        padding); obs_kf/obs_feat: i32[B,M]; n_obs: i32[B]."""
        B, M = obs_kf.shape
        safe_kf = torch.clamp(obs_kf, 0, m.kf_capacity - 1).long()
        safe_ft = torch.clamp(obs_feat, 0, m.kf_mp.shape[1] - 1).long()
        dev = obs_kf.device
        valid = torch.arange(M, device=dev)[None, :] < n_obs[:, None]

        descs = m.kf_desc[safe_kf, safe_ft]  # [B,M,8]
        dm = hamming.hamming_pairwise(descs[:, :, None, :],
                                      descs[:, None, :, :])  # [B,M,M]
        dm = torch.where(valid[:, None, :], dm, torch.full_like(dm, hamming.BIG))
        # jnp.median over the M slots: for an even M the mean of the two
        # middle values (torch.median would return the lower one)
        srt = torch.sort(dm.to(torch.float32), dim=2).values
        if M % 2:
            meds = srt[..., M // 2]
        else:
            meds = 0.5 * (srt[..., M // 2 - 1] + srt[..., M // 2])
        best_idx = torch.argmin(torch.where(valid, meds,
                                            torch.full_like(meds, 1e9)), dim=1)
        best_desc = descs[torch.arange(B, device=dev), best_idx]

        # normals: mean unit ray from the observer camera centres
        centers = se3.translation(se3.inverse(m.kf_pose[safe_kf]))  # [B,M,3]
        safe_pts = torch.clamp(pts, 0, m.point_capacity - 1).long()
        xw = m.mp_pos[safe_pts]
        rays = xw[:, None, :] - centers
        rays = rays / torch.clamp(_norm(rays)[..., None], min=1e-9)
        normal = torch.sum(torch.where(valid[..., None], rays,
                                       torch.zeros_like(rays)), dim=1)
        normal = normal / torch.clamp(_norm(normal)[..., None], min=1e-9)
        # scale band from the first (reference) observation
        ref_kf = safe_kf[:, 0]
        ref_ft = safe_ft[:, 0]
        ref_center = se3.translation(se3.inverse(m.kf_pose[ref_kf]))
        dist = _norm(xw - ref_center)
        lvl = m.kf_level[ref_kf, ref_ft].long()
        max_dist = dist * self.sf[lvl]
        min_dist = max_dist / self.sf[-1]

        ok = (pts < m.point_capacity) & (n_obs > 0)
        tgt = torch.where(ok, pts, torch.full_like(pts, m.point_capacity))
        return m._replace(
            mp_desc=_set_drop(m.mp_desc, tgt, best_desc),
            mp_normal=_set_drop(m.mp_normal, tgt, normal),
            mp_min_dist=_set_drop(m.mp_min_dist, tgt, min_dist),
            mp_max_dist=_set_drop(m.mp_max_dist, tgt, max_dist),
            mp_nobs=_set_drop(m.mp_nobs, tgt, n_obs),
        )

    # -- host orchestration ----------------------------------------------

    def refresh_points(self, m: MapArrays, graph: MapGraph, new_kf: int,
                       batch: int = 1024):
        """Refresh stats of every multi-observation point seen by the new KF."""
        pts, okf, oft, nob, n = graph.refresh_export(
            graph.kf_row[new_kf], min_obs=2, M=self.MAXOBS, B=batch)
        if n == 0:
            return m
        return self._refresh_points_impl(m, self._t(pts[:n]),
                                         self._t(okf[:n]), self._t(oft[:n]),
                                         self._t(nob[:n]))

    def fuse_neighbors(self, m: MapArrays, graph: MapGraph, new_kf: int,
                       n_neighbors: int = 5):
        """SearchInNeighbors (`src/LocalMapping.cc:580-639`): fuse the new
        KF's landmarks into its covisible ring and vice versa. The decisions
        are applied at the next stage (`_drain_fuse`)."""
        neighbors = graph.covis_neighbors(new_kf, top_k=n_neighbors)
        if not neighbors:
            return m, {"merged": 0, "added": 0}
        pairs = ([(new_kf, nb) for nb in neighbors]
                 + [(nb, new_kf) for nb in neighbors])[:2 * n_neighbors]
        packed = [torch.stack([idx, dst_pt, keep.to(torch.int32), src_mp], -1)
                  for idx, dst_pt, keep, src_mp in
                  (self._fuse_pair_impl(m, a, b) for a, b in pairs)]
        self._pending_fuse = (new_kf, pairs, Readback(torch.stack(packed)))
        return m, {"merged": -1, "added": -1}

    def _drain_fuse(self, m: MapArrays, graph: MapGraph):
        pend = self._pending_fuse
        if pend is None:
            return m
        self._pending_fuse = None
        new_kf, pairs, packed_read = pend
        packed = packed_read.result()
        idx_all = packed[..., 0]
        dst_pt_all = packed[..., 1]
        keep_all = packed[..., 2] > 0
        src_mp_all = packed[..., 3]
        # every host-graph decision first (the C++ arena's `mg_apply_fuse`
        # or the Python graph's loop), then ALL device writes in one program
        (a_kf, a_ft, a_pt), (m_src, m_dst), _ = graph.apply_fuse(
            np.asarray([a for a, _ in pairs], np.int32),
            np.asarray([b for _, b in pairs], np.int32),
            idx_all, dst_pt_all, keep_all, src_mp_all)
        if len(a_kf) or len(m_src):
            m = self._fuse_apply_impl(
                m, self._t(a_kf), self._t(a_ft), self._t(a_pt),
                self._t(m_src), self._t(m_dst))
            graph.update_connections(new_kf, graph.kf_row[new_kf])
        return m

    def cull_keyframes(self, m: MapArrays, graph: MapGraph, new_kf: int):
        """KeyFrameCulling (`src/LocalMapping.cc:641-701`): a covisible KF
        dies when >90% of its landmarks are observed by >=3 other KFs at the
        same or finer scale."""
        killed = []
        cands = [kf for kf in graph.covis_neighbors(new_kf, top_k=self.window)
                 if kf != graph.origin_kf and kf != new_kf]
        if not cands:
            return m, killed
        kf_level = graph.kf_levels
        for kf in cands:
            # copy: erase_observation mutates the kf_row mirror in place
            mp_row = graph.kf_row[kf].copy()
            obs_feats = np.nonzero(mp_row >= 0)[0]
            if len(obs_feats) < 20:
                continue
            n_redundant, n_total = graph.redundant_obs(kf, mp_row, kf_level)
            if n_total >= 20 and n_redundant > 0.9 * n_total:
                # detach observations, repair spanning tree, free the row
                for f in obs_feats:
                    graph.erase_observation(int(mp_row[f]), kf)
                parent = int(graph.parent[kf])
                graph.kill_keyframe(kf)
                m = self._kill_kf_impl(m, kf)
                killed.append((kf, parent))
                # orphan cascade: points this KF observed may have fallen
                # below 2 observers
                m, _ = self.kill_orphan_points(m, graph,
                                               mp_row[obs_feats].tolist())
        if killed:
            # Tcp = Tc_w * Tw_parent at cull time, so culled reference KFs
            # stay walkable in trajectory export (KeyFrame::SetBadFlag,
            # src/KeyFrame.cc:464)
            self._resolve_tcp(graph)
            PAD = 16
            ks = [k for k, _ in killed[:PAD]]
            ps = [max(p, 0) for _, p in killed[:PAD]]
            tcp = se3.compose(m.kf_pose[self._t(ks).long()],
                              se3.inverse(m.kf_pose[self._t(ps).long()]))
            self._pending_tcp = (list(killed[:PAD]), Readback(tcp))
        return m, [k for k, _ in killed]

    def _resolve_tcp(self, graph: MapGraph):
        pend = self._pending_tcp
        if pend is None:
            return
        self._pending_tcp = None
        killed, tcp_read = pend
        tcp = tcp_read.result()
        for i, (k, p) in enumerate(killed):
            graph.kf_tcp[k] = (p, tcp[i])

    def local_ba(self, m: MapArrays, graph: MapGraph, new_kf: int):
        """Window BA: free set = new KF + covisible window; fixed frontier =
        their covisible ring (`src/Optimizer.cc:493-537`); points shared
        with KFs outside the window are frozen inside `_ba_impl`. One device
        solve; the outlier mask is read back once and erased from the host
        graph at the next keyframe (`drain_ba_erase`)."""
        if len(graph.alive_kfs()) < self.min_kfs:
            return m, None
        W = self.BA_WINDOW
        K = graph.cap.max_keyframes
        free_list = [new_kf] + graph.covis_neighbors(new_kf, top_k=self.window)
        free_list = free_list[:W - 1]  # always leave room for one fixed row
        seen = set(free_list)
        frontier = []
        for k in free_list:
            for nb in graph.covis_neighbors(int(k)):
                if nb not in seen:
                    seen.add(nb)
                    frontier.append(nb)
                    if len(free_list) + len(frontier) >= W:
                        break
            if len(free_list) + len(frontier) >= W:
                break
        # gauge: at least one fixed row among alive KFs
        if not frontier:
            if graph.origin_kf in free_list and len(free_list) > 1:
                free_list.remove(graph.origin_kf)
                frontier = [graph.origin_kf]
            elif len(free_list) > 1:
                frontier = [free_list.pop()]
            else:
                return m, None
        win_idx = np.full(W, K, np.int32)  # K = out-of-range padding
        win_free = np.zeros(W, bool)
        win_valid = np.zeros(W, bool)
        n_f = len(free_list)
        win_idx[:n_f] = free_list
        win_free[:n_f] = True
        win_valid[:n_f] = True
        win_idx[n_f:n_f + len(frontier)] = frontier
        win_valid[n_f:n_f + len(frontier)] = True

        # window-point compaction: the host kf_row mirror knows the window's
        # landmarks, so the solve runs on Q compacted rows; a device-side
        # association the mirror lags on maps to the sentinel and is dropped
        # from this solve only
        P = m.point_capacity
        win_all = [int(k) for k in win_idx[: n_f + len(frontier)]]
        rows = graph.kf_row[win_all]
        pts = np.unique(rows[rows >= 0]).astype(np.int64)
        Q = next((b for b in self.BA_POINT_BUCKETS if len(pts) < b),
                 self.BA_POINT_BUCKETS[-1])
        if len(pts) > Q - 1:
            pts = pts[: Q - 1]
        lut = np.full(P, Q - 1, np.int32)
        lut[pts] = np.arange(len(pts), dtype=np.int32)
        pts_local = np.full(Q, P, np.int32)
        pts_local[: len(pts)] = pts

        old_rows = graph.kf_row.copy()  # pre-BA rows (what outliers refer to)
        m, outlier_dev, c0, c1 = self._ba_impl(
            m, self._t(win_idx), self._t(win_free, torch.bool),
            self._t(win_valid, torch.bool), self._t(lut), self._t(pts_local),
            self.ba_iters, self.lambda0)
        self.n_ba += 1
        # host-side erasure defers to the NEXT keyframe (the reference's
        # mapping-thread lag); the device kf_mp was cleaned by _ba_impl
        self._pending_ba_erase = (old_rows, Readback(outlier_dev))
        return m, {"cost0_dev": c0, "cost1_dev": c1, "free": n_f}

    def drain_pending(self, m: MapArrays, graph: MapGraph):
        """Drain every one-keyframe-deferred mapping product, in the stage
        order: triangulation insert + bookkeeping, fusion decisions + apply,
        BA outlier erasure, found/visible-ratio culling."""
        m = self._drain_tri(m, graph)
        m = self._drain_fuse(m, graph)
        m = self.drain_ba_erase(m, graph)
        m = self._drain_ratio_cull(m, graph)
        self._resolve_tcp(graph)
        return m

    def _drain_ratio_cull(self, m: MapArrays, graph: MapGraph):
        pend = self._pending_ratio
        if pend is None:
            return m
        self._pending_ratio = None
        ref_kf, packed_read = pend
        packed = packed_read.result()
        vis, found = packed[0], packed[1]
        ratio = found / np.maximum(vis, 1)
        kill = []
        cur_seq = int(graph.kf_seq[ref_kf])
        for pt in graph.young_points(cur_seq, max_age=4):
            first = graph.pt_first_kf[pt]
            if first < 0 or cur_seq - first > 4:
                continue
            if vis[pt] >= 4 and ratio[pt] < 0.25:
                kill.append(pt)
        if not kill:
            return m
        return self._kill_points(m, graph, kill)

    def queue_ratio_cull(self, ref_kf: int, vis_dev, found_dev):
        """Snapshot the found/visible counters for ratio culling at the next
        drain (one stacked read, started now)."""
        self._pending_ratio = (ref_kf,
                               Readback(torch.stack([vis_dev, found_dev])))

    def drain_ba_erase(self, m: MapArrays, graph: MapGraph):
        """Apply the PREVIOUS keyframe's BA outlier erasure to the host
        graph (+ orphan cascade)."""
        p = self._pending_ba_erase
        if p is None:
            return m
        self._pending_ba_erase = None
        old_rows, outlier_read = p
        touched = self.erase_outlier_obs(graph, old_rows,
                                         outlier_read.result())
        m, _ = self.kill_orphan_points(m, graph, touched)
        return m

    def erase_outlier_obs(self, graph: MapGraph, old_kf_mp: np.ndarray,
                          outlier: np.ndarray):
        """Remove erased observations from the host graph. Returns the set
        of touched points (candidates for the orphan cascade)."""
        kfs, feats = np.nonzero(outlier)
        touched = set()
        for k, f in zip(kfs, feats):
            pt = int(old_kf_mp[k, f])
            if pt >= 0:
                graph.erase_observation(pt, int(k))
                touched.add(pt)
        return touched

    def _kill_points(self, m: MapArrays, graph: MapGraph, kill: List[int]):
        pairs = []
        for pt in kill:
            pairs.extend(graph.kill_point(pt))
        return self._cull_impl(m, self._t(kill),
                               self._t([p[0] for p in pairs]),
                               self._t([p[1] for p in pairs]))

    def kill_orphan_points(self, m: MapArrays, graph: MapGraph, cand_pts):
        """SetBadFlag cascade (`src/MapPoint.cc:131-150`): after batch
        erasures, points left with <2 observers die on host AND device."""
        kill = [pt for pt in {int(p) for p in cand_pts}
                if pt >= 0 and graph.pt_alive[pt] and graph.n_obs(pt) < 2]
        if not kill:
            return m, 0
        return self._kill_points(m, graph, kill), len(kill)

    def triangulate_new_points(self, m: MapArrays, graph: MapGraph,
                               new_kf: int):
        """Triangulate `new_kf` against its covisible neighbours; slot
        allocation, insert and graph bookkeeping happen at the drain
        (`_drain_tri`), as in the JAX package's mapping-thread order
        (src/LocalMapping.cc:133-170)."""
        neighbors = graph.covis_neighbors(new_kf, top_k=self.tri_neighbors)
        if not neighbors:
            return m, 0
        nbs = [int(nb) for nb in neighbors[: self.tri_neighbors]]
        out = [self._triangulate_impl(m, new_kf, nb) for nb in nbs]
        # the host needs (idx_b, good) for slot allocation and the graph:
        # one read, started now; the positions stay on the device
        small = torch.stack([torch.stack([idx_b, good.to(torch.int32)], -1)
                             for _, idx_b, good in out])
        self._pending_tri = (new_kf, nbs, out, Readback(small))
        return m, -1  # created count known at drain time

    def _drain_tri(self, m: MapArrays, graph: MapGraph):
        pend = self._pending_tri
        if pend is None:
            return m
        self._pending_tri = None
        new_kf, nbs, out, small_read = pend
        small = small_read.result()
        idx_b_b = small[..., 0]
        good_b = small[..., 1] > 0
        n_created = 0
        N = good_b.shape[1]
        slots_all = np.full((len(nbs), N), -1, np.int32)
        taken = np.zeros(N, bool)  # feature of new_kf already used
        for bi, nb in enumerate(nbs):
            feats = np.nonzero(good_b[bi] & ~taken)[0]
            if len(feats) == 0:
                continue
            new_slots = graph.alloc_point_slots(len(feats))
            if len(new_slots) == 0:
                break  # point capacity exhausted: stop creating, keep running
            feats = feats[: len(new_slots)]
            taken[feats] = True
            slots_all[bi, feats] = new_slots
            for f, ss in zip(feats, new_slots):
                ss = int(ss)
                graph.pt_alive[ss] = True
                graph.note_new_point(ss, new_kf)
                graph.add_observation(ss, new_kf, int(f), False)
                graph.add_observation(ss, nb, int(idx_b_b[bi][f]), False)
            n_created += len(feats)
        if n_created:
            for bi, nb in enumerate(nbs):
                xw, idx_b, _ = out[bi]
                m = self._tri_insert_impl(m, new_kf, nb,
                                          self._t(slots_all[bi]), idx_b, xw)
            graph.update_connections(new_kf, graph.kf_row[new_kf])
        return m

    def cull_points(self, m: MapArrays, graph: MapGraph, new_kf: int,
                    min_obs: int = 3, age: int = 2):
        """Young points (first seen within `age` KFs) with too few
        observations die (MapPointCulling, src/LocalMapping.cc:335-369). The
        found/visible-ratio rule runs at `_drain_ratio_cull`, on the
        counters `queue_ratio_cull` snapshotted (the JAX method's
        `vis_found` argument, which its tracker never passes, has no
        port)."""
        kill: List[int] = []
        cur_seq = int(graph.kf_seq[new_kf])
        for pt in graph.young_points(cur_seq, max_age=age + 2):
            first = graph.pt_first_kf[pt]
            if first < 0:
                continue
            pt_age = cur_seq - first
            if age < pt_age <= age + 2 and graph.n_obs(pt) < min_obs:
                kill.append(pt)
        if not kill:
            return m, 0
        return self._kill_points(m, graph, kill), len(kill)
