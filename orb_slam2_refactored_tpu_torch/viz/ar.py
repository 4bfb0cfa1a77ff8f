"""Headless AR: plane detection and a virtual cube anchored in the map.

Port of `orb_slam2_refactored_tpu/viz/ar.py` (the reference's AR demo,
`Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc`), numpy only, as there: tracked
keypoints (`DrawTrackedPoints`), a dominant scene plane found by RANSAC over
well-observed map points (`DetectPlane`), and a cube standing on it
(`DrawCube` / `DrawPlane`) projected through the live tracked pose each
frame, drawn into numpy images.

It reads the port's tracker on the host: the graph's live points and
observation counts, `map.mp_pos` once a call, `pose`, `last_mp_dev` (the
port keeps no host `last_mp`) and `last_frame.xy`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _exp_so3(v: np.ndarray) -> np.ndarray:
    """so3 exponential (ViewerAR ExpSO3 analog)."""
    th = float(np.linalg.norm(v))
    if th < 1e-12:
        return np.eye(3, dtype=np.float64)
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


@dataclasses.dataclass
class DetectedPlane:
    """Dominant scene plane: unit normal (toward the camera), centroid
    origin, and the plane->world transform Tpw whose y-axis is the normal
    (the reference's `Plane::Recompute`, ViewerAR.cc:518-600)."""

    normal: np.ndarray        # f32[3], oriented toward the detecting camera
    origin: np.ndarray        # f32[3], inlier centroid
    R_pw: np.ndarray          # f32[3,3] plane->world rotation (y = normal)
    inlier_idx: np.ndarray    # indices into the candidate point array


def detect_plane(points_w: np.ndarray, pose_cw: np.ndarray,
                 iterations: int = 50, seed: int = 0,
                 min_points: int = 50) -> Optional[DetectedPlane]:
    """RANSAC a dominant plane from map points (DetectPlane, :392-508).

    Reference semantics: 3-point hypotheses via SVD, score = the
    20th-percentile absolute distance (nth = max(0.2N, 20)), inliers at
    1.4x the best score, full-inlier SVD refit, normal flipped to face
    the camera, plane frame built by rotating +y onto the normal plus an
    in-plane yaw (seeded here instead of rand() — determinism over
    flourish)."""
    pts = np.asarray(points_w, np.float64)
    N = len(pts)
    if N < min_points:
        return None
    rng = np.random.default_rng(seed)

    def fit(idx):
        A = np.concatenate([pts[idx], np.ones((len(idx), 1))], axis=1)
        _, _, vt = np.linalg.svd(A, full_matrices=True)
        return vt[3]  # (a, b, c, d)

    best_dist, best_d = np.inf, None
    nth = max(int(0.2 * N), 20)
    for _ in range(iterations):
        abcd = fit(rng.choice(N, 3, replace=False))
        a, b, c, d = abcd
        f = 1.0 / max(np.sqrt(a * a + b * b + c * c + d * d), 1e-12)
        dist = np.abs(pts @ abcd[:3] + d) * f
        med = np.sort(dist)[min(nth, N - 1)]
        if med < best_dist:
            best_dist, best_d = med, dist
    th = 1.4 * best_dist
    inl = np.nonzero(best_d < th)[0]
    if len(inl) < 3:
        return None

    # full-inlier refit (Plane::Recompute)
    abcd = fit(inl)
    a, b, c = abcd[:3]
    o = pts[inl].mean(axis=0)
    # orient the normal toward the camera center
    pose_cw = np.asarray(pose_cw, np.float64)
    qw, qx, qy, qz = pose_cw[0:4] / max(np.linalg.norm(pose_cw[0:4]), 1e-12)
    R_cw = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ])
    cam_center = -(R_cw.T @ pose_cw[4:7])
    n = np.array([a, b, c])
    n = n / max(np.linalg.norm(n), 1e-12)
    if np.dot(cam_center - o, n) < 0:
        n = -n
    # plane frame: rotate +y onto n, then a seeded in-plane yaw (:570-580)
    up = np.array([0.0, 1.0, 0.0])
    v = np.cross(up, n)
    sa = np.linalg.norm(v)
    ang = np.arctan2(sa, np.dot(up, n))
    R1 = _exp_so3(v * ang / sa) if sa > 1e-9 else np.eye(3)
    rang = float(rng.uniform(-np.pi / 2, np.pi / 2))
    R_pw = R1 @ _exp_so3(up * rang)
    return DetectedPlane(normal=n.astype(np.float32),
                         origin=o.astype(np.float32),
                         R_pw=R_pw.astype(np.float32),
                         inlier_idx=inl)


def _draw_line(img: np.ndarray, p0, p1, value, thickness: int = 1):
    """Dense-sampled line rasterizer into [H,W] or [H,W,3] numpy images."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    for t in range(-(thickness // 2), thickness // 2 + 1):
        xi = np.clip(np.round(xs).astype(int) + t, 0, w - 1)
        yi = np.clip(np.round(ys).astype(int), 0, h - 1)
        keep = (xs >= -2) & (xs < w + 2) & (ys >= -2) & (ys < h + 2)
        img[yi[keep], xi[keep]] = value


def _cube_edges(size: float):
    """12 wireframe edges of a cube of side `size` sitting ON the plane
    (centered at plane origin, resting on y in [0, size] of the plane
    frame — the reference translates by size/2 along the plane normal,
    ViewerAR.cc:336-343)."""
    s = size / 2.0
    corners = np.array([
        [x, y, z]
        for x in (-s, s) for y in (0.0, size) for z in (-s, s)
    ])
    edges = []
    for i in range(8):
        for j in range(i + 1, 8):
            if np.sum(np.abs(corners[i] - corners[j]) > 1e-9) == 1:
                edges.append((i, j))
    return corners, edges


class ArOverlay:
    """AR session over a live tracker (ViewerAR::Run analog).

    Usage:
        ar = ArOverlay(tracker)
        ... track until a map exists ...
        ar.insert_cube(size=0.2)      # "Insert Cube" menu action
        out = ar.render(img)          # per-frame composited overlay
    """

    def __init__(self, tracker, min_obs: int = 5):
        self.tracker = tracker
        self.min_obs = min_obs
        self.plane: Optional[DetectedPlane] = None
        self.cube_size = 0.0

    def _well_observed_points(self):
        """World positions of currently-valid landmarks with > min_obs
        observations (the reference's candidate filter, :402-410)."""
        t = self.tracker
        g = t.graph
        alive = [p for p in g.alive_points() if g.n_obs(int(p)) > self.min_obs]
        if not alive:
            return np.zeros((0, 3), np.float32)
        return t.map.mp_pos.cpu().numpy()[alive]

    def insert_cube(self, size: float = 0.2, iterations: int = 50,
                    seed: int = 0) -> bool:
        """Detect the dominant plane in the current map and anchor a cube
        (the menu's Insert Cube -> DetectPlane flow, :170-216). Returns
        False when no plane is found (too few well-observed points)."""
        pts = self._well_observed_points()
        plane = detect_plane(pts, self.tracker.pose, iterations=iterations,
                             seed=seed)
        if plane is None:
            return False
        self.plane = plane
        self.cube_size = float(size)
        return True

    def project(self, points_w: np.ndarray) -> np.ndarray:
        """World points -> pixel coords under the CURRENT tracked pose."""
        from ..io.synthetic import _np_quat_rotate

        t = self.tracker
        pose = np.asarray(t.pose, np.float64)
        q, tr = pose[0:4], pose[4:7]
        uv = []
        for X in np.asarray(points_w, np.float64).reshape(-1, 3):
            xc = _np_quat_rotate(q, X) + tr
            z = max(float(xc[2]), 1e-6)
            uv.append([t.cfg.fx * xc[0] / z + t.cfg.cx,
                       t.cfg.fy * xc[1] / z + t.cfg.cy])
        return np.asarray(uv)

    def render(self, img: np.ndarray, draw_points: bool = True) -> np.ndarray:
        """Composite the AR content over a gray frame -> u8[H,W,3]."""
        img = np.asarray(img)
        if img.ndim == 2:
            out = np.stack([img] * 3, axis=-1)
        else:
            out = img.copy()
        out = np.clip(out, 0, 255).astype(np.uint8)

        if draw_points:  # DrawTrackedPoints (:378-390)
            t = self.tracker
            mp = getattr(t, "last_mp", None)
            if mp is None and t.last_mp_dev is not None:
                mp = t.last_mp_dev.cpu().numpy()
            if mp is not None and t.last_frame is not None:
                xy = t.last_frame.xy.cpu().numpy()
                for f in np.nonzero(mp >= 0)[0]:
                    x, y = int(round(xy[f, 0])), int(round(xy[f, 1]))
                    if 1 <= x < out.shape[1] - 1 and 1 <= y < out.shape[0] - 1:
                        out[y - 1:y + 2, x - 1:x + 2] = (0, 255, 0)

        if self.plane is not None and self.cube_size > 0:
            corners_p, edges = _cube_edges(self.cube_size)
            # plane frame -> world: X_w = R_pw @ X_p + origin
            corners_w = corners_p @ self.plane.R_pw.T + self.plane.origin
            uv = self.project(corners_w)
            for i, j in edges:
                _draw_line(out, uv[i], uv[j], (255, 64, 64), thickness=2)
            # plane grid (DrawPlane analog): a 4x4 grid in the plane
            g = self.cube_size * 2
            for k in range(-2, 3):
                a = np.array([k * g / 2, 0, -g]) @ self.plane.R_pw.T + self.plane.origin
                b = np.array([k * g / 2, 0, g]) @ self.plane.R_pw.T + self.plane.origin
                c = np.array([-g, 0, k * g / 2]) @ self.plane.R_pw.T + self.plane.origin
                d = np.array([g, 0, k * g / 2]) @ self.plane.R_pw.T + self.plane.origin
                pa, pb = self.project(np.stack([a, b]))
                pc, pd = self.project(np.stack([c, d]))
                _draw_line(out, pa, pb, (64, 64, 255))
                _draw_line(out, pc, pd, (64, 64, 255))
        return out
