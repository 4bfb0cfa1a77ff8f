"""Trajectory evaluation: ATE (with SE3/Sim3 Umeyama alignment) and RPE.

Port of `orb_slam2_refactored_tpu/io/evaluation.py` on numpy alone (float64
host arithmetic; the JAX package routes the pose algebra through f32
device ops, so results agree to f32 rounding).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _quat_rotate(q, v):
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _inverse(p):
    qi = p[..., 0:4] * np.array([1.0, -1.0, -1.0, -1.0])
    return np.concatenate([qi, -_quat_rotate(qi, p[..., 4:7])], -1)


def _compose(a, b):
    q = _quat_mul(a[..., 0:4], b[..., 0:4])
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    t = _quat_rotate(a[..., 0:4], b[..., 4:7]) + a[..., 4:7]
    return np.concatenate([q, t], -1)


def _log(p):
    """Pose [...,7] -> se(3) tangent [...,6] ([omega, upsilon])."""
    q = np.where(p[..., 0:1] < 0, -p[..., 0:4], p[..., 0:4])
    w = np.clip(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn = np.linalg.norm(v, axis=-1, keepdims=True)
    theta = 2.0 * np.arctan2(vn, w)
    k = np.where(vn < 1e-9, 2.0 / np.maximum(w, 1e-12),
                 theta / np.maximum(vn, 1e-24))
    omega = k * v
    th2 = np.sum(omega * omega, -1)[..., None, None]
    th = np.sqrt(np.maximum(th2, 1e-24))
    z = np.zeros_like(omega[..., 0])
    K = np.stack([np.stack([z, -omega[..., 2], omega[..., 1]], -1),
                  np.stack([omega[..., 2], z, -omega[..., 0]], -1),
                  np.stack([-omega[..., 1], omega[..., 0], z], -1)], -2)
    half = 0.5 * th
    cot = np.where(th2 < 1e-12, 1.0 / 12.0 + th2 / 720.0,
                   (1.0 - half * np.cos(half) / np.maximum(np.sin(half), 1e-24))
                   / np.maximum(th2, 1e-24))
    Vinv = np.eye(3) - 0.5 * K + cot * (K @ K)
    ups = (Vinv @ p[..., 4:7, None])[..., 0]
    return np.concatenate([omega, ups], -1)


def _positions(poses_cw: np.ndarray) -> np.ndarray:
    """[N,7] world->camera poses -> [N,3] camera centers in world frame."""
    p = np.asarray(poses_cw, np.float64)
    q = p[:, 0:4] / np.linalg.norm(p[:, 0:4], axis=-1, keepdims=True)
    return _inverse(np.concatenate([q, p[:, 4:7]], -1))[:, 4:7]


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity aligning src -> dst. Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_cw: np.ndarray, gt_cw: np.ndarray,
             align: str = "se3") -> Tuple[float, np.ndarray]:
    """Absolute trajectory error RMSE after alignment ('se3' or 'sim3').
    Returns (rmse, per-frame errors)."""
    p_est = _positions(est_cw)
    p_gt = _positions(gt_cw)
    assert p_est.shape == p_gt.shape
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale=(align == "sim3"))
    p_al = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_al - p_gt, axis=1)
    return float(np.sqrt((err ** 2).mean())), err


def associate_timestamps(ts_a: np.ndarray, ts_b: np.ndarray,
                         max_dt: float = 0.02):
    """Greedy nearest-timestamp association (TUM associate.py semantics).

    Returns (idx_a, idx_b) index arrays of matched pairs with |dt| <= max_dt;
    each b index is used at most once."""
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    order = np.argsort(ts_b)
    ts_b_sorted = ts_b[order]
    used = np.zeros(len(ts_b), bool)
    ia, ib = [], []
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b_sorted, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(ts_b_sorted) and not used[k]:
                dt = abs(ts_b_sorted[k] - t)
                if dt <= best_dt:
                    best, best_dt = k, dt
        if best >= 0:
            used[best] = True
            ia.append(i)
            ib.append(int(order[best]))
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def ate_rmse_assoc(est_ts: np.ndarray, est_cw: np.ndarray,
                   gt_ts: np.ndarray, gt_cw: np.ndarray,
                   align: str = "se3", max_dt: float = 0.02
                   ) -> Tuple[float, np.ndarray, int]:
    """ATE RMSE between trajectories on different timestamp grids, as the
    TUM tools score a saved trajectory against a groundtruth file:
    timestamp association, then the aligned RMSE.

    Returns (rmse, per-pair errors, n_matched)."""
    ia, ib = associate_timestamps(est_ts, gt_ts, max_dt)
    if len(ia) < 3:
        raise ValueError(
            f"only {len(ia)} associated pairs (need >=3 for alignment)")
    rmse, err = ate_rmse(np.asarray(est_cw)[ia], np.asarray(gt_cw)[ib], align)
    return rmse, err, len(ia)


def rpe(est_cw: np.ndarray, gt_cw: np.ndarray,
        delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over frame offsets of `delta`. Returns (trans RMSE
    per step, rot RMSE radians per step)."""
    e = np.asarray(est_cw, np.float64)
    g = np.asarray(gt_cw, np.float64)
    rel_e = _compose(e[delta:], _inverse(e[:-delta]))
    rel_g = _compose(g[delta:], _inverse(g[:-delta]))
    d = _log(_compose(rel_e, _inverse(rel_g)))
    t_err = np.linalg.norm(d[:, 3:6], axis=1)
    r_err = np.linalg.norm(d[:, 0:3], axis=1)
    return float(np.sqrt((t_err ** 2).mean())), float(np.sqrt((r_err ** 2).mean()))
