"""Host-side pose helpers of the system facade.

Copies of `orb_slam2_refactored_tpu/slam/system.py`'s `_np_compose`,
`_np_inverse` and `corrected_frame_poses` (the `SlamSystem` facade itself
is not ported). Poses are numpy f32 `[qw, qx, qy, qz, tx, ty, tz]`,
world-to-camera.
"""

from __future__ import annotations

import numpy as np


def _np_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side se3 compose (the layout and semantics of
    `geometry.se3.compose`: apply b first, then a)."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    q = np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], np.float32)
    q /= max(np.linalg.norm(q), 1e-12)
    u, w = a[1:4], a[0]
    v = b[4:7]
    uv = np.cross(u, v)
    t = v + 2.0 * (w * uv + np.cross(u, uv)) + a[4:7]
    return np.concatenate([q, t.astype(np.float32)])


def _np_inverse(a: np.ndarray) -> np.ndarray:
    """Host-side se3 inverse (`geometry.se3.inverse`)."""
    q = np.array([a[0], -a[1], -a[2], -a[3]], np.float32)
    u, w = q[1:4], q[0]
    v = -a[4:7]
    uv = np.cross(u, v)
    t = v + 2.0 * (w * uv + np.cross(u, uv))
    return np.concatenate([q, t.astype(np.float32)])


def corrected_frame_poses(tracker) -> np.ndarray:
    """Per-frame world->camera poses with the loop and global-BA
    corrections applied: each frame's Tcr composed with its reference
    keyframe's current pose, walking culled reference keyframes through
    their recorded Tcp (`SaveTrajectoryTUM`, `src/System.cc:690-747`).
    Frames without a Tcr record (losses, relocalizations) keep their raw
    pose."""
    entries = tracker.traj_entries
    if not entries:
        return (np.stack(tracker.trajectory) if tracker.trajectory
                else np.zeros((0, 7), np.float32))
    kf_pose = tracker.map.kf_pose.cpu().numpy()  # one device read
    g = tracker.graph
    tcp_map = getattr(g, "kf_tcp", {})
    out = np.zeros((len(entries), 7), np.float32)
    ident = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    for i, e in enumerate(entries):
        if e["lost"] or e["tcr"] is None or e["ref"] < 0:
            out[i] = e["pose"]
            continue
        ref = e["ref"]
        trw = ident
        hops = 0
        while not g.kf_alive[ref] and ref in tcp_map and hops < 64:
            parent, tcp = tcp_map[ref]
            trw = _np_compose(trw, np.asarray(tcp))
            ref = parent
            hops += 1
        if not g.kf_alive[ref]:
            out[i] = e["pose"]  # unwalkable (a reset wiped the map)
            continue
        trw = _np_compose(trw, kf_pose[ref])
        out[i] = _np_compose(e["tcr"], trw)
    return out
