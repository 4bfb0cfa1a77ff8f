"""Synthetic RGB-D/stereo sequence generator: a textured box room.

No public SLAM datasets ship with this container (zero egress), so unit /
integration tests and the benchmark harness render their own ground-truthed
sequences: a camera moving inside a box room whose walls carry blocky
random textures (sharp L-corner-rich, FAST-friendly). Rendering is exact
ray-plane intersection per pixel, so the depth channel is perfect and ATE
against the ground-truth trajectory measures the tracker alone.

This plays the role of the reference's dataset drivers + ground truth files
(`reference Examples/RGB-D/rgbd_tum.cc` etc.) for in-repo testing.

A copy of `orb_slam2_refactored_tpu/io/synthetic.py` (numpy only): the port
imports nothing from the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np

from . import png


def _np_quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], np.float32)


def _np_quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qw, qv = q[0], q[1:4]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def _np_pose_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a o b)(x) = a(b(x)) for poses x -> q*x*q^-1 + t (se3.compose analog,
    kept numpy: data generation stays on the host)."""
    q = _np_quat_mul(a[0:4], b[0:4])
    t = _np_quat_rotate(a[0:4], b[4:7]) + a[4:7]
    return np.concatenate([q, t]).astype(np.float32)


def _np_pose_inverse(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.float32)
    q = p[0:4] / max(np.linalg.norm(p[0:4]), 1e-12)
    qinv = np.array([q[0], -q[1], -q[2], -q[3]], np.float32)
    return np.concatenate([qinv, -_np_quat_rotate(qinv, p[4:7])]).astype(np.float32)


def _hash2(ix, iy, seed):
    """Deterministic integer hash -> [0,1) floats (blocky texture lookup)."""
    h = (ix.astype(np.int64) * 73856093) ^ (iy.astype(np.int64) * 19349663) ^ (seed * 83492791)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return ((h & 0xFFFF).astype(np.float32)) / 65536.0


def block_texture(u, v, seed: int, scales=(0.25, 0.5)):
    """Multi-scale random-block texture in [0,255], sharp edges everywhere.

    Pass `scales=None` for seed-varied block scales: different surfaces get
    different spatial statistics, which keeps BoW place recognition from
    aliasing (with uniform scales every wall has near-identical word
    histograms and all loop candidates alias — the geometric gates reject
    them, verified experimentally, but no true loop can be retrieved either).
    """
    if scales is None:
        # seed-varied block scales, clamped to a corner-dense range: at a
        # typical 2m viewing distance with fx=260 these are 19-45px blocks,
        # so every wall keeps enough FAST corners for tracking (a 0.58m
        # block at that range is ~75px — one near-blank wall starves the
        # extractor and tracking dies on luck, not geometry)
        base = 0.15 + 0.05 * ((seed * 29) % 5)
        scales = (base, base * 2.3)
    val = np.zeros_like(u, dtype=np.float32)
    for k, s in enumerate(scales):
        iu = np.floor(u / s).astype(np.int64)
        iv = np.floor(v / s).astype(np.int64)
        val += _hash2(iu, iv, seed * 7 + k)
    val /= len(scales)
    return 40.0 + 180.0 * val


@dataclasses.dataclass
class Plane:
    point: np.ndarray   # a point on the plane
    normal: np.ndarray  # unit normal (pointing into the room)
    axis_u: np.ndarray  # in-plane texture axes
    axis_v: np.ndarray
    seed: int
    scales: tuple = (0.25, 0.5)  # None -> seed-varied (distinct per surface)


def box_room(half_x=3.0, half_y=2.0, z_far=7.0, z_near=-7.0,
             distinct_textures=False) -> List[Plane]:
    """`distinct_textures=True` gives every surface its own block scales so
    BoW place recognition can discriminate surfaces (see block_texture)."""
    e = np.eye(3, dtype=np.float32)
    sc = None if distinct_textures else (0.25, 0.5)
    return [
        Plane(np.array([0, 0, z_far], np.float32), -e[2], e[0], e[1], 1, sc),   # back wall
        Plane(np.array([0, 0, z_near], np.float32), e[2], e[0], e[1], 6, sc),   # front wall
        Plane(np.array([-half_x, 0, 0], np.float32), e[0], e[2], e[1], 2, sc),  # left
        Plane(np.array([half_x, 0, 0], np.float32), -e[0], e[2], e[1], 3, sc),  # right
        Plane(np.array([0, half_y, 0], np.float32), -e[1], e[0], e[2], 4, sc),  # floor
        Plane(np.array([0, -half_y, 0], np.float32), e[1], e[0], e[2], 5, sc),  # ceiling
    ]


class SyntheticScene:
    """Renders gray + depth images from any camera pose (world->camera Tcw)."""

    def __init__(self, width=320, height=240, fx=260.0, fy=260.0,
                 cx=None, cy=None, baseline=0.08, planes=None,
                 dist_coeffs=(0.0, 0.0, 0.0, 0.0, 0.0)):
        """`dist_coeffs=(k1,k2,p1,p2,k3)`: renders through a distorting lens —
        each output pixel's ray comes from undistorting its coordinates, so
        the image exhibits the radial-tangential warp a real camera would
        (exercises the frontend's UndistortKeyPoints analog)."""
        self.width, self.height = width, height
        self.fx, self.fy = fx, fy
        self.cx = width / 2.0 if cx is None else cx
        self.cy = height / 2.0 if cy is None else cy
        self.bf = baseline * fx
        self.dist_coeffs = tuple(dist_coeffs)
        self.planes = planes if planes is not None else box_room()
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        if any(c != 0.0 for c in self.dist_coeffs):
            from ..geometry.projection import undistort_points_np

            uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float64)
            und = undistort_points_np(fx, fy, self.cx, self.cy,
                                      self.dist_coeffs, uv, iters=12)
            xn = ((und[:, 0] - self.cx) / fx).reshape(height, width)
            yn = ((und[:, 1] - self.cy) / fy).reshape(height, width)
            self._rays = np.stack(
                [xn, yn, np.ones_like(xn)], axis=-1
            ).astype(np.float32)
        else:
            self._rays = np.stack(
                [(u - self.cx) / fx, (v - self.cy) / fy, np.ones_like(u, np.float32)],
                axis=-1,
            ).astype(np.float32)

    def render(self, pose_cw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (gray f32[H,W], depth f32[H,W]); depth = z in camera frame.

        Pure numpy on purpose: renderers run on the host while the tracker
        owns the device."""
        pose_cw = np.asarray(pose_cw, np.float32)
        qw, qx, qy, qz = pose_cw[0:4] / max(np.linalg.norm(pose_cw[0:4]), 1e-12)
        R_cw = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ], np.float32)
        R_wc = R_cw.T
        c = -(R_wc @ pose_cw[4:7])
        dirs = self._rays @ R_wc.T  # [H,W,3] world-frame ray directions

        best_t = np.full((self.height, self.width), np.inf, np.float32)
        img = np.zeros((self.height, self.width), np.float32)
        for pl in self.planes:
            denom = dirs @ pl.normal
            t = ((pl.point - c) @ pl.normal) / np.where(
                np.abs(denom) < 1e-9, 1e-9, denom
            )
            hit = (t > 0.05) & (t < best_t)
            if not hit.any():
                continue
            pt = c + dirs * t[..., None]
            u = (pt - pl.point) @ pl.axis_u
            v = (pt - pl.point) @ pl.axis_v
            tex = block_texture(u, v, pl.seed, pl.scales)
            img = np.where(hit, tex, img)
            best_t = np.where(hit, t, best_t)
        depth = best_t * 1.0  # t multiplies unit-z rays: depth = t (z component 1)
        depth[~np.isfinite(depth)] = 0.0
        return img, depth

    def render_stereo(self, pose_cw: np.ndarray):
        """-> (left, right, depth_left). Right camera offset +baseline in x."""
        left, depth = self.render(pose_cw)
        # right camera pose: x_right = x_left - baseline (camera frame shift)
        shift = np.array([1, 0, 0, 0, -self.bf / self.fx, 0, 0], np.float32)
        pose_r = _np_pose_compose(shift, np.asarray(pose_cw, np.float32))
        right, _ = self.render(pose_r)
        return left, right, depth


def export_tum_sequence(out_dir: str, scene: "SyntheticScene",
                        poses_cw: np.ndarray, fps: float = 30.0,
                        depth_factor: float = 5000.0,
                        depth_noise: float = 0.0, seed: int = 0,
                        t0: float = 1000.0) -> str:
    """Write a rendered sequence in the TUM RGB-D on-disk layout.

    Produces `rgb/*.png` (8-bit gray), `depth/*.png` (16-bit, meters *
    depth_factor), `rgb.txt`, `depth.txt` and `groundtruth.txt` — byte-format
    compatible with the files `rgbd_tum.cc` and the TUM tools consume
    (`reference Examples/RGB-D/rgbd_tum.cc`, association format of
    associate.py), written through `io/png.py`. Lets the CLI
    (`drivers.py rgbd_tum`) run end to end on rendered frames. Returns
    out_dir.
    """
    rng = np.random.default_rng(seed)

    def frames():
        for pose in poses_cw:
            img, depth = scene.render(pose)
            if depth_noise:
                depth = depth * (1 + rng.normal(0, depth_noise, depth.shape))
            yield img, depth

    return write_tum_sequence(out_dir, frames(), poses_cw, fps, depth_factor,
                              t0)


def write_tum_sequence(out_dir: str, frames, poses_cw: np.ndarray,
                       fps: float = 30.0, depth_factor: float = 5000.0,
                       t0: float = 1000.0) -> str:
    """Write (image, depth in metres) pairs and their world->camera poses
    in the TUM RGB-D layout of `export_tum_sequence`: the image clipped
    and truncated to 8-bit gray, the depth times `depth_factor` to
    16-bit."""
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i, ((img, depth), pose) in enumerate(zip(frames, poses_cw)):
        ts = t0 + i / fps
        rgb_name = f"rgb/{ts:.6f}.png"
        depth_name = f"depth/{ts:.6f}.png"
        png.write_png(os.path.join(out_dir, rgb_name),
                      np.clip(img, 0, 255).astype(np.uint8))
        png.write_png(os.path.join(out_dir, depth_name),
                      np.clip(depth * depth_factor, 0, 65535).astype(
                          np.uint16))
        rgb_lines.append(f"{ts:.6f} {rgb_name}")
        depth_lines.append(f"{ts:.6f} {depth_name}")
        wc = _np_pose_inverse(pose)
        qw, qx, qy, qz, tx, ty, tz = wc
        gt_lines.append(
            f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    for name, lines in [("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)]:
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(f"# synthetic TUM-layout export\n# timestamp data\n")
            f.write("\n".join(lines) + "\n")
    return out_dir


def _np_rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [w,x,y,z] (numpy, host-side)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return (q / np.linalg.norm(q)).astype(np.float32)


def export_kitti_sequence(out_dir: str, scene: "SyntheticScene",
                          poses_cw: np.ndarray, fps: float = 10.0) -> str:
    """Write a rendered stereo sequence in the KITTI odometry on-disk layout.

    Produces `image_0/%06d.png`, `image_1/%06d.png` (8-bit gray), and
    `times.txt` — the files `stereo_kitti.cc` consumes
    (`reference Examples/Stereo/stereo_kitti.cc`). Also writes
    `poses_gt.txt` in the KITTI ground-truth format (3x4 row-major Twc per
    line, the devkit convention and `SaveTrajectoryKITTI`'s output format,
    `src/System.cc:790-843`) so the driver's saved trajectory can be scored
    frame-by-frame. Returns out_dir."""
    os.makedirs(os.path.join(out_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_1"), exist_ok=True)
    times, gt_rows = [], []
    for i, pose in enumerate(poses_cw):
        left, right, _ = scene.render_stereo(pose)
        png.write_png(os.path.join(out_dir, "image_0", f"{i:06d}.png"),
                      np.clip(left, 0, 255).astype(np.uint8))
        png.write_png(os.path.join(out_dir, "image_1", f"{i:06d}.png"),
                      np.clip(right, 0, 255).astype(np.uint8))
        times.append(f"{i / fps:.6e}")
        wc = _np_pose_inverse(pose)
        q, t = wc[0:4], wc[4:7]
        qw, qx, qy, qz = q
        R = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ])
        row = np.concatenate([R, t.reshape(3, 1)], axis=1).reshape(-1)
        gt_rows.append(" ".join(f"{v:.9e}" for v in row))
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    with open(os.path.join(out_dir, "poses_gt.txt"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    return out_dir


def make_euroc_rig(width=320, height=240, fx_rect=260.0, baseline=0.08):
    """A synthetic EuRoC-style stereo rig: two RAW cameras with distinct
    intrinsics, mild radial-tangential distortion, and small rectifying
    rotations, plus the LEFT./RIGHT. K,D,R,P rectification blocks that map
    them onto a common rectified pinhole pair (the fixture format of
    `reference Examples/Stereo/stereo_euroc.cc:61-107` /
    `EuRoC.yaml`). Raw FOVs are slightly wider than the rectified FOV so
    the remap stays inside the raw images."""

    def rot_yz(deg_y, deg_z):
        ay, az = np.deg2rad(deg_y), np.deg2rad(deg_z)
        Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                       [-np.sin(ay), 0, np.cos(ay)]])
        Rz = np.array([[np.cos(az), -np.sin(az), 0],
                       [np.sin(az), np.cos(az), 0], [0, 0, 1]])
        return (Rz @ Ry).astype(np.float64)

    cx, cy = width / 2.0, height / 2.0
    K_l = np.array([[fx_rect * 0.94, 0, cx - 3.0],
                    [0, fx_rect * 0.95, cy + 2.0], [0, 0, 1]])
    K_r = np.array([[fx_rect * 0.95, 0, cx + 2.5],
                    [0, fx_rect * 0.94, cy - 1.5], [0, 0, 1]])
    D_l = np.array([-0.02, 0.004, 0.0003, -0.0002, 0.0])
    D_r = np.array([-0.018, 0.003, -0.0002, 0.0003, 0.0])
    R_l = rot_yz(0.5, 0.35)
    R_r = rot_yz(-0.45, -0.3)
    P_l = np.array([[fx_rect, 0, cx, 0], [0, fx_rect, cy, 0], [0, 0, 1, 0]])
    P_r = P_l.copy()
    P_r[0, 3] = -fx_rect * baseline
    return {
        "width": width, "height": height, "baseline": baseline,
        "fx_rect": fx_rect, "cx": cx, "cy": cy,
        "K_l": K_l, "K_r": K_r, "D_l": D_l, "D_r": D_r,
        "R_l": R_l, "R_r": R_r, "P_l": P_l, "P_r": P_r,
    }


def euroc_settings_yaml(rig, n_features=600, n_levels=4,
                        th_depth=35.0) -> str:
    """Reference-format stereo settings YAML (EuRoC.yaml analog) with the
    LEFT./RIGHT. rectification blocks for this rig."""

    def mat(m):
        m = np.asarray(m, np.float64)
        rows, cols = (m.shape[0], m.shape[1]) if m.ndim == 2 else (1, m.size)
        data = ", ".join(f"{v:.12g}" for v in m.reshape(-1))
        return (f"!!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
                f"   dt: d\n   data: [{data}]")

    fx, cx, cy = rig["fx_rect"], rig["cx"], rig["cy"]
    lines = [
        "%YAML:1.0",
        f"Camera.fx: {fx}", f"Camera.fy: {fx}",
        f"Camera.cx: {cx}", f"Camera.cy: {cy}",
        "Camera.k1: 0.0", "Camera.k2: 0.0",
        "Camera.p1: 0.0", "Camera.p2: 0.0",
        f"Camera.width: {rig['width']}", f"Camera.height: {rig['height']}",
        "Camera.fps: 20.0",
        f"Camera.bf: {fx * rig['baseline']}",
        "Camera.RGB: 1",
        f"ThDepth: {th_depth}",
        f"ORBextractor.nFeatures: {n_features}",
        "ORBextractor.scaleFactor: 1.2",
        f"ORBextractor.nLevels: {n_levels}",
        "ORBextractor.iniThFAST: 20",
        "ORBextractor.minThFAST: 7",
        f"LEFT.width: {rig['width']}", f"LEFT.height: {rig['height']}",
        f"RIGHT.width: {rig['width']}", f"RIGHT.height: {rig['height']}",
    ]
    for side, kk in (("LEFT", "l"), ("RIGHT", "r")):
        for name in ("K", "D", "R", "P"):
            lines.append(f"{side}.{name}: {mat(rig[f'{name}_{kk}'])}")
    return "\n".join(lines) + "\n"


def export_euroc_sequence(out_dir: str, planes, poses_cw: np.ndarray,
                          rig=None, fps: float = 20.0,
                          t0_ns: int = 1403636579763555584) -> str:
    """Write a rendered stereo sequence in the EuRoC MAV on-disk layout.

    Produces `mav0/cam0/data/<ns>.png`, `mav0/cam1/data/<ns>.png` (RAW
    distorted/rotated camera images — rectification is the DRIVER's job,
    through the LEFT./RIGHT. blocks, exactly like
    `stereo_euroc.cc:61-107`), a `timestamps.txt` (nanosecond stamps, the
    format the reference's EuRoC timestamp files use), and
    `groundtruth_tum.txt` (TUM-format, for scoring). Returns out_dir."""
    if rig is None:
        rig = make_euroc_rig()
    os.makedirs(os.path.join(out_dir, "mav0", "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mav0", "cam1", "data"), exist_ok=True)

    # raw cameras: rectified pose composed with the INVERSE rectifying
    # rotation (cv2.initUndistortRectifyMap maps rect rays through R^-1 into
    # the raw frame), rendered through (K, D) lenses
    def raw_scene(K, D):
        return SyntheticScene(
            width=rig["width"], height=rig["height"],
            fx=float(K[0, 0]), fy=float(K[1, 1]),
            cx=float(K[0, 2]), cy=float(K[1, 2]),
            dist_coeffs=tuple(float(x) for x in D),
            planes=planes,
        )

    scene_l = raw_scene(rig["K_l"], rig["D_l"])
    scene_r = raw_scene(rig["K_r"], rig["D_r"])
    rot_l = np.concatenate(
        [_np_rot_to_quat(rig["R_l"].T), np.zeros(3, np.float32)])
    rot_r = np.concatenate(
        [_np_rot_to_quat(rig["R_r"].T), np.zeros(3, np.float32)])
    shift = np.array([1, 0, 0, 0, -rig["baseline"], 0, 0], np.float32)

    stamps, gt_lines = [], []
    for i, pose in enumerate(poses_cw):
        ns = t0_ns + int(round(i * 1e9 / fps))
        pose = np.asarray(pose, np.float32)
        pose_l = _np_pose_compose(rot_l, pose)
        pose_r = _np_pose_compose(rot_r, _np_pose_compose(shift, pose))
        img_l, _ = scene_l.render(pose_l)
        img_r, _ = scene_r.render(pose_r)
        png.write_png(os.path.join(out_dir, "mav0", "cam0", "data",
                                   f"{ns}.png"),
                      np.clip(img_l, 0, 255).astype(np.uint8))
        png.write_png(os.path.join(out_dir, "mav0", "cam1", "data",
                                   f"{ns}.png"),
                      np.clip(img_r, 0, 255).astype(np.uint8))
        stamps.append(str(ns))
        wc = _np_pose_inverse(pose)
        qw, qx, qy, qz, tx, ty, tz = wc
        gt_lines.append(f"{ns / 1e9:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                        f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
    with open(os.path.join(out_dir, "timestamps.txt"), "w") as f:
        f.write("\n".join(stamps) + "\n")
    with open(os.path.join(out_dir, "groundtruth_tum.txt"), "w") as f:
        f.write("# synthetic EuRoC-layout export\n# timestamp data\n")
        f.write("\n".join(gt_lines) + "\n")
    return out_dir


def orbit_trajectory(n_frames: int, radius=0.8, z_amp=0.3, yaw_amp=0.25):
    """Smooth looping trajectory inside the room: lateral orbit + yaw sweep.

    Returns f32[n,7] world->camera poses (Tcw).
    """
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / max(n_frames, 1)
        # camera center in world
        cx = radius * np.sin(a)
        cy = 0.3 * np.sin(2 * a) * z_amp
        cz = radius * (1 - np.cos(a)) * 0.5
        yaw = yaw_amp * np.sin(a)
        cq = np.array(
            [np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0], np.float32
        )  # rotation about y
        pose_wc = np.concatenate([cq, np.array([cx, cy, cz], np.float32)])
        poses.append(_np_pose_inverse(pose_wc))
    return np.stack(poses)
