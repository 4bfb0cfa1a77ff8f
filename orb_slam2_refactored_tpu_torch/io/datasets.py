"""Dataset readers: TUM RGB-D, KITTI odometry, EuRoC MAV.

Port of `orb_slam2_refactored_tpu/io/datasets.py`, the reference's example
drivers' readers (`Examples/{Monocular,Stereo,RGB-D}/*.cc`): sequence
discovery, timestamp parsing and image loading. Images load through the
port's own PNG reader (`io/png.py`), as float32 gray as the JAX package's
`cv2.imread(..., IMREAD_GRAYSCALE)` gives them; depth images stay in their
raw sensor units. Each reader yields `(timestamp, images...)` lazily.
`EurocRectifier` rectifies raw EuRoC pairs from the settings' LEFT./RIGHT.
blocks as the JAX package's `cv2.initUndistortRectifyMap` and
`cv2.remap` do, in numpy on the host.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..geometry import se3
from . import png


def _imread_gray(path: str) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.read_gray(path).astype(np.float32)


def _lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


def load_tum_associations(seq_dir: str, assoc_file: Optional[str] = None):
    """(timestamp, rgb path, depth path) triples: from an association file,
    or rgb.txt and depth.txt paired by nearest timestamp (under 0.02 s)."""
    if assoc_file and os.path.exists(assoc_file):
        return [(float(p[0]), p[1], p[3]) for p in _lines(assoc_file)]
    rgb = [(float(p[0]), p[1]) for p in _lines(os.path.join(seq_dir,
                                                            "rgb.txt"))]
    depth = [(float(p[0]), p[1]) for p in _lines(os.path.join(seq_dir,
                                                              "depth.txt"))]
    d_ts = np.asarray([t for t, _ in depth])
    pairs = []
    for t, rgb_path in rgb:
        i = int(np.argmin(np.abs(d_ts - t)))
        if abs(d_ts[i] - t) < 0.02:
            pairs.append((t, rgb_path, depth[i][1]))
    return pairs


def tum_rgbd_sequence(
    seq_dir: str, assoc_file: Optional[str] = None
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """Yields (timestamp, gray f32[H,W], depth_raw f32[H,W]) (rgbd_tum.cc).
    Depth stays in raw sensor units: the system divides by DepthMapFactor
    once."""
    for t, rgb_rel, depth_rel in load_tum_associations(seq_dir, assoc_file):
        img = _imread_gray(os.path.join(seq_dir, rgb_rel))
        d = png.read_png(os.path.join(seq_dir, depth_rel))
        yield t, img, d.astype(np.float32)


def tum_mono_sequence(seq_dir: str) -> Iterator[Tuple[float, np.ndarray]]:
    """mono_tum.cc: rgb.txt only."""
    for p in _lines(os.path.join(seq_dir, "rgb.txt")):
        yield float(p[0]), _imread_gray(os.path.join(seq_dir, p[1]))


def _kitti_times(seq_dir: str):
    with open(os.path.join(seq_dir, "times.txt")) as f:
        return [float(x) for x in f.read().split()]


def kitti_stereo_sequence(seq_dir: str
                          ) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """stereo_kitti.cc: image_0/, image_1/ and times.txt."""
    for i, t in enumerate(_kitti_times(seq_dir)):
        l = _imread_gray(os.path.join(seq_dir, "image_0", f"{i:06d}.png"))
        r = _imread_gray(os.path.join(seq_dir, "image_1", f"{i:06d}.png"))
        yield t, l, r


def kitti_mono_sequence(seq_dir: str) -> Iterator[Tuple[float, np.ndarray]]:
    for i, t in enumerate(_kitti_times(seq_dir)):
        yield t, _imread_gray(os.path.join(seq_dir, "image_0", f"{i:06d}.png"))


def _euroc_stamps(timestamps_file: str):
    with open(timestamps_file) as f:
        return [line.strip() for line in f if line.strip()]


def undistort_rectify_map(K, D, R, P, width: int, height: int):
    """`cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], (width, height),
    CV_32F)` in float64 numpy: each rectified pixel (u, v, 1) through
    inv(P[:3, :3] R) to a ray, divided by its z, distorted by the
    radial-tangential model (k1, k2, p1, p2, k3) and projected by K; the
    raw image's (x, y) of every pixel, each f32[height, width]."""
    K, R = np.asarray(K, np.float64), np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)[:3, :3]
    k1, k2, p1, p2, k3 = (list(np.asarray(D, np.float64).reshape(-1))
                          + [0.0] * 5)[:5]
    ir = np.linalg.inv(P @ R)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    ray = [ir[r, 0] * u + ir[r, 1] * v + ir[r, 2] for r in range(3)]
    x, y = ray[0] / ray[2], ray[1] / ray[2]
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    return ((K[0, 0] * xd + K[0, 2]).astype(np.float32),
            (K[1, 1] * yd + K[1, 2]).astype(np.float32))


class RemapTable:
    """`cv2.remap(img, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT)` of an
    f32 [h, w] image as a table: per output pixel the flat indices of its
    four taps (floor of the map, then one right, one down, both) and their
    f32 weights (1 - fx)(1 - fy), fx (1 - fy), (1 - fx) fy, fx fy. A tap
    outside the image reads a zero past the image's last pixel, and a
    pixel whose four taps all lie outside has all-zero weights."""

    def __init__(self, map_x, map_y, height: int, width: int):
        mx = np.asarray(map_x, np.float32)
        my = np.asarray(map_y, np.float32)
        x0, y0 = np.floor(mx), np.floor(my)
        fx, fy = mx - x0, my - y0
        one = np.float32(1.0)
        x0 = np.clip(x0, -2, width + 1).astype(np.int64)
        y0 = np.clip(y0, -2, height + 1).astype(np.int64)
        idx, w, inside = [], [], []
        for dy, wy in ((0, one - fy), (1, fy)):
            for dx, wx in ((0, one - fx), (1, fx)):
                x, y = x0 + dx, y0 + dy
                ok = (x >= 0) & (x < width) & (y >= 0) & (y < height)
                idx.append(np.where(ok, y * width + x, height * width))
                w.append(wx * wy)
                inside.append(ok)
        some = np.logical_or.reduce(inside)
        self.shape = mx.shape
        self.size = height * width
        self.idx = np.stack(idx).reshape(4, -1)
        self.weights = np.where(some, np.stack(w), np.float32(0.0)).reshape(
            4, -1).astype(np.float32)

    def __call__(self, img) -> np.ndarray:
        src = np.zeros(self.size + 1, np.float32)
        src[:self.size] = np.asarray(img, np.float32).reshape(-1)
        tap = src[self.idx] * self.weights
        return (((tap[0] + tap[1]) + tap[2]) + tap[3]).reshape(self.shape)


class EurocRectifier:
    """Stereo rectification from the settings' LEFT./RIGHT. blocks
    (`Examples/Stereo/stereo_euroc.cc:61-107`), the port of the JAX
    package's `io/datasets.py::EurocRectifier`: both maps built once
    (`undistort_rectify_map`, as `cv2.initUndistortRectifyMap` with
    CV_32F builds them) and each image remapped bilinearly (`RemapTable`,
    as `cv2.remap` with INTER_LINEAR and a zero border). It runs on the
    host, where the raw pairs are and where the tracker quantizes them."""

    def __init__(self, rect):
        w, h = rect.width, rect.height
        self.remap_l = RemapTable(*undistort_rectify_map(
            rect.K_l, rect.D_l, rect.R_l, rect.P_l, w, h), h, w)
        self.remap_r = RemapTable(*undistort_rectify_map(
            rect.K_r, rect.D_r, rect.R_r, rect.P_r, w, h), h, w)

    def __call__(self, img_l, img_r):
        return self.remap_l(img_l), self.remap_r(img_r)


def euroc_stereo_sequence(
    seq_dir: str, timestamps_file: str, rectifier=None
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """stereo_euroc.cc: mav0/cam0/data and cam1/data by timestamp file; each
    raw pair through `rectifier` (an `EurocRectifier`) where one is
    given."""
    for s in _euroc_stamps(timestamps_file):
        t = float(s) / 1e9
        l = _imread_gray(os.path.join(seq_dir, "mav0", "cam0", "data",
                                      s + ".png"))
        r = _imread_gray(os.path.join(seq_dir, "mav0", "cam1", "data",
                                      s + ".png"))
        if rectifier is not None:
            l, r = rectifier(l, r)
        yield t, l, r


def euroc_mono_sequence(seq_dir: str, timestamps_file: str):
    for s in _euroc_stamps(timestamps_file):
        yield float(s) / 1e9, _imread_gray(
            os.path.join(seq_dir, "mav0", "cam0", "data", s + ".png"))


def load_tum_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt -> (timestamps [N], poses_cw f32[N,7] world->camera)."""
    ts, poses_wc = [], []
    for p in _lines(path):
        v = [float(x) for x in p]
        ts.append(v[0])
        tx, ty, tz, qx, qy, qz, qw = v[1:8]
        poses_wc.append([qw, qx, qy, qz, tx, ty, tz])
    poses_wc = np.asarray(poses_wc, np.float32).reshape(-1, 7)
    return np.asarray(ts), se3.inverse(torch.from_numpy(poses_wc)).numpy()
