"""Dataset readers: TUM RGB-D, KITTI odometry, EuRoC MAV.

Port of `orb_slam2_refactored_tpu/io/datasets.py`, the reference's example
drivers' readers (`Examples/{Monocular,Stereo,RGB-D}/*.cc`): sequence
discovery, timestamp parsing and image loading. Images load through the
port's own PNG reader (`io/png.py`), as float32 gray as the JAX package's
`cv2.imread(..., IMREAD_GRAYSCALE)` gives them; depth images stay in their
raw sensor units. Each reader yields `(timestamp, images...)` lazily.

Not ported: `EurocRectifier` (`cv2.initUndistortRectifyMap` and
`cv2.remap`); `euroc_stereo_sequence` reads raw, already rectified pairs.
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


def euroc_stereo_sequence(
    seq_dir: str, timestamps_file: str, rectifier=None
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """stereo_euroc.cc: mav0/cam0/data and cam1/data by timestamp file, the
    pairs as they are (they must be rectified already). A `rectifier` (the
    settings' LEFT./RIGHT. blocks) raises: it is not ported."""
    if rectifier is not None:
        raise NotImplementedError(
            "io/datasets.py::EurocRectifier (cv2.initUndistortRectifyMap and "
            "cv2.remap) is not ported; pass rectified pairs")
    for s in _euroc_stamps(timestamps_file):
        t = float(s) / 1e9
        l = _imread_gray(os.path.join(seq_dir, "mav0", "cam0", "data",
                                      s + ".png"))
        r = _imread_gray(os.path.join(seq_dir, "mav0", "cam1", "data",
                                      s + ".png"))
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
