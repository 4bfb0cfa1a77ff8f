"""Pinhole projection / unprojection and radial-tangential distortion.

Port of `orb_slam2_refactored_tpu/geometry/projection.py`. Intrinsics are
plain Python floats rounded to f32 (the JAX package holds them as f32
scalars), so they enter every tensor op as f32 constants on any device.

`project` and `project_stereo` round as the JAX package's compiled code
does on the CPU, where XLA fuses `fx * x * inv_z + cx` and
`u - bf * inv_z` into fused multiply-adds: the last product and the sum
are rounded once (`_fma`). Rounding the product first parts from JAX on
about a quarter of random points, and a point on a search window's edge
then changes a match.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


class CameraIntrinsics(NamedTuple):
    """Pinhole intrinsics. `bf` = baseline * fx (0 for monocular)."""

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float

    @staticmethod
    def create(fx, fy, cx, cy, bf=0.0) -> "CameraIntrinsics":
        return CameraIntrinsics(_f32(fx), _f32(fy), _f32(cx), _f32(cy),
                                _f32(bf))


class DistCoeffs(NamedTuple):
    """OpenCV-style radial-tangential distortion [k1,k2,p1,p2,k3]."""

    k1: float
    k2: float
    p1: float
    p2: float
    k3: float

    @staticmethod
    def create(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0) -> "DistCoeffs":
        return DistCoeffs(_f32(k1), _f32(k2), _f32(p1), _f32(p2), _f32(k3))


def _inv_z(z):
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _fma(a, b, c):
    """`a * b + c` rounded once, as a fused multiply-add: for an f32
    tensor `a` (and f32 `b`, `c`, tensors or Python floats holding f32
    values) the product is exact in f64, the sum is rounded there and the
    result once to f32 (bit-equal to XLA's fused code on the CPU over 200,000
    random points); other dtypes round as they are."""
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b + c).to(torch.float32)


def project(cam: CameraIntrinsics, xc):
    """Camera-frame points [...,3] -> pixel coords [...,2] (no distortion)."""
    inv_z = _inv_z(xc[..., 2])
    u = _fma(cam.fx * xc[..., 0], inv_z, cam.cx)
    v = _fma(cam.fy * xc[..., 1], inv_z, cam.cy)
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: CameraIntrinsics, xc):
    """Camera-frame points -> [u, v, u_right]."""
    uv = project(cam, xc)
    inv_z = _inv_z(xc[..., 2])
    ur = _fma(inv_z, -cam.bf, uv[..., 0])
    return torch.cat([uv, ur[..., None]], dim=-1)


def unproject(cam: CameraIntrinsics, uv, depth):
    """Pixels [...,2] + depth [...] -> camera-frame 3D points [...,3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def undistort_points(cam: CameraIntrinsics, dist: DistCoeffs, uv,
                     iters: int = 8):
    """Iteratively invert the distortion model (cv::undistortPoints analog)."""
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + dist.k1 * r2 + dist.k2 * r2 * r2 + dist.k3 * r2 * r2 * r2
        dx = 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
        dy = dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], dim=-1)


def undistort_points_np(fx, fy, cx, cy, coeffs, uv, iters: int = 8):
    """Host (numpy, f64) undistortion for static quantities (image bounds)."""
    k1, k2, p1, p2, k3 = coeffs
    uv = np.asarray(uv, np.float64)
    xn0 = np.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    xn = xn0.copy()
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = np.stack([(xn0[..., 0] - dx) / radial,
                       (xn0[..., 1] - dy) / radial], -1)
    return np.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], -1)


def image_bounds_np(fx, fy, cx, cy, coeffs, width: int, height: int):
    """Undistorted image bounds from the 4 corners, as Python floats
    (min_x, max_x, min_y, max_y)."""
    corners = np.array(
        [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]]
    )
    und = undistort_points_np(fx, fy, cx, cy, coeffs, corners)
    return (
        float(min(und[0, 0], und[2, 0])), float(max(und[1, 0], und[3, 0])),
        float(min(und[0, 1], und[1, 1])), float(max(und[2, 1], und[3, 1])),
    )
