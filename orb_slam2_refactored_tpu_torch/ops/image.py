"""Image-space primitives: grayscale, pyramid resize, Gaussian blur.

Port of `orb_slam2_refactored_tpu/ops/image.py`.

The pyramid resize reproduces `jax.image.resize(method="linear")`, which
low-pass filters when it downsamples: a triangle kernel stretched by the
downsampling factor. `F.interpolate(mode="bilinear", antialias=False)` is
not that function (it is off by tens of gray levels), so each axis here is
one product with the same f32 weight matrix that JAX builds
(`jax/_src/image/scale.py::compute_weight_mat`); only the summation order
of the two products differs from XLA's.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def to_gray(img):
    """RGB[H,W,3] (or gray[H,W]) uint8/float tensor -> float32 gray [H,W]."""
    if img.ndim == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                         device=img.device)
        img = torch.tensordot(img.to(torch.float32), w, dims=([-1], [0]))
    return img.to(torch.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """f32[in, out] linear-resize weights, computed in f32 step by step as
    `compute_weight_mat(..., kernel=triangle, antialias=True)` does once
    XLA has compiled it: the sample position is one fused multiply-add and
    the kernel-scale division a multiply by its reciprocal. (Written as in
    the JAX source instead, the weights differ by up to 2e-5, which moves
    upper-level FAST responses and reorders keypoints.)"""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    pos = np.arange(out_size, dtype=f32) + f32(0.5)
    sample_f = (pos.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    d = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    x = d * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > f32(1000.0) * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img, out_hw: Tuple[int, int]):
    """Linear resize of a [H,W] float image (antialiased when shrinking)."""
    h, w = img.shape
    oh, ow = out_hw
    out = img
    if oh != h:
        wh = torch.as_tensor(_resize_weights_np(h, oh), device=img.device)
        out = wh.T @ out
    if ow != w:
        ww = torch.as_tensor(_resize_weights_np(w, ow), device=img.device)
        out = out @ ww
    return out


def pyramid_shapes(h: int, w: int, n_levels: int,
                   scale_factor: float) -> List[Tuple[int, int]]:
    shapes = []
    for l in range(n_levels):
        s = scale_factor ** l
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


def build_pyramid(img, n_levels: int, scale_factor: float):
    """List of per-level images, level 0 = input resolution; each level is
    resized from the previous one, like the reference's cascade."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _gaussian_pass(p, k, n: int, dim: int):
    """One 7-tap pass along `dim` of the padded image `p`, giving `n`
    samples: the taps' products rounded one by one and added in tap order
    (no fused multiply-add), the order kernel K7 (`csrc/orb_desc_learned.cu`)
    sums them in, so the two agree bit for bit."""
    acc = k[0] * p.narrow(dim, 0, n)
    for t in range(1, k.shape[0]):
        acc = acc + k[t] * p.narrow(dim, t, n)
    return acc


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur of an f32 [H,W] image, borders mirrored
    without repeating the edge (`jnp.pad(mode="reflect")`: -1 -> 1): a
    horizontal, then a vertical pass. The pre-descriptor blur of the
    reference (GaussianBlur(7,7,2,2), `src/ORBextractor.cc:791`)."""
    k = torch.as_tensor(_gaussian_kernel(ksize, sigma), device=img.device)
    r = ksize // 2
    h, w = img.shape
    p = torch.nn.functional.pad(img[None, None].to(torch.float32),
                                (r, r, r, r), mode="reflect")[0, 0]
    return _gaussian_pass(_gaussian_pass(p, k, w, 1), k, h, 0)
