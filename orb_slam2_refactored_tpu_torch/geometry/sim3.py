"""Sim(3) similarity transforms as quaternion + translation + scale tensors.

Port of `orb_slam2_refactored_tpu/geometry/sim3.py`. Layout: f32[..., 8] =
`[qw, qx, qy, qz, tx, ty, tz, log_s]`; the scale is stored in log space so
the 7-DoF pose-graph tangent is `[omega, upsilon, dlog_s]`. A similarity
maps `x -> s * R x + t`.
"""

from __future__ import annotations

import torch

from . import se3

DIM = 8
TANGENT_DIM = 7


def identity(batch_shape=(), device=None) -> torch.Tensor:
    g = torch.zeros(tuple(batch_shape) + (DIM,), dtype=torch.float32,
                    device=device)
    g[..., 0] = 1.0
    return g


def make(q, t, s):
    """`s` is the linear scale [...] (not its log)."""
    return torch.cat([q, t, torch.log(s)[..., None]], dim=-1)


def rotation(g):
    return g[..., 0:4]


def translation(g):
    return g[..., 4:7]


def scale(g):
    return torch.exp(g[..., 7])


def log_scale(g):
    return g[..., 7]


def from_se3(p, s=None):
    ls = (torch.zeros(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
          if s is None else torch.log(s)[..., None])
    return torch.cat([p, ls], dim=-1)


def to_se3(g):
    """Drop the scale: the translation is divided by s (the reference's
    `Correct` rescaling)."""
    s = scale(g)[..., None]
    return se3.make(rotation(g), translation(g) / s)


def transform(g, x):
    s = scale(g)
    if x.ndim > g.ndim:
        s = s[..., None]
        q = rotation(g)[..., None, :]
        t = translation(g)[..., None, :]
    else:
        q = rotation(g)
        t = translation(g)
    return s[..., None] * se3.quat_rotate(q, x) + t


def compose(a, b):
    """a @ b: x -> sa Ra (sb Rb x + tb) + ta."""
    q = se3.quat_mul(rotation(a), rotation(b))
    sa = scale(a)
    t = (sa[..., None] * se3.quat_rotate(rotation(a), translation(b))
         + translation(a))
    ls = log_scale(a) + log_scale(b)
    return torch.cat([se3.quat_normalize(q), t, ls[..., None]], dim=-1)


def inverse(g):
    qi = se3.quat_conj(rotation(g))
    # 1 / s, as `reciprocal`: `1.0 / t` of a 0-d tensor gives an f64
    # tangent under torch.func.jacfwd
    si = torch.reciprocal(scale(g))
    t = -si[..., None] * se3.quat_rotate(qi, translation(g))
    return torch.cat([qi, t, -log_scale(g)[..., None]], dim=-1)


def exp(tangent):
    """Sim(3) exp with first-order coupling, as the JAX package's: rotation
    and scale exact, the translation through the SE(3) left Jacobian."""
    p = se3.exp(tangent[..., 0:6])
    return torch.cat([p, tangent[..., 6:7]], dim=-1)


def retract(g, delta):
    return compose(exp(delta), g)


def log(g):
    p = se3.log(g[..., 0:7])
    return torch.cat([p, log_scale(g)[..., None]], dim=-1)
