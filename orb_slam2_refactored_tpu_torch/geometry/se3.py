"""SE(3) rigid transforms as quaternion + translation tensors.

Port of `orb_slam2_refactored_tpu/geometry/se3.py`: poses are flat f32
tensors `[qw, qx, qy, qz, tx, ty, tz]`, every op broadcasts over leading
axes, and the tangent order is `[omega, upsilon]`. A pose `T = (q, t)` maps
points `x -> q * x * q^-1 + t`; camera poses are world-to-camera (`Tcw`).
"""

from __future__ import annotations

import torch

POSE_DIM = 7
TANGENT_DIM = 6


def identity(batch_shape=(), device=None) -> torch.Tensor:
    p = torch.zeros(tuple(batch_shape) + (POSE_DIM,), dtype=torch.float32,
                    device=device)
    p[..., 0] = 1.0
    return p


# ---------------------------------------------------------------------------
# Quaternion primitives (wxyz, Hamilton convention)
# ---------------------------------------------------------------------------

def _norm(x, keepdim=False):
    # sqrt(sum(x*x)) like jnp.linalg.norm (torch.linalg.norm rescales)
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def quat_normalize(q):
    return q / torch.clamp(_norm(q, keepdim=True), min=1e-12)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate 3-vectors v by unit quaternions q (broadcasting)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(m):
    """Rotation matrix -> quaternion (Shepperd's method, branchless)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0 + 1e-12),
                      (m02 - m20) / (4 * qw0 + 1e-12),
                      (m10 - m01) / (4 * qw0 + 1e-12)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack([(m21 - m12) / (4 * qx1 + 1e-12), qx1,
                      (m01 + m10) / (4 * qx1 + 1e-12),
                      (m02 + m20) / (4 * qx1 + 1e-12)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack([(m02 - m20) / (4 * qy2 + 1e-12),
                      (m01 + m10) / (4 * qy2 + 1e-12), qy2,
                      (m12 + m21) / (4 * qy2 + 1e-12)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack([(m10 - m01) / (4 * qz3 + 1e-12),
                      (m02 + m20) / (4 * qz3 + 1e-12),
                      (m12 + m21) / (4 * qz3 + 1e-12), qz3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE3 ops on [...,7] tensors
# ---------------------------------------------------------------------------

def make(q, t):
    return torch.cat([q, t], dim=-1)


def rotation(p):
    return p[..., 0:4]


def translation(p):
    return p[..., 4:7]


def compose(a, b):
    """Return a @ b (apply b first, then a)."""
    q = quat_mul(rotation(a), rotation(b))
    t = quat_rotate(rotation(a), translation(b)) + translation(a)
    return make(quat_normalize(q), t)


def inverse(p):
    qi = quat_conj(rotation(p))
    return make(qi, -quat_rotate(qi, translation(p)))


def to_matrix(p):
    """[...,7] -> [...,4,4] homogeneous matrix."""
    r = quat_to_matrix(rotation(p))
    top = torch.cat([r, translation(p)[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=p.dtype,
                          device=p.device).expand(p.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _bcast(field, x):
    """Broadcast a pose field [...,k] against points [..., N, 3] if needed."""
    if field.ndim == x.ndim:
        return field
    return field[..., None, :]


def transform(p, x):
    """Apply pose to 3D points x[...,3] (broadcasting over leading dims)."""
    return quat_rotate(_bcast(rotation(p), x), x) + _bcast(translation(p), x)


# ---------------------------------------------------------------------------
# so(3)/se(3) exp & log — tangent order [omega, upsilon]
# ---------------------------------------------------------------------------

def _so3_exp_quat(omega):
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    small = theta2 < 1e-12
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return quat_normalize(torch.cat([w, k * omega], dim=-1))


def _so3_log(q):
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vnorm = _norm(v, keepdim=True)
    theta = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-6
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                    theta / torch.clamp(vnorm, min=1e-24))
    return k * v


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _left_jacobian(omega):
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = _skew(omega)
    KK = K @ K
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    small = theta2 < 1e-12
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta2 * theta, min=1e-24))
    return eye + a * K + b * KK


def _left_jacobian_inv(omega):
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = _skew(omega)
    KK = K @ K
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    small = theta2 < 1e-12
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta)
         / torch.clamp(torch.sin(half_theta), min=1e-24))
        / torch.clamp(theta2, min=1e-24),
    )
    return eye - 0.5 * K + cot_term * KK


def exp(tangent):
    """se(3) exp: [...,6] ([omega, upsilon]) -> pose [...,7]."""
    omega = tangent[..., 0:3]
    ups = tangent[..., 3:6]
    q = _so3_exp_quat(omega)
    V = _left_jacobian(omega)
    t = (V @ ups[..., :, None])[..., 0]
    return make(q, t)


def log(p):
    """Pose [...,7] -> se(3) tangent [...,6]."""
    omega = _so3_log(rotation(p))
    Vinv = _left_jacobian_inv(omega)
    ups = (Vinv @ translation(p)[..., :, None])[..., 0]
    return torch.cat([omega, ups], dim=-1)


def retract(p, delta):
    """Left-multiplicative LM update: exp(delta) @ p."""
    return compose(exp(delta), p)
