"""Port parity: SE(3) algebra and camera projection against the JAX package.

Inputs are made with numpy from a seed and handed to both; tolerances are
f32 rounding (the two packages evaluate the same formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import projection as jproj
from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.geometry import se3 as tse3

torch.set_num_threads(1)
TOL = 2e-5


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    tang = np.concatenate([rng.normal(0, 0.7, (n, 3)),
                           rng.normal(0, 1.5, (n, 3))], -1).astype(np.float32)
    return np.asarray(jse3.exp(jnp.asarray(tang))), tang


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("op", ["compose", "inverse", "transform", "exp",
                                "log", "retract", "to_from_matrix"])
def test_se3_matches_jax(op):
    pa, tang = _poses(64, 0)
    pb, _ = _poses(64, 1)
    pts = np.random.default_rng(2).normal(0, 3, (64, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(pa), torch.from_numpy(pb)
    ja, jb = jnp.asarray(pa), jnp.asarray(pb)
    if op == "compose":
        _close(jse3.compose(ja, jb), tse3.compose(ta, tb))
    elif op == "inverse":
        _close(jse3.inverse(ja), tse3.inverse(ta))
    elif op == "transform":
        _close(jse3.transform(ja, jnp.asarray(pts)),
               tse3.transform(ta, torch.from_numpy(pts)), 1e-4)
        # one pose against a point cloud (the matchers' broadcast)
        _close(jse3.transform(ja[0], jnp.asarray(pts)),
               tse3.transform(ta[0], torch.from_numpy(pts)), 1e-4)
    elif op == "exp":
        _close(jse3.exp(jnp.asarray(tang)), tse3.exp(torch.from_numpy(tang)))
        small = (tang * 1e-7).astype(np.float32)
        _close(jse3.exp(jnp.asarray(small)), tse3.exp(torch.from_numpy(small)))
    elif op == "log":
        _close(jse3.log(ja), tse3.log(ta), 1e-4)
    elif op == "retract":
        d = (tang * 0.01).astype(np.float32)
        _close(jse3.retract(ja, jnp.asarray(d)),
               tse3.retract(ta, torch.from_numpy(d)))
    else:
        R = np.asarray(jse3.quat_to_matrix(ja[:, :4]))
        _close(jse3.quat_to_matrix(ja[:, :4]), tse3.quat_to_matrix(ta[:, :4]))
        _close(jse3.quat_from_matrix(jnp.asarray(R)),
               tse3.quat_from_matrix(torch.from_numpy(R)))


def test_projection_matches_jax():
    rng = np.random.default_rng(3)
    xc = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                   rng.uniform(0.3, 6, 200)], -1).astype(np.float32)
    xc[0, 2] = 0.0  # the |z| < 1e-9 clamp
    jc = jproj.CameraIntrinsics.create(520.0, 521.0, 320.0, 240.0, 41.6)
    tc = tproj.CameraIntrinsics.create(520.0, 521.0, 320.0, 240.0, 41.6)
    _close(jproj.project(jc, jnp.asarray(xc)),
           tproj.project(tc, torch.from_numpy(xc)), 1e-2)
    _close(jproj.project_stereo(jc, jnp.asarray(xc[1:])),
           tproj.project_stereo(tc, torch.from_numpy(xc[1:])), 1e-3)
    uv = rng.uniform(0, 640, (100, 2)).astype(np.float32)
    d = rng.uniform(0.5, 5, 100).astype(np.float32)
    _close(jproj.unproject(jc, jnp.asarray(uv), jnp.asarray(d)),
           tproj.unproject(tc, torch.from_numpy(uv), torch.from_numpy(d)), 1e-5)


def test_undistort_matches_jax():
    coeffs = (-0.28, 0.07, 0.0002, 0.00002, 0.0)
    rng = np.random.default_rng(4)
    uv = rng.uniform(0, 640, (300, 2)).astype(np.float32)
    jc = jproj.CameraIntrinsics.create(458.0, 457.0, 367.0, 248.0)
    tc = tproj.CameraIntrinsics.create(458.0, 457.0, 367.0, 248.0)
    out_j = jproj.undistort_points(jc, jproj.DistCoeffs.create(*coeffs),
                                   jnp.asarray(uv))
    out_t = tproj.undistort_points(tc, tproj.DistCoeffs.create(*coeffs),
                                   torch.from_numpy(uv))
    _close(out_j, out_t, 1e-3)
    assert tproj.image_bounds_np(458.0, 457.0, 367.0, 248.0, coeffs, 752,
                                 480) == jproj.image_bounds_np(
        458.0, 457.0, 367.0, 248.0, coeffs, 752, 480)


def test_projection_rounds_as_jax_compiled():
    """`project` and `project_stereo` are bit-equal to JAX's jitted ones on
    the CPU, where XLA fuses `fx * x * inv_z + cx` and `u - bf * inv_z`
    into multiply-adds: 50,000 points from a seed, and a point on cell E's
    motion-model window edge (u = 59.000004 in JAX; rounding the product
    first gives 59.0, which matched two more features at frame 1)."""
    jc = jproj.CameraIntrinsics.create(260.0, 260.0, 160.0, 120.0, 20.8)
    tc = tproj.CameraIntrinsics.create(260.0, 260.0, 160.0, 120.0, 20.8)
    rng = np.random.default_rng(5)
    n = 50000
    xc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(0.3, 6, n)], -1).astype(np.float32)
    edge = np.array([3214978127, 0, 1078906516], np.uint32).view(np.float32)
    xc = np.concatenate([xc, edge[None]])
    for jfn, tfn in ((jproj.project, tproj.project),
                     (jproj.project_stereo, tproj.project_stereo)):
        want = np.asarray(jax.jit(lambda x, f=jfn: f(jc, x))(
            jnp.asarray(xc)))
        np.testing.assert_array_equal(tfn(tc, torch.from_numpy(xc)).numpy(),
                                      want)
    assert want[-1, 0] == np.float32(59.000004)
    x = torch.from_numpy(edge)
    assert float(260.0 * x[0] * (1.0 / x[2]) + 160.0) == 59.0
