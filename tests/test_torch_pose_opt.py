"""Port parity: pose-only LM against the JAX package, and the analytic
Jacobian against automatic differentiation.

The JAX parity goes through `pose_optimize_plain`, the plain version of
kernel K4; `pose_optimize` on CPU tensors is that same plain version (on
CUDA tensors it launches K4, held against the plain version on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py).

Tolerance: the optimized pose within 1e-4 m / 1e-4 rad of JAX's on the same
inputs (f32 arithmetic in another order; the analytic Jacobian replaces
jacfwd), inlier sets equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import projection as jproj
from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.optim import pose_opt as jpo
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.geometry import se3 as tse3
from orb_slam2_refactored_tpu_torch.optim import pose_opt as tpo

torch.set_num_threads(1)
FX, CX, CY, BF = 260.0, 160.0, 120.0, 20.8


def _problem(seed, n=400, outliers=0.15):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(1.0, 5.0, n)], -1).astype(np.float32)
    gt = np.asarray(jse3.exp(jnp.asarray(
        rng.normal(0, [0.05, 0.05, 0.05, 0.1, 0.1, 0.1]).astype(np.float32))))
    xc = np.asarray(jse3.transform(jnp.asarray(gt), jnp.asarray(pts)))
    uvr = np.stack([FX * xc[:, 0] / xc[:, 2] + CX, FX * xc[:, 1] / xc[:, 2] + CY,
                    FX * xc[:, 0] / xc[:, 2] + CX - BF / xc[:, 2]], -1)
    uvr += rng.normal(0, 0.7, uvr.shape)
    bad = rng.uniform(size=n) < outliers
    uvr[bad, :2] += rng.uniform(-40, 40, (bad.sum(), 2))
    obs_ur = np.where(rng.uniform(size=n) < 0.7, uvr[:, 2], -1.0)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    pose0 = np.asarray(jse3.compose(jse3.exp(jnp.asarray(
        rng.normal(0, 0.02, 6).astype(np.float32))), jnp.asarray(gt)))
    return (pose0, pts, uvr[:, :2].astype(np.float32),
            obs_ur.astype(np.float32), inv_s2, valid), gt


@pytest.mark.parametrize("seed,rounds,iters", [(0, 4, 5), (1, 2, 5),
                                               (2, 4, 10)])
def test_pose_optimize_matches_jax(seed, rounds, iters):
    args, gt = _problem(seed)
    jc = jproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    ref = jpo.pose_optimize(*(jnp.asarray(a) for a in args), jc,
                            rounds=rounds, iters_per_round=iters)
    out = tpo.pose_optimize_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), tc,
        rounds=rounds, iters_per_round=iters)
    d = np.asarray(jse3.log(jse3.compose(
        jnp.asarray(out.pose.numpy()), jse3.inverse(ref.pose))))
    assert np.abs(d[:3]).max() <= 1e-4 and np.abs(d[3:]).max() <= 1e-4, d
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert int(out.num_inliers) == int(ref.num_inliers) > 250
    # and the optimum is the truth to within the noise
    assert np.abs(out.pose.numpy()[4:] - gt[4:]).max() < 0.02


def test_pose_optimize_on_cpu_is_the_plain_version():
    from orb_slam2_refactored_tpu_torch import kernels

    args, _ = _problem(4)
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    before = kernels.counts()["pose_lm"]
    out = tpo.pose_optimize(*t_args, tc, rounds=4, iters_per_round=5)
    ref = tpo.pose_optimize_plain(*t_args, tc, rounds=4, iters_per_round=5)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert kernels.counts()["pose_lm"] == before  # no kernel launched


def test_analytic_jacobian_matches_jacfwd():
    rng = np.random.default_rng(3)
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    pose = tse3.exp(torch.from_numpy(rng.normal(0, 0.3, 6).astype(np.float32)))
    pts = torch.from_numpy(np.stack(
        [rng.uniform(-2, 2, 50), rng.uniform(-1, 1, 50),
         rng.uniform(1, 5, 50)], -1).astype(np.float32))
    has_ur = torch.from_numpy(rng.uniform(size=50) > 0.5)

    def r_of_delta(delta):
        xc = tse3.transform(tse3.retract(pose, delta), pts)
        r = -tproj.project_stereo(tc, xc)
        return torch.cat([r[:, :2], torch.where(has_ur, r[:, 2],
                                                torch.zeros_like(r[:, 2]))[:, None]],
                         -1)

    auto = torch.func.jacfwd(r_of_delta)(torch.zeros(6))  # [N,3,6]
    xc = tse3.transform(pose, pts)
    ana = tpo.residual_jacobian(xc, has_ur, tc)
    err = (ana - auto).abs().max() / auto.abs().max()
    assert err < 1e-4, float(err)
