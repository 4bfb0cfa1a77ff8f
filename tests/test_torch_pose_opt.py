"""Port parity: pose-only LM against the JAX package, and the analytic
Jacobian against automatic differentiation.

The JAX parity goes through `pose_optimize_plain`, the plain version of
kernel K4; `pose_optimize` on CPU tensors is that same plain version (on
CUDA tensors it launches K4, held against the plain version on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py). The plain version runs
in K4's schedule (one evaluation an iteration, at the candidate); the
two-pass loop it restructures is kept below as a reference, and the two
must give the same bits.

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


def _two_pass_reference(pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid,
                        cam, rounds, iters_per_round):
    """The LM loop in its earlier schedule: H and g at the current pose,
    then the cost at the candidate, in every iteration of a fixed loop with
    a frozen-state mask; reclassification and the final cost in passes of
    their own. Also returns the steps refused before a round's `done`."""
    has_ur = obs_ur > 0
    obs_uvr = torch.cat([obs_uv, torch.where(has_ur, obs_ur,
                                             torch.zeros_like(obs_ur))[..., None]],
                        dim=-1)
    chi2_th = torch.where(has_ur, torch.full_like(obs_ur, tpo.CHI2_STEREO),
                          torch.full_like(obs_ur, tpo.CHI2_MONO))
    huber_delta = torch.sqrt(chi2_th)
    eye6 = torch.eye(6, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    def huber(chi2, use_huber):
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        if not use_huber:
            return torch.ones_like(s)
        return torch.where(s > huber_delta, huber_delta / s,
                           torch.ones_like(s))

    pose, inliers, refused = pose0, valid, 0
    for round_idx in range(rounds):
        use_huber = round_idx < 2
        lam = torch.full((), 1e-3, dtype=torch.float32)
        done = torch.zeros((), dtype=torch.bool)
        active = valid & inliers
        for _ in range(iters_per_round):
            r, xc = tpo._residuals(pose, pts_w, obs_uvr, has_ur, cam)
            J = tpo.residual_jacobian(xc, has_ur, cam)
            chi2 = chi2_of(r)
            w_huber = huber(chi2, use_huber)
            w = torch.where(active, inv_sigma2 * w_huber, zero)
            JW = J * w[:, None, None]
            H = torch.einsum("nij,nik->jk", JW, J)
            g = torch.einsum("nij,ni->j", JW, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            delta = -torch.linalg.solve_ex(Hd, g)[0]
            new_pose = tse3.retract(pose, delta)
            r_new, _ = tpo._residuals(new_pose, pts_w, obs_uvr, has_ur, cam)
            cost_old = torch.sum(torch.where(active, chi2 * w_huber, zero))
            chi2n = chi2_of(r_new)
            cost_new = torch.sum(torch.where(
                active, chi2n * huber(chi2n, use_huber), zero))
            improved = cost_new < cost_old
            refused += int(~improved & ~done)
            step_inf = torch.amax(torch.abs(delta))
            rel_gain = (cost_old - cost_new) / torch.clamp(cost_old, min=1e-12)
            done_now = ((improved & ((rel_gain < 1e-5) | (step_inf < 1e-5)))
                        | (~improved & (lam >= 1e6)))
            take = improved & ~done
            pose = torch.where(take, new_pose, pose)
            lam_out = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                                  1e-8, 1e6)
            lam = torch.where(done, lam, lam_out)
            done = done | done_now
        r, _ = tpo._residuals(pose, pts_w, obs_uvr, has_ur, cam)
        inliers = valid & (chi2_of(r) <= chi2_th)
    r, _ = tpo._residuals(pose, pts_w, obs_uvr, has_ur, cam)
    final_cost = torch.sum(torch.where(inliers, chi2_of(r), zero))
    return (tpo.PoseOptResult(pose, inliers, inliers.sum(dtype=torch.int32),
                              final_cost), refused)


@pytest.mark.parametrize("seed,rounds,iters,kick", [
    (0, 4, 5, 0.0), (1, 2, 5, 0.0), (2, 4, 10, 0.0),
    # a start far from the optimum: the first steps overshoot and are refused
    (5, 4, 10, 0.3)])
def test_plain_schedule_is_the_two_pass_loop_bit_for_bit(seed, rounds, iters,
                                                         kick):
    args, _ = _problem(seed)
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if kick:
        t_args[0] = tse3.retract(t_args[0], torch.tensor(
            [kick, -kick, kick, 3 * kick, -3 * kick, 3 * kick]))
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    out = tpo.pose_optimize_plain(*t_args, tc, rounds=rounds,
                                  iters_per_round=iters)
    ref, refused = _two_pass_reference(*t_args, tc, rounds, iters)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), (a, b)
    if kick:
        assert refused > 0


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
