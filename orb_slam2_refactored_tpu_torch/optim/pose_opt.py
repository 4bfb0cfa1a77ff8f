"""Pose-only optimization: Levenberg-Marquardt on SE(3) with outlier rounds.

Port of `orb_slam2_refactored_tpu/optim/pose_opt.py`: 4 rounds of LM,
Huber kernel (first two rounds) with delta = sqrt(5.991) mono /
sqrt(7.815) stereo, chi2 outlier re-classification after every round,
dense 6x6 normal equations. Two changes of form, not of result:

- the data-dependent `while_loop` becomes a fixed `iters_per_round` loop
  with a frozen-state mask: once an iteration reports `done`, pose and
  lambda stay as they are, so no iteration count is read back to the host;
- `jacfwd` of the retraction becomes the analytic 3x6 Jacobian of
  `project_stereo(transform(retract(pose, d), x))` at d = 0.

f32 throughout; the normal equations are f32 products (TF32 is never
enabled for them), as the JAX code forces "highest" precision.

`pose_optimize` runs kernel K4 (`csrc/pose_lm.cu`, one launch a call) on
CUDA tensors and `pose_optimize_plain` on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..geometry import projection as proj
from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    pose: torch.Tensor         # f32[7]
    inliers: torch.Tensor      # bool[N]
    num_inliers: torch.Tensor  # i32 scalar
    final_cost: torch.Tensor   # f32 scalar


def _residuals(pose, pts_w, obs_uvr, has_ur, cam):
    """r[N,3] = observation - prediction; third row masked for mono."""
    xc = se3.transform(pose, pts_w)
    r = obs_uvr - proj.project_stereo(cam, xc)
    r = torch.cat([r[..., :2], torch.where(has_ur, r[..., 2],
                                           torch.zeros_like(r[..., 2]))[..., None]],
                  dim=-1)
    return r, xc


def residual_jacobian(xc, has_ur, cam):
    """J[N,3,6] = d r / d delta at delta = 0 for r = obs - project_stereo(
    transform(exp(delta) @ pose, x)), tangent order [omega, upsilon].

    The left update moves a camera-frame point by d xc = -[xc]_x omega +
    upsilon, and the projection's derivative is that of u = fx X/Z + cx,
    v = fy Y/Z + cy, u_r = u - bf/Z."""
    X, Y, Z = xc[..., 0], xc[..., 1], xc[..., 2]
    small = torch.abs(Z) < 1e-9
    iz = 1.0 / torch.where(small, torch.full_like(Z, 1e-9), Z)
    # d(1/z)/dz; zero where the projection clamps z
    diz = torch.where(small, torch.zeros_like(Z), -iz * iz)
    zero = torch.zeros_like(Z)
    # d pred / d xc  [N,3,3]
    du = torch.stack([cam.fx * iz, zero, cam.fx * X * diz], -1)
    dv = torch.stack([zero, cam.fy * iz, cam.fy * Y * diz], -1)
    dur = torch.stack([cam.fx * iz, zero, cam.fx * X * diz - cam.bf * diz], -1)
    dur = torch.where(has_ur[..., None], dur, torch.zeros_like(dur))
    dpred = torch.stack([du, dv, dur], dim=-2)
    # d xc / d delta  [N,3,6] = [-[xc]_x | I]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape[:-1] + (3, 3))
    dxc = torch.cat([-se3._skew(xc), eye], dim=-1)
    return -(dpred @ dxc)


def pose_optimize(pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid,
                  cam: proj.CameraIntrinsics, rounds: int = 4,
                  iters_per_round: int = 10) -> PoseOptResult:
    """Optimize a world->camera pose against matched 3D points.

    pts_w: f32[N,3]; obs_uv: f32[N,2]; obs_ur: f32[N] (<0 = mono
    observation); inv_sigma2: f32[N]; valid: bool[N]. The JAX package's
    `_pose_optimize_f32` under "highest" matmul precision.
    CUDA tensors -> kernel `csrc/pose_lm.cu`; CPU -> plain version."""
    if not pose0.is_cuda:
        return pose_optimize_plain(pose0, pts_w, obs_uv, obs_ur, inv_sigma2,
                                   valid, cam, rounds, iters_per_round)
    return _pose_lm(pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid, cam,
                    rounds, iters_per_round, None)


def pose_lm_work(pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid,
                 cam: proj.CameraIntrinsics, rounds: int = 4,
                 iters_per_round: int = 10) -> torch.Tensor:
    """Kernel K4's own account of one call on CUDA tensors: i32[rounds, 2],
    each round's iterations run before `done` froze its state and its
    active observations. This is the data-dependent work that a bound on
    the call counts; the tracking path never asks for it."""
    work = torch.empty((rounds, 2), dtype=torch.int32, device=pose0.device)
    _pose_lm(pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid, cam, rounds,
             iters_per_round, work)
    return work


def _pose_lm(pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid, cam, rounds,
             iters_per_round, work) -> PoseOptResult:
    N = pts_w.shape[0]
    args = [t.contiguous() for t in (pose0, pts_w, obs_uv, obs_ur,
                                     inv_sigma2, valid)]
    for t, what, dtype, shape in zip(
            args, ("pose0", "pts_w", "obs_uv", "obs_ur", "inv_sigma2",
                   "valid"),
            (torch.float32,) * 5 + (torch.bool,),
            ((7,), (N, 3), (N, 2), (N,), (N,), (N,))):
        kernels.require(t, "pose_lm " + what, dtype, shape)
    dev = pose0.device
    pose = torch.empty((7,), dtype=torch.float32, device=dev)
    inliers = torch.empty((N,), dtype=torch.bool, device=dev)
    num = torch.empty((), dtype=torch.int32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    fn = kernels.bind("pose_lm", "pose_lm",
                      [kernels.VP] * 6 + [kernels.CI] + [kernels.CF] * 5
                      + [kernels.CI] * 2 + [kernels.VP] * 6)
    kernels.LAUNCHES["pose_lm"] += 1
    kernels.check(fn(*(kernels.ptr(t) for t in args), N, cam.fx, cam.fy,
                     cam.cx, cam.cy, cam.bf, int(rounds), int(iters_per_round),
                     kernels.ptr(pose), kernels.ptr(inliers), kernels.ptr(num),
                     kernels.ptr(cost),
                     None if work is None else kernels.ptr(work),
                     kernels.stream_of(pose0)), "pose_lm")
    return PoseOptResult(pose=pose, inliers=inliers, num_inliers=num,
                         final_cost=cost)


def pose_optimize_plain(pose0, pts_w, obs_uv, obs_ur, inv_sigma2, valid,
                        cam: proj.CameraIntrinsics, rounds: int = 4,
                        iters_per_round: int = 10) -> PoseOptResult:
    """Plain PyTorch version of kernel K4 (same signature)."""
    dev = pose0.device
    has_ur = obs_ur > 0
    obs_uvr = torch.cat([obs_uv, torch.where(has_ur, obs_ur,
                                             torch.zeros_like(obs_ur))[..., None]],
                        dim=-1)
    chi2_th = torch.where(has_ur, torch.full_like(obs_ur, CHI2_STEREO),
                          torch.full_like(obs_ur, CHI2_MONO))
    huber_delta = torch.sqrt(chi2_th)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    def huber(chi2, use_huber):
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        if not use_huber:
            return torch.ones_like(s)
        return torch.where(s > huber_delta, huber_delta / s,
                           torch.ones_like(s))

    pose = pose0
    inliers = valid
    for round_idx in range(rounds):
        use_huber = round_idx < 2
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        active = valid & inliers
        for _ in range(iters_per_round):
            r, xc = _residuals(pose, pts_w, obs_uvr, has_ur, cam)
            J = residual_jacobian(xc, has_ur, cam)
            chi2 = chi2_of(r)
            w_huber = huber(chi2, use_huber)
            w = torch.where(active, inv_sigma2 * w_huber, zero)
            JW = J * w[:, None, None]
            H = torch.einsum("nij,nik->jk", JW, J)
            g = torch.einsum("nij,ni->j", JW, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            delta = -torch.linalg.solve_ex(Hd, g)[0]
            new_pose = se3.retract(pose, delta)
            r_new, _ = _residuals(new_pose, pts_w, obs_uvr, has_ur, cam)
            cost_old = torch.sum(torch.where(active, chi2 * w_huber, zero))
            chi2n = chi2_of(r_new)
            cost_new = torch.sum(torch.where(active, chi2n * huber(chi2n, use_huber),
                                             zero))
            improved = cost_new < cost_old
            step_inf = torch.amax(torch.abs(delta))
            rel_gain = (cost_old - cost_new) / torch.clamp(cost_old, min=1e-12)
            done_now = ((improved & ((rel_gain < 1e-5) | (step_inf < 1e-5)))
                        | (~improved & (lam >= 1e6)))
            # frozen-state mask: an iteration after `done` changes nothing
            take = improved & ~done
            pose = torch.where(take, new_pose, pose)
            lam_out = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                                  1e-8, 1e6)
            lam = torch.where(done, lam, lam_out)
            done = done | done_now
        r, _ = _residuals(pose, pts_w, obs_uvr, has_ur, cam)
        inliers = valid & (chi2_of(r) <= chi2_th)
    r, _ = _residuals(pose, pts_w, obs_uvr, has_ur, cam)
    final_cost = torch.sum(torch.where(inliers, chi2_of(r), zero))
    return PoseOptResult(pose=pose, inliers=inliers,
                         num_inliers=inliers.sum(dtype=torch.int32),
                         final_cost=final_cost)
