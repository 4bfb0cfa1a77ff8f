"""Pose-only optimization: Levenberg-Marquardt on SE(3) with outlier rounds.

Port of `orb_slam2_refactored_tpu/optim/pose_opt.py`: 4 rounds of LM,
Huber kernel (first two rounds) with delta = sqrt(5.991) mono /
sqrt(7.815) stereo, chi2 outlier re-classification after every round,
dense 6x6 normal equations. Two changes of form, not of result:

- the data-dependent `while_loop` becomes a fixed `iters_per_round` loop
  with a frozen-state mask: once an iteration reports `done`, pose and
  lambda stay as they are (kernel K4 and the plain version then leave the
  round: the remaining iterations would change nothing);
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
    """Plain PyTorch version of kernel K4 (same signature), in the kernel's
    schedule: one evaluation an iteration, at the candidate pose (its H, g
    and cost become the current ones when the step is taken, and the
    current ones stay when it is refused); the reclassification after a
    round fused with the next round's first evaluation, the last one with
    the final cost. Each evaluation is the one the two-pass loop (H and g
    at the current pose, then the cost at the candidate) made at the same
    pose, so the result is the same bits."""
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

    def chi2_at(pose):
        r, xc = _residuals(pose, pts_w, obs_uvr, has_ur, cam)
        return r, xc, torch.sum(r * r, dim=-1) * inv_sigma2

    def normal_equations(r, xc, chi2, active, use_huber):
        """H, g and the Huber cost over `active` at one pose."""
        J = residual_jacobian(xc, has_ur, cam)
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w_huber = (torch.where(s > huber_delta, huber_delta / s,
                               torch.ones_like(s))
                   if use_huber else torch.ones_like(s))
        w = torch.where(active, inv_sigma2 * w_huber, zero)
        JW = J * w[:, None, None]
        return (torch.einsum("nij,nik->jk", JW, J),
                torch.einsum("nij,ni->j", JW, r),
                torch.sum(torch.where(active, chi2 * w_huber, zero)))

    pose = pose0
    inliers = valid
    for round_idx in range(rounds):
        use_huber = round_idx < 2
        r, xc, chi2 = chi2_at(pose)
        if round_idx > 0:  # reclassify at the round's pose
            inliers = valid & (chi2 <= chi2_th)
        active = valid & inliers
        H, g, cost = normal_equations(r, xc, chi2, active, use_huber)
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        for _ in range(iters_per_round):
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            delta = -torch.linalg.solve_ex(Hd, g)[0]
            cand = se3.retract(pose, delta)
            H_c, g_c, cost_c = normal_equations(*chi2_at(cand), active,
                                                use_huber)
            improved = bool(cost_c < cost)
            rel_gain = (cost - cost_c) / torch.clamp(cost, min=1e-12)
            done = (bool((rel_gain < 1e-5) | (torch.amax(torch.abs(delta))
                                              < 1e-5))
                    if improved else bool(lam >= 1e6))
            if improved:
                pose, H, g, cost = cand, H_c, g_c, cost_c
            lam = torch.clamp(lam * 0.5 if improved else lam * 4.0, 1e-8, 1e6)
            if done:  # the frozen-state mask: later iterations change nothing
                break
    _, _, chi2 = chi2_at(pose)
    if rounds > 0:
        inliers = valid & (chi2 <= chi2_th)
    final_cost = torch.sum(torch.where(inliers, chi2, zero))
    return PoseOptResult(pose=pose, inliers=inliers,
                         num_inliers=inliers.sum(dtype=torch.int32),
                         final_cost=final_cost)
