"""Relative-Sim3 optimization over paired reprojections.

Port of `orb_slam2_refactored_tpu/optim/sim3_opt.py` (`OptimizeSim3`,
`src/Optimizer.cc:944-1100`): refine the loop similarity S12 (keyframe 2's
camera frame into keyframe 1's) by Levenberg-Marquardt over paired
reprojection residuals, each matched landmark an edge in both images, with
a Huber kernel and a chi2 = 10 gate between rounds (a pair is dropped when
either edge fails).

Differences of form: the Jacobian [N, 4, 7] comes from one
`torch.func.jacfwd` of the whole residual vector with respect to the
shared 7-DoF tangent (the JAX package takes it pair by pair under `vmap`;
the arithmetic of each entry is the same), and the two `lax.scan`s are
Python loops of fixed length with no host read. Plain PyTorch: at most
~1000 pairs and 7 unknowns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import projection as proj
from ..geometry import sim3
from .ba import highest_precision

CHI2_SIM3 = 10.0  # reference th2 (src/Optimizer.cc:1042)


class Sim3OptResult(NamedTuple):
    S: torch.Tensor            # f32[8] refined Sim3 (KF2 cam -> KF1 cam)
    inliers: torch.Tensor      # bool[N] per matched pair
    num_inliers: torch.Tensor  # i32
    final_cost: torch.Tensor   # f32


def _pair_residuals(S, x1, x2, uv1, uv2, cam):
    """r[N, 4]: x2 through S into image 1 (2), x1 through S^-1 into image 2
    (2)."""
    r1 = uv1 - proj.project(cam, sim3.transform(S, x2))
    r2 = uv2 - proj.project(cam, sim3.transform(sim3.inverse(S), x1))
    return torch.cat([r1, r2], dim=-1)


def optimize_sim3(S0, x1, x2, uv1, uv2, inv_s2_1, inv_s2_2, valid,
                  cam: proj.CameraIntrinsics, fix_scale: bool = True,
                  rounds: int = 2, iters_per_round: int = 6) -> Sim3OptResult:
    """x1/x2: f32[N,3] matched landmarks in keyframe 1's / 2's camera frame;
    uv1/uv2: f32[N,2] their observed keypoints; inv_s2_*: per-observation
    information weights; valid: bool[N]."""
    with highest_precision():
        return _optimize_sim3_f32(S0, x1, x2, uv1, uv2, inv_s2_1, inv_s2_2,
                                  valid, cam, fix_scale, rounds,
                                  iters_per_round)


def _optimize_sim3_f32(S0, x1, x2, uv1, uv2, inv_s2_1, inv_s2_2, valid, cam,
                       fix_scale, rounds, iters_per_round) -> Sim3OptResult:
    dev = x1.device
    huber = float(torch.sqrt(torch.tensor(CHI2_SIM3, dtype=torch.float32)))
    # tangent-row mask: the log-scale is frozen for stereo / RGB-D
    dof = torch.ones((7,), dtype=torch.float32, device=dev)
    if fix_scale:
        dof[6] = 0.0
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    w_info = torch.stack([inv_s2_1, inv_s2_1, inv_s2_2, inv_s2_2], -1)

    def chi2_parts(r):
        c1 = torch.sum(r[..., 0:2] ** 2, -1) * inv_s2_1
        c2 = torch.sum(r[..., 2:4] ** 2, -1) * inv_s2_2
        return c1, c2

    def huber_w(c1, c2):
        s_norm = torch.sqrt(torch.clamp(c1 + c2, min=1e-12))
        return torch.where(s_norm > huber, huber / s_norm,
                           torch.ones_like(s_norm))

    def jac_res(S):
        def r_of(delta):
            return _pair_residuals(sim3.retract(S, delta * dof), x1, x2,
                                   uv1, uv2, cam)

        z = torch.zeros((7,), dtype=torch.float32, device=dev)
        return r_of(z), torch.func.jacfwd(r_of)(z)  # [N,4], [N,4,7]

    S, inl = S0, valid
    for _ in range(rounds):
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        m = (valid & inl).to(torch.float32)
        for _ in range(iters_per_round):
            r, J = jac_res(S)
            c1, c2 = chi2_parts(r)
            w_h = huber_w(c1, c2)
            w = w_info * (w_h * m)[..., None]  # [N,4]
            JW = J * w[..., None]
            H = torch.einsum("nci,ncj->ij", JW, J)
            g = torch.einsum("nci,nc->i", JW, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
            delta = -torch.linalg.solve(Hd, g) * dof
            S_new = sim3.retract(S, delta)
            c1n, c2n = chi2_parts(_pair_residuals(S_new, x1, x2, uv1, uv2,
                                                  cam))
            cost_old = torch.sum((c1 + c2) * w_h * m)
            cost_new = torch.sum((c1n + c2n) * huber_w(c1n, c2n) * m)
            ok = cost_new < cost_old
            S = torch.where(ok, S_new, S)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0),
                              1e-8, 1e6)
        c1, c2 = chi2_parts(_pair_residuals(S, x1, x2, uv1, uv2, cam))
        inl = valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    c1, c2 = chi2_parts(_pair_residuals(S, x1, x2, uv1, uv2, cam))
    cost = torch.sum(torch.where(inl, c1 + c2, torch.zeros_like(c1)))
    return Sim3OptResult(S=S, inliers=inl,
                         num_inliers=inl.sum(dtype=torch.int32),
                         final_cost=cost)
