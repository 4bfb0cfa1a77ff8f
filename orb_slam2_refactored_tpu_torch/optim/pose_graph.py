"""Sim(3) pose-graph optimization (essential graph), matrix-free LM + CG.

Port of `orb_slam2_refactored_tpu/optim/pose_graph.py`
(`OptimizeEssentialGraph`, `src/Optimizer.cc:743-942`): every keyframe's
7-DoF similarity pose against relative-Sim3 edge measurements, fixed
keyframes held as the gauge, LM with preconditioned CG on the [K, 7]
tangent space.

Differences of form: both 7x7 Jacobian blocks of every edge come from one
`torch.func.jacfwd` of the whole residual vector with respect to a
14-vector, the tangent shared by the edges' first endpoints and the one
shared by their second; and every scatter-add
along the edge endpoints (JAX's `.at[].add`) is a fixed-order segment sum:
the edge rows are gathered into a padded [K, D] table of each keyframe's
rows (built once a solve on the host from the edge lists) and summed along
D. No float atomics, so a solve gives the same bits on every run.
Plain PyTorch: at most a few hundred edges, once a loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import sim3
from .ba import highest_precision


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor     # f32[K,8] Sim3 world->camera (Scw)
    fixed: torch.Tensor     # bool[K]
    edge_i: torch.Tensor    # i32[E]
    edge_j: torch.Tensor    # i32[E]
    edge_rel: torch.Tensor  # f32[E,8] measurement M_e ~ S_i * S_j^-1
    edge_w: torch.Tensor    # f32[E] weight (0 = padding)


def edge_measurement(pose_i, pose_j):
    """M_e = S_i * S_j^-1, so that log(M_e * S_j * S_i^-1) = 0 at
    consistency."""
    return sim3.compose(pose_i, sim3.inverse(pose_j))


def _edge_residual(pose_i, pose_j, rel):
    return sim3.log(sim3.compose(rel, sim3.compose(pose_j,
                                                   sim3.inverse(pose_i))))


def _segment_table(edge_i: np.ndarray, edge_j: np.ndarray, K: int):
    """i64[K, D]: row k lists, ascending, the rows of the stacked [2E]
    edge-end array (first ends, then second ends) that touch keyframe k;
    padding points at row 2E (a zero row)."""
    ends = np.concatenate([edge_i, edge_j]).astype(np.int64)
    counts = np.bincount(ends, minlength=K)
    table = np.full((K, max(int(counts.max(initial=0)), 1)), len(ends),
                    np.int64)
    order = np.argsort(ends, kind="stable")
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(ends)) - np.repeat(starts, counts)
    table[ends[order], pos] = order
    return table


def pose_graph_solve(p: PoseGraphProblem, iters: int = 20, cg_iters: int = 60,
                     lambda0: float = 1e-4):
    """Returns (poses [K,8], initial_cost, final_cost)."""
    with highest_precision():
        return _pose_graph_solve_f32(p, iters, cg_iters, lambda0)


def _pose_graph_solve_f32(p, iters, cg_iters, lambda0):
    K = p.poses.shape[0]
    dev = p.poses.device
    free = (~p.fixed)[:, None].to(torch.float32)
    ei, ej = p.edge_i.long(), p.edge_j.long()
    table = torch.as_tensor(_segment_table(p.edge_i.cpu().numpy(),
                                           p.edge_j.cpu().numpy(), K),
                            device=dev)

    def seg_sum(a, b):
        """Sum of the first-end rows `a` [E,...] and second-end rows `b`
        onto their keyframes, in a fixed order: [K,...]."""
        x = torch.cat([a, b, torch.zeros_like(a[:1])])
        return x[table].sum(1)

    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    z14 = torch.zeros((14,), dtype=torch.float32, device=dev)

    def residuals_jacobians(poses):
        pi, pj = poses[ei], poses[ej]

        def f(d):
            return _edge_residual(sim3.retract(pi, d[:7]),
                                  sim3.retract(pj, d[7:]), p.edge_rel)

        J = torch.func.jacfwd(f)(z14)  # [E, 7, 14]: both blocks at once
        return f(z14), J[..., :7], J[..., 7:]

    def cost_of(poses):
        r = _edge_residual(poses[ei], poses[ej], p.edge_rel)
        return torch.sum(p.edge_w * torch.sum(r * r, -1))

    poses = p.poses
    lam = torch.full((), lambda0, dtype=torch.float32, device=dev)
    cost0 = cost_of(poses)
    prev_cost = cost0
    for _ in range(iters):
        r, Ji, Jj = residuals_jacobians(poses)  # [E,7], [E,7,7] x2
        w = p.edge_w[:, None, None]
        JiW, JjW = Ji * w, Jj * w
        g = seg_sum(torch.einsum("eci,ec->ei", JiW, r),
                    torch.einsum("eci,ec->ei", JjW, r))
        Hii = seg_sum(torch.einsum("eci,ecj->eij", JiW, Ji),
                      torch.einsum("eci,ecj->eij", JjW, Jj))
        diag = torch.diagonal(Hii, dim1=1, dim2=2)
        damp = lam * diag + 1e-6
        Minv = torch.linalg.inv(Hii + damp[:, :, None] * eye7
                                + 1e-9 * eye7)

        def H_mv(v):
            v = v * free
            Jv = (torch.einsum("eci,ei->ec", Ji, v[ei])
                  + torch.einsum("eci,ei->ec", Jj, v[ej]))
            out = seg_sum(torch.einsum("eci,ec->ei", JiW, Jv),
                          torch.einsum("eci,ec->ei", JjW, Jv))
            return (out + damp * v) * free

        def precond(v):
            return torch.einsum("kij,kj->ki", Minv, v) * free

        rhs = -g * free
        x = torch.zeros_like(rhs)
        rr = rhs
        z = precond(rhs)
        pd = z
        rz = torch.sum(rhs * z)
        for _ in range(cg_iters):
            Ap = H_mv(pd)
            denom = torch.sum(pd * Ap)
            alpha = rz / torch.where(torch.abs(denom) < 1e-12,
                                     torch.full_like(denom, 1e-12), denom)
            x = x + alpha * pd
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.where(torch.abs(rz) < 1e-12,
                                        torch.full_like(rz, 1e-12), rz)
            pd = z + beta * pd
            rz = rz_new
        new_poses = sim3.retract(poses, x)
        new_poses = torch.where(free > 0, new_poses, poses)
        new_cost = cost_of(new_poses)
        improved = new_cost < prev_cost
        poses = torch.where(improved, new_poses, poses)
        lam = torch.clamp(torch.where(improved, lam * 0.4, lam * 5.0),
                          1e-8, 1e5)
        prev_cost = torch.where(improved, new_cost, prev_cost)
    return poses, cost0, prev_cost
