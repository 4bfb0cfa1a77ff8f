"""Keyframe-sharded global bundle adjustment over a process group.

Port of `orb_slam2_refactored_tpu/parallel/sharded_ba.py`. JAX shards the
BA problem's keyframe axis over a 1-D device mesh under `shard_map` with
the landmark arrays replicated; here each rank of a `torch.distributed`
process group holds one contiguous block of keyframes (the block
`PartitionSpec(AXIS)` gives a device) and every point, and `ba_solve(...,
group=)` turns each of JAX's cross-device reductions into a collective
(`optim/ba.py::ShardComm`). The result comes back whole on every rank:
the poses gathered in rank order, the points with the same bits on every
rank, the padding sliced off.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..geometry import projection as proj
from ..optim.ba import BAProblem, BAResult, all_gather_rows, ba_solve


def make_group():
    """The process group of the sharded solve (JAX `make_mesh`): every
    rank of the initialized default group."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.distributed.initialize first")
    return dist.group.WORLD


def pad_problem(p: BAProblem, n_shards: int) -> BAProblem:
    """Pad the keyframe axis to a multiple of `n_shards` with fixed,
    observation-free dummy frames (they add nothing to any reduction)."""
    K = p.kf_pose.shape[0]
    pad = (-K) % n_shards
    if pad == 0:
        return p

    def cat(x, fill, dtype=None):
        extra = torch.full((pad,) + tuple(x.shape[1:]), fill,
                           dtype=dtype or x.dtype, device=x.device)
        return torch.cat([x, extra])

    pose = torch.tensor([1, 0, 0, 0, 0, 0, 0], dtype=p.kf_pose.dtype,
                        device=p.kf_pose.device)
    return p._replace(
        kf_pose=torch.cat([p.kf_pose, pose.expand(pad, 7)]),
        kf_fixed=cat(p.kf_fixed, True), obs_uv=cat(p.obs_uv, 0.0),
        obs_ur=cat(p.obs_ur, -1.0), obs_pt=cat(p.obs_pt, -1),
        obs_inv_s2=cat(p.obs_inv_s2, 1.0))


def pad_points(p: BAProblem, n_shards: int) -> BAProblem:
    """Pad the point axis to a multiple of `n_shards` with invalid, frozen
    points, so that the solve shards the points (JAX `:86-98`)."""
    P = p.pt_pos.shape[0]
    pad = (-P) % n_shards
    if pad == 0:
        return p
    dev = p.pt_pos.device
    return p._replace(
        pt_pos=torch.cat([p.pt_pos, torch.zeros((pad, 3), dtype=p.pt_pos.dtype,
                                                device=dev)]),
        pt_valid=torch.cat([p.pt_valid, torch.zeros(pad, dtype=torch.bool,
                                                    device=dev)]),
        pt_frozen=(None if p.pt_frozen is None else torch.cat(
            [p.pt_frozen, torch.ones(pad, dtype=torch.bool, device=dev)])))


def rank_block(p: BAProblem, n: int, rank: int) -> BAProblem:
    """Rank `rank`'s contiguous block of the (padded) keyframe axis, the
    point arrays whole."""
    Kl = p.kf_pose.shape[0] // n
    sl = slice(rank * Kl, (rank + 1) * Kl)
    return p._replace(**{f: getattr(p, f)[sl].contiguous() for f in (
        "kf_pose", "kf_fixed", "obs_uv", "obs_ur", "obs_pt", "obs_inv_s2")})


def _gather_rows(x, group, n):
    """[Kl, ...] of every rank -> [n Kl, ...] in rank order."""
    return x if n == 1 else all_gather_rows(x, group)


def sharded_ba_solve(p: BAProblem, cam: proj.CameraIntrinsics, group=None,
                     iters: int = 10, cg_iters: int = 50,
                     use_huber: bool = True,
                     lambda0: float = 1e-4) -> BAResult:
    """`ba_solve` with the keyframe axis sharded over `group` (the default
    group when None; JAX `sharded_ba_solve` over a mesh). Every rank passes
    the whole problem; each solves its block and gets the whole result.
    `lambda0` is `ba_solve`'s (JAX's sharded solve keeps its default; the
    loop closer's global BA starts at 1e-3)."""
    if group is None:
        group = make_group()
    n, rank = group.size(), group.rank()
    K0, P0 = p.kf_pose.shape[0], p.pt_pos.shape[0]
    p = pad_points(pad_problem(p, n), n)
    res = ba_solve(rank_block(p, n, rank), cam, iters=iters,
                   cg_iters=cg_iters, use_huber=use_huber, lambda0=lambda0,
                   group=group)
    kf_pose = _gather_rows(res.kf_pose, group, n)
    inlier = _gather_rows(res.obs_inlier.to(torch.uint8), group, n).bool()
    return BAResult(kf_pose[:K0], res.pt_pos[:P0], res.initial_cost,
                    res.final_cost, inlier[:K0])
