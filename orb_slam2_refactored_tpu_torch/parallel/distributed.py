"""Multi-process wiring for the sharded global bundle adjustment.

Port of `orb_slam2_refactored_tpu/parallel/distributed.py`: one process a
card, `torch.distributed` initialized over a TCP rendezvous (JAX's
`jax.distributed.initialize` over its coordinator), the keyframe axis
sharded over every rank, and `sharded_ba_solve` unchanged. NCCL carries
the collectives between cards; gloo is taken only when the caller asks
for it (a run on the CPU, or two ranks on one card, which NCCL refuses).

`run_multiprocess_ba` is the per-process entry of the two-process CPU test
(`tests/test_torch_distributed.py`); `dryrun` is the counterpart of
`__graft_entry__.dryrun_multichip`, the distributed workload at a
compute-bound size (K=256 keyframes, 512 observations each, 16,384
points).
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch

from .. import resolve_device
from ..geometry import projection as proj
from ..geometry import se3
from ..optim import ba

RENDEZVOUS_TIMEOUT_S = 300


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = None,
               device=None) -> torch.device:
    """`init_process_group` over `tcp://coordinator_address` (host:port)
    for rank `process_id` of `num_processes`; returns the rank's device.

    `backend` None takes NCCL, which needs a card: with none, it raises
    (pass backend="gloo" and device="cpu" to run on the CPU). The device is
    cuda:{rank % device_count}, and without a card `initialize` raises;
    `device` overrides it (device="cpu", or gloo ranks sharing one card)."""
    import torch.distributed as dist

    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for NCCL; pass backend='gloo' "
                               "and device='cpu' to run the ranks on the CPU")
        backend = "nccl"
    if device is None:
        resolve_device()  # raises without a card
        device = f"cuda:{process_id % torch.cuda.device_count()}"
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL takes CUDA devices only")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return device


def make_ba_problem(K: int = 256, N: int = 512, P: int = 16384,
                    seed: int = 0, device="cpu"):
    """The compute-bound synthetic global-BA problem of
    `__graft_entry__.make_ba_problem` (a slow forward translation with a
    slight rotation, N random points seen by each of K keyframes, 0.5 px
    of noise, the points moved by 2 cm), built on the CPU from numpy draws
    of `seed` and moved to `device`. Returns (BAProblem, camera)."""
    rng = np.random.default_rng(seed)
    cam = proj.CameraIntrinsics.create(200.0, 200.0, 80.0, 60.0, bf=16.0)
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-2, 2, P),
                    rng.uniform(3, 10, P)], -1).astype(np.float32)
    tang = np.zeros((K, 6), np.float32)
    tang[:, 4] = 0.02 * np.arange(K)
    tang[:, 0] = 0.002 * np.arange(K)
    poses = se3.exp(torch.as_tensor(tang))
    obs_pt = np.stack([rng.permutation(P)[:N] for _ in range(K)]).astype(
        np.int32)
    xc = se3.transform(poses[:, None, :], torch.as_tensor(pts[obs_pt]))
    uvr = proj.project_stereo(cam, xc).numpy()
    rng2 = np.random.default_rng(seed + 1)
    uv = uvr[..., :2] + rng2.normal(0, 0.5, uvr[..., :2].shape)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    pt_pos = pts + rng2.normal(0, 0.02, pts.shape).astype(np.float32)
    dev = torch.device(device)
    prob = ba.BAProblem(
        kf_pose=poses.to(dev), kf_fixed=torch.as_tensor(fixed, device=dev),
        obs_uv=torch.as_tensor(uv.astype(np.float32), device=dev),
        obs_ur=torch.as_tensor(uvr[..., 2].copy(), device=dev),
        obs_pt=torch.as_tensor(obs_pt, device=dev),
        obs_inv_s2=torch.ones((K, N), dtype=torch.float32, device=dev),
        pt_pos=torch.as_tensor(pt_pos, device=dev),
        pt_valid=torch.ones(P, dtype=torch.bool, device=dev))
    return prob, cam


def _rank_device(device):
    """`device`, else the card this rank is bound to (`initialize` binds
    it); without a card it raises, as `resolve_device` does."""
    if device is not None:
        return torch.device(device)
    resolve_device()
    return torch.device("cuda", torch.cuda.current_device())


def run_multiprocess_ba(K: int = 64, N: int = 128, P: int = 2048,
                        iters: int = 2, cg_iters: int = 6, device=None):
    """Solve a keyframe-sharded BA over every rank of the default group
    (after `initialize`). Every rank builds the same problem from the same
    seed on `device` (the card the rank is bound to unless the caller
    passes another, device="cpu" for the CPU). Returns (initial_cost,
    final_cost), the same on every rank."""
    from .sharded_ba import sharded_ba_solve

    device = _rank_device(device)
    prob, cam = make_ba_problem(K=K, N=N, P=P, device=device)
    res = sharded_ba_solve(prob, cam, iters=iters, cg_iters=cg_iters)
    return float(res.initial_cost), float(res.final_cost)


def dryrun(K: int = 256, N: int = 512, P: int = 16384, iters: int = 2,
           cg_iters: int = 8, group=None, device=None):
    """The distributed workload at its compute-bound size (JAX
    `dryrun_multichip`): the sharded BA over `group` (the default group),
    checked finite and not worse, on `device` (as `run_multiprocess_ba`
    takes it); returns the result."""
    from .sharded_ba import make_group, sharded_ba_solve

    device = _rank_device(device)
    group = make_group() if group is None else group
    prob, cam = make_ba_problem(K=K, N=N, P=P, device=device)
    res = sharded_ba_solve(prob, cam, group=group, iters=iters,
                           cg_iters=cg_iters)
    c0, c1 = float(res.initial_cost), float(res.final_cost)
    assert np.isfinite(c1), "sharded BA produced NaN"
    assert c1 <= c0 + 1e-3, (c0, c1)
    print(f"dryrun OK: {group.size()} ranks, K={K}/N={N}/P={P} sharded BA, "
          f"cost {c0:.3f} -> {c1:.3f}")
    return res
