"""Bundle adjustment: Levenberg-Marquardt with Schur-complement landmark
marginalization, dense reduced camera system.

Port of `orb_slam2_refactored_tpu/optim/ba.py`: the dense-Schur branch
(the window BA that `LocalMapper` runs) and the matrix-free CG branch
(global BA after a loop closure). Observations live in the map's
dense `[K, N]` layout (keyframe x feature slot) with -1 padding; fixed
keyframes are a mask projected out of the reduced system; landmarks that
are frozen get G = 0 (no Schur term, no update); Huber kernel with the
chi2 deltas 5.991 (mono) / 7.815 (stereo).

Differences of form, not of result:
- the `while_loop` with its gain-stall exit becomes a fixed `iters` loop
  with a frozen-state mask: once `done`, pose, points, lambda and cost stay
  as they are, and no iteration count is read back to the host;
- the per-iteration assembly (residuals, both Jacobian blocks, Hpp, g_p,
  the [Q,12] Hll|g_l scatter and the [Q*K,18] camera-block scatter T) and
  the cost are kernel K5 (`csrc/ba_assemble.cu`) on CUDA tensors, and their
  plain versions (`ba_assemble_plain`, `ba_cost_plain`) on CPU tensors;
  the assembly reads the live slots by point from a `PointIndex` built
  once a solve (`ba_point_index`), and the cost stores chi2 only for the
  final gate;
- `_cost_only` uses the same analytic residual as the Jacobian pass;
- the CG branch (`dense_schur=False`) assembles with K5 in its `w_obs`
  mode (W_obs = (w Jp)^T Jl a live slot in place of T: on the card the
  rows in the point index's order, `LiveRows`; on the CPU JAX's [K*N, 18]
  slot layout) and solves each LM iteration's reduced camera system with
  kernel K6 (`csrc/ba_schur.cu`, `ba_schur_cg`): the rhs, the fixed
  `cg_iters` CG iterations and the back-substitution's U^T dp in one
  launch, with no float atomic and no host read; `cg_solve_plain` is the
  same solve op by op.

The sharded forms: JAX's `axis_name` / `axis_size` under `shard_map`
become `group=`, a `torch.distributed` process group (`ShardComm`). The
keyframe axis is this rank's shard and the points are replicated; every
cross-device reduction of JAX's solve is a collective: the costs and the
two CG scalars an `all_reduce`; the [P,12] Hll|g_l and U^T dp a
`reduce_scatter` when the points shard (group size > 1, the CG branch,
P % n == 0) and an `all_reduce` otherwise, with an `all_gather` of the
rank's point rows where JAX gathers them (G and g_l before the CG, the
landmark update after it). The CG of a sharded solve is kernel K6 split
at its reductions (`sharded_cg_solve`, `csrc/ba_schur_sharded.cu`: three
launches and three all_reduces a CG iteration), since a collective cannot
run inside K6's one launch. The dense branch over a group of more than one
rank gathers every rank's keyframe rows of Hpp_d, g_p and T
(`all_gather`, in rank order) and solves the whole reduced system on each
rank: T is indexed by the rank's own keyframes, so JAX's `psum` of T
(`optim/ba.py:377-380`, a path its sharded solve never takes) would add
different keyframes under one index.

Everything is f32 at "highest" matmul precision: the S contraction and
the solves never run in TF32.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import kernels
from ..geometry import projection as proj
from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    kf_pose: torch.Tensor     # f32[K,7] world->camera
    kf_fixed: torch.Tensor    # bool[K] gauge/frontier frames (not optimized)
    obs_uv: torch.Tensor      # f32[K,N,2]
    obs_ur: torch.Tensor      # f32[K,N] (<0 -> mono observation)
    obs_pt: torch.Tensor      # i32[K,N] point index (-1 -> no observation)
    obs_inv_s2: torch.Tensor  # f32[K,N]
    pt_pos: torch.Tensor      # f32[P,3]
    pt_valid: torch.Tensor    # bool[P]
    # bool[P] landmarks held fixed (observed by keyframes outside the
    # window); None -> all landmarks free
    pt_frozen: Optional[torch.Tensor] = None


class BAResult(NamedTuple):
    kf_pose: torch.Tensor
    pt_pos: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    obs_inlier: torch.Tensor  # bool[K,N] final chi2 gate per observation


@contextlib.contextmanager
def highest_precision():
    """f32 products in full f32 (no TF32) inside the block, whatever the
    process-wide setting; restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def problem_from_map(m, free_mask, inv_sigma2, pt_frozen=None) -> BAProblem:
    """The whole-map BA problem as views of live `MapArrays`: dead keyframe
    slots arrive with free_mask False, dead landmarks with mp_valid False."""
    return BAProblem(
        kf_pose=m.kf_pose, kf_fixed=~free_mask, obs_uv=m.kf_xy,
        obs_ur=m.kf_uright, obs_pt=m.kf_mp,
        obs_inv_s2=inv_sigma2[m.kf_level.long()], pt_pos=m.mp_pos,
        pt_valid=m.mp_valid, pt_frozen=pt_frozen)


def _residuals(kf_pose, pt_pos, p: BAProblem, cam):
    """r[K,N,3] = observation - prediction for every observation slot
    (depth gate z > 1e-2, mono third row masked), with the camera-frame
    points xc[K,N,3] and 1/z."""
    has_ur = p.obs_ur > 0
    pt_idx = torch.clamp(p.obs_pt, 0, pt_pos.shape[0] - 1).long()
    xc = se3.transform(kf_pose[:, None, :], pt_pos[pt_idx])
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / zs
    pred_u = cam.fx * x * inv_z + cam.cx
    pred_v = cam.fy * y * inv_z + cam.cy
    pred_r = pred_u - cam.bf * inv_z
    r = torch.stack([p.obs_uv[..., 0] - pred_u, p.obs_uv[..., 1] - pred_v,
                     torch.where(has_ur, p.obs_ur - pred_r,
                                 torch.zeros_like(x))], -1)
    r = torch.where((z > 1e-2)[..., None], r, torch.zeros_like(r))
    return r, xc, inv_z


def _residuals_jacobians(kf_pose, pt_pos, p: BAProblem, cam):
    """r[K,N,3], Jp[K,N,3,6], Jl[K,N,3,3] for every observation slot.

    Analytic Jacobians with the left-multiplicative retraction
    exp(delta) @ pose: dxc/domega = -[xc]x, dxc/dupsilon = I,
    dxc/dx_world = R(pose). Depth gate z > 1e-2; mono third row masked."""
    r, xc, inv_z = _residuals(kf_pose, pt_pos, p, cam)
    has_ur = p.obs_ur > 0
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    live = z > 1e-2
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], -1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1),
        torch.stack([cam.fx * inv_z, zero,
                     -cam.fx * x * inv_z2 + cam.bf * inv_z2], -1),
    ], -2)
    row_mask = torch.stack([live, live, live & has_ur], -1)
    dr_dxc = torch.where(row_mask[..., None], -Jproj, torch.zeros_like(Jproj))
    skew = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)
    Jp_rot = -(dr_dxc @ skew)
    Jp = torch.cat([Jp_rot, dr_dxc], -1)  # [K,N,3,6]
    R = se3.quat_to_matrix(kf_pose[:, 0:4])  # [K,3,3]
    Jl = dr_dxc @ R[:, None]
    return r, Jp, Jl


def _huber_rho(chi2, delta, use_huber):
    """g2o Huber on the error norm: rho(s) = s if sqrt(s)<=d else 2d*sqrt(s)-d^2."""
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    rho = torch.where(s <= delta, chi2, 2.0 * delta * s - delta * delta)
    return rho if use_huber else chi2


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12,
                                torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return adj * inv_det[..., None, None]


# ---------------------------------------------------------------------------
# kernel K5 and its plain versions
# ---------------------------------------------------------------------------

class PointIndex(NamedTuple):
    """The live observation slots grouped by point (CSR): point q's slots
    (flat k * N + n, ascending) are slots[offsets[q]:offsets[q + 1]];
    slots past offsets[Q] hold -1. `place` is the inverse on the live
    slots: slots[place[s]] == s, and -1 on a dead slot."""
    offsets: torch.Tensor  # i32[Q+1]
    slots: torch.Tensor    # i32[K*N]
    place: torch.Tensor    # i32[K*N]


def ba_point_index_plain(obs_pt, obs_ok, Q: int) -> PointIndex:
    """Plain PyTorch version of K5's `ba_point_index` (same signature): the
    slots with `obs_ok`, by point clamped to [0, Q) as `ba_assemble_plain`
    clamps it, ascending within a point."""
    flat_pt = torch.clamp(obs_pt, 0, Q - 1).reshape(-1).long()
    live = torch.nonzero(obs_ok.reshape(-1)).reshape(-1)
    # slot ids ascend in `live`, so a stable sort keeps them ascending
    order = torch.sort(flat_pt[live], stable=True).indices
    counts = torch.bincount(flat_pt[live], minlength=Q)
    offsets = torch.zeros(Q + 1, dtype=torch.int32, device=obs_pt.device)
    offsets[1:] = torch.cumsum(counts, 0)
    slots = torch.full((obs_pt.numel(),), -1, dtype=torch.int32,
                       device=obs_pt.device)
    slots[:live.numel()] = live[order].to(torch.int32)
    place = torch.full_like(slots, -1)
    place[slots[:live.numel()].long()] = torch.arange(
        live.numel(), dtype=torch.int32, device=obs_pt.device)
    return PointIndex(offsets, slots, place)


def ba_assemble_plain(kf_pose, pt_pos, p: BAProblem, obs_ok, cam,
                      use_huber: bool, index: Optional[PointIndex] = None,
                      w_obs: bool = False):
    """Plain PyTorch version of K5's `ba_assemble` (same signature; it has
    no use for `index`).

    Returns Hpp f32[K,6,6], g_p f32[K,6], the packed point accumulator
    f32[Q,12] (Hll row-major | g_l) and T f32[Q*K,18] (row q*K + k holds
    sum over k's observations of q of (w Jp)^T Jl, [6,3] row-major); with
    `w_obs`, W_obs f32[K*N,18] (row k*N + n: slot (k, n)'s (w Jp)^T Jl,
    zero for a slot without `obs_ok`) in place of T."""
    K, N = p.obs_uv.shape[:2]
    Q = pt_pos.shape[0]
    has_ur = p.obs_ur > 0
    r, Jp, Jl = _residuals_jacobians(kf_pose, pt_pos, p, cam)
    chi2 = torch.sum(r * r, -1) * p.obs_inv_s2
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    delta = torch.sqrt(torch.where(has_ur, torch.full_like(s, CHI2_STEREO),
                                   torch.full_like(s, CHI2_MONO)))
    w_huber = (torch.where(s > delta, delta / s, torch.ones_like(s))
               if use_huber else torch.ones_like(s))
    w = torch.where(obs_ok, p.obs_inv_s2 * w_huber, torch.zeros_like(s))
    JpW = Jp * w[..., None, None]
    JlW = Jl * w[..., None, None]
    Hpp = torch.einsum("knci,kncj->kij", JpW, Jp)
    g_p = torch.einsum("knci,knc->ki", JpW, r)
    Hll_obs = torch.einsum("knci,kncj->knij", JlW, Jl)
    g_l_obs = torch.einsum("knci,knc->kni", JlW, r)
    flat_pt = torch.clamp(p.obs_pt, 0, Q - 1).long().reshape(-1)
    ok = obs_ok.reshape(-1, 1)
    packed = torch.cat([Hll_obs.reshape(-1, 9), g_l_obs.reshape(-1, 3)], -1)
    acc = torch.zeros((Q, 12), dtype=pt_pos.dtype, device=pt_pos.device)
    acc.index_add_(0, flat_pt, torch.where(ok, packed,
                                           torch.zeros_like(packed)))
    W_obs = torch.einsum("knci,kncj->knij", JpW, Jl).reshape(-1, 18)
    if w_obs:
        return Hpp, g_p, acc, torch.where(ok, W_obs, torch.zeros_like(W_obs))
    kidx = torch.arange(K, device=pt_pos.device)[:, None].expand(K, N)
    T = torch.zeros((Q * K, 18), dtype=pt_pos.dtype, device=pt_pos.device)
    T.index_add_(0, flat_pt * K + kidx.reshape(-1),
                 torch.where(ok, W_obs, torch.zeros_like(W_obs)))
    return Hpp, g_p, acc, T


class LiveRows(NamedTuple):
    """W_obs as K5 writes it on the card (`ba_assemble(..., w_obs=True)`):
    row i of `rows` is live slot `index.slots[i]`'s, and rows past
    `index.offsets[Q]` are not written. A type of its own, so that a
    [K*N, 18] W_obs in JAX's slot layout (the plain version's) is never
    read as these rows: `ba_schur_cg` takes only this on the card, and
    `w_obs_slot_rows` turns it into the slot layout."""
    rows: torch.Tensor   # f32[K*N, 18]
    index: PointIndex


def w_obs_slot_rows(live: LiveRows):
    """`live` in JAX's [K*N, 18] slot layout, zero on the dead slots: the
    layout of `ba_assemble_plain` and `cg_solve_plain`."""
    L = int(live.index.offsets[-1])
    W = torch.zeros_like(live.rows)
    W[live.index.slots[:L].long()] = live.rows[:L]
    return W


def ba_cost_plain(kf_pose, pt_pos, p: BAProblem, obs_ok, cam,
                  use_huber: bool, want_chi2: bool = True):
    """Plain PyTorch version of K5's `ba_cost` (same signature): the Huber
    cost summed over `obs_ok` (f32 scalar) and chi2[K,N] of every slot
    (None unless `want_chi2`)."""
    r, _, _ = _residuals(kf_pose, pt_pos, p, cam)
    chi2 = torch.sum(r * r, -1) * p.obs_inv_s2
    has_ur = p.obs_ur > 0
    delta = torch.sqrt(torch.where(has_ur, torch.full_like(chi2, CHI2_STEREO),
                                   torch.full_like(chi2, CHI2_MONO)))
    rho = _huber_rho(chi2, delta, use_huber)
    cost = torch.sum(torch.where(obs_ok, rho, torch.zeros_like(rho)))
    return cost, (chi2 if want_chi2 else None)


def _k5_inputs(kf_pose, pt_pos, p: BAProblem, obs_ok):
    K, N = p.obs_uv.shape[:2]
    Q = pt_pos.shape[0]
    if Q < 1:
        raise ValueError("ba: the problem needs at least one point")
    args = [t.contiguous() for t in (kf_pose, pt_pos, p.obs_uv, p.obs_ur,
                                     p.obs_pt, p.obs_inv_s2, obs_ok)]
    for t, what, dtype, shape in zip(
            args, ("kf_pose", "pt_pos", "obs_uv", "obs_ur", "obs_pt",
                   "obs_inv_s2", "obs_ok"),
            (torch.float32,) * 4 + (torch.int32, torch.float32, torch.bool),
            ((K, 7), (Q, 3), (K, N, 2), (K, N), (K, N), (K, N), (K, N))):
        kernels.require(t, "ba " + what, dtype, shape)
    return args, K, N, Q


_K5_CAM = [kernels.CF] * 5 + [kernels.CI]


def ba_point_index(obs_pt, obs_ok, Q: int) -> PointIndex:
    """The live slots by point (see `PointIndex`), built once a solve in
    two launches. CUDA tensors -> kernel `csrc/ba_assemble.cu`; CPU ->
    plain version."""
    if not obs_pt.is_cuda:
        return ba_point_index_plain(obs_pt, obs_ok, Q)
    obs_pt, obs_ok = obs_pt.contiguous(), obs_ok.contiguous()
    kernels.require(obs_pt, "ba_point_index obs_pt", torch.int32)
    kernels.require(obs_ok, "ba_point_index obs_ok", torch.bool,
                    obs_pt.shape)
    if obs_pt.dim() != 2 or obs_pt.shape[1] < 1 or Q < 1:
        raise ValueError(f"ba_point_index: needs obs_pt [K, N >= 1] and "
                         f"Q >= 1, got {tuple(obs_pt.shape)}, Q={Q}")
    (K, N), S, dev = obs_pt.shape, obs_pt.numel(), obs_pt.device
    offsets = torch.empty((Q + 1,), dtype=torch.int32, device=dev)
    slots = torch.empty((S,), dtype=torch.int32, device=dev)
    place = torch.empty((S,), dtype=torch.int32, device=dev)
    # a row's counts, then (for a Q past the kernel's shared-memory rows)
    # its running counts
    table = torch.empty((2 * max(K, 1), Q), dtype=torch.int32, device=dev)
    rank = torch.empty((S,), dtype=torch.int32, device=dev)
    fn = kernels.bind("ba_assemble", "ba_point_index",
                      [kernels.VP] * 2 + [kernels.CI] * 3 + [kernels.VP] * 8)
    kernels.LAUNCHES["ba_point_index"] += 2  # a row and a scatter launch
    kernels.check(fn(kernels.ptr(obs_pt), kernels.ptr(obs_ok), S, N, Q,
                     kernels.ptr(offsets), kernels.ptr(slots),
                     kernels.ptr(place), kernels.ptr(table), kernels.ptr(rank),
                     kernels.ptr(kernels.ticket(dev, "ba_point_index count",
                                                Q)),
                     kernels.ptr(kernels.ticket(dev, "ba_point_index", 1)),
                     kernels.stream_of(obs_pt)), "ba_point_index")
    return PointIndex(offsets, slots, place)


def ba_assemble(kf_pose, pt_pos, p: BAProblem, obs_ok, cam, use_huber: bool,
                index: Optional[PointIndex] = None, w_obs: bool = False):
    """Per-iteration assembly (see `ba_assemble_plain`), one launch: T for
    the dense Schur branch; with `w_obs` (the CG branch) `LiveRows`, the
    live slots' W_obs rows in the index's order, in place of the plain
    version's slot layout. `index` is
    `ba_point_index(p.obs_pt, obs_ok, Q)`, built here when not given. CUDA
    tensors -> kernel `csrc/ba_assemble.cu`; CPU -> plain version."""
    if not kf_pose.is_cuda:
        return ba_assemble_plain(kf_pose, pt_pos, p, obs_ok, cam, use_huber,
                                 w_obs=w_obs)
    args, K, N, Q = _k5_inputs(kf_pose, pt_pos, p, obs_ok)
    if index is None:
        index = ba_point_index(args[4], args[6], Q)
    kernels.require(index.offsets, "ba index offsets", torch.int32, (Q + 1,))
    kernels.require(index.slots, "ba index slots", torch.int32, (K * N,))
    dev = kf_pose.device
    Hpp = torch.empty((K, 6, 6), dtype=torch.float32, device=dev)
    g_p = torch.empty((K, 6), dtype=torch.float32, device=dev)
    acc = torch.empty((Q, 12), dtype=torch.float32, device=dev)
    entry = "ba_assemble_w_obs" if w_obs else "ba_assemble"
    T = torch.empty((K * N, 18) if w_obs else (Q * K, 18),
                    dtype=torch.float32, device=dev)
    C = kernels.bind("ba_assemble", "ba_assemble_row_ctas",
                     [kernels.CI] * 2)(K, N)
    partial = torch.empty((max(K, 1) * C * 27,), dtype=torch.float32,
                          device=dev)
    fn = kernels.bind("ba_assemble", entry,
                      [kernels.VP] * 9 + [kernels.CI] * 3 + _K5_CAM
                      + [kernels.VP] * 7)
    kernels.LAUNCHES[entry] += 1
    kernels.check(fn(*(kernels.ptr(t) for t in args),
                     kernels.ptr(index.offsets), kernels.ptr(index.slots),
                     K, N, Q, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                     int(use_huber),
                     *(kernels.ptr(t) for t in (Hpp, g_p, acc, T, partial)),
                     kernels.ptr(kernels.ticket(dev, "ba_assemble", K)),
                     kernels.stream_of(kf_pose)), entry)
    return Hpp, g_p, acc, LiveRows(T, index) if w_obs else T


def ba_cost(kf_pose, pt_pos, p: BAProblem, obs_ok, cam, use_huber: bool,
            want_chi2: bool = True):
    """Huber cost over `obs_ok` and chi2[K,N] (None unless `want_chi2`; see
    `ba_cost_plain`), one launch. CUDA tensors -> kernel
    `csrc/ba_assemble.cu`; CPU -> plain version."""
    if not kf_pose.is_cuda:
        return ba_cost_plain(kf_pose, pt_pos, p, obs_ok, cam, use_huber,
                             want_chi2)
    args, K, N, Q = _k5_inputs(kf_pose, pt_pos, p, obs_ok)
    dev = kf_pose.device
    n_cta = kernels.bind("ba_assemble", "ba_cost_ctas",
                         [kernels.CI] * 2)(K, N)
    partial = torch.empty((n_cta,), dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    chi2 = (torch.empty((K, N), dtype=torch.float32, device=dev)
            if want_chi2 else None)
    fn = kernels.bind("ba_assemble", "ba_cost",
                      [kernels.VP] * 7 + [kernels.CI] * 3 + _K5_CAM
                      + [kernels.VP] * 5)
    kernels.LAUNCHES["ba_cost"] += 1
    kernels.check(fn(*(kernels.ptr(t) for t in args), K, N, Q, cam.fx, cam.fy,
                     cam.cx, cam.cy, cam.bf, int(use_huber),
                     kernels.ptr(partial),
                     kernels.ptr(kernels.ticket(dev, "ba_cost", 1)),
                     kernels.ptr(cost),
                     None if chi2 is None else kernels.ptr(chi2),
                     kernels.stream_of(kf_pose)), "ba_cost")
    return cost, chi2


# ---------------------------------------------------------------------------
# kernel K6 (an LM iteration's CG solve of the CG branch) and its plain
# versions
# ---------------------------------------------------------------------------

def ba_schur_ut_plain(v, W_obs, obs_pt, obs_ok, Q: int):
    """U^T v: f32[Q,3], each live slot's W_obs^T v_k added to its point
    (JAX `U_T`)."""
    K, N = obs_pt.shape
    contrib = torch.einsum("sij,si->sj", W_obs.reshape(K * N, 6, 3),
                           v.repeat_interleave(N, 0))
    flat_pt = torch.clamp(obs_pt, 0, Q - 1).long().reshape(-1)
    out = torch.zeros((Q, 3), dtype=v.dtype, device=v.device)
    return out.index_add_(0, flat_pt, torch.where(
        obs_ok.reshape(-1, 1), contrib, torch.zeros_like(contrib)))


def ba_schur_u_plain(y, W_obs, obs_pt, obs_ok):
    """U y: f32[K,6], each live slot's W_obs y_p summed over its keyframe's
    features (JAX `U`)."""
    K, N = obs_pt.shape
    yk = y[torch.clamp(obs_pt, 0, y.shape[0] - 1).long()]
    contrib = torch.einsum("knij,knj->kni", W_obs.reshape(K, N, 6, 3), yk)
    return torch.where(obs_ok[..., None], contrib,
                       torch.zeros_like(contrib)).sum(1)


def ba_schur_mv_plain(v, free, Hpp_d, G, W_obs, obs_pt, obs_ok):
    """S v = (Hpp_d v - U G U^T v) on the free keyframes (JAX `S_mv`),
    f32[K,6]."""
    fm = free[:, None].to(v.dtype)
    v = v * fm
    out = torch.einsum("kij,kj->ki", Hpp_d, v)
    w1 = ba_schur_ut_plain(v, W_obs, obs_pt, obs_ok, G.shape[0])
    w2 = torch.einsum("pij,pj->pi", G, w1)
    return (out - ba_schur_u_plain(w2, W_obs, obs_pt, obs_ok)) * fm


def cg_solve_plain(Hpp_d, g_p, g_l, G, W_obs, obs_pt, obs_ok, free,
                   cg_iters: int):
    """Plain PyTorch version of K6's `ba_schur_cg` (same signature; W_obs
    in JAX's [K*N, 18] slot layout, as `ba_assemble_plain` gives it):
    dp [K,6] and U^T dp [Q,3] of one LM iteration by `cg_iters` iterations
    of block-Jacobi preconditioned CG on S dp = -(g_p - U G g_l), free
    keyframes only (JAX `optim/ba.py:319-360, 400-412`)."""
    fm = free[:, None].to(torch.float32)
    eye6 = torch.eye(6, dtype=torch.float32, device=Hpp_d.device)
    Minv = torch.linalg.inv(Hpp_d + 1e-9 * eye6)

    def precond(v):
        return torch.einsum("kij,kj->ki", Minv, v) * fm

    Gg = torch.einsum("pij,pj->pi", G, g_l)
    rhs = -(g_p - ba_schur_u_plain(Gg, W_obs, obs_pt, obs_ok)) * fm
    x = torch.zeros_like(rhs)
    rr = rhs
    z = precond(rhs)
    pdir = z
    rz = torch.sum(rhs * z)
    for _ in range(cg_iters):
        Ap = ba_schur_mv_plain(pdir, free, Hpp_d, G, W_obs, obs_pt, obs_ok)
        denom = torch.sum(pdir * Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-12,
                                 torch.full_like(denom, 1e-12), denom)
        x = x + alpha * pdir
        rr = rr - alpha * Ap
        z = precond(rr)
        rz_new = torch.sum(rr * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-12,
                                    torch.full_like(rz, 1e-12), rz)
        pdir = z + beta * pdir
        rz = rz_new
    return x, ba_schur_ut_plain(x, W_obs, obs_pt, obs_ok, G.shape[0])


def ba_schur_cg(Hpp_d, g_p, g_l, G, W_obs, obs_pt, obs_ok, free,
                cg_iters: int):
    """dp [K,6] and U^T dp [Q,3] of one LM iteration (see
    `cg_solve_plain`). CUDA tensors -> kernel `csrc/ba_schur.cu`, one
    cooperative launch for the whole solve, on W_obs as `ba_assemble(...,
    w_obs=True)` gives it on the card (`LiveRows`, and nothing else); the
    block-Jacobi inverse is computed before it, as JAX computes it outside
    the CG loop. CPU -> plain version."""
    if not Hpp_d.is_cuda:
        return cg_solve_plain(Hpp_d, g_p, g_l, G, W_obs, obs_pt, obs_ok,
                              free, cg_iters)
    if not isinstance(W_obs, LiveRows):
        raise TypeError("ba_schur_cg: on the card W_obs is K5's LiveRows "
                        f"(the live rows in point order), got {type(W_obs)}")
    rows, index = W_obs
    K, N = obs_pt.shape
    Q = G.shape[0]
    limit = kernels.bind("ba_schur", "ba_schur_cg_max_k", [])()
    if not 1 <= K <= limit or N < 1 or Q < 1 or cg_iters < 0:
        raise ValueError(f"ba_schur_cg: needs 1 <= K <= {limit}, N, Q >= 1 "
                         f"and cg_iters >= 0, got {K}, {N}, {Q}, {cg_iters}")
    args = [t.contiguous() for t in (Hpp_d, g_p, g_l, G, rows, obs_pt, free,
                                     index.offsets, index.slots, index.place)]
    for t, what, dtype, shape in zip(
            args, ("Hpp_d", "g_p", "g_l", "G", "W_obs", "obs_pt", "free",
                   "offsets", "slots", "place"),
            (torch.float32,) * 5 + (torch.int32, torch.bool)
            + (torch.int32,) * 3,
            ((K, 6, 6), (K, 6), (Q, 3), (Q, 3, 3), (K * N, 18), (K, N), (K,),
             (Q + 1,), (K * N,), (K * N,))):
        kernels.require(t, "ba_schur_cg " + what, dtype, shape)
    Hpp_d, g_p, g_l, G, rows, obs_pt, free, offsets, slots, place = args
    eye6 = torch.eye(6, dtype=torch.float32, device=Hpp_d.device)
    # `inv_ex`: `inv`'s result without its error check, which reads the
    # device's status back to the host
    Minv = torch.linalg.inv_ex(Hpp_d + 1e-9 * eye6).inverse.contiguous()
    scratch = torch.empty((3 * Q + 6 * K,), dtype=torch.float32,
                          device=Hpp_d.device)
    x = torch.empty((K, 6), dtype=torch.float32, device=Hpp_d.device)
    ut = torch.empty((Q, 3), dtype=torch.float32, device=Hpp_d.device)
    fn = kernels.bind("ba_schur", "ba_schur_cg",
                      [kernels.VP] * 11 + [kernels.CI] * 4
                      + [kernels.VP] * 4)
    kernels.LAUNCHES["ba_schur_cg"] += 1
    kernels.check(fn(*(kernels.ptr(t) for t in (
        Hpp_d, Minv, g_p, g_l, G, rows, obs_pt, offsets, slots, place,
        free)), K, N, Q, cg_iters, kernels.ptr(scratch), kernels.ptr(x),
        kernels.ptr(ut), kernels.stream_of(Hpp_d)), "ba_schur_cg")
    return x, ut


# ---------------------------------------------------------------------------
# the sharded solve's collectives, and K6 split at its reductions
# ---------------------------------------------------------------------------

def collective(name: str, fn, *tensors, group):
    """`fn(*tensors, group=group)`, one of the sharded solve's collectives,
    counted in `kernels.COLLECTIVES[name]` and its host time in
    `kernels.COLLECTIVE_HOST_S[name]`; returns `tensors[0]`."""
    t0 = time.perf_counter()
    fn(*tensors, group=group)
    kernels.count_collective(name, time.perf_counter() - t0)
    return tensors[0]


def all_gather_rows(x, group):
    """Every rank's [R, ...] rows -> [n R, ...] in rank order."""
    x = x.contiguous()
    out = torch.empty((group.size() * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return collective("all_gather", dist.all_gather_into_tensor, out, x,
                      group=group)


class ShardComm:
    """The collectives of a keyframe-sharded solve over `group` (JAX's
    `psum`, `psum_scatter` and `all_gather` over the mesh axis). The points
    shard as JAX shards them (`optim/ba.py:242-243`): group size > 1, the
    CG branch and P % n == 0; then rank r holds point rows
    [r P/n, (r + 1) P/n). Each collective runs in the caller's stream
    order and is counted by `collective`. Gloo takes CUDA tensors for all
    three (torch 2.11 on the H100, phase 3n of `chip_smoke.py`), so two
    ranks can share one card."""

    def __init__(self, group, P: int, dense_schur: bool = False):
        self.group = group
        self.n, self.rank = group.size(), group.rank()
        self.shard = self.n > 1 and not dense_schur and P % self.n == 0
        self.Psh = P // self.n if self.shard else P

    def _run(self, name, fn, *tensors):
        return collective(name, fn, *tensors, group=self.group)

    def sum_(self, t):
        """`t` summed over the group, in place (JAX `psum`)."""
        return self._run("all_reduce", dist.all_reduce, t)

    def to_shard(self, x):
        """A local [P, ...] accumulator -> the reduced rows this rank holds:
        [P/n, ...] by `reduce_scatter` when the points shard, else all of
        them by `all_reduce`."""
        x = x.contiguous()
        if not self.shard:
            return self.sum_(x)
        out = torch.empty((self.Psh,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return self._run("reduce_scatter", dist.reduce_scatter_tensor, out,
                         x)

    def to_full(self, x):
        """This rank's [P/n, ...] rows -> [P, ...] in rank order when the
        points shard; else `x` as it is."""
        return all_gather_rows(x, self.group) if self.shard else x

    def my_rows(self, x):
        """This rank's rows of a replicated [P, ...] array."""
        if not self.shard:
            return x
        return x[self.rank * self.Psh:(self.rank + 1) * self.Psh]


def _guard(d):
    return torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)


def ba_cg_ut_plain(W_obs, obs_pt, obs_ok, free, v, out, p_prev=None,
                   p_out=None, rz=None, it: int = 0):
    """Plain version of K6s `ba_cg_ut` (same signature; W_obs in the slot
    layout). Without `p_out`: out [Q,3] = U^T v over every live slot. With
    `p_out` (a CG iteration): p_out = v (the preconditioned residual z) at
    iteration 0, else v + beta p_prev with beta = rz[it] / rz[it - 1]
    (guarded), and out = U^T p_out on the free keyframes."""
    Q = out.shape[0]
    if p_out is None:
        return out.copy_(ba_schur_ut_plain(v, W_obs, obs_pt, obs_ok, Q))
    p = v if it == 0 else v + rz[it] / _guard(rz[it - 1]) * p_prev
    p_out.copy_(p)
    fm = free[:, None].to(v.dtype)
    return out.copy_(ba_schur_ut_plain(p_out * fm, W_obs, obs_pt, obs_ok, Q))


def ba_cg_ap_plain(Hpp_d, g_p, G, vec, W_obs, obs_pt, obs_ok, free, out,
                   p=None, pap=None, it: int = 0):
    """Plain version of K6s `ba_cg_ap` (same signature; W_obs in the slot
    layout; G and vec [Q,...] over every point). Without `p` (the rhs):
    out = -(g_p - U G vec) on the free keyframes. With `p`: out = A p =
    Hpp_d p - U G vec on the free keyframes (vec = U^T p, summed over the
    group) and pap[it] = p . A p, this rank's part."""
    fm = free[:, None].to(g_p.dtype)
    y = torch.einsum("pij,pj->pi", G, vec)
    if p is None:
        return out.copy_(-(g_p - ba_schur_u_plain(y, W_obs, obs_pt, obs_ok))
                         * fm)
    hv = torch.einsum("kij,kj->ki", Hpp_d, p * fm)
    out.copy_((hv - ba_schur_u_plain(y, W_obs, obs_pt, obs_ok)) * fm)
    pap[it] = torch.sum(p * out)
    return out


def ba_cg_update_plain(Minv, free, r, x, z, rz, p=None, ap=None, pap=None,
                       it: int = 0):
    """Plain version of K6s `ba_cg_update` (same signature), in place.
    Without `p` (the setup): x = 0, z = Minv r on the free keyframes and
    rz[0] = r . z, this rank's part. With `p`: alpha = rz[it] / pap[it]
    (guarded), x += alpha p, r -= alpha ap, z = Minv r and rz[it + 1] =
    r . z."""
    fm = free[:, None].to(r.dtype)
    if p is None:
        x.zero_()
    else:
        alpha = rz[it] / _guard(pap[it])
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * ap)
    z.copy_(torch.einsum("kij,kj->ki", Minv, r) * fm)
    rz[0 if p is None else it + 1] = torch.sum(r * z)
    return x


def _cg_args(W_obs, obs_pt, free, K, N, Q, what):
    if not isinstance(W_obs, LiveRows):
        raise TypeError(f"{what}: on the card W_obs is K5's LiveRows (the "
                        f"live rows in point order), got {type(W_obs)}")
    limit = kernels.bind("ba_schur", "ba_schur_cg_max_k", [])()
    if not 1 <= K <= limit or N < 1 or Q < 1:
        raise ValueError(f"{what}: needs 1 <= K <= {limit} and N, Q >= 1, "
                         f"got {K}, {N}, {Q}")
    rows, index = W_obs
    kernels.require(rows, what + " W_obs", torch.float32, (K * N, 18))
    kernels.require(index.offsets, what + " offsets", torch.int32, (Q + 1,))
    kernels.require(index.slots, what + " slots", torch.int32, (K * N,))
    kernels.require(index.place, what + " place", torch.int32, (K * N,))
    kernels.require(obs_pt, what + " obs_pt", torch.int32, (K, N))
    kernels.require(free, what + " free", torch.bool, (K,))
    return rows, index


def ba_cg_ut(W_obs, obs_pt, obs_ok, free, v, out, p_prev=None, p_out=None,
             rz=None, it: int = 0):
    """This rank's part of U^T v [Q,3] (see `ba_cg_ut_plain`), one launch:
    a warp a point over its live rows. CUDA tensors -> kernel
    `csrc/ba_schur_sharded.cu`; CPU -> plain version."""
    if not v.is_cuda:
        return ba_cg_ut_plain(W_obs, obs_pt, obs_ok, free, v, out, p_prev,
                              p_out, rz, it)
    (K, N), Q = obs_pt.shape, out.shape[0]
    rows, index = _cg_args(W_obs, obs_pt, free, K, N, Q, "ba_cg_ut")
    mode = int(p_out is not None)
    kernels.require(v, "ba_cg_ut v", torch.float32, (K, 6))
    kernels.require(out, "ba_cg_ut out", torch.float32, (Q, 3))
    if mode:
        kernels.require(p_prev, "ba_cg_ut p_prev", torch.float32, (K, 6))
        kernels.require(p_out, "ba_cg_ut p_out", torch.float32, (K, 6))
        kernels.require(rz, "ba_cg_ut rz", torch.float32)
        if not 0 <= it < rz.numel() or p_prev.data_ptr() == p_out.data_ptr():
            raise ValueError("ba_cg_ut: needs 0 <= it < rz.numel() and "
                             "p_prev apart from p_out")
    fn = kernels.bind("ba_schur_sharded", "ba_cg_ut",
                      [kernels.VP] * 8 + [kernels.CI] * 5 + [kernels.VP] * 2)
    kernels.LAUNCHES["ba_cg_ut"] += 1
    kernels.check(fn(kernels.ptr(rows), kernels.ptr(index.offsets),
                     kernels.ptr(index.slots), kernels.ptr(free),
                     kernels.ptr(v),
                     kernels.ptr(p_prev) if mode else None,
                     kernels.ptr(rz) if mode else None,
                     kernels.ptr(p_out) if mode else None,
                     it, mode, K, N, Q, kernels.ptr(out),
                     kernels.stream_of(v)), "ba_cg_ut")
    return out


def ba_cg_ap(Hpp_d, g_p, G, vec, W_obs, obs_pt, obs_ok, free, out, p=None,
             pap=None, it: int = 0):
    """A p (or the rhs) on this rank's keyframes, with this rank's part of
    p . A p (see `ba_cg_ap_plain`), one launch: a block a keyframe over its
    live slots, G vec a slot; the last block adds the keyframes' parts in
    order. CUDA tensors -> kernel `csrc/ba_schur_sharded.cu`; CPU -> plain
    version."""
    if not g_p.is_cuda:
        return ba_cg_ap_plain(Hpp_d, g_p, G, vec, W_obs, obs_pt, obs_ok,
                              free, out, p, pap, it)
    (K, N), Q = obs_pt.shape, G.shape[0]
    rows, index = _cg_args(W_obs, obs_pt, free, K, N, Q, "ba_cg_ap")
    mode = int(p is not None)
    for t, what, shape in ((Hpp_d, "Hpp_d", (K, 6, 6)), (g_p, "g_p", (K, 6)),
                           (G, "G", (Q, 3, 3)), (vec, "vec", (Q, 3)),
                           (out, "out", (K, 6))):
        kernels.require(t, "ba_cg_ap " + what, torch.float32, shape)
    if mode:
        kernels.require(p, "ba_cg_ap p", torch.float32, (K, 6))
        kernels.require(pap, "ba_cg_ap pap", torch.float32)
        if not 0 <= it < pap.numel():
            raise ValueError("ba_cg_ap: needs 0 <= it < pap.numel()")
    dev = g_p.device
    part = torch.empty((K,), dtype=torch.float32, device=dev)
    fn = kernels.bind("ba_schur_sharded", "ba_cg_ap",
                      [kernels.VP] * 10 + [kernels.CI] * 5
                      + [kernels.VP] * 4)
    kernels.LAUNCHES["ba_cg_ap"] += 1
    kernels.check(fn(*(kernels.ptr(t) for t in (
        Hpp_d, g_p, G, vec, rows, obs_pt, index.place, free)),
        kernels.ptr(p) if mode else None, kernels.ptr(out), K, N, Q, mode,
        it, kernels.ptr(part), kernels.ptr(kernels.ticket(dev, "ba_cg_ap", 1)),
        kernels.ptr(pap) if mode else None, kernels.stream_of(g_p)),
        "ba_cg_ap")
    return out


def ba_cg_update(Minv, free, r, x, z, rz, p=None, ap=None, pap=None,
                 it: int = 0):
    """The CG's vector step on this rank's keyframes (see
    `ba_cg_update_plain`), one launch of one block. CUDA tensors -> kernel
    `csrc/ba_schur_sharded.cu`; CPU -> plain version."""
    if not r.is_cuda:
        return ba_cg_update_plain(Minv, free, r, x, z, rz, p, ap, pap, it)
    K = r.shape[0]
    mode = int(p is not None)
    kernels.require(Minv, "ba_cg_update Minv", torch.float32, (K, 6, 6))
    kernels.require(free, "ba_cg_update free", torch.bool, (K,))
    for t, what in ((r, "r"), (x, "x"), (z, "z")) + (
            ((p, "p"), (ap, "ap")) if mode else ()):
        kernels.require(t, "ba_cg_update " + what, torch.float32, (K, 6))
    kernels.require(rz, "ba_cg_update rz", torch.float32)
    if mode:
        kernels.require(pap, "ba_cg_update pap", torch.float32)
        if not (0 <= it < pap.numel() and it + 1 < rz.numel()):
            raise ValueError("ba_cg_update: needs it < pap.numel() and "
                             "it + 1 < rz.numel()")
    fn = kernels.bind("ba_schur_sharded", "ba_cg_update",
                      [kernels.VP] * 9 + [kernels.CI] * 3 + [kernels.VP])
    kernels.LAUNCHES["ba_cg_update"] += 1
    kernels.check(fn(*(kernels.ptr(t) for t in (Minv, free, r, x, z, rz)),
                     kernels.ptr(p) if mode else None,
                     kernels.ptr(ap) if mode else None,
                     kernels.ptr(pap) if mode else None, K, mode, it,
                     kernels.stream_of(r)), "ba_cg_update")
    return x


def _split_cg(Hpp_d, g_p, g_l, G, W_obs, obs_pt, obs_ok, free,
              cg_iters: int, comm: Optional[ShardComm], entries):
    """The sharded CG as `entries` (ut, ap, update) and the collectives
    between them: per CG iteration ut (beta, p and this rank's U^T p), its
    all_reduce, ap (G w1 a slot, A p and this rank's p . A p), its
    all_reduce, update (alpha, x, r, z and this rank's r . z), its
    all_reduce: three launches and three collectives. JAX reduce-scatters
    U^T p and gathers G w1 when the points shard; with G applied a slot
    there is no per-point work to divide, and one all_reduce moves the
    same bytes. g_l and G are this rank's point rows, gathered once; U^T
    dp comes back as this rank's rows."""
    ut, ap, update = entries
    K = obs_pt.shape[0]
    dev = g_p.device
    sum_ = comm.sum_ if comm is not None else (lambda t: t)
    shard = comm.to_shard if comm is not None else (lambda t: t)
    full = comm.to_full if comm is not None else (lambda t: t)
    G_f = full(G.reshape(G.shape[0], 9)).reshape(-1, 3, 3)
    gl_f = full(g_l.contiguous())
    P = G_f.shape[0]
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    Minv = torch.linalg.inv_ex(Hpp_d + 1e-9 * eye6).inverse.contiguous()
    r, x, z, Ap = (torch.empty((K, 6), dtype=torch.float32, device=dev)
                   for _ in range(4))
    pbuf = torch.empty((2, K, 6), dtype=torch.float32, device=dev)
    # this iteration's scalars, reduced in place: r.z before iteration i at
    # rz[i], p.Ap of iteration i at pap[i]
    rz = torch.zeros((cg_iters + 1,), dtype=torch.float32, device=dev)
    pap = torch.zeros((max(cg_iters, 1),), dtype=torch.float32, device=dev)
    part = torch.empty((P, 3), dtype=torch.float32, device=dev)
    ap(Hpp_d, g_p, G_f, gl_f, W_obs, obs_pt, obs_ok, free, r)
    update(Minv, free, r, x, z, rz)
    sum_(rz[0:1])
    for i in range(cg_iters):
        p = pbuf[i % 2]
        ut(W_obs, obs_pt, obs_ok, free, z, part, p_prev=pbuf[(i + 1) % 2],
           p_out=p, rz=rz, it=i)
        w1 = sum_(part)
        ap(Hpp_d, g_p, G_f, w1, W_obs, obs_pt, obs_ok, free, Ap, p=p,
           pap=pap, it=i)
        sum_(pap[i:i + 1])
        update(Minv, free, r, x, z, rz, p=p, ap=Ap, pap=pap, it=i)
        sum_(rz[i + 1:i + 2])
    ut(W_obs, obs_pt, obs_ok, free, x, part)
    return x, shard(part)


def sharded_cg_solve_plain(Hpp_d, g_p, g_l, G, W_obs, obs_pt, obs_ok, free,
                           cg_iters: int, comm: Optional[ShardComm] = None):
    """Plain version of `sharded_cg_solve` (same signature; W_obs in the
    slot layout): `cg_solve_plain` with the collectives, op for op, so
    that without a group (or in a group of one) it gives `cg_solve_plain`'s
    bits."""
    return _split_cg(Hpp_d, g_p, g_l, G, W_obs, obs_pt, obs_ok, free,
                     cg_iters, comm, (ba_cg_ut_plain, ba_cg_ap_plain,
                                      ba_cg_update_plain))


def sharded_cg_solve(Hpp_d, g_p, g_l, G, W_obs, obs_pt, obs_ok, free,
                     cg_iters: int, comm: Optional[ShardComm] = None):
    """dp [K,6] of this rank's keyframes and U^T dp of this rank's point
    rows of one LM iteration of a keyframe-sharded solve: `cg_solve_plain`'s
    solve with its sums over the group. g_l and G are this rank's point
    rows. CUDA tensors -> K6 split at its reductions (`ba_cg_ut`,
    `ba_cg_ap`, `ba_cg_update`: three launches a CG iteration) on W_obs as
    `ba_assemble(..., w_obs=True)` gives it on the card; CPU -> the same
    entries' plain versions (`sharded_cg_solve_plain`'s bits)."""
    if cg_iters < 0:
        raise ValueError(f"sharded_cg_solve: cg_iters >= 0, got {cg_iters}")
    return _split_cg(Hpp_d, g_p, g_l, G, W_obs, obs_pt, obs_ok, free,
                     cg_iters, comm, (ba_cg_ut, ba_cg_ap, ba_cg_update))


# the compacted global-BA problem's point count is a multiple of this, so
# that its shapes repeat from one loop to the next
POINT_BUCKET = 1024


def compact_points(p: BAProblem):
    """The problem restricted to its live points (`pt_valid`), in index
    order, padded with dead rows to a multiple of POINT_BUCKET; and the
    live point ids i64[n] (one host read). Every live point is kept."""
    live = torch.nonzero(p.pt_valid).reshape(-1)
    n = live.numel()
    Q = max(-(-n // POINT_BUCKET) * POINT_BUCKET, POINT_BUCKET)
    dev = p.pt_pos.device
    lut = torch.full((p.pt_pos.shape[0],), -1, dtype=torch.int32, device=dev)
    lut[live] = torch.arange(n, dtype=torch.int32, device=dev)
    obs_pt = torch.where(
        p.obs_pt >= 0, lut[torch.clamp(p.obs_pt, 0, lut.shape[0] - 1).long()],
        torch.full_like(p.obs_pt, -1))
    pt_pos = torch.zeros((Q, 3), dtype=p.pt_pos.dtype, device=dev)
    pt_pos[:n] = p.pt_pos[live]
    pt_valid = torch.zeros((Q,), dtype=torch.bool, device=dev)
    pt_valid[:n] = True
    frozen = None
    if p.pt_frozen is not None:
        frozen = torch.zeros((Q,), dtype=torch.bool, device=dev)
        frozen[:n] = p.pt_frozen[live]
    return p._replace(obs_pt=obs_pt, pt_pos=pt_pos, pt_valid=pt_valid,
                      pt_frozen=frozen), live


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def ba_solve(p: BAProblem, cam: proj.CameraIntrinsics, iters: int = 10,
             cg_iters: int = 50, use_huber: bool = True,
             chi2_gate: bool = True, lambda0: float = 1e-4,
             dense_schur: bool = False, group=None) -> BAResult:
    """LM bundle adjustment with the landmarks eliminated (Schur).

    `dense_schur=True` forms S = blockdiag(Hpp_d) - sum_j T_j G_j T_j^T from
    the per-point camera-block sums and solves it directly ([K*6, K*6],
    192x192 for the W=32 window; `cg_iters` unused). `dense_schur=False`
    solves the same system by `cg_iters` iterations of block-Jacobi
    preconditioned CG, S applied matrix-free, one K6 launch an LM
    iteration.

    With `group` (a `torch.distributed` process group; JAX's `axis_name`
    and `axis_size` under `shard_map`), `p`'s keyframe axis is this rank's
    shard and its points are replicated: every cross-device reduction is a
    collective of `ShardComm`, the CG is `sharded_cg_solve`, the dense
    branch solves every rank's keyframes (`_dense_step_gathered`), and
    pt_pos comes back with the same bits on every rank. A group of one
    gives the unsharded solve's result (on the CPU its bits)."""
    comm = (None if group is None
            else ShardComm(group, p.pt_pos.shape[0], dense_schur))
    with highest_precision():
        return _ba_solve_f32(p, cam, iters, use_huber, chi2_gate, lambda0,
                             dense_schur, cg_iters, comm)


def _dense_step(T, Hpp_d, g_p, g_l, G, free, K, P):
    """dp [K,6] and U^T dp [P,3] of one LM iteration from the dense reduced
    camera system S [K*6, K*6], solved directly (JAX
    `optim/ba.py:362-391`)."""
    D = K * 6
    fmask = free.repeat_interleave(6).to(torch.float32)
    k6 = (torch.arange(K, device=T.device)[:, None] * 6
          + torch.arange(6, device=T.device)[None, :])
    rows = k6[:, :, None].expand(K, 6, 6)
    cols = k6[:, None, :].expand(K, 6, 6)
    T3 = T.reshape(P, D, 3)
    TG = torch.einsum("pdi,pij->pdj", T3, G)
    S_sub = torch.einsum("pdi,pei->de", TG, T3)
    S = torch.zeros((D, D), dtype=torch.float32, device=T.device)
    S.index_put_((rows.reshape(-1), cols.reshape(-1)), Hpp_d.reshape(-1),
                 accumulate=True)
    S = S - S_sub
    S = S * fmask[:, None] * fmask[None, :]
    S = S + torch.diag(1.0 - fmask)
    Gg = torch.einsum("pij,pj->pi", G, g_l)
    rhs = -(g_p.reshape(D) - torch.einsum("pdi,pi->d", T3, Gg)) * fmask
    dp = torch.linalg.solve(S, rhs).reshape(K, 6)
    dp = dp * free[:, None]
    return dp, torch.einsum("pdi,d->pi", T3, dp.reshape(D))


def _dense_step_gathered(comm, T, Hpp_d, g_p, g_l, G, free_all, K, P):
    """`_dense_step` over a group of n > 1 ranks, each holding K keyframes:
    every rank's keyframe rows of Hpp_d, g_p and T gathered in rank order
    (one `all_gather`) and the whole [n K*6, n K*6] system solved on each
    rank. dp is this rank's rows; U^T dp sums every keyframe's, with the
    same bits on every rank."""
    Ka = comm.n * K
    mine = torch.cat([Hpp_d.reshape(K, 36), g_p,
                      T.reshape(P, K, 18).transpose(0, 1).reshape(K, P * 18)],
                     1)
    every = all_gather_rows(mine, comm.group)
    T_all = every[:, 42:].reshape(Ka, P, 18).transpose(0, 1).reshape(
        P * Ka, 18)
    dp, ut_dp = _dense_step(T_all, every[:, :36].reshape(Ka, 6, 6),
                            every[:, 36:42], g_l, G, free_all, Ka, P)
    return dp[comm.rank * K:(comm.rank + 1) * K], ut_dp


def _ba_solve_f32(p: BAProblem, cam, iters, use_huber, chi2_gate,
                  lambda0, dense_schur=True, cg_iters=50,
                  comm: Optional[ShardComm] = None) -> BAResult:
    K, N = p.obs_uv.shape[:2]
    P = p.pt_pos.shape[0]
    dev = p.pt_pos.device
    has_ur = p.obs_ur > 0
    chi2_th = torch.where(has_ur, torch.full_like(p.obs_ur, CHI2_STEREO),
                          torch.full_like(p.obs_ur, CHI2_MONO))
    obs_ok0 = (p.obs_pt >= 0) & p.pt_valid[
        torch.clamp(p.obs_pt, 0, P - 1).long()]
    free = ~p.kf_fixed
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    # the dense branch over several ranks solves every rank's keyframes
    gathered = dense_schur and comm is not None and comm.n > 1
    if gathered:
        free_all = all_gather_rows(free.to(torch.uint8), comm.group).bool()

    sum_ = comm.sum_ if comm is not None else (lambda t: t)
    # obs_pt and obs_ok0 hold for the whole solve: one point index
    index = ba_point_index(p.obs_pt, obs_ok0, P)
    cost0 = sum_(ba_cost(p.kf_pose, p.pt_pos, p, obs_ok0, cam, use_huber,
                         want_chi2=False)[0])
    kf_pose, pt_pos = p.kf_pose, p.pt_pos
    lam = torch.full((), lambda0, dtype=torch.float32, device=dev)
    cost = cost0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        Hpp, g_p, acc, T = ba_assemble(kf_pose, pt_pos, p, obs_ok0, cam,
                                       use_huber, index=index,
                                       w_obs=not dense_schur)
        if comm is not None:
            # this rank's point rows, summed over the group
            acc = comm.to_shard(acc)
        Hll = acc[:, :9].reshape(acc.shape[0], 3, 3)
        g_l = acc[:, 9:]
        dp_diag = torch.diagonal(Hpp, dim1=1, dim2=2)
        Hpp_d = Hpp + (lam * dp_diag + 1e-6)[:, :, None] * eye6
        dl_diag = torch.diagonal(Hll, dim1=1, dim2=2)
        Hll_d = Hll + (lam * dl_diag + 1e-6)[:, :, None] * eye3
        G = _inv3x3(Hll_d + 1e-9 * eye3)
        if p.pt_frozen is not None:
            # frozen landmarks leave the Schur elimination (G = 0): no
            # -U G U^T term, and dl = 0 in back-substitution
            frozen = (p.pt_frozen if comm is None
                      else comm.my_rows(p.pt_frozen))
            G = torch.where(frozen[:, None, None], torch.zeros_like(G), G)
        if gathered:
            dp, ut_dp = _dense_step_gathered(comm, T, Hpp_d, g_p, g_l, G,
                                             free_all, K, P)
        elif dense_schur:
            dp, ut_dp = _dense_step(T, Hpp_d, g_p, g_l, G, free, K, P)
        elif comm is None:
            dp, ut_dp = ba_schur_cg(Hpp_d, g_p, g_l, G, T, p.obs_pt,
                                    obs_ok0, free, cg_iters)
        else:
            dp, ut_dp = sharded_cg_solve(Hpp_d, g_p, g_l, G, T, p.obs_pt,
                                         obs_ok0, free, cg_iters, comm)
        dl = torch.einsum("pij,pj->pi", G, -g_l - ut_dp)
        if comm is not None:
            # this rank's rows, gathered: the same bits on every rank
            dl = comm.to_full(dl)
        dl = torch.where(p.pt_valid[:, None], dl, torch.zeros_like(dl))
        new_pose = se3.retract(kf_pose, dp)
        new_pose = torch.where(free[:, None], new_pose, kf_pose)
        new_pts = pt_pos + dl
        new_cost = sum_(ba_cost(new_pose, new_pts, p, obs_ok0, cam,
                                use_huber, want_chi2=False)[0])
        improved = new_cost < cost
        # frozen-state mask: an iteration after `done` changes nothing
        take = improved & ~done
        kf_pose = torch.where(take, new_pose, kf_pose)
        pt_pos = torch.where(take, new_pts, pt_pos)
        lam_out = torch.clamp(torch.where(improved, lam * 0.4, lam * 5.0),
                              1e-8, 1e5)
        lam = torch.where(done, lam, lam_out)
        rel_gain = (cost - new_cost) / torch.clamp(cost, min=1e-12)
        cost = torch.where(take, new_cost, cost)
        done = done | (improved & (rel_gain < 1e-5))
    # chi2 is a slot's own: the gate needs no collective (JAX's psum of
    # this cost is unused)
    _, chi2 = ba_cost(kf_pose, pt_pos, p, obs_ok0, cam, use_huber)
    inlier = obs_ok0 & (chi2 <= chi2_th) if chi2_gate else obs_ok0
    return BAResult(kf_pose, pt_pos, cost0, cost, inlier)
