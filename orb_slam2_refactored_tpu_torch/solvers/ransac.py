"""RANSAC solvers: Horn 3D-3D (the RGB-D/stereo fallback and relocalization)
and planar-safe PnP (the monocular fallback and relocalization).

Port of `orb_slam2_refactored_tpu/solvers/ransac.py`:
- `horn_align` / `horn_ransac`: closed-form absolute orientation from 3
  correspondences inside RANSAC (fixed scale for RGB-D), all hypotheses as
  one batch;
- `pnp_ransac`: half the hypotheses DLT resections (`_dlt_resection`,
  exact on general structure), half plane-homography decompositions
  (`_planar_resection`, exact on coplanar structure), every one scored on
  all points, then a non-minimal refit of both families on the winner's
  inliers and an argmax over the three;
- `p6p_ransac`: the DLT-only variant with 12-point samples.

Differences of form from the JAX package:
- the samples are drawn apart from the solvers, by `draw_samples`: Gumbel
  top-k from an explicit `torch.Generator` (JAX splits a PRNG key). Each
  solver takes the drawn `[S, k]` indices as `samples`, or draws them from
  `generator`; JAX's PRNG stream cannot be reproduced in torch, so with
  the generator the results agree with the JAX package in outcome, and
  with JAX's own draws passed in, hypothesis by hypothesis;
- the hypotheses of a population are solved as one batch of SVDs (JAX
  vmaps one solve); the nullspace of a sample's `[2n, 12]` or `[2n, 9]`
  system comes from its full `Vh`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import projection as proj
from ..geometry import se3


class RansacResult(NamedTuple):
    success: torch.Tensor   # bool
    pose: torch.Tensor      # f32[7]
    scale: torch.Tensor     # f32 (1.0 when fixed)
    inliers: torch.Tensor   # bool[M]
    n_inliers: torch.Tensor


def _kabsch(xs, xd, with_scale: bool):
    """R, s from centred point sets [..., K, 3] (src -> dst)."""
    cov = xd.transpose(-1, -2) @ xs
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    ones = torch.ones_like(det)
    S = torch.diag_embed(torch.stack([ones, ones, det], dim=-1))
    R = U @ S @ Vt
    if with_scale:
        var_s = torch.clamp(torch.sum(xs * xs, dim=(-1, -2)), min=1e-12)
        s = torch.sum(D * torch.diagonal(S, dim1=-2, dim2=-1), dim=-1) / var_s
    else:
        s = torch.ones_like(det)
    return R, s


def horn_align(x_src, x_dst, with_scale: bool):
    """Closed-form similarity aligning src -> dst point sets [..., K, 3].
    Returns (q, t, s): x_dst ~= s*R(q) x_src + t."""
    mu_s = x_src.mean(-2)
    mu_d = x_dst.mean(-2)
    R, s = _kabsch(x_src - mu_s[..., None, :], x_dst - mu_d[..., None, :],
                   with_scale)
    t = mu_d - s[..., None] * (R @ mu_s[..., :, None])[..., 0]
    return se3.quat_from_matrix(R), t, s


def draw_samples(valid, n: int, k: int,
                 generator: torch.Generator) -> torch.Tensor:
    """i64[n, k]: n samples of k indices drawn without replacement among
    the `valid` ones (Gumbel top-k: uniform over the valid k-subsets)."""
    u = torch.rand((n, valid.shape[0]), generator=generator,
                   device=valid.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-7)))
    g = gumbel + torch.where(valid, 0.0, -1e9)[None, :]
    return torch.topk(g, k, dim=1).indices


def horn_ransac(x_src, x_dst, valid, generator: torch.Generator,
                with_scale: bool = False, n_iters: int = 128,
                inlier_th: float = 0.09, min_inliers: int = 20) -> RansacResult:
    """RANSAC absolute orientation between matched 3D sets [M,3]; inlier
    gate e2 < th * min(1, s^2) with 0.25 < s < 4 (threshold in m^2)."""
    def gate(e2, s):
        s_ok = (s > 0.25) & (s < 4.0)
        return (e2 < inlier_th * torch.clamp(s * s, max=1.0)) & s_ok

    idx = draw_samples(valid, n_iters, 3, generator)  # [I,3]
    q, t, s = horn_align(x_src[idx], x_dst[idx], with_scale)  # [I,...]
    pred = s[:, None, None] * se3.quat_rotate(q[:, None, :], x_src[None]) \
        + t[:, None, :]
    e2 = torch.sum((pred - x_dst[None]) ** 2, dim=-1)  # [I,M]
    inls = valid[None, :] & gate(e2, s[:, None])
    n_inl = inls.sum(dim=1)
    best = torch.argmax(n_inl)
    inl = inls[best]
    # refine on the full inlier set
    w = inl.to(torch.float32)[:, None]
    n = torch.clamp(inl.sum(), min=3).to(torch.float32)
    mu_s = (x_src * w).sum(0) / n
    mu_d = (x_dst * w).sum(0) / n
    R, s = _kabsch((x_src - mu_s) * w, (x_dst - mu_d) * w, with_scale)
    t = mu_d - s * (R @ mu_s)
    q = se3.quat_from_matrix(R)
    pred = s * se3.quat_rotate(q[None], x_src) + t[None]
    e2 = torch.sum((pred - x_dst) ** 2, dim=-1)
    inl = valid & gate(e2, s)
    n = inl.sum()
    return RansacResult(success=n >= min_inliers, pose=se3.make(q, t),
                        scale=s, inliers=inl, n_inliers=n)


def _nullvec(A):
    """The right singular vector of the smallest singular value of each
    [..., m, n] system (the whole Vh, also when m < n)."""
    return torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])[2][
        ..., -1, :]


def _nearest_rotation(Rraw):
    """(R, D, det): the rotation nearest each [..., 3, 3] matrix."""
    U, D, Vt = torch.linalg.svd(Rraw)
    det = torch.linalg.det(U @ Vt)
    ones = torch.ones_like(det)
    R = U @ torch.diag_embed(torch.stack([ones, ones, det], -1)) @ Vt
    return R, D, det


def _from_Rt(R, t):
    return se3.make(se3.quat_from_matrix(R), t)


def _dlt_matrix(X, uv, w=None):
    """The DLT's P [..., 3, 4] (unit norm, sign arbitrary): the nullspace
    of the [2n, 12] system of [..., n, 3] points and their normalized image
    coords [..., n, 2]. `w` [..., n]: per-point weights (0 rows drop
    out)."""
    ones = torch.ones_like(X[..., :1])
    Xh = torch.cat([X, ones], -1)  # [...,n,4]
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -uv[..., 0:1] * Xh], -1)
    r2 = torch.cat([zeros, Xh, -uv[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], -2)  # [...,2n,12]
    if w is not None:
        A = A * torch.cat([w, w], -1)[..., None]
    return _nullvec(A).reshape(A.shape[:-2] + (3, 4))


def _dlt_resection(X, uv, w=None):
    """6+ point DLT resection (see `_dlt_matrix`): P, the nearest rotation
    to its leading 3x3, the signed scale, then the cheirality flip (most
    points in front)."""
    P = _dlt_matrix(X, uv, w)
    R, D, det = _nearest_rotation(P[..., :3])
    scale = torch.sum(D, -1) / 3.0 * det  # signed scale
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12,
                                torch.full_like(scale, 1e-12), scale)[..., None]
    z = torch.sum(X * R[..., None, 2, :], -1) + t[..., None, 2]
    flip = (torch.sum(torch.sign(z), -1) < 0)[..., None]
    R = torch.where(flip[..., None], -R, R)
    t = torch.where(flip, -t, t)
    return _from_Rt(R, t)


def _planar_resection(X, xn, w=None):
    """Pose from a (near-)coplanar 2D-3D set [..., n, 3] / [..., n, 2]:
    the weighted PCA plane (`eigh`, a right-handed in-plane frame), the
    DLT of the plane -> normalized-image homography ([2n, 9]), its sign
    from the centroid's depth (h3[2] > 0), and H = [r1 r2 t] / lambda with
    the nearest rotation. `w` [..., n]: per-point weights. The pose does
    not depend on the signs `eigh` gives its vectors."""
    ww = torch.ones_like(X[..., 0]) if w is None else w
    wn = ww / torch.clamp(ww.sum(-1, keepdim=True), min=1e-9)
    c = torch.sum(X * wn[..., None], -2)
    Xc = X - c[..., None, :]
    cov = (Xc * wn[..., None]).transpose(-1, -2) @ Xc
    _, evecs = torch.linalg.eigh(cov)  # ascending
    v_ax, u_ax = evecs[..., :, 1], evecs[..., :, 2]
    nrm = torch.linalg.cross(u_ax, v_ax)
    p2 = torch.stack([torch.sum(Xc * u_ax[..., None, :], -1),
                      torch.sum(Xc * v_ax[..., None, :], -1)], -1)
    ph = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    zeros = torch.zeros_like(ph)
    r1 = torch.cat([ph, zeros, -xn[..., 0:1] * ph], -1)
    r2 = torch.cat([zeros, ph, -xn[..., 1:2] * ph], -1)
    A = torch.cat([r1, r2], -2) * torch.cat([ww, ww], -1)[..., None]
    H = _nullvec(A).reshape(A.shape[:-2] + (3, 3))
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = torch.sqrt(torch.clamp(
        torch.linalg.norm(h1, dim=-1) * torch.linalg.norm(h2, dim=-1),
        min=1e-12))
    sgn = torch.where(h3[..., 2] < 0, -1.0, 1.0)
    f = (sgn / lam)[..., None]
    h1, h2, h3 = h1 * f, h2 * f, h3 * f
    Rp, _, _ = _nearest_rotation(
        torch.stack([h1, h2, torch.linalg.cross(h1, h2)], -1))
    R_wc = Rp @ torch.stack([u_ax, v_ax, nrm], -2)
    t_wc = h3 - (R_wc @ c[..., None])[..., 0]
    return _from_Rt(R_wc, t_wc)


def _reproj(cam, poses, pts3d, uv, valid, inlier_th_px):
    """e2 [..., M] and the inliers of poses [..., 7] on all points."""
    xc = se3.transform(poses[..., None, :],
                       pts3d.expand(poses.shape[:-1] + pts3d.shape))
    e2 = torch.sum((proj.project(cam, xc) - uv) ** 2, -1)
    return e2, valid & (xc[..., 2] > 0.01) & (e2 < inlier_th_px)


def _normalized(cam, uv):
    return torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                        (uv[:, 1] - cam.cy) / cam.fy], -1)


def pnp_ransac(pts3d, uv, valid, cam: proj.CameraIntrinsics,
               generator: torch.Generator = None, n_iters: int = 256,
               sample_size: int = 8, inlier_th_px: float = 9.0,
               min_inliers: int = 15, samples=None) -> RansacResult:
    """Planar-safe PnP RANSAC (the reference's EPnP relocalization solver,
    `src/PnPsolver.cc:165-258,375-568`): n_iters/2 DLT and n_iters/2 planar
    hypotheses in one batch, scored on all points (inliers, with the mean
    inlier error over `inlier_th_px` taken off to break ties toward the
    more accurate fit), then both families refit on the winner's inliers
    and the best of the three kept. `samples` i64[n_iters, sample_size]
    (DLT rows first): the drawn indices; else drawn from `generator`."""
    half = n_iters // 2
    if samples is None:
        samples = draw_samples(valid, 2 * half, sample_size, generator)
    xn = _normalized(cam, uv)

    def score(poses):
        e2, inl = _reproj(cam, poses, pts3d, uv, valid, inlier_th_px)
        n = inl.sum(-1)
        mean_e2 = torch.where(inl, e2, torch.zeros_like(e2)).sum(-1) \
            / torch.clamp(n, min=1)
        return n.to(torch.float32) - mean_e2 / inlier_th_px, inl

    sd, sp = samples[:half], samples[half:2 * half]
    poses = torch.cat([_dlt_resection(pts3d[sd], xn[sd]),
                       _planar_resection(pts3d[sp], xn[sp])])
    n_inl, inls = score(poses)
    best = torch.argmax(n_inl)
    w = inls[best].to(torch.float32)
    refit = torch.stack([_dlt_resection(pts3d, xn, w),
                         _planar_resection(pts3d, xn, w)])
    n_r, inl_r = score(refit)
    ns = torch.cat([n_inl[best][None], n_r])
    pick = torch.argmax(ns)
    pose = torch.cat([poses[best][None], refit])[pick]
    inl = torch.cat([inls[best][None], inl_r])[pick]
    n = inl.sum()
    return RansacResult(success=n >= min_inliers, pose=pose,
                        scale=torch.ones((), device=pose.device),
                        inliers=inl, n_inliers=n)


def p6p_ransac(pts3d, uv, valid, cam: proj.CameraIntrinsics,
               generator: torch.Generator = None, n_iters: int = 256,
               sample_size: int = 12, inlier_th_px: float = 9.0,
               min_inliers: int = 15, samples=None) -> RansacResult:
    """DLT-only RANSAC resection with non-minimal 12-point samples and a
    refit on the winner's inliers (`PnPsolver::Refine`,
    `src/PnPsolver.cc:260-306`), kept when it holds as many inliers.
    Degenerate on coplanar points: `pnp_ransac` is the tracker's."""
    if samples is None:
        samples = draw_samples(valid, n_iters, sample_size, generator)
    xn = _normalized(cam, uv)
    poses = _dlt_resection(pts3d[samples], xn[samples])
    _, inls = _reproj(cam, poses, pts3d, uv, valid, inlier_th_px)
    n_inl = inls.sum(-1)
    best = torch.argmax(n_inl)
    pose_r = _dlt_resection(pts3d, xn, inls[best].to(torch.float32))
    _, inl_r = _reproj(cam, pose_r, pts3d, uv, valid, inlier_th_px)
    use_r = inl_r.sum() >= n_inl[best]
    pose = torch.where(use_r, pose_r, poses[best])
    inl = torch.where(use_r, inl_r, inls[best])
    return RansacResult(
        success=torch.maximum(inl.sum(), n_inl[best]) >= min_inliers,
        pose=pose, scale=torch.ones((), device=pose.device), inliers=inl,
        n_inliers=inl.sum())
