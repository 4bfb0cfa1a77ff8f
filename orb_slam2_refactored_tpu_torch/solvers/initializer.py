"""Monocular bootstrap: homography and fundamental RANSAC as one batch, then
structure from motion.

Port of `orb_slam2_refactored_tpu/solvers/initializer.py` (the reference's
`Initializer`, `src/Initializer.cc:45-122`): a homography (8-point DLT) and
a fundamental matrix (8-point, rank 2) are fitted to the same 200 samples
and scored over every correspondence (sigma 1, th_H 5.991, th_F 3.841,
score cap 5.991); RH = SH / (SH + SF) > 0.40 picks the model; the 8
Faugeras motions of H and the 4 of E are checked together (cheirality,
parallax, reprojection), and the winner must dominate the runner-up, clear
1 degree of parallax and triangulate max(50, 0.9 n_inliers) points.

Differences of form from the JAX package:
- the samples are drawn apart from the solver (`ransac.draw_samples`,
  Gumbel top-8 from an explicit `torch.Generator`) or passed in as
  `samples` i64[n_iters, 8]; JAX splits a PRNG key. With JAX's own draws
  passed in, the two agree hypothesis by hypothesis;
- each population is one batch of SVDs (JAX vmaps one solve): 200 of
  `[16, 9]` and 200 of `[8, 9]` (its nullspace needs the full Vh), and
  12 x M of `[4, 4]` for the triangulation. Nothing is read back to the
  host: `InitResult` holds tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import projection as proj
from ..geometry import se3
from .ransac import _nullvec, draw_samples

TH_H = 5.991
TH_F = 3.841
TH_SCORE = 5.991  # both models' per-point score cap uses chi2(2dof)
N_ITERS = 200
MIN_PARALLAX_DEG = 1.0


class InitResult(NamedTuple):
    success: torch.Tensor          # bool
    pose21: torch.Tensor           # f32[7] frame1 -> frame2
    points3d: torch.Tensor         # f32[M,3] triangulated in frame-1 coords
    is_good: torch.Tensor          # bool[M] triangulation gates passed
    used_homography: torch.Tensor  # bool


def _kmat(cam: proj.CameraIntrinsics, device):
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def _normalize(pts, valid):
    """Hartley normalization (`Normalize`, :750): zero mean, unit mean
    absolute deviation over the valid points. Returns (pts_n, T)."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    d = (torch.abs(pts - mean) * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(d, min=1e-8)
    z = torch.zeros_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, torch.ones_like(z)])])
    return (pts - mean) * s, T


def _compute_h(p1, p2):
    """8-point homography DLT (`ComputeH21`, :227): p [..., 8, 2] each;
    the [16, 9] system's rows in JAX's order (two a point)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    r2 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    A = torch.stack([r1, r2], -2).reshape(p1.shape[:-2] + (-1, 9))
    return _nullvec(A).reshape(p1.shape[:-2] + (3, 3))


def _compute_f(p1, p2):
    """8-point fundamental matrix with the rank-2 projection (`ComputeF21`,
    :269): p [..., 8, 2] each."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                     torch.ones_like(x)], -1)  # [...,8,9]
    F = _nullvec(A).reshape(p1.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return (U * S[..., None, :]) @ Vt


def _homog(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], -1)


def _score_h(H, x1, x2, valid):
    """Symmetric transfer error score (`CheckHomography`, :306) of H
    [..., 3, 3] over x [M, 2]: (score [...], inliers [..., M])."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv(H + 1e-12 * eye)

    def transfer(Mx, a):
        b = _homog(a) @ Mx.transpose(-1, -2)
        w = b[..., 2:3]
        return b[..., :2] / torch.where(torch.abs(w) < 1e-12,
                                        torch.full_like(w, 1e-12), w)

    e12 = torch.sum((x2 - transfer(H, x1)) ** 2, -1)
    e21 = torch.sum((x1 - transfer(Hinv, x2)) ** 2, -1)
    ok = (e12 < TH_H) & (e21 < TH_H) & valid
    zero = torch.zeros_like(e12)
    score = (torch.where(valid & (e12 < TH_H), TH_SCORE - e12, zero)
             + torch.where(valid & (e21 < TH_H), TH_SCORE - e21, zero))
    return score.sum(-1), ok


def _score_f(F, x1, x2, valid):
    """Epipolar distance score (`CheckFundamental`, :391) of F [..., 3, 3]
    over x [M, 2]: (score [...], inliers [..., M])."""
    p1, p2 = _homog(x1), _homog(x2)
    l2 = p1 @ F.transpose(-1, -2)  # epipolar lines in image 2
    l1 = p2 @ F
    d2 = torch.sum(p2 * l2, -1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(p1 * l1, -1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    ok = (d1 < TH_F) & (d2 < TH_F) & valid
    zero = torch.zeros_like(d1)
    score = (torch.where(valid & (d2 < TH_F), TH_SCORE - d2, zero)
             + torch.where(valid & (d1 < TH_F), TH_SCORE - d1, zero))
    return score.sum(-1), ok


def _triangulate(P1, P2, x1, x2):
    """Linear SVD triangulation (`Triangulate`, :735): P [..., 3, 4], x
    [M, 2] -> X [..., M, 3], one [4, 4] SVD a point."""
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    A = torch.stack([x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
                     x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
                     x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
                     x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]], -2)
    X = torch.linalg.svd(A)[2][..., -1, :]
    w = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12,
                                    torch.full_like(w, 1e-12), w)


def _check_rt(R, t, x1, x2, valid, cam: proj.CameraIntrinsics,
              th2: float = 4.0):
    """Triangulated points passing cheirality, parallax and reprojection
    (`CheckRT`, :799) for motions R [..., 3, 3], t [..., 3]; x in pixels.
    Returns (n_good [...], good [..., M], X [..., M, 3], parallax_deg [...])
    where the parallax is that of the 50th-best point (clamped)."""
    Km = _kmat(cam, R.device)
    P1 = Km @ torch.cat([torch.eye(3, device=R.device),
                         torch.zeros((3, 1), device=R.device)], 1)
    P2 = Km @ torch.cat([R, t[..., None]], -1)
    X = _triangulate(P1.expand(P2.shape), P2, x1, x2)
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    # parallax between the viewing rays
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r2 = X - O2[..., None, :]
    cosp = torch.sum(X * r2, -1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-12)

    def reproj(Xc, x):
        u = Xc @ Km.T
        return torch.sum((u[..., :2] / torch.clamp(u[..., 2:3], min=1e-12)
                          - x) ** 2, -1)

    e1, e2 = reproj(X, x1), reproj(X2, x2)
    finite = torch.all(torch.isfinite(X), -1)
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < th2) & (e2 < th2))
    sorted_cos = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)),
                            -1).values
    n_good = good.sum(-1)
    idx = torch.clamp(torch.clamp(n_good - 1, min=0), max=50)
    c = torch.gather(sorted_cos, -1, idx[..., None])[..., 0]
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))
    return n_good, good, X, parallax_deg


def _decompose_e(E):
    """E -> (R1, R2, t) (`DecomposeE`, :910), each rotation made proper."""
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     device=E.device)
    R1 = U @ W @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2]
    return R1, R2, t / torch.clamp(torch.linalg.norm(t), min=1e-12)


def _decompose_h(H, cam: proj.CameraIntrinsics):
    """Faugeras-Lustman's 8 motions of H (`ReconstructH`, :573): Rs
    [8, 3, 3], unit ts [8, 3]; d' > 0 first, then d' < 0, in JAX's
    order."""
    Km = _kmat(cam, H.device)
    A = torch.linalg.inv(Km) @ H @ Km
    U, w, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    sgn = torch.tensor([1.0, -1.0, -1.0, 1.0], device=H.device)
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)
    # d' > 0
    dp = torch.clamp((d1 + d3) * d2, min=1e-12)
    st = sgn * (root / dp)
    ct = ((d2 * d2 + d1 * d3) / dp).expand(4)
    Rp_pos = torch.stack([torch.stack([ct, zero, -st], -1),
                          torch.stack([zero, one, zero], -1),
                          torch.stack([st, zero, ct], -1)], -2)
    tp_pos = (d1 - d3) * torch.stack([x1s, zero, -x3s], -1)
    # d' < 0
    dn = torch.clamp((d1 - d3) * d2, min=1e-12)
    sp = sgn * (root / dn)
    cp = ((d1 * d3 - d2 * d2) / dn).expand(4)
    Rp_neg = torch.stack([torch.stack([cp, zero, sp], -1),
                          torch.stack([zero, -one, zero], -1),
                          torch.stack([sp, zero, -cp], -1)], -2)
    tp_neg = (d1 + d3) * torch.stack([x1s, zero, x3s], -1)
    Rp = torch.cat([Rp_pos, Rp_neg])
    tp = torch.cat([tp_pos, tp_neg])
    Rs = s * U @ Rp @ Vt
    ts = tp @ U.T
    return Rs, ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True),
                                min=1e-12)


def initialize(x1, x2, valid, cam: proj.CameraIntrinsics,
               generator: torch.Generator = None, n_iters: int = N_ITERS,
               min_triangulated: int = 50, samples=None) -> InitResult:
    """Monocular initialization from matched pixel coords x1, x2 [M, 2].

    `samples` i64[n_iters, 8]: the drawn correspondences of each
    hypothesis; else drawn from `generator` among the valid ones."""
    xn1, T1 = _normalize(x1, valid)
    xn2, T2 = _normalize(x2, valid)
    if samples is None:
        samples = draw_samples(valid, n_iters, 8, generator)
    p1, p2 = xn1[samples], xn2[samples]  # [S,8,2]
    Hs = torch.linalg.inv(T2) @ _compute_h(p1, p2) @ T1
    Fs = T2.T @ _compute_f(p1, p2) @ T1
    sh, _ = _score_h(Hs, x1, x2, valid)
    sf, _ = _score_f(Fs, x1, x2, valid)
    H_best, SH = Hs[torch.argmax(sh)], torch.max(sh)
    F_best, SF = Fs[torch.argmax(sf)], torch.max(sf)
    _, inliers_h = _score_h(H_best, x1, x2, valid)
    _, inliers_f = _score_f(F_best, x1, x2, valid)
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40  # :113

    # motions: 8 from H, then 4 from E, all checked at once
    Km = _kmat(cam, x1.device)
    R1, R2, te = _decompose_e(Km.T @ F_best @ Km)
    Rs_h, ts_h = _decompose_h(H_best, cam)
    Rs = torch.cat([Rs_h, torch.stack([R1, R1, R2, R2])])  # [12,3,3]
    ts = torch.cat([ts_h, torch.stack([te, -te, te, -te])])
    from_h = torch.arange(12, device=x1.device) < 8
    inl = torch.where(use_h, inliers_h, inliers_f)
    model_ok = torch.where(use_h, from_h, ~from_h)
    n_good, good, X, par = _check_rt(Rs, ts, x1, x2, inl, cam)
    n_good = torch.where(model_ok, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(n_good)
    n_best = n_good[best]
    # the winner must dominate (secondBestGood < 0.75 bestGood, :521/:616)
    # and clear the parallax and count gates
    second = torch.sort(n_good).values[-2]
    n_inl = inl.sum()
    need = torch.clamp((0.9 * n_inl).to(torch.int32), min=min_triangulated)
    success = ((n_best >= need)
               & (second.to(torch.float32) < 0.75 * n_best.to(torch.float32))
               & (par[best] > MIN_PARALLAX_DEG))
    pose21 = se3.make(se3.quat_from_matrix(Rs[best]), ts[best])
    return InitResult(success=success, pose21=pose21, points3d=X[best],
                      is_good=good[best], used_homography=use_h)
