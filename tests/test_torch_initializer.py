"""Port parity: the monocular H/F initializer (`solvers/initializer.py`).

(a) With the same samples: the 200 hypotheses' 8 matches are drawn with
    `jax.random` exactly as JAX's `initialize` draws them (split, Gumbel,
    top_k) and passed to the port as `samples`.
    - `_normalize` within 1e-5 relative; `_score_h` and `_score_f` of JAX's
      own H and F (all 200 hypotheses) within 1e-5 of the score's scale
      (2 x 5.991 a valid point: a score sums up to two capped terms a
      point, each rounded in f32; relative to a low score they read up to
      2.5e-4), the inlier flags equal on >= 99.9 % of points;
    - each hypothesis's H and F (in normalized coordinates) equal JAX's up
      to sign and scale: H within 1e-4; F within 1e-4 on >= 98 % of the
      hypotheses and 5e-4 on all (its rank-2 projection, a second SVD,
      amplifies f32 rounding on near-degenerate samples; measured 2e-4);
    - `_decompose_e` and `_decompose_h` give the same motions as sets
      (within 1e-4);
    - `_check_rt` on JAX's 12 motions: `n_good` within 1 and the
      triangulated points within 1e-4 relative (on the points both call
      good);
    - whole `initialize`: the same success and model, the pose within 1e-3
      (rotation rad, translation m) and >= 98 % of `is_good` shared.
(b) With the port's own generator, the outcomes of JAX's
    `test_initializer.py`: a general scene picks F, a planar one H, and a
    pure rotation fails.
The scenes are `test_initializer.py::make_pair`'s, copied here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import projection as jproj
from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.solvers import initializer as ji
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.solvers import initializer as ti

torch.set_num_threads(1)
JCAM = jproj.CameraIntrinsics.create(400.0, 400.0, 160.0, 120.0)
TCAM = tproj.CameraIntrinsics.create(400.0, 400.0, 160.0, 120.0)


def make_pair(seed, planar=False, n=150, outlier_frac=0.1, noise=0.4,
              tau=(0.02, -0.06, 0.01, 0.35, 0.05, 0.1)):
    """Two views of a general or planar scene, frame 1 at the origin."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n)], -1)
    if planar:  # a plane z = 4 + 0.2x + 0.1y
        z = 4.0 + 0.2 * xy[:, 0] + 0.1 * xy[:, 1]
    else:
        z = rng.uniform(3, 7, n)
    pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    pose2 = jse3.exp(jnp.asarray(np.array(tau, np.float32)))
    uv1 = np.array(jproj.project(JCAM, jnp.asarray(pts)))
    uv2 = np.array(jproj.project(JCAM, jse3.transform(pose2,
                                                      jnp.asarray(pts))))
    uv1 += rng.normal(0, noise, uv1.shape)
    uv2 += rng.normal(0, noise, uv2.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv2[idx] += rng.uniform(20, 60, (n_out, 2)) * rng.choice(
            [-1, 1], (n_out, 2))
    valid = np.ones(n, bool)
    valid[rng.permutation(n)[:5]] = False
    return (uv1.astype(np.float32), uv2.astype(np.float32), valid,
            np.asarray(pose2))


def jax_samples(key, valid, n=200, k=8):
    """`initialize`'s draws: one key a hypothesis, Gumbel top-8."""
    keys = jax.random.split(key, n)
    pen = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.vmap(lambda kk: jax.lax.top_k(
        jax.random.gumbel(kk, (len(valid),)) + pen, k)[1])(keys))


def rel_pose_err(est, gt):
    """Rotation error (rad) and the translation direction's angle (rad)."""
    rot = np.linalg.norm(np.asarray(jse3.boxminus(
        jnp.asarray(np.asarray(est)), jnp.asarray(gt)))[:3])
    a, b = np.asarray(est)[4:], gt[4:]
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    return rot, float(np.arccos(np.clip(abs(cos), -1, 1)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(M):
    M = M / np.linalg.norm(M, axis=(-2, -1), keepdims=True)
    flat = M.reshape(M.shape[0], -1)
    s = np.sign(flat[np.arange(len(flat)), np.abs(flat).argmax(-1)])
    return M * s[:, None, None]


@pytest.fixture(scope="module", params=[False, True], ids=["general",
                                                           "planar"])
def scene(request):
    seed = int(request.param)
    uv1, uv2, valid, pose2 = make_pair(seed, request.param)
    return uv1, uv2, valid, pose2, seed, jax_samples(
        jax.random.PRNGKey(seed), valid)


def _jax_models(uv1, uv2, valid, i):
    """JAX's denormalized H and F of sample i."""
    xn1, T1 = ji._normalize(jnp.asarray(uv1), jnp.asarray(valid))
    xn2, T2 = ji._normalize(jnp.asarray(uv2), jnp.asarray(valid))
    return (jnp.linalg.inv(T2) @ ji._compute_h(xn1[i], xn2[i]) @ T1,
            T2.T @ ji._compute_f(xn1[i], xn2[i]) @ T1)


def test_normalize_and_scores_match_jax(scene):
    uv1, uv2, valid, _, _, sel = scene
    pj, Tj = ji._normalize(jnp.asarray(uv1), jnp.asarray(valid))
    pt, Tt = ti._normalize(_t(uv1), _t(valid))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-5)
    scale = 2 * ti.TH_SCORE * int(valid.sum())
    flips = 0
    for i in sel:
        H, F = _jax_models(uv1, uv2, valid, i)
        for jf, tf, M in ((ji._score_h, ti._score_h, H),
                          (ji._score_f, ti._score_f, F)):
            sj, okj = jf(M, jnp.asarray(uv1), jnp.asarray(uv2),
                         jnp.asarray(valid))
            st, okt = tf(_t(M), _t(uv1), _t(uv2), _t(valid))
            assert abs(float(st) - float(sj)) <= 1e-5 * scale
            flips += int((okt.numpy() != np.asarray(okj)).sum())
    assert flips <= 1e-3 * 2 * len(sel) * len(valid), flips


def test_h_and_f_match_jax_up_to_sign_and_scale(scene):
    uv1, uv2, valid, _, _, sel = scene
    xn1, _ = ji._normalize(jnp.asarray(uv1), jnp.asarray(valid))
    xn2, _ = ji._normalize(jnp.asarray(uv2), jnp.asarray(valid))
    Hj = np.asarray(jax.vmap(lambda i: ji._compute_h(xn1[i], xn2[i]))(sel))
    Fj = np.asarray(jax.vmap(lambda i: ji._compute_f(xn1[i], xn2[i]))(sel))
    p1, p2 = _t(xn1)[sel], _t(xn2)[sel]
    np.testing.assert_allclose(_unit(ti._compute_h(p1, p2).numpy()),
                               _unit(Hj), atol=1e-4)
    dF = np.abs(_unit(ti._compute_f(p1, p2).numpy()) - _unit(Fj)).max((1, 2))
    assert (dF <= 1e-4).mean() >= 0.98 and dF.max() <= 5e-4, np.sort(dF)[-5:]


def _as_set_equal(Rt, Rj, tt, tj):
    """Every port motion has a JAX motion within 1e-4, and back."""
    def d(Ra, ta, Rb, tb):
        return max(np.abs(Ra - Rb).max(), np.abs(ta - tb).max())
    for A, a, B, b in ((Rt, tt, Rj, tj), (Rj, tj, Rt, tt)):
        for R, t in zip(A, a):
            assert min(d(R, t, R2, t2) for R2, t2 in zip(B, b)) <= 1e-4


def test_decompositions_match_jax_as_sets(scene):
    uv1, uv2, valid, _, _, sel = scene
    H, F = _jax_models(uv1, uv2, valid, sel[0])
    Rs_j, ts_j = ji._decompose_h(H, JCAM)
    Rs_t, ts_t = ti._decompose_h(_t(H), TCAM)
    _as_set_equal(Rs_t.numpy(), np.asarray(Rs_j), ts_t.numpy(),
                  np.asarray(ts_j))
    Km = jnp.array([[400.0, 0, 160.0], [0, 400.0, 120.0], [0, 0, 1.0]])
    E = Km.T @ F @ Km

    def motions(R1, R2, t):  # the 4 of E, as `initialize` lists them
        R1, R2, t = (np.asarray(a) for a in (R1, R2, t))
        return np.stack([R1, R1, R2, R2]), np.stack([t, -t, t, -t])

    _as_set_equal(*motions(*ti._decompose_e(_t(E)))[:1],
                  motions(*ji._decompose_e(E))[0],
                  motions(*ti._decompose_e(_t(E)))[1],
                  motions(*ji._decompose_e(E))[1])


def test_check_rt_on_jax_motions(scene):
    """The 8 motions of a sample's H, then the true motion (unit t)."""
    uv1, uv2, valid, pose2, _, sel = scene
    H, _ = _jax_models(uv1, uv2, valid, sel[0])
    Rs_h, ts_h = ji._decompose_h(H, JCAM)
    R = np.asarray(jse3.quat_to_matrix(jnp.asarray(pose2[:4])))
    Rs = np.concatenate([np.asarray(Rs_h), R[None]])
    ts = np.concatenate([np.asarray(ts_h),
                         pose2[None, 4:] / np.linalg.norm(pose2[4:])])
    nj, gj, Xj, pj = jax.vmap(lambda R_, t_: ji._check_rt(
        R_, t_, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
        JCAM))(jnp.asarray(Rs), jnp.asarray(ts))
    nt, gt_, Xt, pt = ti._check_rt(_t(Rs), _t(ts), _t(uv1), _t(uv2),
                                   _t(valid), TCAM)
    assert np.abs(nt.numpy() - np.asarray(nj)).max() <= 1
    assert int(nj[-1]) > 80  # the true motion triangulates most points
    both = gt_.numpy() & np.asarray(gj)
    Xj = np.asarray(Xj)
    err = np.abs(Xt.numpy() - Xj)[both]
    scale = np.abs(Xj[both]).max(-1, keepdims=True)
    assert (err <= 1e-4 * np.maximum(scale, 1.0)).all(), err.max()
    np.testing.assert_allclose(pt.numpy()[-1], float(pj[-1]), atol=1e-3)


def test_initialize_with_jax_samples(scene):
    uv1, uv2, valid, _, seed, sel = scene
    ref = ji.initialize(jnp.asarray(uv1), jnp.asarray(uv2),
                        jnp.asarray(valid), JCAM, jax.random.PRNGKey(seed))
    out = ti.initialize(_t(uv1), _t(uv2), _t(valid), TCAM,
                        samples=_t(sel))
    assert bool(out.success) == bool(ref.success) is True
    assert bool(out.used_homography) == bool(ref.used_homography)
    rot, trans = (np.abs(np.asarray(jse3.boxminus(
        jnp.asarray(out.pose21.numpy()), ref.pose21)))[s].max()
        for s in (slice(0, 3), slice(3, 6)))
    assert rot <= 1e-3 and trans <= 1e-3, (rot, trans)
    assert (out.is_good.numpy() == np.asarray(ref.is_good)).mean() >= 0.98


def _own(uv1, uv2, valid, seed):
    return ti.initialize(_t(uv1), _t(uv2), _t(valid), TCAM,
                         torch.Generator().manual_seed(seed))


def test_general_scene_uses_fundamental():
    uv1, uv2, valid, pose2 = make_pair(0)
    res = _own(uv1, uv2, valid, 0)
    assert bool(res.success) and not bool(res.used_homography)
    rot, ang = rel_pose_err(res.pose21.numpy(), pose2)
    assert rot < 0.03 and ang < 0.12
    assert int(res.is_good.sum()) > 80


def test_planar_scene_uses_homography():
    uv1, uv2, valid, pose2 = make_pair(1, planar=True)
    res = _own(uv1, uv2, valid, 1)
    assert bool(res.used_homography) and bool(res.success)
    rot, ang = rel_pose_err(res.pose21.numpy(), pose2)
    assert rot < 0.04 and ang < 0.15


def test_no_parallax_fails():
    """A pure rotation leaves nothing to triangulate."""
    uv1, uv2, valid, _ = make_pair(2, n=150, outlier_frac=0.0, noise=0.3,
                                   tau=(0.0, 0.08, 0.0, 0.0, 0.0, 0.0))
    assert not bool(_own(uv1, uv2, valid, 2).success)
