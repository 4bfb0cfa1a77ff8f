"""Port parity: planar-safe PnP RANSAC (`pnp_ransac`) and the DLT-only
`p6p_ransac`, the monocular fallback's and relocalization's solvers.

(a) With the same samples: the indices are drawn with `jax.random` exactly
    as the JAX solvers draw them (split, Gumbel, top_k) and passed to the
    port as `samples`.
    - The DLT's P equals the one JAX's SVD gives, up to sign and scale,
      within 1e-4 on general structure; its poses agree within 1e-3 on
      >= 95 % of the hypotheses (median <= 1e-4: the 8-point pose
      amplifies P's rounding on a few samples), and every planar
      hypothesis (one wall) gives the same pose within 1e-3.
    - Whole `pnp_ransac` and `p6p_ransac`: the same success, the pose
      within 1e-3 (rotation rad, translation m) and >= 98 % of the inlier
      flags shared.
(b) With the port's own generator, the outcomes of JAX's
    `test_vocab_solvers.py::TestPlanarPnP`: on one wall `pnp_ransac`
    succeeds and `p6p_ransac` does not recover the pose; on general
    structure the hybrid keeps the DLT's accuracy.
The scenes are `TestPlanarPnP`'s, copied here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import projection as jproj
from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.solvers import ransac as jr
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.solvers import ransac as tr

torch.set_num_threads(1)
TCAM = tproj.CameraIntrinsics.create(400.0, 400.0, 160.0, 120.0)
JCAM = jproj.CameraIntrinsics.create(400.0, 400.0, 160.0, 120.0)


def one_wall(seed=7):
    """Every landmark on one wall (z = 5, tilted 20 degrees), 20 of 120
    observations gross outliers."""
    rng = np.random.default_rng(seed)
    n = 120
    uvp = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-1.8, 1.8, n)], -1)
    u_ax = np.array([np.cos(0.35), 0.0, np.sin(0.35)])
    v_ax = np.array([0.0, 1.0, 0.0])
    pts = (np.array([0.3, 0.1, 5.0])[None] + uvp[:, :1] * u_ax[None]
           + uvp[:, 1:] * v_ax[None]).astype(np.float32)
    pose = jse3.exp(jnp.asarray(
        np.array([0.08, -0.12, 0.03, 0.3, -0.1, 0.2], np.float32)))
    uv = np.array(jproj.project_world(JCAM, pose, jnp.asarray(pts))[0])
    uv += rng.normal(0, 0.4, uv.shape)
    out = rng.choice(n, 20, replace=False)
    uv[out] += rng.uniform(30, 80, (20, 2)) * rng.choice([-1, 1], (20, 2))
    return pts, uv.astype(np.float32), np.asarray(pose)


def general(seed=11):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, 100), rng.uniform(-1.5, 1.5, 100),
                    rng.uniform(3, 8, 100)], -1).astype(np.float32)
    pose = jse3.exp(jnp.asarray(
        np.array([0.05, -0.1, 0.02, 0.2, 0.1, -0.3], np.float32)))
    uv = np.array(jproj.project_world(JCAM, pose, jnp.asarray(pts))[0])
    uv += rng.normal(0, 0.5, uv.shape)
    return pts, uv.astype(np.float32), np.asarray(pose)


def jax_samples(key, valid, n, k):
    """The JAX solvers' draws: one key a hypothesis, Gumbel top-k."""
    keys = jax.random.split(key, n)
    pen = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.vmap(lambda kk: jax.lax.top_k(
        jax.random.gumbel(kk, (len(valid),)) + pen, k)[1])(keys))


def pose_err(a, b):
    d = np.asarray(jse3.boxminus(jnp.asarray(np.asarray(a)),
                                 jnp.asarray(np.asarray(b))))
    return np.abs(d[..., :3]).max(), np.abs(d[..., 3:]).max()


def _normalized(uv):
    return np.stack([(uv[:, 0] - 160.0) / 400.0,
                     (uv[:, 1] - 120.0) / 400.0], -1).astype(np.float32)


def _jax_dlt_matrix(X, xn):
    """The P of JAX's `_dlt_resection` (`solvers/ransac.py:136-150`)."""
    Xh = jnp.concatenate([X, jnp.ones((X.shape[0], 1))], -1)
    z = jnp.zeros_like(Xh)
    A = jnp.concatenate([
        jnp.concatenate([Xh, z, -xn[:, 0:1] * Xh], -1),
        jnp.concatenate([z, Xh, -xn[:, 1:2] * Xh], -1)], 0)
    return jnp.linalg.svd(A, full_matrices=True)[2][-1].reshape(3, 4)


def _unit(P):
    P = P / np.linalg.norm(P, axis=(-2, -1), keepdims=True)
    flat = P.reshape(P.shape[0], -1)
    s = np.sign(flat[np.arange(len(flat)), np.abs(flat).argmax(-1)])
    return P * s[:, None, None]


def test_dlt_matrix_and_hypotheses_match_jax():
    pts, uv, _ = general()
    xn = _normalized(uv)
    sel = jax_samples(jax.random.PRNGKey(2), np.ones(100, bool), 128, 8)
    Pj = np.asarray(jax.vmap(lambda i: _jax_dlt_matrix(
        jnp.asarray(pts)[i], jnp.asarray(xn)[i]))(sel))
    Pt = tr._dlt_matrix(torch.from_numpy(pts)[sel],
                        torch.from_numpy(xn)[sel]).numpy()
    np.testing.assert_allclose(_unit(Pt), _unit(Pj), atol=1e-4)
    ref = np.asarray(jax.vmap(lambda i: jr._dlt_resection(
        jnp.asarray(pts)[i], jnp.asarray(xn)[i]))(sel))
    out = tr._dlt_resection(torch.from_numpy(pts)[sel],
                            torch.from_numpy(xn)[sel]).numpy()
    # an 8-point DLT's pose amplifies P's rounding on some samples
    d = np.abs(np.asarray(jse3.boxminus(jnp.asarray(out), jnp.asarray(ref))))
    assert (d.max(-1) <= 1e-3).mean() >= 0.95, np.sort(d.max(-1))[-8:]
    assert np.median(d.max(-1)) <= 1e-4


def test_planar_hypotheses_match_jax():
    pts, uv, _ = one_wall()
    xn = _normalized(uv)
    sel = jax_samples(jax.random.PRNGKey(3), np.ones(120, bool), 128, 8)
    ref = np.asarray(jax.vmap(lambda i: jr._planar_resection(
        jnp.asarray(pts)[i], jnp.asarray(xn)[i]))(sel))
    out = tr._planar_resection(torch.from_numpy(pts)[sel],
                               torch.from_numpy(xn)[sel]).numpy()
    rot, trans = pose_err(out, ref)
    assert rot <= 1e-3 and trans <= 1e-3, (rot, trans)
    # the weighted (non-minimal) form on every point, as the refit runs it
    w = (np.arange(120) % 3 != 0).astype(np.float32)
    ref = jr._planar_resection(jnp.asarray(pts), jnp.asarray(xn),
                               jnp.asarray(w))
    out = tr._planar_resection(torch.from_numpy(pts), torch.from_numpy(xn),
                               torch.from_numpy(w))
    assert max(pose_err(out.numpy(), ref)) <= 1e-3


def _valid(n, seed):
    v = np.ones(n, bool)
    v[np.random.default_rng(seed).permutation(n)[: n // 10]] = False
    return v


@pytest.mark.parametrize("scene,seed", [(one_wall, 3), (general, 2),
                                        (general, 5)])
def test_pnp_ransac_with_jax_samples(scene, seed):
    pts, uv, _ = scene()
    valid = _valid(len(pts), seed)
    key = jax.random.PRNGKey(seed)
    ref = jr.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid),
                        JCAM, key)
    sel = jax_samples(key, valid, 256, 8)
    out = tr.pnp_ransac(torch.from_numpy(pts), torch.from_numpy(uv),
                        torch.from_numpy(valid), TCAM,
                        samples=torch.from_numpy(sel))
    assert bool(out.success) == bool(ref.success)
    assert max(pose_err(out.pose.numpy(), ref.pose)) <= 1e-3
    assert (out.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.98


def test_p6p_ransac_with_jax_samples():
    pts, uv, _ = general()
    valid = np.ones(len(pts), bool)
    key = jax.random.PRNGKey(4)
    ref = jr.p6p_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid),
                        JCAM, key)
    out = tr.p6p_ransac(torch.from_numpy(pts), torch.from_numpy(uv),
                        torch.from_numpy(valid), TCAM,
                        samples=torch.from_numpy(jax_samples(key, valid, 256,
                                                             12)))
    assert bool(out.success) == bool(ref.success) is True
    assert max(pose_err(out.pose.numpy(), ref.pose)) <= 1e-3
    assert (out.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.98


def _port(solver, pts, uv, seed):
    return solver(torch.from_numpy(pts), torch.from_numpy(uv),
                  torch.ones(len(pts), dtype=torch.bool), TCAM,
                  torch.Generator().manual_seed(seed))


def test_one_wall_pnp_succeeds():
    pts, uv, pose = one_wall()
    res = _port(tr.pnp_ransac, pts, uv, 3)
    assert bool(res.success)
    err = np.asarray(jse3.boxminus(jnp.asarray(res.pose.numpy()),
                                   jnp.asarray(pose)))
    assert np.linalg.norm(err) < 0.03, err
    assert int(res.n_inliers) > 70


def test_one_wall_dlt_fails():
    pts, uv, pose = one_wall()
    res = _port(tr.p6p_ransac, pts, uv, 3)
    err = np.linalg.norm(np.asarray(jse3.boxminus(
        jnp.asarray(res.pose.numpy()), jnp.asarray(pose))))
    assert (not bool(res.success)) or err > 0.03


def test_general_structure_unharmed():
    pts, uv, pose = general()
    res = _port(tr.pnp_ransac, pts, uv, 2)
    assert bool(res.success)
    err = np.asarray(jse3.boxminus(jnp.asarray(res.pose.numpy()),
                                   jnp.asarray(pose)))
    assert np.linalg.norm(err) < 0.02
    assert int(res.n_inliers) > 80


def test_draw_samples_are_valid_and_distinct():
    valid = torch.from_numpy(_valid(50, 0))
    idx = tr.draw_samples(valid, 64, 8, torch.Generator().manual_seed(0))
    assert idx.shape == (64, 8)
    assert bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 8 for row in idx)
