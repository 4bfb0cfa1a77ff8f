"""Port parity: dense-Schur bundle adjustment against the JAX package.

(a) `ba_solve(dense_schur=True)` on a small problem made with numpy: 8
    keyframes (2 fixed), 300 points (10 frozen), mono and stereo
    observations, 5 % outliers. Tolerances: poses within 1e-4 m / 1e-4 rad,
    points within 1e-3 m, initial cost within 1e-5 relative, final cost
    within 1e-3 relative, the final chi2 gate equal on >= 99.9 % of slots.
    The two sides differ only in the order of f32 sums (scatter-adds,
    einsums, the 6x6 and 192x192 solves).
(b) `LocalMapper._ba_impl` on the JAX map state and window captured at the
    third keyframe of the QVGA clip (local BA on): the same tolerances on
    the window's keyframes and landmarks, and the outlier mask equal on
    >= 99.9 % of slots.
(c) The settings of other slices (the sharded forms) raise
    NotImplementedError; the CG branch is `test_torch_ba_cg.py`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import projection as jproj
from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.optim import ba as jba
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.optim import ba as tba
from orb_slam2_refactored_tpu_torch.slam.local_mapping import LocalMapper

torch.set_num_threads(1)
FX, CX, CY, BF = 400.0, 160.0, 120.0, 32.0


def _pose_err(a, b):
    """(rotation rad, translation m) of a relative to b, per row."""
    d = np.asarray(jse3.log(jse3.compose(jnp.asarray(a),
                                         jse3.inverse(jnp.asarray(b)))))
    return np.abs(d[..., :3]).max(), np.abs(d[..., 3:]).max()


def _problem(seed=0, K=8, P=300, N=160):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                    rng.uniform(4, 9, P)], -1).astype(np.float32)
    poses = np.stack([np.asarray(jse3.exp(jnp.asarray(np.array(
        [0, 0.02 * k, 0, 0.25 * k, 0, 0], np.float32)))) for k in range(K)])
    obs_uv = np.zeros((K, N, 2), np.float32)
    obs_ur = -np.ones((K, N), np.float32)
    obs_pt = np.full((K, N), -1, np.int32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, (K, N))).astype(np.float32)
    for k in range(K):
        sel = rng.permutation(P)[:N]
        xc = np.asarray(jse3.transform(jnp.asarray(poses[k]),
                                       jnp.asarray(pts[sel])))
        uvr = np.stack([FX * xc[:, 0] / xc[:, 2] + CX,
                        FX * xc[:, 1] / xc[:, 2] + CY,
                        FX * xc[:, 0] / xc[:, 2] + CX - BF / xc[:, 2]], -1)
        vis = xc[:, 2] > 0.5
        vis &= rng.uniform(size=N) > 0.1  # some empty slots
        obs_pt[k, vis] = sel[vis]
        obs_uv[k] = uvr[:, :2] + rng.normal(0, 0.5, (N, 2))
        stereo = rng.uniform(size=N) < 0.6
        obs_ur[k] = np.where(stereo, uvr[:, 2] + rng.normal(0, 0.5, N), -1.0)
    bad = rng.uniform(size=(K, N)) < 0.05
    obs_uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
    poses0 = poses.copy()
    for k in range(1, K):
        poses0[k] = np.asarray(jse3.retract(jnp.asarray(poses[k]), jnp.asarray(
            rng.normal(0, 0.02, 6).astype(np.float32))))
    pts0 = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    valid = np.ones(P, bool)
    valid[-5:] = False
    # a point seen by one keyframe has no depth constraint: its update is set
    # by the 1e-6 damping alone, and any two f32 sum orders move it apart by
    # centimetres. Such points are left out of the solve.
    valid &= np.bincount(obs_pt[obs_pt >= 0], minlength=P) >= 2
    frozen = np.zeros(P, bool)
    frozen[rng.permutation(P)[:10]] = True
    return dict(kf_pose=poses0, kf_fixed=fixed, obs_uv=obs_uv, obs_ur=obs_ur,
                obs_pt=obs_pt, obs_inv_s2=inv_s2, pt_pos=pts0, pt_valid=valid,
                pt_frozen=frozen)


def _check_result(out, ref, rows=None):
    kp, rp = out.kf_pose.numpy(), np.asarray(ref.kf_pose)
    if rows is not None:
        kp, rp = kp[rows], rp[rows]
    rot, trans = _pose_err(kp, rp)
    assert rot <= 1e-4 and trans <= 1e-4, (rot, trans)
    assert np.abs(out.pt_pos.numpy() - np.asarray(ref.pt_pos)).max() <= 1e-3
    c0, r0 = float(out.initial_cost), float(ref.initial_cost)
    assert abs(c0 - r0) <= 1e-5 * abs(r0), (c0, r0)
    c1, r1 = float(out.final_cost), float(ref.final_cost)
    assert abs(c1 - r1) <= 1e-3 * abs(r1), (c1, r1)
    assert (out.obs_inlier.numpy() == np.asarray(ref.obs_inlier)).mean() \
        >= 0.999


@pytest.mark.parametrize("iters,use_huber", [(3, True), (6, True),
                                             (4, False)])
def test_ba_solve_dense_schur_matches_jax(iters, use_huber):
    d = _problem()
    jc = jproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    ref = jba.ba_solve(jba.BAProblem(**{k: jnp.asarray(v)
                                        for k, v in d.items()}),
                       jc, iters=iters, use_huber=use_huber, dense_schur=True)
    out = tba.ba_solve(convert.ba_problem_from_numpy(d, "cpu"), tc,
                       iters=iters, use_huber=use_huber, dense_schur=True)
    _check_result(out, ref)
    # the solve moved the free frames and reduced the cost
    assert float(out.final_cost) < 0.5 * float(out.initial_cost)
    np.testing.assert_array_equal(out.kf_pose.numpy()[:2], d["kf_pose"][:2])


def test_ba_settings_of_other_slices_raise():
    """The sharded forms run: JAX's `axis_name` / `axis_size` are
    `group=`, and a group of one gives the unsharded solve's bits on both
    branches (`tests/test_torch_sharded_ba.py` holds the sharded solve to
    JAX's)."""
    import torch.distributed as dist

    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    p = convert.ba_problem_from_numpy(_problem(), "cpu")
    be = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
    group = dist.ProcessGroup(dist.HashStore(), 0, 1)
    group._set_default_backend(dist.ProcessGroup.BackendType.GLOO)
    group._register_backend(torch.device("cpu"),
                            dist.ProcessGroup.BackendType.GLOO, be)
    for dense in (False, True):
        ref = tba.ba_solve(p, tc, iters=3, cg_iters=10, dense_schur=dense)
        got = tba.ba_solve(p, tc, iters=3, cg_iters=10, dense_schur=dense,
                           group=group)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
    with pytest.raises(TypeError):
        tba.ba_solve(p, tc, axis_name="kf")


@pytest.fixture(scope="module")
def captured_ba():
    """The inputs and outputs of the JAX window BA at the third keyframe of
    the QVGA clip (keyframes at frames 0, 1 and 3)."""
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(20, radius=0.35, yaw_amp=0.25)
    rng = np.random.default_rng(0)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_SLAM_NATIVE_GRAPH", "0")
        jt = JTracker(JConfig(
            width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
            bf=0.08 * 260.0, n_features=500, n_levels=4,
            map_capacity=JCap(16, 4096, 500), enable_local_ba=True))
        lm = jt.local_mapper
        real = lm._ba

        def record(m, wi, wf, wv, lut, pl):
            out = real(m, wi, wf, wv, lut, pl)
            calls.append((
                {k: np.asarray(v) for k, v in m._asdict().items()},
                {"win_idx": np.asarray(wi), "win_free": np.asarray(wf),
                 "win_valid": np.asarray(wv), "pt_lut": np.asarray(lut),
                 "pts_local": np.asarray(pl)},
                jax.tree.map(np.asarray, out)))
            return out

        lm._ba = record
        for i in range(4):
            img, depth = scene.render(gt[i])
            depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
            jt.track_rgbd(np.clip(img, 0, 255).astype(np.uint8),
                          depth.astype(np.float16).astype(np.float32))
    assert len(calls) == 2, len(calls)
    return calls[-1], lm


def test_ba_impl_on_captured_window_matches_jax(captured_ba):
    (m_np, win, (jm, joutlier, jc0, jc1)), jlm = captured_ba
    lm = LocalMapper(tproj.CameraIntrinsics.create(260.0, 260.0, 160.0, 120.0,
                                                   0.08 * 260.0),
                     4, 1.2, ba_iters=3, device="cpu")
    m = convert.map_from_numpy(m_np, "cpu")
    a = convert.mapper_inputs_from_numpy(win, "cpu")
    out, outlier, c0, c1 = lm._ba_impl(
        m, a["win_idx"], a["win_free"], a["win_valid"], a["pt_lut"],
        a["pts_local"], 3, 1e-4)
    rows = win["win_idx"][win["win_valid"] & win["win_free"]]
    assert len(rows) >= 2 and win["pts_local"].shape[0] == 2048
    rot, trans = _pose_err(out.kf_pose.numpy()[rows], jm.kf_pose[rows])
    assert rot <= 1e-4 and trans <= 1e-4, (rot, trans)
    # the solve did move the free keyframes
    assert np.abs(out.kf_pose.numpy()[rows] - m_np["kf_pose"][rows]).max() > 0
    pts = win["pts_local"][win["pts_local"] < m_np["mp_pos"].shape[0]]
    assert np.abs(out.mp_pos.numpy()[pts] - jm.mp_pos[pts]).max() <= 1e-3
    assert abs(float(c0) - float(jc0)) <= 1e-5 * abs(float(jc0))
    assert abs(float(c1) - float(jc1)) <= 1e-3 * abs(float(jc1))
    assert (outlier.numpy() == joutlier).mean() >= 0.999
    assert (out.kf_mp.numpy() == jm.kf_mp).mean() >= 0.999
    # everything outside the window is untouched
    others = np.setdiff1d(np.arange(m_np["kf_pose"].shape[0]), rows)
    np.testing.assert_array_equal(out.kf_pose.numpy()[others],
                                  m_np["kf_pose"][others])


def _counting_sort(obs_pt, obs_ok, Q):
    """The point index by a numpy counting sort, slot by slot in order."""
    pt = np.clip(obs_pt.reshape(-1), 0, Q - 1)
    live = obs_ok.reshape(-1)
    counts = np.zeros(Q, np.int64)
    for s in np.flatnonzero(live):
        counts[pt[s]] += 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    cursor = offsets[:-1].copy()
    slots = np.full(pt.size, -1, np.int64)
    for s in np.flatnonzero(live):
        slots[cursor[pt[s]]] = s
        cursor[pt[s]] += 1
    return offsets, slots


def _index_case(name):
    """(obs_pt, obs_ok, Q) of one point-index case."""
    if name == "problem":
        d = _problem()
        P = d["pt_pos"].shape[0]
        ok = (d["obs_pt"] >= 0) & d["pt_valid"][np.clip(d["obs_pt"], 0, P - 1)]
        return d["obs_pt"], ok, P
    rng = np.random.default_rng(3)
    K, N, Q = 6, 40, 16
    obs_pt = rng.integers(0, Q, (K, N)).astype(np.int32)
    ok = rng.uniform(size=(K, N)) < 0.7
    if name == "duplicate":  # two features of one keyframe on one point
        obs_pt[2, 5] = obs_pt[2, 30] = 7
        ok[2, [5, 30]] = True
    elif name == "seen_by_all":  # one point in every keyframe, 3x in one
        obs_pt[:, 11] = 4
        obs_pt[1, [0, 20]] = 4
        ok[:, 11] = ok[1, [0, 20]] = True
    elif name == "empty_points":  # points 0-7 have no live slot
        obs_pt = np.where(obs_pt < 8, obs_pt + 8, obs_pt).astype(np.int32)
        obs_pt[0, :4] = [1, 2, 3, 4]
        ok[0, :4] = False
    elif name == "beyond_q":  # clamped to [0, Q) as the plain assembly does
        obs_pt[3, :10] = Q + np.arange(10)
        obs_pt[4, :10] = -1 - np.arange(10)
        ok[3:5, :10] = True
    elif name == "all_dead":
        ok[:] = False
    return obs_pt, ok, Q


@pytest.mark.parametrize("name", ["problem", "duplicate", "seen_by_all",
                                  "empty_points", "beyond_q", "all_dead"])
def test_point_index_plain_matches_counting_sort(name):
    obs_pt, ok, Q = _index_case(name)
    idx = tba.ba_point_index_plain(torch.from_numpy(obs_pt),
                                   torch.from_numpy(ok), Q)
    assert idx.offsets.dtype == idx.slots.dtype == torch.int32
    offsets, slots = _counting_sort(obs_pt, ok, Q)
    np.testing.assert_array_equal(idx.offsets.numpy(), offsets)
    np.testing.assert_array_equal(idx.slots.numpy(), slots)
    # on the CPU the wrapper is the plain version
    again = tba.ba_point_index(torch.from_numpy(obs_pt), torch.from_numpy(ok),
                               Q)
    assert all(torch.equal(a, b) for a, b in zip(idx, again))


def test_cost_plain_without_chi2_gives_the_same_cost():
    p = convert.ba_problem_from_numpy(_problem(), "cpu")
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
    P = p.pt_pos.shape[0]
    ok = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(0, P - 1).long()]
    for use_huber in (True, False):
        args = (p.kf_pose, p.pt_pos, p, ok, tc, use_huber)
        cost, chi2 = tba.ba_cost_plain(*args)
        cost_only, none = tba.ba_cost_plain(*args, want_chi2=False)
        assert none is None and chi2.shape == ok.shape
        assert torch.equal(cost, cost_only)
        assert torch.equal(tba.ba_cost(*args, want_chi2=False)[0], cost)
