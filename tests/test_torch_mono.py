"""Port parity for the monocular slice: `_prepare_mono_impl`,
`_mono_match_impl`, the bootstrap (`_initialize_mono`), `_mono_step` and
the `track_mono` loop, against the JAX tracker (QVGA, 600 features, 4
levels, local BA on, `kf_ref_ratio=0.9`: `tests/test_mono_e2e.py`'s
configuration).

(a) `_prepare_mono_impl` on one frame, under `test_torch_orb.py`'s C2
    tolerances: on level 0 the keypoints, levels, responses and validity
    equal, angles within 2e-3 rad, >= 99.9 % of descriptor bits equal; the
    upper levels as keypoint sets (>= 70 % shared); no depth and no right
    coordinate anywhere.
(b) `_mono_match_impl` on two frames the port prepared: the indices and
    the kept matches exactly JAX's.
(c) The bootstrap in lockstep: JAX's `track_mono` runs until it
    initializes; the port's `_initialize_mono` then takes JAX's own
    prepared reference and current frames with JAX's draws
    (`PRNGKey(frame_id)`'s Gumbel top-8). The initializer's pose within
    1e-4, its `is_good` flags equal on >= 98 %, the landmarks within
    max(1e-4 m, 2e-6 / sin^2 parallax) (`ROADMAP.md` §C's triangulation
    tolerance), and the 2-keyframe BA's keyframe pose within 1e-4 m.
(d) `_track_impl` on JAX's state right after the bootstrap and JAX's next
    prepared frame: the pose within 1e-4, the landmark assignments on
    >= 99 % of features, the inliers within +-2.
(e) `test_mono_e2e.py`'s 35-frame sequence through the port's
    `track_mono` on the CPU, with its gates: OK at the end, >= 2
    keyframes, sim3-aligned ATE < 0.3 m, more than 150 live landmarks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu.solvers.initializer import initialize as jinit
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam import tracking as ttracking
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    Tracker, TrackerConfig, wire_image)

torch.set_num_threads(1)
N_FRAMES = 35
KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
          n_features=600, n_levels=4, enable_local_ba=True, kf_ref_ratio=0.9)
CAP = (64, 8192, 600)


@pytest.fixture(scope="module")
def clip():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(N_FRAMES, radius=0.35, yaw_amp=0.3)
    return [scene.render(gt[i])[0] for i in range(N_FRAMES)], gt


def _port_tracker():
    return Tracker(TrackerConfig(map_capacity=MapCapacity(*CAP), **KW),
                   device="cpu")


def _jframe(f):
    return convert.frame_from_numpy(
        {k: np.asarray(v) for k, v in f._asdict().items()}, "cpu")


def jax_samples(frame_id, valid):
    """JAX's `initialize` draws for `PRNGKey(frame_id)`."""
    keys = jax.random.split(jax.random.PRNGKey(frame_id), 200)
    v = jnp.asarray(valid.numpy())
    pen = jnp.where(v, 0.0, -1e9)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.lax.top_k(
        jax.random.gumbel(k, (v.shape[0],)) + pen, 8)[1])(keys)))


@pytest.fixture(scope="module")
def jax_boot(clip):
    """JAX's tracker up to its bootstrap: its prepared reference and
    current frames, the initializer's inputs and result, the map right
    after, its state for the next step and that step's outputs."""
    imgs, _ = clip
    jt = JTracker(JConfig(map_capacity=JCap(*CAP), **KW))
    rec = {}
    prep, init = jt._prepare_mono, jax.jit(
        lambda x1, x2, v, k: jinit(x1, x2, v, jt.cam, k))

    def rec_prep(img):
        rec["frame"] = prep(img)
        return rec["frame"]

    def rec_init(x1, x2, v, k):
        rec["init"] = init(x1, x2, v, k)
        return rec["init"]

    jt._prepare_mono, jt._mono_init = rec_prep, rec_init
    for i, img in enumerate(imgs):
        ref = jt._mono_ref
        jt.track_mono(img, timestamp=i / 30.0)
        if jt.state == 1:
            break
    assert jt.state == 1 and i < 6, i
    leaves = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}
    out = {
        "i": i, "ref": ref, "cur": rec["frame"],
        "init": jax.tree.map(np.asarray, rec["init"]), "map": leaves(jt.map),
        "slot1": jt.ref_kf,
        "snap": {"last_frame": leaves(jt.last_frame),
                 "last_mp": np.asarray(jt.last_mp_dev),
                 "pose": np.asarray(jt.pose_dev),
                 "velocity": np.asarray(jt.velocity_dev),
                 "ref_kf": jt.ref_kf, "mp_vis": np.asarray(jt.mp_vis_dev),
                 "mp_found": np.asarray(jt.mp_found_dev),
                 "mp_seen": np.asarray(jt.mp_seen_dev),
                 "fidx": int(jt.fidx_dev)},
    }
    nxt = prep(jnp.asarray(wire_image(imgs[i + 1], rint=True)))
    out["next"] = nxt
    out["step"] = jax.tree.map(np.asarray, jt._mono_step(nxt))
    return out


def test_prepare_mono_matches_jax(clip, jax_boot):
    img = wire_image(clip[0][jax_boot["i"]], rint=True)
    ft = _port_tracker()._prepare_mono_impl(torch.from_numpy(img))
    fj = {k: np.asarray(v) for k, v in jax_boot["cur"]._asdict().items()}
    out = convert.frame_to_numpy(ft)
    lvl0 = fj["level"] == 0
    assert lvl0.sum() > 100
    for k in ("xy", "xy_raw", "valid", "level", "response"):
        np.testing.assert_array_equal(out[k][lvl0], fj[k][lvl0])
    dang = np.angle(np.exp(1j * (out["angle"] - fj["angle"])[lvl0]))
    assert np.abs(dang).max() < 2e-3
    bits = np.unpackbits((out["desc"][lvl0] ^ fj["desc"][lvl0]).view(
        np.uint8))
    assert bits.mean() <= 1e-3
    assert (ft.u_right == -1).all() and (ft.depth == -1).all()
    # upper levels: the C2 rounding moves some keypoints (sets >= 70 %)
    up_t = {tuple(p) for p in ft.xy.numpy()[ft.level.numpy() > 0]}
    up_j = {tuple(p) for p in fj["xy"][~lvl0]}
    assert len(up_t & up_j) >= 0.7 * len(up_j)


def test_mono_match_matches_jax(clip, jax_boot):
    tt = _port_tracker()
    i = jax_boot["i"]
    ref, cur = (tt._prepare_mono_impl(torch.from_numpy(
        wire_image(clip[0][k], rint=True))) for k in (i - 1, i))
    idx, keep = tt._mono_match_impl(cur, ref)
    jt = JTracker(JConfig(map_capacity=JCap(*CAP), **KW))
    as_j = lambda f: type(jax_boot["cur"])(**{
        k: jnp.asarray(v) for k, v in convert.frame_to_numpy(f).items()})
    jidx, jkeep = jt._mono_match(as_j(cur), as_j(ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert int(keep.sum()) >= 100


@pytest.fixture(scope="module")
def port_boot(jax_boot, monkeypatch_module):
    """The port's bootstrap on JAX's two prepared frames and draws."""
    tt = _port_tracker()
    got = {}
    real = ttracking.initialize

    def rec(*a, **kw):
        got["init"] = real(*a, **kw)
        return got["init"]

    monkeypatch_module.setattr(ttracking, "initialize", rec)
    monkeypatch_module.setattr(
        tt, "_mono_init_samples",
        lambda valid: jax_samples(tt.frame_id, valid))
    i = jax_boot["i"]
    tt.frame_id = i - 1
    tt._initialize_mono(_jframe(jax_boot["ref"]), (i - 1) / 30.0)
    tt.frame_id = i
    tt._initialize_mono(_jframe(jax_boot["cur"]), i / 30.0)
    assert tt.state == 1
    return tt, got["init"]


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_bootstrap_in_lockstep(jax_boot, port_boot):
    tt, res = port_boot
    ref = jax_boot["init"]
    assert bool(res.success) and bool(ref.success)
    assert bool(res.used_homography) == bool(ref.used_homography)
    np.testing.assert_allclose(res.pose21.numpy(), ref.pose21, atol=1e-4)
    good_t, good_j = res.is_good.numpy(), ref.is_good
    assert (good_t == good_j).mean() >= 0.98
    both = good_t & good_j
    X = ref.points3d[both]
    # parallax of each landmark's two rays (frame 1 at the origin)
    c2 = np.asarray(jse3.translation(jse3.inverse(jnp.asarray(ref.pose21))))
    r1, r2 = X, X - c2[None]
    cos = np.sum(r1 * r2, -1) / (np.linalg.norm(r1, axis=-1)
                                 * np.linalg.norm(r2, axis=-1))
    sin2 = np.clip(1 - cos ** 2, 1e-12, None)
    tol = np.maximum(1e-4, 2e-6 / sin2)
    err = np.abs(res.points3d.numpy()[both] - X).max(-1)
    assert (err <= tol).all(), (err / tol).max()
    s1 = jax_boot["slot1"]
    assert tt.ref_kf == s1
    np.testing.assert_allclose(tt.map.kf_pose[s1].numpy()[4:],
                               jax_boot["map"]["kf_pose"][s1][4:], atol=1e-4)
    np.testing.assert_allclose(tt.map.kf_pose[s1].numpy()[:4],
                               jax_boot["map"]["kf_pose"][s1][:4], atol=1e-4)
    np.testing.assert_array_equal(tt.map.kf_valid.numpy(),
                                  jax_boot["map"]["kf_valid"])
    assert int(tt.graph.pt_alive.sum()) == int(good_j.sum())


def test_mono_step_on_jax_state(jax_boot):
    st = convert.tracker_state_from_numpy(jax_boot["snap"], "cpu")
    m = convert.map_from_numpy(jax_boot["map"], "cpu")
    jout = jax_boot["step"]
    out = _port_tracker()._track_impl(
        _jframe(jax_boot["next"]), st["last_frame"], st["last_mp"], m,
        st["pose"], st["velocity"], st["ref_kf"], st["fidx"])
    np.testing.assert_allclose(out[0].numpy(), jout[1], atol=1e-4)
    assert (out[1].numpy() == jout[3]).mean() >= 0.99
    assert abs(int(out[2]) - int(jout[4][14])) <= 2
    assert int(out[2]) > 50


def test_track_mono_sequence(clip):
    imgs, gt = clip
    tt = _port_tracker()
    for i, img in enumerate(imgs):
        tt.track_mono(img, timestamp=i / 30.0)
    assert tt.state == 1, tt.track_info[-3:]
    assert len(tt.graph.alive_kfs()) >= 2
    est = np.stack(tt.trajectory)
    rmse, _ = ate_rmse(est, gt[: len(est)], align="sim3")
    assert rmse < 0.3, rmse
    assert tt.graph.pt_alive.sum() > 150


def test_mono_reference_keyframe_fallback_branch(clip):
    """With `min_matches_mm` out of reach every tracked frame takes the
    other branch, which in mono seeds the LM with `pnp_ransac` (Horn
    needs depth), and still tracks."""
    imgs, gt = clip
    tt = Tracker(TrackerConfig(map_capacity=MapCapacity(*CAP),
                               min_matches_mm=10 ** 6, **KW), device="cpu")
    for i, img in enumerate(imgs[:8]):
        tt.track_mono(img, timestamp=i / 30.0)
    tracked = [t for t in tt.track_info if "ref_fallback" in t]
    assert len(tracked) >= 5
    assert all(t["ref_fallback"] and not t["lost"] for t in tracked)
    assert all(t["inliers"] > 50 for t in tracked)
    est = np.stack(tt.trajectory)
    assert ate_rmse(est, gt[: len(est)], align="sim3")[0] < 0.05


def test_mono_relocalization_solve_on_one_wall():
    """`_reloc_solve_impl` with bf = 0 runs `pnp_ransac` (it used to raise):
    every landmark on one wall, 20 of 120 matches gross outliers."""
    from test_torch_pnp import one_wall

    pts, uv, pose = one_wall()
    tt = Tracker(TrackerConfig(
        width=320, height=240, fx=400.0, fy=400.0, cx=160.0, cy=120.0,
        n_features=120, n_levels=4, enable_local_ba=False,
        map_capacity=MapCapacity(4, 256, 120)), device="cpu")
    n = len(pts)
    neg = -torch.ones(n)
    frame = ttracking.FrameData(
        xy=torch.from_numpy(uv), xy_raw=torch.from_numpy(uv),
        level=torch.zeros(n, dtype=torch.int32), angle=torch.zeros(n),
        response=torch.zeros(n), desc=torch.zeros((n, 8), dtype=torch.int32),
        u_right=neg, depth=neg.clone(), valid=torch.ones(n, dtype=torch.bool))
    ok, est, inliers, n_inl = tt._reloc_solve_impl(
        frame, torch.from_numpy(pts), torch.ones(n, dtype=torch.bool),
        seed=7 * 31 + 2)
    assert bool(ok) and int(n_inl) >= 90
    err = np.asarray(jse3.boxminus(jnp.asarray(est.numpy()),
                                   jnp.asarray(pose)))
    assert np.linalg.norm(err) < 0.03, err
