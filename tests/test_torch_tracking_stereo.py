"""Port parity for the stereo slice as a whole: the fused stereo step
against the JAX tracker's, and the port's `track_stereo` loop.

(a) A JAX stereo tracker (local BA off) tracks 3 frames of a QVGA stereo
    clip; its state goes through `convert.py` and frame 4 is stepped by
    both packages' `_step_stereo_impl` (JAX's through the packed program its
    `track_stereo` compiled, on the same uint8 pair). The port's extractor
    is fed JAX's pyramid levels (C2 moves upper-level keypoints otherwise):
    the pose within 2 mm, the level-0 landmark assignments on >= 95 % of
    the features and the inlier count within 5 %.
(b) The port's `track_stereo` on a 20-frame QVGA stereo clip with local BA
    on (the bench's setting): ATE under 3 cm and no frame lost. (The same
    clip through the JAX tracker: 2.64 cm; through the port: 2.69 cm.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.ops import image as jax_image
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.ops import image as port_image
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker, TrackerConfig

torch.set_num_threads(1)
N_FRAMES = 20
KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
          bf=0.08 * 260.0, n_features=500, n_levels=4)


def _q8(img):
    """The 8-bit quantization of the JAX tracker's wire packing, so both
    packages see the same pixels."""
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def clip():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes, baseline=0.08)
    gt = orbit_trajectory(N_FRAMES, radius=0.35, yaw_amp=0.25)
    frames = []
    for i in range(N_FRAMES):
        left, right, _ = scene.render_stereo(gt[i])
        frames.append((_q8(left), _q8(right)))
    return frames, gt


def _snapshot(jt):
    leaves = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}
    return {
        "map": leaves(jt.map), "last_frame": leaves(jt.last_frame),
        "last_mp": np.asarray(jt.last_mp_dev), "pose": np.asarray(jt.pose_dev),
        "velocity": np.asarray(jt.velocity_dev), "ref_kf": max(jt.ref_kf, 0),
        "mp_vis": np.asarray(jt.mp_vis_dev),
        "mp_found": np.asarray(jt.mp_found_dev),
        "mp_seen": np.asarray(jt.mp_seen_dev), "fidx": int(jt.fidx_dev),
    }


@pytest.fixture(scope="module")
def step4(clip):
    """JAX's state after 3 tracked stereo frames and its step of frame 4."""
    frames, _ = clip
    jt = JTracker(JConfig(map_capacity=JCap(16, 4096, 500),
                          enable_local_ba=False, **KW))
    for left, right in frames[:3]:
        jt.track_stereo(left, right)
    snap = _snapshot(jt)
    left, right = frames[3]
    jout = jt._step_stereo_packed(
        jnp.asarray(jt._pack_stereo(left, right)), jt.last_frame,
        jt.last_mp_dev, jt.map, jt.pose_dev, jt.velocity_dev,
        jt._ref_kf_scalar(), jt.mp_vis_dev, jt.mp_found_dev,
        jt.local_mask_dev, jt.mp_seen_dev, jt.fidx_dev)
    return snap, jax.tree.map(np.asarray, jout), frames[3]


def test_step_stereo_impl_on_jax_pyramid_tracks_like_jax(step4):
    snap, jout, (left, right) = step4
    st = convert.tracker_state_from_numpy(snap, "cpu")
    m = convert.map_from_numpy(snap["map"], "cpu")
    jax_pyramid = jax.jit(jax_image.build_pyramid, static_argnums=(1, 2))

    def build_pyramid(img, n_levels, scale_factor):
        return [torch.from_numpy(np.array(lvl)) for lvl in
                jax_pyramid(jnp.asarray(img.numpy()), n_levels, scale_factor)]

    tt = Tracker(TrackerConfig(map_capacity=MapCapacity(16, 4096, 500),
                               enable_local_ba=False, **KW), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_image, "build_pyramid", build_pyramid)
        out = tt._step_stereo_impl(
            torch.from_numpy(left), torch.from_numpy(right),
            st["last_frame"], st["last_mp"], m, st["pose"], st["velocity"],
            st["ref_kf"], st["mp_vis"], st["mp_found"], st["mp_seen"],
            st["fidx"])
    frame, pose, _, feat_mp, pack = out[:5]
    jframe = jout[0]
    lvl0 = jframe.level == 0
    matched = jframe.u_right > 0
    same0 = (feat_mp.numpy()[lvl0] == jout[3][lvl0]).mean()
    dpose = np.abs(pose.numpy()[4:] - jout[1][4:]).max()
    print(f"stereo step on frame 4: pose {dpose:.3g} m from JAX's, level-0 "
          f"assignments {same0:.4f} equal, inliers {pack[14].item():g} vs "
          f"{jout[4][14]:g}, matched {int((frame.u_right > 0).sum())} vs "
          f"{int(matched.sum())}")
    assert matched.sum() > 100
    np.testing.assert_array_equal(frame.xy.numpy()[lvl0], jframe.xy[lvl0])
    assert (frame.u_right.numpy() > 0).sum() >= 0.95 * matched.sum()
    assert same0 >= 0.95
    assert dpose <= 2e-3
    assert abs(pack[14].item() - jout[4][14]) <= 0.05 * jout[4][14]
    assert out[8] == snap["fidx"] + 1


def test_track_stereo_clip_with_local_ba(clip):
    frames, gt = clip
    tt = Tracker(TrackerConfig(map_capacity=MapCapacity(16, 4096, 500),
                               enable_local_ba=True, **KW), device="cpu")
    for i, (left, right) in enumerate(frames):
        tt.track_stereo(left, right, timestamp=i / 30.0)
    tt.flush()
    assert not any(t.get("lost") for t in tt.track_info)
    est = np.stack(tt.trajectory)
    assert est.shape == gt.shape and np.isfinite(est).all()
    ate, _ = ate_rmse(est, gt, align="se3")
    print(f"port stereo clip: ATE {ate:.5f} m, "
          f"{len(tt.graph.alive_kfs())} keyframes, "
          f"{tt.local_mapper.n_ba} window BA solves")
    assert ate < 0.03, ate
    assert tt.local_mapper.n_ba >= 1
