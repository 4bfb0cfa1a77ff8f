"""Port parity for slice 2 as a whole: the 20-frame QVGA clip through both
`track_rgbd` loops with local mapping and window BA on
(`enable_local_ba=True`, `pipelined=False`). The JAX tracker runs with the
Python `MapGraph` (`TPU_SLAM_NATIVE_GRAPH=0`), the one the port has.

- With the JAX pyramid levels fed into the port's extractor, every frame's
  position is within 5 mm of JAX's and both make the same keyframes.
- With the port's own pyramid (whose C2 rounding moves upper-level
  keypoints, see tests/test_torch_tracking.py) the ATE is under 3 cm and
  every position within 2 cm of JAX's.
- `flush()` leaves no pending mapping product: `drain_pending` after it
  changes neither the map nor the graph.
- Pipelined (`pipelined=True`, `pipeline_depth=2`), both trackers on
  JAX's pyramid, with every stage ready at its first pump (JAX's mapper
  fetches resolved at once, `_Resolved`; the port's reads on the CPU
  are): the same keyframes, every position within 5 mm of JAX's, one
  trajectory entry a frame after `flush()`, which leaves nothing pending.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.ops import image as jax_image
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import _Resolved
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
          bf=0.08 * 260.0, n_features=500, n_levels=4, enable_local_ba=True,
          pipelined=False)
PIPE = dict(KW, pipelined=True, pipeline_depth=2)


@pytest.fixture(scope="module")
def clip():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(N_FRAMES, radius=0.35, yaw_amp=0.25)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(N_FRAMES):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       depth.astype(np.float16).astype(np.float32)))
    return frames, gt


def _jax_tracker_run(frames, kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_SLAM_NATIVE_GRAPH", "0")
        jt = JTracker(JConfig(map_capacity=JCap(16, 4096, 500), **kw))
        if kw["pipelined"]:
            # every mapping stage ready at its first pump
            jt.local_mapper._fetch = lambda a: _Resolved(np.asarray(a))
        for img, depth in frames:
            jt.track_rgbd(img, depth)
    jt.flush()
    return jt


@pytest.fixture(scope="module")
def jax_run(clip):
    return _jax_tracker_run(clip[0], KW)


def _port_tracker(kw=KW):
    return Tracker(TrackerConfig(map_capacity=MapCapacity(16, 4096, 500),
                                 **kw), device="cpu")


def _port_on_jax_pyramid_run(frames, kw):
    jax_pyramid = jax.jit(jax_image.build_pyramid, static_argnums=(1, 2))

    def build_pyramid(img, n_levels, scale_factor):
        return [torch.from_numpy(np.array(lvl)) for lvl in
                jax_pyramid(jnp.asarray(img.numpy()), n_levels, scale_factor)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_image, "build_pyramid", build_pyramid)
        tt = _port_tracker(kw)
        for img, depth in frames:
            tt.track_rgbd(img, depth)
    return tt


@pytest.fixture(scope="module")
def port_on_jax_pyramid(clip):
    return _port_on_jax_pyramid_run(clip[0], KW)


@pytest.fixture(scope="module")
def port_run(clip):
    frames, _ = clip
    tt = _port_tracker()
    for img, depth in frames:
        tt.track_rgbd(img, depth)
    return tt


def _kf_frames(info):
    return [i for i, t in enumerate(info) if t.get("kf")]


def test_clip_with_local_ba_on_jax_pyramid_within_5mm(clip, jax_run,
                                                      port_on_jax_pyramid):
    _, gt = clip
    jt, tt = jax_run, port_on_jax_pyramid
    assert jt.local_mapper is not None and tt.local_mapper is not None
    assert not any(t.get("lost") for t in tt.track_info)
    est_t, est_j = np.stack(tt.trajectory), np.stack(jt.trajectory)
    assert est_t.shape == est_j.shape == gt.shape
    assert ate_rmse(est_t, gt)[0] < 0.03
    assert np.abs(est_t[:, 4:] - est_j[:, 4:]).max() <= 5e-3
    assert _kf_frames(tt.track_info) == _kf_frames(jt.track_info)
    assert len(tt.graph.alive_kfs()) == len(jt.graph.alive_kfs())
    # window BA ran at every keyframe after the first, on both sides
    n_kf = 1 + len(_kf_frames(tt.track_info))
    assert tt.local_mapper.n_ba == n_kf - 1 >= 2


def test_clip_with_local_ba_own_pyramid(clip, jax_run, port_run):
    _, gt = clip
    jt, tt = jax_run, port_run
    assert not any(t.get("lost") for t in tt.track_info)
    est_t, est_j = np.stack(tt.trajectory), np.stack(jt.trajectory)
    ate_t, _ = ate_rmse(est_t, gt)
    assert ate_t < 0.03, ate_t
    assert np.abs(est_t[:, 4:] - est_j[:, 4:]).max() <= 0.02
    assert tt.local_mapper.n_ba >= 1


def test_flush_leaves_no_pending_product(port_run):
    _assert_flush_leaves_nothing(port_run)


def _assert_flush_leaves_nothing(tt):
    tt.flush()
    assert tt._map_job is None and not tt._pending_q
    lm = tt.local_mapper
    assert all(p is None for p in (lm._pending_tri, lm._pending_fuse,
                                   lm._pending_ratio, lm._pending_ba_erase,
                                   lm._pending_tcp))
    before = convert.map_to_numpy(tt.map)
    obs = {p: dict(o) for p, o in tt.graph.obs.items()}
    alive = tt.graph.pt_alive.copy()
    m = lm.drain_pending(tt.map, tt.graph)
    for k, v in convert.map_to_numpy(m).items():
        np.testing.assert_array_equal(v, before[k])
    assert {p: dict(o) for p, o in tt.graph.obs.items()} == obs
    np.testing.assert_array_equal(tt.graph.pt_alive, alive)


def test_reset_map_clears_the_mapping_job(clip):
    frames, _ = clip
    tt = _port_tracker()
    for img, depth in frames[:5]:
        tt.track_rgbd(img, depth)
    assert tt.local_mapper._pending_ba_erase is not None
    tt.reset_map()
    lm = tt.local_mapper
    assert all(p is None for p in (lm._pending_tri, lm._pending_fuse,
                                   lm._pending_ratio, lm._pending_ba_erase,
                                   lm._pending_tcp))
    assert len(tt.graph.alive_kfs()) == 0


def test_pipelined_on_jax_pyramid_within_5mm(clip):
    frames, gt = clip
    jt = _jax_tracker_run(frames, PIPE)
    tt = _port_on_jax_pyramid_run(frames, PIPE)
    tt.flush()
    assert len(tt.trajectory) == len(jt.trajectory) == N_FRAMES
    assert len(tt.track_info) == len(jt.track_info) == N_FRAMES - 1
    assert not any(t.get("lost") for t in tt.track_info)
    assert _kf_frames(tt.track_info) == _kf_frames(jt.track_info)
    assert len(tt.graph.alive_kfs()) == len(jt.graph.alive_kfs()) >= 3
    est_t, est_j = np.stack(tt.trajectory), np.stack(jt.trajectory)
    assert np.abs(est_t[:, 4:] - est_j[:, 4:]).max() <= 5e-3
    assert ate_rmse(est_t, gt)[0] < 0.03
    assert tt.pumps_not_ready == 0
    _assert_flush_leaves_nothing(tt)
