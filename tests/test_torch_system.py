"""Port parity: the system facade (`slam/system.py`) and the settings reader
(`config.py`).

- `Settings.from_yaml` equals the JAX package's field by field (its `raw`
  dict key by key, with the same Python types) on the repo's RGB-D config,
  on a EuRoC settings file with `!!opencv-matrix` nodes, and on a file with
  comments, inline comments, a flow list over two lines and
  `ORBextractor.pattern: learned`.
- The three savers write the JAX package's bytes: JAX's `SlamSystem`
  methods run on a stub holding the port run's numpy values.
- `SlamSystem.create` builds the `TrackerConfig` the JAX package builds
  (`system.py:139-159`) and tracks as a `Tracker` built by hand with it, to
  the bit, on the CPU.
- Localization mode leaves the map's bytes unchanged over 10 frames (as
  JAX's `test_system.py:70-104`), and keyframes resume after it.
- `change_calibration` gives JAX's intrinsics, image bounds and distortion,
  and tracking goes on; `reset` and `request_command` as JAX's.
"""

import dataclasses
import hashlib
import os
import types

import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.config import Settings as JSettings
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.system import SlamSystem as JSystem
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch.config import Settings
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, euroc_settings_yaml, make_euroc_rig,
    orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.system import (
    MONOCULAR, RGBD, STEREO, SlamSystem)
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    Tracker, TrackerConfig, TrackState)
from orb_slam2_refactored_tpu_torch.slam.vocabulary import train_vocabulary

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RGBD_YAML = os.path.join(ROOT, "configs", "synthetic_rgbd.yaml")
N_FRAMES = 10
# a QVGA RGB-D camera at 5 fps: `kf_max_interval` = int(fps) = 5, so a
# 10-frame run makes keyframes
SETTINGS = """%YAML:1.0
---
# synthetic box-room RGB-D camera
Camera.fx: 260.0
Camera.fy: 260.0   # square pixels
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 5.0
Camera.bf: 20.8
Camera.RGB: 1
ThDepth: 35.0
DepthMapFactor: 1.0
ORBextractor.nFeatures: 500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
ORBextractor.pattern: learned
Viewer.KeyFrameSize: 0.05
Viewer.on: yes
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28340811, 0.07395907, 0.00019359,
          1.76187114e-05, 0.0]
"""


def _write(tmp_path, name, text):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def settings_path(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("settings"), "cam.yaml", SETTINGS)


@pytest.fixture(scope="module")
def frames():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(30, radius=0.3, yaw_amp=0.25)
    return [scene.render(gt[i]) for i in range(2 * N_FRAMES + 4)]


@pytest.fixture(scope="module")
def run(settings_path, frames):
    """The facade over the first 10 frames, on the CPU."""
    system = SlamSystem.create(settings_path, RGBD,
                               enable_loop_closing=False, device="cpu")
    for i in range(N_FRAMES):
        system.track_rgbd(*frames[i], timestamp=100.0 + i / 5.0)
    return system


def _same_settings(a, b):
    assert set(a.raw) == set(b.raw)
    for k, v in a.raw.items():
        assert type(b.raw[k]) is type(v) and b.raw[k] == v, k
    for f in ("camera", "orb"):
        assert dataclasses.asdict(getattr(a, f)) == dataclasses.asdict(
            getattr(b, f)), f
    for f in ("th_depth", "depth_map_factor", "viewer"):
        assert getattr(a, f) == getattr(b, f), f
    if a.rectification is None:
        assert b.rectification is None
        return
    for f in dataclasses.fields(a.rectification):
        x, y = getattr(a.rectification, f.name), getattr(b.rectification,
                                                         f.name)
        assert np.array_equal(x, y), f.name


@pytest.mark.parametrize("which", ["rgbd_config", "euroc", "commented"])
def test_settings_match_jax(which, settings_path, tmp_path):
    path = {"rgbd_config": RGBD_YAML, "commented": settings_path,
            "euroc": _write(tmp_path, "euroc.yaml",
                            euroc_settings_yaml(make_euroc_rig()))}[which]
    js, ts = JSettings.from_yaml(path), Settings.from_yaml(path)
    _same_settings(js, ts)
    if which == "euroc":
        assert ts.rectification.P_r.shape == (3, 4)
    if which == "commented":
        assert ts.raw["ORBextractor.pattern"] == "learned"
        assert ts.raw["LEFT.D"]["data"][3] == 1.76187114e-05


def test_create_builds_jax_config_and_tracks_as_a_tracker(run, frames,
                                                          settings_path,
                                                          tmp_path):
    """The facade's `TrackerConfig` is the one the JAX facade fills
    (`system.py:139-159`: bf, the distortion, `kf_max_interval` from the
    fps, `kf_ref_ratio`, the pattern), and a `Tracker` built by hand with
    it tracks the same 10 frames to the bit."""
    st = Settings.from_yaml(settings_path)
    cam = st.camera
    kw = dict(width=320, height=240, fx=cam.fx, fy=cam.fy, cx=cam.cx,
              cy=cam.cy, bf=cam.bf, dist_coeffs=(0.0,) * 5,
              th_depth=st.th_depth, n_features=500, n_levels=4,
              scale_factor=1.2, ini_th_fast=20, min_th_fast=7,
              kf_max_interval=5, kf_ref_ratio=0.75,
              enable_loop_closing=False, descriptor_pattern="learned")
    assert dataclasses.asdict(run.tracker.cfg) == dataclasses.asdict(
        TrackerConfig(**kw))
    jcfg = dataclasses.asdict(JConfig(**kw))
    jcfg["map_capacity"] = dataclasses.asdict(JCap(**jcfg["map_capacity"]))
    assert {k: v for k, v in dataclasses.asdict(run.tracker.cfg).items()
            if k in jcfg} == jcfg
    mono = SlamSystem.create(settings_path, MONOCULAR, device="cpu")
    assert mono.tracker.cfg.bf == 0.0 and mono.tracker.cfg.kf_ref_ratio == 0.9
    assert mono.tracker.cfg.enable_loop_closing
    t = Tracker(TrackerConfig(**kw), device="cpu")
    for i in range(N_FRAMES):
        t.track_rgbd(*frames[i], timestamp=100.0 + i / 5.0)
    np.testing.assert_array_equal(np.stack(t.trajectory),
                                  np.stack(run.tracker.trajectory))
    assert run.get_tracking_state() == TrackState.OK
    assert len(run.tracker.graph.alive_kfs()) >= 2
    # the viewer (`viz/viewer.py`) starts with the system and stops with it
    viewed = SlamSystem.create(settings_path, RGBD, device="cpu",
                               use_viewer=True, viewer_dir=str(tmp_path))
    assert viewed.viewer.running and viewed.viewer.system is viewed
    viewer = viewed.viewer
    viewed.shutdown()
    assert viewed.viewer is None and not viewer.running


def test_savers_write_jax_bytes(run, tmp_path):
    """JAX's three savers on a stub that holds the port run's trajectory,
    its Tcr records, timestamps, graph and keyframe poses write the bytes
    the port's savers write."""
    tr = run.tracker
    stub = types.SimpleNamespace(
        trajectory=list(tr.trajectory), traj_entries=tr.traj_entries,
        graph=tr.graph,
        map=types.SimpleNamespace(kf_pose=tr.map.kf_pose.numpy()))
    js = object.__new__(JSystem)
    js.tracker, js.timestamps = stub, list(run.timestamps)
    for name in ("save_trajectory_tum", "save_keyframe_trajectory_tum",
                 "save_trajectory_kitti"):
        a, b = str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")
        getattr(js, name)(a)
        getattr(run, name)(b)
        ja, pb = open(a, "rb").read(), open(b, "rb").read()
        assert ja == pb and len(pb) > 0, name
    lines = open(str(tmp_path / "port_save_trajectory_tum")).read().split("\n")
    assert len(lines) == N_FRAMES + 1 and lines[0].startswith("100.000000 ")
    kf = open(str(tmp_path / "port_save_keyframe_trajectory_tum")).read()
    assert len(kf.splitlines()) == len(tr.graph.alive_kfs())


def _map_hash(tracker):
    h = hashlib.sha256()
    m = tracker.map
    for a in (m.kf_pose, m.kf_mp, m.kf_valid, m.mp_pos, m.mp_valid,
              m.mp_desc):
        h.update(a.numpy().tobytes())
    h.update(np.int64(tracker.graph.num_kfs).tobytes())
    return h.hexdigest()


def test_localization_mode_freezes_the_map(run, frames):
    """Track-only mode: 10 more frames leave the map's bytes and its
    keyframes as they were, the camera still tracked; deactivated through
    `request_command`, applied at the next frame, keyframes resume."""
    tr = run.tracker
    n_kf = tr.graph.num_kfs
    run.activate_localization_mode()
    assert tr.localization_only
    h0 = _map_hash(tr)
    for i in range(N_FRAMES, 2 * N_FRAMES):
        run.track_rgbd(*frames[i], timestamp=100.0 + i / 5.0)
    tr.flush()
    assert _map_hash(tr) == h0 and tr.graph.num_kfs == n_kf
    assert run.get_tracking_state() == TrackState.OK
    assert not any(t.get("kf") for t in tr.track_info[-N_FRAMES:])
    # a mapping job in the mode (a seam keyframe's) is held by the pump, as
    # the JAX tracker's pump holds it; the next frame, once the mode is
    # off, completes it
    job = (tr.ref_kf, 0)
    tr._map_job = job
    tr._pump_mapping()
    assert tr._map_job == job and _map_hash(tr) == h0
    run.request_command("localization_mode", "off")
    assert tr.localization_only  # applied at the next frame, not before
    for i in range(2 * N_FRAMES, 2 * N_FRAMES + 4):
        run.track_rgbd(*frames[i], timestamp=100.0 + i / 5.0)
    assert not tr.localization_only and not run.localization_only
    assert tr._map_job is None
    assert tr.graph.num_kfs > n_kf


def test_change_calibration_matches_jax(settings_path, frames, tmp_path):
    """The intrinsics, the undistorted image bounds and the distortion
    after `change_calibration` equal a JAX tracker's after its own; the
    mapper is rebuilt with the new camera and tracking goes on."""
    new = SETTINGS.replace("Camera.fx: 260.0", "Camera.fx: 262.0").replace(
        "Camera.k1: 0.0", "Camera.k1: 0.02").replace("Camera.cy: 120.0",
                                                     "Camera.cy: 121.5")
    new_path = _write(tmp_path, "new.yaml", new)
    system = SlamSystem.create(settings_path, RGBD,
                               enable_loop_closing=False, device="cpu")
    for i in range(3):
        system.track_rgbd(*frames[i], timestamp=i / 5.0)
    system.change_calibration(new_path)
    jt = JTracker(JConfig(width=320, height=240, fx=260.0, fy=260.0,
                          cx=160.0, cy=120.0, bf=20.8, n_features=500,
                          n_levels=4, map_capacity=JCap(8, 1024, 500)))
    cam = Settings.from_yaml(new_path).camera
    jt.change_calibration(cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf,
                          dist_coeffs=(cam.k1, cam.k2, cam.p1, cam.p2,
                                       cam.k3))
    tr = system.tracker
    for f in ("fx", "fy", "cx", "cy", "bf"):
        assert getattr(tr.cam, f) == float(getattr(jt.cam, f)), f
    for f in ("k1", "k2", "p1", "p2", "k3"):
        assert getattr(tr.dist, f) == float(getattr(jt.dist, f)), f
    np.testing.assert_array_equal(np.asarray(tr.image_bounds, np.float64),
                                  np.asarray(jt.image_bounds, np.float64))
    assert tr._has_dist and tr.local_mapper.cam is tr.cam
    assert system.settings.camera.fx == 262.0
    for i in range(3, 6):
        system.track_rgbd(*frames[i], timestamp=i / 5.0)
    assert system.get_tracking_state() == TrackState.OK


def test_reset_and_request_command(run, frames, tmp_path):
    """`request_command` applies at the next tracked frame: `save_map`
    writes the map, then `reset` gives a new tracker (NOT_INITIALIZED, an
    empty trajectory) on the same device with the vocabulary kept, which
    the next frame initializes."""
    rng = np.random.default_rng(0)
    voc = train_vocabulary(rng.integers(0, 2 ** 32, (600, 8), np.uint32),
                           n_words=64, iters=2, device="cpu")
    run.tracker.set_vocabulary(voc)
    path = str(tmp_path / "map.npz")
    run.request_command("save_map", path)
    run.request_command("reset")
    assert not os.path.exists(path)
    old = run.tracker
    run.track_rgbd(*frames[0], timestamp=200.0)
    assert os.path.exists(path)
    assert run.tracker is not old and run.tracker.vocabulary is voc
    assert run.tracker.device == torch.device("cpu")
    # as in the JAX facade, the frame's timestamp is logged before the
    # reset it carries clears the log (a reproduced JAX fault: its frame is
    # tracked but has no timestamp to be saved with)
    assert run.timestamps == [] and len(run.tracker.trajectory) == 1
    assert run.get_tracking_state() == TrackState.OK
    run.reset()
    assert run.get_tracking_state() == TrackState.NOT_INITIALIZED
    assert run.tracker.trajectory == [] and run.timestamps == []
    assert run.tracker.vocabulary is voc
    assert run.map_changed_counter() == 0
    with pytest.raises(AssertionError):
        run.track_stereo(frames[0][0], frames[0][0], 0.0)
