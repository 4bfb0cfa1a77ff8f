"""System facade: the user-facing entry point of the SLAM engine.

Port of `orb_slam2_refactored_tpu/slam/system.py`, the reference `System`
(`include/System.h:45-113`, `src/System.cc:310-951`):
`SlamSystem.create(settings_yaml, sensor)` builds the engine from the
reference's YAML settings schema (`config.py`), `track_monocular`,
`track_stereo` and `track_rgbd` process frames, the trajectory savers
write the reference's TUM and KITTI text formats (`SaveTrajectoryTUM`
:690, `SaveKeyFrameTrajectoryTUM` :753, `SaveTrajectoryKITTI` :790),
`activate_localization_mode` freezes the map (:221-271) and `reset` clears
every state (:281-308). Tracking, local mapping and loop closing are
synchronous staged calls, as in the JAX package.

Poses are f32 `[qw, qx, qy, qz, tx, ty, tz]`, world-to-camera. The tracker
runs on `cuda:0` unless `create` is given another device. `use_viewer=True`
starts the live viewer (`viz/viewer.py`, the reference's Viewer thread);
`shutdown()` stops it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Settings
from ..geometry import se3

MONOCULAR = 0
STEREO = 1
RGBD = 2


def _np_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side se3 compose (the layout and semantics of
    `geometry.se3.compose`: apply b first, then a)."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    q = np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], np.float32)
    q /= max(np.linalg.norm(q), 1e-12)
    u, w = a[1:4], a[0]
    v = b[4:7]
    uv = np.cross(u, v)
    t = v + 2.0 * (w * uv + np.cross(u, uv)) + a[4:7]
    return np.concatenate([q, t.astype(np.float32)])


def _np_inverse(a: np.ndarray) -> np.ndarray:
    """Host-side se3 inverse (`geometry.se3.inverse`)."""
    q = np.array([a[0], -a[1], -a[2], -a[3]], np.float32)
    u, w = q[1:4], q[0]
    v = -a[4:7]
    uv = np.cross(u, v)
    t = v + 2.0 * (w * uv + np.cross(u, uv))
    return np.concatenate([q, t.astype(np.float32)])


def corrected_frame_poses(tracker) -> np.ndarray:
    """Per-frame world->camera poses with the loop and global-BA
    corrections applied: each frame's Tcr composed with its reference
    keyframe's current pose, walking culled reference keyframes through
    their recorded Tcp (`SaveTrajectoryTUM`, `src/System.cc:690-747`).
    Frames without a Tcr record (losses, relocalizations) keep their raw
    pose."""
    entries = tracker.traj_entries
    if not entries:
        return (np.stack(tracker.trajectory) if tracker.trajectory
                else np.zeros((0, 7), np.float32))
    kf_pose = tracker.map.kf_pose.cpu().numpy()  # one device read
    g = tracker.graph
    tcp_map = getattr(g, "kf_tcp", {})
    out = np.zeros((len(entries), 7), np.float32)
    ident = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    for i, e in enumerate(entries):
        if e["lost"] or e["tcr"] is None or e["ref"] < 0:
            out[i] = e["pose"]
            continue
        ref = e["ref"]
        trw = ident
        hops = 0
        while not g.kf_alive[ref] and ref in tcp_map and hops < 64:
            parent, tcp = tcp_map[ref]
            trw = _np_compose(trw, np.asarray(tcp))
            ref = parent
            hops += 1
        if not g.kf_alive[ref]:
            out[i] = e["pose"]  # unwalkable (a reset wiped the map)
            continue
        trw = _np_compose(trw, kf_pose[ref])
        out[i] = _np_compose(e["tcr"], trw)
    return out


def _inverse(poses: np.ndarray) -> np.ndarray:
    """World<->camera inverse of f32 [N,7] poses (`geometry/se3.py`)."""
    return se3.inverse(torch.as_tensor(np.asarray(poses, np.float32))).numpy()


class SlamSystem:
    def __init__(self, tracker, sensor: int, settings: Settings):
        self.tracker = tracker
        self.sensor = sensor
        self.settings = settings
        self.localization_only = False
        self.timestamps: List[float] = []
        self._pending_cmds: List = []
        self.viewer = None

    @staticmethod
    def create(settings_path: str, sensor: int, map_capacity=None,
               enable_loop_closing: bool = True, vocabulary=None,
               device=None, use_viewer: bool = False,
               viewer_dir: str = "viz_live") -> "SlamSystem":
        """Build from a reference-format YAML settings file (the key schema
        of `src/System.cc:333-375`, `config.Settings`), with the
        `TrackerConfig` the JAX package fills from it. `vocabulary` is a
        port `Vocabulary` (a JAX one goes through
        `convert.vocabulary_from_numpy`); `device` defaults to the card.
        `use_viewer` is the reference constructor's bUseViewer: it starts
        the background `LiveViewer` render loop into `viewer_dir`."""
        from .tracking import Tracker, TrackerConfig

        st = Settings.from_yaml(settings_path)
        cam = st.camera
        if not cam.width or not cam.height:
            raise ValueError(
                "Camera.width/Camera.height must be set in the settings YAML "
                "(the image geometry sizes the pipeline)")
        cfg = TrackerConfig(
            width=cam.width, height=cam.height,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            bf=cam.bf if sensor != MONOCULAR else 0.0,
            dist_coeffs=(cam.k1, cam.k2, cam.p1, cam.p2, cam.k3),
            th_depth=st.th_depth,
            n_features=st.orb.n_features,
            n_levels=st.orb.n_levels,
            scale_factor=st.orb.scale_factor,
            ini_th_fast=st.orb.ini_th_fast,
            min_th_fast=st.orb.min_th_fast,
            kf_max_interval=int(cam.fps),
            kf_ref_ratio=0.9 if sensor == MONOCULAR else 0.75,
            enable_loop_closing=enable_loop_closing,
            map_capacity=map_capacity,
            # extension key (not in the reference schema): the BRIEF test
            # table; "learned" matches externally trained vocabularies
            descriptor_pattern=str(st.raw.get("ORBextractor.pattern",
                                              "fresh")),
        )
        tracker = Tracker(cfg, device)
        if vocabulary is not None:
            tracker.set_vocabulary(vocabulary)
        system = SlamSystem(tracker, sensor, st)
        if use_viewer:
            from ..viz.viewer import LiveViewer

            system.viewer = LiveViewer(tracker, out_dir=viewer_dir,
                                       system=system).start()
        return system

    # per-frame entry points (System::Track*, src/System.cc:430-622)

    def track_monocular(self, img, timestamp: float):
        assert self.sensor == MONOCULAR
        self.timestamps.append(timestamp)
        return self._track(lambda: self.tracker.track_mono(img, timestamp))

    def track_stereo(self, img_left, img_right, timestamp: float):
        assert self.sensor == STEREO
        self.timestamps.append(timestamp)
        return self._track(
            lambda: self.tracker.track_stereo(img_left, img_right, timestamp))

    def track_rgbd(self, img, depth, timestamp: float):
        assert self.sensor == RGBD
        if self.settings.depth_map_factor not in (0.0, 1.0):
            depth = (np.asarray(depth, np.float32)
                     / self.settings.depth_map_factor)
        self.timestamps.append(timestamp)
        return self._track(
            lambda: self.tracker.track_rgbd(img, depth, timestamp))

    def _track(self, fn):
        if self._pending_cmds:
            self._apply_pending_commands()
        return fn()

    # the runtime control surface: a command is requested from any thread
    # and applied at the next tracked frame (ModeManager / ResetManager,
    # src/System.cc:221-308,439-442)

    def request_command(self, cmd: str, arg: str = ""):
        """Queue a control command, applied at the next tracked frame:
        `localization_mode on|off`, `reset`, `save_map <path>`."""
        self._pending_cmds.append((str(cmd), str(arg)))

    def _apply_pending_commands(self):
        cmds, self._pending_cmds = self._pending_cmds, []
        for cmd, arg in cmds:
            if cmd == "localization_mode":
                if arg.lower() in ("on", "1", "true"):
                    self.activate_localization_mode()
                else:
                    self.deactivate_localization_mode()
            elif cmd == "reset":
                self.reset()
            elif cmd == "save_map" and arg:
                self.save_map(arg)

    def activate_localization_mode(self):
        """Track-only mode (ModeManager stopping LocalMapping,
        `src/System.cc:221-271`): every deferred mapping product is drained
        first, then keyframe creation and the mapping job stop, so the map
        cannot change until deactivation."""
        self.tracker._finalize_map()
        self.tracker.localization_only = True
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False
        self.localization_only = False

    def change_calibration(self, settings_path: str):
        """System::ChangeCalibration analog (`src/System.cc:869-875`):
        reload the intrinsics and the distortion from a settings YAML
        mid-session; the map survives."""
        st = Settings.from_yaml(settings_path)
        cam = st.camera
        self.settings = st
        self.tracker.change_calibration(
            cam.fx, cam.fy, cam.cx, cam.cy,
            bf=cam.bf if self.sensor != MONOCULAR else None,
            dist_coeffs=(cam.k1, cam.k2, cam.p1, cam.p2, cam.k3))

    def get_tracking_state(self) -> int:
        return self.tracker.state

    def map_changed_counter(self) -> int:
        return self.tracker.graph.big_change_counter

    def reset(self):
        """Full system reset (src/System.cc:624-660): a new tracker (map,
        graph, state NOT_INITIALIZED) on the same device, the vocabulary
        kept."""
        from .tracking import Tracker

        voc = self.tracker.vocabulary
        new = Tracker(self.tracker.cfg, self.tracker.device)
        if voc is not None:
            new.set_vocabulary(voc)
        self.tracker = new
        self.timestamps = []

    def save_map(self, path: str):
        """Persist the whole SLAM state (`slam/serialize.py`)."""
        from .serialize import save_map as _save
        _save(self.tracker, path)

    def load_map(self, path: str):
        """Restore a saved map; the next tracked frame relocalizes in it."""
        from .serialize import load_map as _load
        _load(self.tracker, path)

    def shutdown(self):
        """Stop the viewer thread if one runs (the reference joins its
        Viewer, LocalMapping and LoopClosing threads, `src/System.cc:
        665-684`; here the stages run in the caller's thread, so the viewer
        is the only thread)."""
        if self.viewer is not None:
            self.viewer.stop()
            self.viewer = None

    # trajectory export in the reference's text formats

    def _frame_poses_wc(self) -> np.ndarray:
        traj = self.tracker.trajectory
        return _inverse(np.stack(traj)) if traj else np.zeros((0, 7),
                                                               np.float32)

    def corrected_frame_poses(self) -> np.ndarray:
        return corrected_frame_poses(self.tracker)

    def save_trajectory_tum(self, path: str, corrected: bool = True):
        """TUM format, `t tx ty tz qx qy qz qw` a frame (`SaveTrajectoryTUM`,
        src/System.cc:690-747). With `corrected=True` (the reference's
        behaviour) each frame's Tcr is composed with its reference
        keyframe's current, loop- and BA-corrected pose."""
        if corrected and self.tracker.traj_entries:
            poses_wc = _inverse(self.corrected_frame_poses())
        else:
            poses_wc = self._frame_poses_wc()
        with open(path, "w") as f:
            for ts, p in zip(self.timestamps, poses_wc):
                qw, qx, qy, qz, tx, ty, tz = p
                f.write(f"{ts:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframes only, TUM format (`SaveKeyFrameTrajectoryTUM`,
        :753-784)."""
        g = self.tracker.graph
        kf_pose = np.asarray(self.tracker.map.kf_pose.cpu())
        with open(path, "w") as f:
            for k in g.alive_kfs():
                qw, qx, qy, qz, tx, ty, tz = _inverse(kf_pose[k])
                ts = g.kf_timestamp[k]
                f.write(f"{ts:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                        f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")

    def save_trajectory_kitti(self, path: str):
        """KITTI format: the 3x4 row-major pose matrix of each frame
        (`SaveTrajectoryKITTI`, src/System.cc:790-843)."""
        poses_wc = self._frame_poses_wc()
        mats = (se3.to_matrix(torch.as_tensor(poses_wc)).numpy()
                if len(poses_wc) else np.zeros((0, 4, 4)))
        with open(path, "w") as f:
            for m in mats:
                f.write(" ".join(f"{v:.9e}" for v in m[:3].reshape(-1))
                        + "\n")
