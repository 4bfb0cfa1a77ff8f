"""The port's `viz/` against the JAX package's, on stub trackers that hold
the same arrays for both: `detect_plane` and `ArOverlay` bit for bit,
`map_primitives` against the formulas of JAX's `plot_map`, the viewer's
control relay, `status.json`, its rendered PNG and its failure report, and
`SlamSystem(use_viewer=True)` on the CPU."""

import json
import os
import time
import types

import jax.numpy as jnp
import numpy as np
import torch

from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.viz import ar as jar
from orb_slam2_refactored_tpu.viz.viewer import LiveViewer as JViewer
from orb_slam2_refactored_tpu_torch.io.png import read_png
from orb_slam2_refactored_tpu_torch.slam.system import RGBD, SlamSystem
from orb_slam2_refactored_tpu_torch.viz import ar as tar
from orb_slam2_refactored_tpu_torch.viz.plot import (
    map_primitives, plot_frame, render_map)
from orb_slam2_refactored_tpu_torch.viz.viewer import LiveViewer

torch.set_num_threads(1)
FX, CX, CY = 260.0, 160.0, 120.0


class StubGraph:
    """The graph calls `viz/` makes, over numpy arrays."""

    def __init__(self, n_obs, kf_alive, covis):
        self.pt_alive = n_obs > 0
        self._n_obs = n_obs
        self.kf_alive = kf_alive
        self._covis = covis  # {kf: {kf: weight}}

    def alive_points(self):
        return np.nonzero(self.pt_alive)[0]

    def alive_kfs(self):
        return np.nonzero(self.kf_alive)[0]

    def n_obs(self, p):
        return int(self._n_obs[p])

    def covis_neighbors(self, kf, min_weight=0):
        items = sorted(((j, w) for j, w in self._covis.get(kf, {}).items()
                        if w >= min_weight and self.kf_alive[j]),
                       key=lambda t: -t[1])
        return [j for j, _ in items]


def _scene(seed=0):
    """A floor (y = 1) seen from the origin looking down +z, with 20 %
    outliers, three keyframes, a trajectory and the last frame's matches."""
    rng = np.random.default_rng(seed)
    n_on, n_out, P = 240, 60, 320
    on = np.stack([rng.uniform(-1.5, 1.5, n_on),
                   1.0 + rng.normal(0, 0.003, n_on),
                   rng.uniform(2.0, 5.0, n_on)], -1)
    out = np.stack([rng.uniform(-1.5, 1.5, n_out), rng.uniform(-1, 1, n_out),
                    rng.uniform(2.0, 5.0, n_out)], -1)
    mp_pos = np.zeros((P, 3), np.float32)
    mp_pos[:n_on + n_out] = np.concatenate([on, out])
    n_obs = np.zeros(P, np.int64)
    n_obs[:n_on + n_out] = rng.integers(1, 9, n_on + n_out)
    kf_pose = np.zeros((4, 7), np.float32)
    kf_pose[:, 0] = 1.0
    kf_pose[:, 4] = [0.0, -0.1, -0.2, 0.0]
    kf_alive = np.array([True, True, True, False])
    traj = [np.array([1, 0, 0, 0, -0.02 * i, 0.0, 0.01 * i], np.float32)
            for i in range(6)]
    xc = mp_pos[:40]
    xy = np.zeros((60, 2), np.float32)
    xy[:40] = np.stack([FX * xc[:, 0] / xc[:, 2] + CX,
                        FX * xc[:, 1] / xc[:, 2] + CY], -1)
    last_mp = np.full(60, -1, np.int32)
    last_mp[:40:2] = np.arange(0, 40, 2)
    graph = StubGraph(n_obs, kf_alive, {0: {1: 30, 2: 10}, 1: {0: 30, 2: 15},
                                        2: {0: 10, 1: 15, 3: 40}})
    return dict(mp_pos=mp_pos, mp_valid=n_obs > 0, kf_pose=kf_pose,
                graph=graph, traj=traj, xy=xy, last_mp=last_mp)


def _trackers(s):
    cfg = types.SimpleNamespace(fx=FX, fy=FX, cx=CX, cy=CY)
    common = dict(graph=s["graph"], pose=np.array([1, 0, 0, 0, 0, 0, 0],
                                                  np.float32),
                  cfg=cfg, trajectory=list(s["traj"]), state=1, frame_id=7,
                  localization_only=False, loop_closer=None)
    j = types.SimpleNamespace(
        map=types.SimpleNamespace(mp_pos=jnp.asarray(s["mp_pos"]),
                                  mp_valid=jnp.asarray(s["mp_valid"]),
                                  kf_pose=jnp.asarray(s["kf_pose"])),
        last_mp=s["last_mp"], last_mp_dev=None,
        last_frame=types.SimpleNamespace(xy=jnp.asarray(s["xy"])), **common)
    t = types.SimpleNamespace(
        map=types.SimpleNamespace(mp_pos=torch.as_tensor(s["mp_pos"]),
                                  mp_valid=torch.as_tensor(s["mp_valid"]),
                                  kf_pose=torch.as_tensor(s["kf_pose"])),
        last_mp_dev=torch.as_tensor(s["last_mp"]),
        last_frame=types.SimpleNamespace(xy=torch.as_tensor(s["xy"])),
        **common)
    return j, t


def test_detect_plane_bit_equal_to_jax():
    s = _scene()
    pose = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    for seed in (0, 3):
        a = jar.detect_plane(s["mp_pos"][:300], pose, seed=seed)
        b = tar.detect_plane(s["mp_pos"][:300], pose, seed=seed)
        for f in ("normal", "origin", "R_pw", "inlier_idx"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert tar.detect_plane(np.zeros((10, 3)), pose) is None


def test_ar_overlay_render_bit_equal_to_jax():
    s = _scene(1)
    jt, tt = _trackers(s)
    ja, ta = jar.ArOverlay(jt, min_obs=2), tar.ArOverlay(tt, min_obs=2)
    assert ja.insert_cube(size=0.3) and ta.insert_cube(size=0.3)
    img = np.random.default_rng(2).integers(0, 256, (240, 320)).astype(
        np.uint8)
    a, b = ja.render(img), ta.render(img)
    assert b.shape == (240, 320, 3) and b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    # the cube drew: JAX's own gate (`tests/test_ar_live.py`)
    red = (b[..., 0].astype(int) - b[..., 2].astype(int)) > 100
    assert red.sum() > 50


def test_map_primitives_equal_jax_formulas(tmp_path):
    s = _scene()
    _, tt = _trackers(s)
    gt = np.stack(s["traj"])[::-1].copy()
    prim = map_primitives(tt, gt=gt)
    alive = s["mp_valid"]
    np.testing.assert_array_equal(prim["landmarks"],
                                  s["mp_pos"][alive][:, [0, 2]])
    centres = np.asarray(jse3.inverse(jnp.asarray(np.stack(s["traj"]))))
    np.testing.assert_allclose(prim["trajectory"], centres[:, [4, 6]],
                               atol=1e-6)
    centres_gt = np.asarray(jse3.inverse(jnp.asarray(gt)))
    np.testing.assert_allclose(prim["ground_truth"], centres_gt[:, [4, 6]],
                               atol=1e-6)
    kfs = s["graph"].alive_kfs()
    kc = np.asarray(jse3.inverse(jnp.asarray(s["kf_pose"][kfs])))[:, 4:7]
    np.testing.assert_allclose(prim["keyframes"], kc[:, [0, 2]], atol=1e-6)
    edges = [(kc[list(kfs).index(a)], kc[list(kfs).index(b)])
             for a in kfs for b in s["graph"].covis_neighbors(
                 int(a), min_weight=15) if b > a]
    assert len(edges) == 2  # 0-1 (30) and 1-2 (15); 0-2 is 10, 3 dead
    np.testing.assert_allclose(
        prim["edges"], [[p[[0, 2]], q[[0, 2]]] for p, q in edges], atol=1e-6)
    img = render_map(prim, size=200)
    assert img.shape == (200, 200, 3) and (img != 255).any()
    frame = types.SimpleNamespace(xy=torch.as_tensor(s["xy"]),
                                  valid=torch.ones(60, dtype=torch.bool))
    path = plot_frame(np.zeros((240, 320), np.uint8), frame,
                      feat_mp=s["last_mp"], out_path=str(tmp_path / "f.png"))
    out = read_png(path)
    tracked = out[..., 1] == 160
    assert out.shape == (240, 320, 3) and tracked.any()


class StubSystem:
    def __init__(self, tracker):
        self.tracker = tracker
        self.commands = []

    def request_command(self, cmd, arg=""):
        self.commands.append((cmd, arg))


def test_viewer_control_relay_and_status_match_jax(tmp_path):
    s = _scene()
    jt, tt = _trackers(s)
    out = {}
    for name, cls, t in (("jax", JViewer, jt), ("port", LiveViewer, tt)):
        d = tmp_path / name
        os.makedirs(d)
        system = StubSystem(t)
        v = cls(t, out_dir=str(d), system=system)
        with open(d / "control", "w") as f:
            f.write("localization_mode on\n# a comment\n\nreset\n"
                    "save_map /tmp/m.npz\n")
        v._poll_control()
        assert not os.path.exists(d / "control")
        v._write_status()
        out[name] = (system.commands, v.commands_relayed,
                     json.load(open(d / "status.json")))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [("localization_mode", "on"), ("reset", ""),
                              ("save_map", "/tmp/m.npz")]


def test_viewer_renders_follows_a_reset_and_reports_failures(tmp_path,
                                                             capsys):
    s = _scene()
    _, tt = _trackers(s)
    system = StubSystem(tt)
    v = LiveViewer(None, out_dir=str(tmp_path), system=system,
                   keep_history=2)
    os.makedirs(tmp_path, exist_ok=True)
    v._render_once()  # starts the map read
    assert v.frames_rendered == 0
    v._render_once()  # renders it (on the CPU a read lands at once)
    v._render_once()
    v._render_once()
    assert v.frames_rendered == 3
    img = read_png(str(tmp_path / "map_latest.png"))
    assert img.shape == (800, 800, 3) and (img != 255).any()
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.startswith("map_0")) == ["map_00001.png",
                                                "map_00002.png"]
    # a reset swaps the system's tracker: the viewer reads the new one
    _, t2 = _trackers(_scene(5))
    t2.frame_id = 99
    system.tracker = t2
    assert v.tracker is t2
    v._write_status()
    assert json.load(open(tmp_path / "status.json"))["frame_id"] == 99
    # a persistent failure is reported, and the thread keeps running
    t2.graph = None
    v.period = 0.01
    v.start()
    time.sleep(0.3)
    assert v.running and v.failures >= 2
    v.stop(final_render=False)
    assert not v.running
    assert "render failed" in capsys.readouterr().err


SETTINGS = """%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.width: 320
Camera.height: 240
Camera.fps: 5.0
Camera.bf: 20.8
ThDepth: 35.0
DepthMapFactor: 1.0
ORBextractor.nFeatures: 500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_system_starts_and_stops_the_viewer(tmp_path):
    path = tmp_path / "cam.yaml"
    path.write_text(SETTINGS)
    system = SlamSystem.create(str(path), RGBD, device="cpu",
                               use_viewer=True,
                               viewer_dir=str(tmp_path / "viz"))
    viewer = system.viewer
    assert viewer.running and viewer.tracker is system.tracker
    system.reset()
    assert viewer.tracker is system.tracker  # follows the new tracker
    system.shutdown()
    assert system.viewer is None and not viewer.running
    assert os.path.isdir(tmp_path / "viz")
