"""The port's pipelined mode (`pipelined=True`) on its own, on the CPU: the
in-flight frame queue, the staged mapping pump and the asynchronous reads
(`utils/readback.py`). Its parity with the JAX package's pipelined mode is
`tests/test_torch_tracking_lba.py::test_pipelined_on_jax_pyramid_within_5mm`.

- A read of a CPU tensor is resolved at once, and is a copy.
- A loss inside the queue discards every frame still in flight: each keeps
  one trajectory slot and one `discarded` entry.
- A pump that meets a read not yet landed leaves the job where it is;
  a forced pump completes it.
- Mono: the bootstrap runs outside the queue, tracking inside it.
- Synchronous mode: the staged pump, forced in the keyframe's frame, gives
  the map and trajectory of the whole job run in one call, stage after
  stage.
"""

import hashlib

import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam import local_mapping, tracking
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    TrackState, Tracker, TrackerConfig)
from orb_slam2_refactored_tpu_torch.utils.readback import Readback

torch.set_num_threads(1)
N_FRAMES = 16
KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
          n_features=500, n_levels=4, enable_local_ba=True, kf_max_interval=4,
          map_capacity=MapCapacity(16, 4096, 500))


@pytest.fixture(scope="module")
def scene():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    return SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                          planes=planes)


@pytest.fixture(scope="module")
def clip(scene):
    gt = orbit_trajectory(N_FRAMES, radius=0.35, yaw_amp=0.25)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(N_FRAMES):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       depth.astype(np.float16).astype(np.float32)))
    return frames


def _tracker(**kw):
    return Tracker(TrackerConfig(bf=0.08 * 260.0, **{**KW, **kw}),
                   device="cpu")


def test_readback_of_a_cpu_tensor_is_resolved_at_once():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    r = Readback(t)
    assert r.done()
    t += 1  # the read is a copy taken when it was made
    np.testing.assert_array_equal(r.result(),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    assert Readback(torch.ones(3, dtype=torch.bool)).result().dtype == bool


def test_loss_in_the_queue_discards_the_frames_in_flight(clip):
    depth_q = 3
    tr = _tracker(pipelined=True, pipeline_depth=depth_q)
    for img, depth in clip[:8]:
        tr.track_rgbd(img, depth)
    assert tr.state == TrackState.OK and len(tr._pending_q) == depth_q
    blank = (np.zeros_like(clip[0][0]), np.zeros_like(clip[0][1]))
    n_blank = depth_q + 2
    for _ in range(n_blank):
        tr.track_rgbd(*blank)
    tr.flush()
    assert len(tr.trajectory) == len(tr.traj_entries) == 8 + n_blank
    discarded = [t for t in tr.track_info if t.get("discarded")]
    assert len(discarded) == depth_q
    assert all(t["lost"] and t["inliers"] == 0 for t in discarded)
    assert tr.state != TrackState.OK and not tr._pending_q
    # the first blank frame is the one found lost; the frames queued behind
    # it are the discarded ones
    first = next(i for i, t in enumerate(tr.track_info) if t.get("lost"))
    assert not tr.track_info[first].get("discarded")
    assert all(t.get("discarded")
               for t in tr.track_info[first + 1:first + 1 + depth_q])


class _NotLanded:
    """A read whose copy never lands: `done()` is false, `result()` the
    value."""

    def __init__(self, t):
        self._r = Readback(t)

    def done(self):
        return False

    def result(self):
        return self._r.result()


def test_pump_waits_for_reads_and_force_completes(clip, monkeypatch):
    monkeypatch.setattr(tracking, "Readback", _NotLanded)
    monkeypatch.setattr(local_mapping, "Readback", _NotLanded)
    tr = _tracker(pipelined=True, pipeline_depth=2)
    jobs = []
    for img, depth in clip:
        tr.track_rgbd(img, depth)
        jobs.append(tr._map_job)
    created = [j for j in jobs if j is not None]
    assert created and tr.pumps_not_ready >= len(created)
    # unforced pumps never passed the insert drain
    assert all(stage == -1 for _, stage in created)
    slot = tr._map_job[0]
    n = tr.pumps_not_ready
    h = _map_hash(tr)
    tr._pump_mapping()
    assert tr._map_job == (slot, -1) and tr.pumps_not_ready == n + 1
    assert _map_hash(tr) == h
    tr._pump_mapping(force=True)
    assert tr._map_job == (slot, 1)  # two stages: the insert drain, stage 0
    tr._pump_mapping()
    assert tr._map_job == (slot, 1)  # the fusion read has not landed
    tr.flush()
    assert tr._map_job is None and not tr._pending_q
    assert len(tr.trajectory) == N_FRAMES
    assert tr.local_mapper.n_ba >= 1


def test_mono_initializes_outside_the_queue(scene):
    gt = orbit_trajectory(14, radius=0.35, yaw_amp=0.3)
    tr = Tracker(TrackerConfig(
        width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
        n_features=600, n_levels=4, enable_local_ba=True, kf_ref_ratio=0.9,
        map_capacity=MapCapacity(64, 8192, 600), pipelined=True,
        pipeline_depth=3), device="cpu")
    queued = []
    for i in range(len(gt)):
        was_ok = tr.state == TrackState.OK
        tr.track_mono(scene.render(gt[i])[0])
        queued.append((was_ok, len(tr._pending_q)))
    # no frame before the map exists went through the queue; every tracked
    # frame after it did
    init = next(i for i, (ok, _) in enumerate(queued) if ok)
    assert init >= 2 and all(n == 0 for _, n in queued[:init])
    assert [n for _, n in queued[init:init + 4]] == [1, 2, 3, 3]
    tr.flush()
    assert tr.state == TrackState.OK and len(tr.trajectory) == len(gt)
    assert not any(t.get("lost") for t in tr.track_info)


def _map_hash(tr):
    h = hashlib.sha256()
    for k, v in sorted(convert.map_to_numpy(tr.map).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _job_in_one_call(tr):
    """The keyframe's mapping job as one call, every stage in order: the
    insert drain, triangulation and fusion drains, the point refresh and
    culls, the window BA, the keyframe cull, the pose adoption."""
    lm = tr.local_mapper
    if tr._map_job is not None and tr._map_job[1] == -1:
        tr._drain_insert()
    if tr._map_job is None:
        return
    slot = tr._map_job[0]
    tr.map = lm._drain_tri(tr.map, tr.graph)
    tr.map, _ = lm.fuse_neighbors(tr.map, tr.graph, slot)
    tr.map = lm._drain_fuse(tr.map, tr.graph)
    tr.map = lm.refresh_points(tr.map, tr.graph, slot)
    tr.map, _ = lm.cull_points(tr.map, tr.graph, slot)
    tr.map = lm._drain_ratio_cull(tr.map, tr.graph)
    tr.last_ba_info = None
    if tr._gba_pending is None:
        tr.map, tr.last_ba_info = lm.local_ba(tr.map, tr.graph, slot)
    tr.map, killed = lm.cull_keyframes(tr.map, tr.graph, slot)
    if killed and tr.loop_closer is not None:
        for k in killed:
            tr.loop_closer.db.erase(k)
    tr._map_job = None
    if tr.last_ba_info is not None:
        tr.pose_dev = tr.map.kf_pose[slot].clone()
        tr.pose = tr.pose_dev.numpy()


def test_synchronous_mode_keeps_the_job_order(clip, monkeypatch):
    staged = _tracker()
    for img, depth in clip:
        staged.track_rgbd(img, depth)
    one_call = _tracker()
    monkeypatch.setattr(one_call, "_complete_mapping",
                        lambda: _job_in_one_call(one_call))
    for img, depth in clip:
        one_call.track_rgbd(img, depth)
    n_kf = 1 + sum(1 for t in staged.track_info if t.get("kf"))
    assert n_kf >= 3 and staged.local_mapper.n_ba == n_kf - 1
    np.testing.assert_array_equal(np.stack(staged.trajectory),
                                  np.stack(one_call.trajectory))
    assert _map_hash(staged) == _map_hash(one_call)
    assert staged.track_info == one_call.track_info
