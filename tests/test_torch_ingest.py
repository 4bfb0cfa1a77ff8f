"""The port's ingest entries on the CPU, RGB-D: the JAX package's
`tests/test_batch_ingest.py` scene and configuration (320x240, 400
features, 4 levels, log8 depth at subsample 2, pipelined at depth 4).

- Same steps, other transfers: `prefetch_rgbd` + `track_rgbd_uploaded`,
  `track_rgbd_batch` in mode 1, and `prefetch_rgbd_batches` with
  `TPU_SLAM_DEFER_PACKS=1` give the per-frame run's trajectory and
  keyframes bit for bit (on the CPU every read is resolved at once, so
  the schedule is the per-frame run's).
- Fused steps: a pair is a 2-chain bit for bit; the 4-chain and batch
  mode 4 hold JAX's own gates against the per-frame run
  (`_check(..., tol=0.025, rel_tol=0.012)`, keyframes +-2): the map they
  see is up to 3 finalizes staler.
- `warm_stage_programs` leaves the map, the counters and the trajectory
  as they were.
"""

import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    TrackState, Tracker, TrackerConfig)

torch.set_num_threads(1)
N = 36
N_BITS = 12  # frames of the bit-for-bit comparisons


@pytest.fixture(scope="module")
def frames_gt():
    """`tests/test_batch_ingest.py:22-35`'s frames."""
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(N, radius=0.3, yaw_amp=0.2)
    rng = np.random.default_rng(5)
    out = []
    for i in range(N):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
        out.append((np.clip(img, 0, 255).astype(np.uint8),
                    depth.astype(np.float16)))
    return out, gt


def _tracker():
    """`tests/test_batch_ingest.py:38-47`'s configuration."""
    return Tracker(TrackerConfig(
        width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
        bf=0.08 * 260.0, n_features=400, n_levels=4, pipelined=True,
        pipeline_depth=4, enable_loop_closing=False,
        map_capacity=MapCapacity(max_keyframes=32, max_points=8192,
                                 max_features=400),
        depth_subsample=2, depth_encoding="log8"), device="cpu")


def _per_frame(frames):
    t = _tracker()
    for i, (img, d) in enumerate(frames):
        t.track_rgbd(img, d, timestamp=i / 30.0)
    t.flush()
    return t


@pytest.fixture(scope="module")
def ref_bits(frames_gt):
    return _per_frame(frames_gt[0][:N_BITS])


@pytest.fixture(scope="module")
def ref_all(frames_gt):
    return _per_frame(frames_gt[0])


def _same_run(t, ref):
    """Trajectory, per-frame records and keyframes equal bit for bit."""
    assert len(t.trajectory) == len(ref.trajectory)
    np.testing.assert_array_equal(np.stack(t.trajectory),
                                  np.stack(ref.trajectory))
    assert [e.get("kf") for e in t.track_info] == \
        [e.get("kf") for e in ref.track_info]
    assert list(t.graph.alive_kfs()) == list(ref.graph.alive_kfs())
    np.testing.assert_array_equal(t.map.kf_pose.numpy(),
                                  ref.map.kf_pose.numpy())


def _check(t, gt, ref, tol=0.025, rel_tol=0.012):
    """`tests/test_batch_ingest.py::_check` with the fused steps' gates."""
    est = np.stack(t.trajectory)
    assert est.shape == (N, 7)
    rmse, _ = ate_rmse(est, gt, align="se3")
    ref_rmse, _ = ate_rmse(np.stack(ref.trajectory), gt, align="se3")
    assert rmse < tol, f"ATE {rmse:.4f} m"
    assert abs(rmse - ref_rmse) < rel_tol, (rmse, ref_rmse)
    assert abs(len(t.graph.alive_kfs()) - len(ref.graph.alive_kfs())) <= 2


def test_prefetch_is_per_frame_bit_for_bit(frames_gt, ref_bits):
    frames = frames_gt[0][:N_BITS]
    t = _tracker()
    futs = t.prefetch_rgbd([f[0] for f in frames], [f[1] for f in frames])
    bufs = [f.result() for f in futs]
    assert all(b.device.type == "cpu" and b.dtype == torch.uint8
               and tuple(b.shape) == (320 * 240 + 160 * 120,) for b in bufs)
    for i, b in enumerate(bufs):
        t.track_rgbd_uploaded(b, timestamp=i / 30.0)
    t.flush()
    _same_run(t, ref_bits)


def test_batch_mode1_is_per_frame_bit_for_bit(frames_gt, ref_bits):
    frames = frames_gt[0][:N_BITS]
    t = _tracker()
    for i in range(0, N_BITS, 4):
        poses = t.track_rgbd_batch([f[0] for f in frames[i:i + 4]],
                                   [f[1] for f in frames[i:i + 4]],
                                   [(i + j) / 30.0 for j in range(4)])
        assert len(poses) == 4
    t.flush()
    _same_run(t, ref_bits)


def test_deferred_packs_are_per_frame_bit_for_bit(frames_gt, ref_bits,
                                                  monkeypatch):
    """Prefetched [4, B] batches with one stacked pack read a batch."""
    monkeypatch.setenv("TPU_SLAM_DEFER_PACKS", "1")
    frames = frames_gt[0][:N_BITS]
    t = _tracker()
    futs = t.prefetch_rgbd_batches([f[0] for f in frames],
                                   [f[1] for f in frames], 4)
    assert len(futs) == N_BITS // 4
    stacked = []
    for i, f in enumerate(futs):
        b = f.result()
        assert tuple(b.shape) == (4, 320 * 240 + 160 * 120)
        t.track_rgbd_batch(None, None, [(4 * i + j) / 30.0 for j in range(4)],
                           uploaded=b)
        q = t._pending_q
        # every entry of the queue reads a row of a stacked read
        stacked.append(all(type(e[2]).__name__ == "_RowRead" for e in q))
    assert stacked[-1]
    t.flush()
    _same_run(t, ref_bits)


def test_pair_is_a_two_chain_bit_for_bit(frames_gt):
    frames = frames_gt[0][:N_BITS]
    runs = []
    for fused in ("pair", "chain"):
        t = _tracker()
        bufs = [f.result() for f in t.prefetch_rgbd(
            [f[0] for f in frames], [f[1] for f in frames])]
        for i in range(0, N_BITS, 2):
            if fused == "pair":
                t.track_rgbd_pair_uploaded(bufs[i], bufs[i + 1], i / 30.0,
                                           (i + 1) / 30.0)
            else:
                t.track_rgbd_chain_uploaded(bufs[i:i + 2],
                                            [i / 30.0, (i + 1) / 30.0])
        t.flush()
        assert t.state == TrackState.OK
        runs.append(t)
    _same_run(*runs)


def test_chain4_within_jax_gates(frames_gt, ref_all):
    frames, gt = frames_gt
    t = _tracker()
    bufs = [f.result() for f in t.prefetch_rgbd([f[0] for f in frames],
                                                [f[1] for f in frames])]
    n_fused = 0
    for i in range(0, N, 4):
        ok = t.state == TrackState.OK
        before = len(t.use_ref_waits)
        t.track_rgbd_chain_uploaded(bufs[i:i + 4],
                                    [(i + j) / 30.0 for j in range(4)])
        # a fused chain keeps each step's one host wait
        assert len(t.use_ref_waits) - before == (4 if ok else 3)
        n_fused += ok
    t.flush()
    assert n_fused >= 8 and len(t.trajectory) == N
    _check(t, gt, ref_all)


def test_quad_batch_within_jax_gates(frames_gt, ref_all):
    frames, gt = frames_gt
    t = _tracker()
    for i in range(0, N, 4):
        poses = t.track_rgbd_batch([f[0] for f in frames[i:i + 4]],
                                   [f[1] for f in frames[i:i + 4]],
                                   [(i + j) / 30.0 for j in range(4)],
                                   mode=4)
        assert len(poses) == 4
    t.flush()
    assert len(t.trajectory) == N
    _check(t, gt, ref_all)


def test_warm_stage_programs_leaves_the_tracker_as_it_was(ref_bits):
    t = ref_bits
    before = (convert.map_to_numpy(t.map), t.mp_vis_dev.clone(),
              t.mp_found_dev.clone(), t.mp_seen_dev.clone(),
              np.stack(t.trajectory), t.frame_id, t.state)
    t.warm_stage_programs()
    t.sync_device()
    after = convert.map_to_numpy(t.map)
    for k, v in before[0].items():
        np.testing.assert_array_equal(after[k], v)
    for a, b in zip(before[1:4], (t.mp_vis_dev, t.mp_found_dev,
                                  t.mp_seen_dev)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.stack(t.trajectory), before[4])
    assert (t.frame_id, t.state) == before[5:]
