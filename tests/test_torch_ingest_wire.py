"""The port's ingest on the CPU, beyond the RGB-D transfers of
`tests/test_torch_ingest.py` (its scene and configuration: 320x240, 400
features, 4 levels, log8 depth at subsample 2, pipelined at depth 4):

- the DCT image codec against the raw image, under JAX's gates
  (`tests/test_codec.py:99-100`: ATE < 3 cm and < raw + 1.2 cm);
- the slice as a whole against JAX: the port's log8 run against the same
  port tracker fed the arrays of JAX's `_unpack_impl` on the same packed
  bytes (ATE within 0.5 mm, the same keyframes);
- stereo: `prefetch_stereo` + `track_stereo_uploaded` is `track_stereo`
  bit for bit, and the stereo pair a stereo 2-chain;
- mono: `prefetch_mono` + `track_mono_uploaded` is `track_mono` bit for bit
  through the bootstrap, and under `image_encoding="dct"` the mono path
  sends `pack_mono`'s raw bytes, as JAX's does.
JAX's unpack is called through a stub holding its `TrackerConfig`.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    TrackState, Tracker, TrackerConfig, pack_mono)

torch.set_num_threads(1)
N = 36
CAM = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
RGBD = dict(bf=0.08 * 260.0, n_features=400, n_levels=4, pipelined=True,
            pipeline_depth=4, enable_loop_closing=False,
            map_capacity=MapCapacity(max_keyframes=32, max_points=8192,
                                     max_features=400),
            depth_subsample=2, depth_encoding="log8")


@pytest.fixture(scope="module")
def scene():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    return SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                          planes=planes, baseline=0.08)


@pytest.fixture(scope="module")
def frames_gt(scene):
    """`tests/test_batch_ingest.py:22-35`'s frames."""
    gt = orbit_trajectory(N, radius=0.3, yaw_amp=0.2)
    rng = np.random.default_rng(5)
    out = []
    for i in range(N):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
        out.append((np.clip(img, 0, 255).astype(np.uint8),
                    depth.astype(np.float16)))
    return out, gt


def _run(frames, unpack=None, **kw):
    t = Tracker(TrackerConfig(**CAM, **{**RGBD, **kw}), device="cpu")
    if unpack is not None:
        t._unpack = types.MethodType(unpack, t)
    for i, (img, d) in enumerate(frames):
        t.track_rgbd(img, d, timestamp=i / 30.0)
    t.flush()
    return t


def _ate(t, gt):
    return ate_rmse(np.stack(t.trajectory), gt, align="se3")[0]


@pytest.fixture(scope="module")
def raw_run(frames_gt):
    return _run(frames_gt[0])


def test_dct_tracks_like_raw(frames_gt, raw_run):
    frames, gt = frames_gt
    t_dct = _run(frames, image_encoding="dct")
    r_raw, r_dct = _ate(raw_run, gt), _ate(t_dct, gt)
    print(f"ATE raw {r_raw:.5f} m, dct {r_dct:.5f} m")
    assert t_dct.state == TrackState.OK and raw_run.state == TrackState.OK
    assert r_dct < 0.03
    assert r_dct < r_raw + 0.012


def test_log8_run_against_jax_unpack(frames_gt, raw_run):
    """The port tracker fed JAX's `_unpack_impl` arrays (log8 decoded by
    XLA's `exp`) against its own decode: the same keyframes, ATE within
    0.5 mm."""
    frames, gt = frames_gt
    stub = types.SimpleNamespace(cfg=JConfig(**CAM, **RGBD))
    for name in ("_packed_depth_hw", "_packed_img_nbytes"):
        setattr(stub, name, types.MethodType(getattr(JTracker, name), stub))

    def jax_unpack(self, buf):
        img, dep = JTracker._unpack_impl(stub, jnp.asarray(buf.numpy()))
        return (torch.from_numpy(np.array(img)),
                torch.from_numpy(np.array(dep)))

    t = _run(frames, unpack=jax_unpack)
    assert len(t.graph.alive_kfs()) == len(raw_run.graph.alive_kfs())
    assert [e.get("kf") for e in t.track_info] == \
        [e.get("kf") for e in raw_run.track_info]
    assert abs(_ate(t, gt) - _ate(raw_run, gt)) < 5e-4


STEREO = dict(bf=0.08 * 260.0, n_features=400, n_levels=4,
              enable_local_ba=True, map_capacity=MapCapacity(16, 4096, 400))


@pytest.fixture(scope="module")
def pairs(scene):
    gt = orbit_trajectory(6, radius=0.3, yaw_amp=0.2)
    out = []
    for g in gt:
        left, right, _ = scene.render_stereo(g)
        out.append((left, right))
    return out


def test_prefetch_stereo_is_track_stereo_bit_for_bit(pairs):
    runs = []
    for uploaded in (False, True):
        t = Tracker(TrackerConfig(**CAM, **STEREO), device="cpu")
        if uploaded:
            futs = t.prefetch_stereo([p[0] for p in pairs[:6]],
                                     [p[1] for p in pairs[:6]])
            for i, f in enumerate(futs):
                t.track_stereo_uploaded(f.result(), timestamp=i / 30.0)
        else:
            for i, (left, right) in enumerate(pairs[:6]):
                t.track_stereo(left, right, timestamp=i / 30.0)
        t.flush()
        runs.append(t)
    np.testing.assert_array_equal(np.stack(runs[0].trajectory),
                                  np.stack(runs[1].trajectory))
    assert list(runs[0].graph.alive_kfs()) == list(runs[1].graph.alive_kfs())


def test_stereo_pair_is_a_two_chain_bit_for_bit(pairs):
    runs = []
    for fused in ("pair", "chain"):
        t = Tracker(TrackerConfig(**CAM, **STEREO, pipelined=True,
                                  pipeline_depth=3), device="cpu")
        bufs = [f.result() for f in t.prefetch_stereo(
            [p[0] for p in pairs], [p[1] for p in pairs])]
        t.track_stereo_uploaded(bufs[0])
        for i in range(1, 5, 2):
            assert t.state == TrackState.OK
            if fused == "pair":
                t.track_stereo_pair_uploaded(bufs[i], bufs[i + 1])
            else:
                t.track_stereo_chain_uploaded(bufs[i:i + 2])
        t.flush()
        assert len(t.trajectory) == 5
        runs.append(t)
    np.testing.assert_array_equal(np.stack(runs[0].trajectory),
                                  np.stack(runs[1].trajectory))
    assert not any(e.get("lost") for e in runs[0].track_info)


MONO = dict(n_features=600, n_levels=4, enable_local_ba=True,
            kf_ref_ratio=0.9, map_capacity=MapCapacity(64, 8192, 600),
            pipelined=True, pipeline_depth=3)


def test_prefetch_mono_is_track_mono_bit_for_bit(scene):
    """Through the bootstrap and the first tracked frames; under "dct" the
    mono buffers are `pack_mono`'s raw bytes and track as raw does."""
    gt = orbit_trajectory(14, radius=0.35, yaw_amp=0.3)
    imgs = [scene.render(g)[0] for g in gt[:8]]
    runs = []
    for mode, enc in (("per_frame", "raw"), ("prefetch", "raw"),
                      ("prefetch", "dct")):
        t = Tracker(TrackerConfig(**CAM, **MONO, image_encoding=enc),
                    device="cpu")
        if mode == "prefetch":
            bufs = [f.result() for f in t.prefetch_mono(imgs)]
            for img, b in zip(imgs, bufs):
                assert b.dtype == torch.uint8 and tuple(b.shape) == (240, 320)
                np.testing.assert_array_equal(b.numpy(), pack_mono(img))
            for i, b in enumerate(bufs):
                t.track_mono_uploaded(b, timestamp=i / 30.0)
        else:
            for i, img in enumerate(imgs):
                t.track_mono(img, timestamp=i / 30.0)
        t.flush()
        runs.append(t)
    assert runs[0].state == TrackState.OK
    assert any(e.get("inliers") for e in runs[0].track_info)
    for t in runs[1:]:
        np.testing.assert_array_equal(np.stack(t.trajectory),
                                      np.stack(runs[0].trajectory))
