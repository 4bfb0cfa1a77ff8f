"""Port parity: the learned BRIEF pattern and kernel K7's plain version.

The learned table (OpenCV's `bit_pattern_31_`) reaches 18 px once rotated,
so both packages take the full-image path for it: the level blurred whole
with reflected borders, the IC angle of the raw level, the tests rotated by
the exact angle. Tolerances (stated, measured on these inputs with the CPU
builds; JAX runs op by op, as its own tests run it):
- the blurred levels within 1e-4 gray of JAX's (XLA's dot sums the 7 taps
  in its own order);
- the angles: on level 0 within 5e-7 rad (integer moments are exact; the
  two atan2s differ by an ulp), on the upper levels within 3e-5 rad
  (bilinear resizes: their moments are not exact in f32, and XLA and torch
  sum them in other orders; measured 1.5e-5, and JAX compiled against JAX
  op by op 2e-6);
- descriptor bits equal except at gated tests: a rotated coordinate within
  1e-4 of a half-integer (widened by 18 px times the angle difference
  where each package steers by its own angle), or the two blurred samples
  within 1e-3 gray; the count of tests that pass the gate is asserted to
  be large, as tests/test_orb_parity.py:251-275 does;
- the extractor (JAX compiled): level 0 exact in its keypoints, angles
  within 5e-7 rad and >= 99.9 % of descriptor bits; upper levels as
  keypoint sets (>= 70 % shared, hazard C2, tests/test_torch_orb.py);
- one tracked step on a JAX tracker's state (4 QVGA frames, learned
  pattern), as tests/test_torch_tracking.py holds the fresh pattern's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.ops import image as jimage
from orb_slam2_refactored_tpu.ops import orb as jorb
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.ops import image as timage
from orb_slam2_refactored_tpu_torch.ops import orb as torb
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.tracking import Tracker, TrackerConfig
from test_orb_parity import unpack_desc

torch.set_num_threads(1)
H, W, NF, NL = 240, 320, 500, 4
KW = dict(width=W, height=H, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
          bf=0.08 * 260.0, n_features=NF, n_levels=NL, enable_local_ba=False,
          descriptor_pattern="learned")


@pytest.fixture(scope="module")
def clip():
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=W, height=H, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(20, radius=0.35, yaw_amp=0.25)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(5):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       depth.astype(np.float16).astype(np.float32)))
    return frames


@pytest.fixture(scope="module")
def jax_frame(clip):
    """JAX's learned-pattern extraction of one frame: its features, its
    pyramid levels and each level's integer keypoints."""
    img = clip[2][0]
    feats, levels = jax.jit(jorb.OrbExtractor(
        H, W, NF, 1.2, NL, pattern="learned")._extract_impl_pyr)(
        jnp.asarray(img))
    f = {k: np.asarray(v) for k, v in feats._asdict().items()}
    levels = [np.array(l) for l in levels]
    counts = [int((f["level"] == l).sum()) for l in range(NL)]
    scale = np.asarray([1.2 ** l for l in range(NL)], np.float32)[f["level"]]
    xs = np.rint(f["xy"][:, 0] / scale).astype(np.int32)
    ys = np.rint(f["xy"][:, 1] / scale).astype(np.int32)
    return img, f, levels, ys, xs, counts


def test_table_and_window_fit_match_jax():
    np.testing.assert_array_equal(torb.learned_pattern(),
                                  jorb.learned_pattern())
    for name in ("fresh", "learned"):
        np.testing.assert_array_equal(torb.get_pattern(name),
                                      jorb.get_pattern(name))
        assert torb.pattern_fits_window(name) == jorb.pattern_fits_window(name)
    assert not torb.pattern_fits_window("learned")
    with pytest.raises(ValueError):
        torb.get_pattern("orbvoc")
    # every rotated and rounded point of the table stays within the
    # kernel's 18-px window (checked on 20,001 angles)
    pat = torb.learned_pattern().reshape(-1, 2).astype(np.float64)
    th = np.linspace(-np.pi, np.pi, 20001)[:, None]
    rx = np.rint(pat[:, 0] * np.cos(th) - pat[:, 1] * np.sin(th))
    ry = np.rint(pat[:, 0] * np.sin(th) + pat[:, 1] * np.cos(th))
    assert max(np.abs(rx).max(), np.abs(ry).max()) == torb.LEARNED_REACH


def test_gaussian_blur_matches_jax(jax_frame):
    _, _, levels, _, _, _ = jax_frame
    for lvl in levels:
        bj = np.asarray(jimage.gaussian_blur(jnp.asarray(lvl), 7, 2.0))
        bt = timage.gaussian_blur(torch.tensor(lvl), 7, 2.0).numpy()
        assert bt.shape == bj.shape
        assert np.abs(bt - bj).max() < 1e-4


def _gate(levels, ys, xs, counts, angles, slack=0.0):
    """The tests outside which the bits must agree: a rotated coordinate
    within 1e-4 (+ `slack`, a keypoint) of a half-integer, or the blurred
    samples within 1e-3 gray (`ops/orb.py::learned_tie_gate`)."""
    return torb.learned_tie_gate(
        [torch.from_numpy(l) for l in levels], torch.from_numpy(ys),
        torch.from_numpy(xs), counts, torch.from_numpy(angles),
        half_tol=1e-4 + torch.as_tensor(slack)).numpy()


def test_learned_plain_matches_jax(jax_frame):
    """`angles_and_descriptors_learned_plain` on JAX's levels and keypoints
    against JAX's `ic_angles` and `brief_descriptors(gaussian_blur(lvl))`,
    op by op; then the same with the angles given (K7's angle entry)."""
    _, _, levels, ys, xs, counts = jax_frame
    aj, dj, start = [], [], 0
    for lvl, k in zip(levels, counts):
        y, x = jnp.asarray(ys[start:start + k]), jnp.asarray(xs[start:start + k])
        start += k
        a = jorb.ic_angles(jnp.asarray(lvl), y, x)
        dj.append(np.asarray(jorb.brief_descriptors(
            jimage.gaussian_blur(jnp.asarray(lvl), 7, 2.0), y, x, a,
            "learned")))
        aj.append(np.asarray(a))
    aj, dj = np.concatenate(aj), np.concatenate(dj)
    lt = [torch.from_numpy(l) for l in levels]
    at, dt = torb.angles_and_descriptors_learned_plain(
        lt, torch.from_numpy(ys), torch.from_numpy(xs), counts)
    dang = np.abs(np.angle(np.exp(1j * (at.numpy().astype(np.float64)
                                        - aj))))
    lvl0 = np.arange(len(aj)) < counts[0]
    assert dang[lvl0].max() < 5e-7 and dang.max() < 3e-5
    # steered by JAX's angles (K7's angle entry), the bits are JAX's except
    # at gated tests
    ag, dg = torb.angles_and_descriptors_learned_levels(
        lt, torch.from_numpy(ys), torch.from_numpy(xs), counts,
        angles=torch.from_numpy(aj))
    np.testing.assert_array_equal(ag.numpy(), aj)
    gated = _gate(levels, ys, xs, counts, aj)
    # not vacuous: the gate spares >= 75 % of the tests (measured 87.8 %;
    # the flat blocks of the rendered texture make equal samples)
    assert (~gated).sum() > 0.75 * gated.size
    diff = unpack_desc(dj) != unpack_desc(dg.numpy().view(np.uint32))
    assert not (diff & ~gated).any(), int((diff & ~gated).sum())
    # steered by its own angles, the gate widens by the angle difference
    gated = _gate(levels, ys, xs, counts, aj, slack=18 * dang)
    assert (~gated).sum() > 0.75 * gated.size
    diff = unpack_desc(dj) != unpack_desc(dt.numpy().view(np.uint32))
    assert not (diff & ~gated).any(), int((diff & ~gated).sum())


def test_swapped_pair_is_told(jax_frame):
    """The control the card's check relies on: the table with one pair
    swapped flips that test's bit wherever its samples differ."""
    _, _, levels, ys, xs, counts = jax_frame
    lt = [torch.from_numpy(l) for l in levels]
    pat = torb.learned_pattern().copy()
    pat[5] = pat[5, ::-1]
    args = (lt, torch.from_numpy(ys), torch.from_numpy(xs), counts)
    _, d0 = torb.angles_and_descriptors_learned_levels(*args)
    _, d1 = torb.angles_and_descriptors_learned_levels(*args, pattern=pat)
    diff = unpack_desc(d0.numpy().view(np.uint32)) != unpack_desc(
        d1.numpy().view(np.uint32))
    assert diff[:, 5].mean() > 0.5
    assert not np.delete(diff, 5, axis=1).any()


def test_extractor_matches_jax(clip, jax_frame, monkeypatch):
    """The port's extractor with the learned pattern against JAX's
    compiled one, under C2's tolerance; it calls K7's wrapper once and
    K3's never."""
    img, j, _, _, _, _ = jax_frame
    calls = {"k3": 0, "k7": 0}
    k3, k7 = (torb.angles_and_descriptors_levels,
              torb.angles_and_descriptors_learned_levels)

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torb, "angles_and_descriptors_levels", spy("k3", k3))
    monkeypatch.setattr(torb, "angles_and_descriptors_learned_levels",
                        spy("k7", k7))
    ft = torb.OrbExtractor(H, W, NF, 1.2, NL, pattern="learned")(
        torch.from_numpy(img))
    assert calls == {"k3": 0, "k7": 1}
    t = {k: v.numpy() for k, v in ft._asdict().items()}
    m = j["level"] == 0
    for k in ("xy", "level", "response", "valid"):
        np.testing.assert_array_equal(t[k][m], j[k][m])
    assert np.abs(np.angle(np.exp(1j * (t["angle"][m] - j["angle"][m])))
                  ).max() < 5e-7
    bits = unpack_desc(j["desc"][m]) == unpack_desc(t["desc"][m].view(
        np.uint32))
    assert bits.mean() >= 0.999
    for l in range(1, NL):
        sj = {tuple(p) for p in j["xy"][(j["level"] == l) & j["valid"]]}
        st = {tuple(p) for p in t["xy"][(t["level"] == l) & t["valid"]]}
        assert len(sj) > 20
        assert len(sj & st) >= 0.70 * max(len(sj), len(st)), l


def test_tracker_step_on_jax_state(clip):
    """A JAX tracker with the learned pattern tracks 4 QVGA frames; its
    state goes through `convert.py` and the port tracks frame 5 (not a
    keyframe) from it, as the JAX tracker's own next frame does. On JAX's
    prepared frame the
    port's `_track_impl` gives the pose within 1e-4, the landmark
    assignments on >= 99 % of features and the inlier count within +-2.
    The port's whole `_step_impl` extracts its own features: level-0
    keypoints identical and >= 99.9 % of their descriptor bits; the upper
    levels differ by the pyramid's C2 rounding, so the position is held
    within 5 mm (the clip's bound with JAX's pyramid fed in,
    tests/test_torch_tracking.py; measured 2.4 mm) and the inlier count
    within 5 %."""
    jt = JTracker(JConfig(map_capacity=JCap(16, 4096, NF), **KW))
    for img, depth in clip[:4]:
        jt.track_rgbd(img, depth)
    snap = {
        "map": {k: np.asarray(v) for k, v in jt.map._asdict().items()},
        "last_frame": {k: np.asarray(v)
                       for k, v in jt.last_frame._asdict().items()},
        "last_mp": np.asarray(jt.last_mp_dev), "pose": np.asarray(jt.pose_dev),
        "velocity": np.asarray(jt.velocity_dev), "ref_kf": max(jt.ref_kf, 0),
        "mp_vis": np.asarray(jt.mp_vis_dev),
        "mp_found": np.asarray(jt.mp_found_dev),
        "mp_seen": np.asarray(jt.mp_seen_dev), "fidx": int(jt.fidx_dev),
        "local_mask": np.asarray(jt.local_mask_dev),
    }
    img, depth = clip[4]
    jt.track_rgbd(img, depth)
    jinfo = jt.track_info[-1]
    jframe = {k: np.asarray(v) for k, v in jt.last_frame._asdict().items()}
    st = convert.tracker_state_from_numpy(snap, "cpu")
    m = convert.map_from_numpy(snap["map"], "cpu")
    tt = Tracker(TrackerConfig(map_capacity=MapCapacity(16, 4096, NF), **KW),
                 device="cpu")
    tr = tt._track_impl(
        convert.frame_from_numpy(jframe, "cpu"), st["last_frame"],
        st["last_mp"], m, st["pose"], st["velocity"], st["ref_kf"],
        st["fidx"])
    np.testing.assert_allclose(tr[0].numpy(), jt.trajectory[-1], atol=1e-4)
    assert abs(int(tr[2]) - jinfo["inliers"]) <= 2
    if not jinfo["kf"]:
        assert (tr[1].numpy() == np.asarray(jt.last_mp_dev)).mean() >= 0.99
    out = tt._step_impl(
        torch.from_numpy(img), torch.from_numpy(depth), st["last_frame"],
        st["last_mp"], m, st["pose"], st["velocity"], st["ref_kf"],
        st["mp_vis"], st["mp_found"], st["mp_seen"], st["fidx"])
    frame, pose, _, feat_mp, pack = out[:5]
    lvl0 = jframe["level"] == 0
    np.testing.assert_array_equal(frame.xy.numpy()[lvl0], jframe["xy"][lvl0])
    bits = unpack_desc(frame.desc.numpy()[lvl0].view(np.uint32)) == \
        unpack_desc(jframe["desc"][lvl0])
    assert bits.mean() >= 0.999
    assert np.abs(pose.numpy()[4:] - jt.trajectory[-1][4:]).max() <= 5e-3
    assert abs(pack[14].item() - jinfo["inliers"]) <= 0.05 * jinfo["inliers"]
    if not jinfo["kf"]:
        assert (feat_mp.numpy()[lvl0]
                == np.asarray(jt.last_mp_dev)[lvl0]).mean() >= 0.95
