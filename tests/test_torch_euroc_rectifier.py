"""Port parity: the EuRoC stereo rectifier (`io/datasets.py::EurocRectifier`)
against the JAX package's, which is OpenCV's `initUndistortRectifyMap` and
`remap` (OpenCV is installed on the CPU machine only; the port needs none).

- The port's maps, built in float64 numpy and cast to f32, equal
  `cv2.initUndistortRectifyMap`'s bit for bit on both cameras of
  `make_euroc_rig`, at the JAX driver test's 320x240 and at EuRoC's
  752x480.
- The port's bilinear table (four taps from the floor of the map, zero
  outside the image, unquantized f32 weights) is within 1e-4 gray of
  `cv2.remap` on random maps that cross every border: OpenCV rounds its
  weights otherwise in the last bits.
- `euroc_stereo_sequence` with the rectifier gives, after the tracker's
  wire rounding (`wire_image(rint=True)`), the uint8 pairs of JAX's reader
  with JAX's rectifier on the first two frames of the JAX driver test's
  export (`tests/test_stereo_dataset_drivers.py:60-73`), but for the few
  pixels whose OpenCV value lies within 1e-4 of a half-integer, where the
  two roundings may part.
- The rectified pair matches the ideal rectified view
  (`tests/test_stereo_dataset_drivers.py:142-178`'s check).
"""

import os

import cv2
import numpy as np
import pytest

from orb_slam2_refactored_tpu.config import Settings as JSettings
from orb_slam2_refactored_tpu.io import datasets as jdatasets
from orb_slam2_refactored_tpu_torch.config import Settings
from orb_slam2_refactored_tpu_torch.io import datasets
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, euroc_settings_yaml, export_euroc_sequence,
    make_euroc_rig, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam.tracking import wire_image

N_FRAMES = 40  # the JAX driver test's trajectory; two frames exported
RIGS = {"qvga": dict(width=320, height=240, fx_rect=260.0, baseline=0.08),
        "euroc": dict(width=752, height=480, fx_rect=435.2, baseline=0.11)}


def _planes():
    return box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)


def _gt():
    return orbit_trajectory(N_FRAMES, radius=0.3, yaw_amp=0.2)


@pytest.fixture(scope="module")
def euroc_export(tmp_path_factory):
    """The first two frames of the JAX driver test's EuRoC export (QVGA rig,
    its trajectory) and the settings file of its rig."""
    root = tmp_path_factory.mktemp("euroc_rect")
    rig = make_euroc_rig(**RIGS["qvga"])
    seq = export_euroc_sequence(str(root / "seq"), _planes(), _gt()[:2],
                                rig=rig, fps=20.0)
    settings = str(root / "euroc.yaml")
    with open(settings, "w") as f:
        f.write(euroc_settings_yaml(rig))
    return seq, settings


@pytest.mark.parametrize("rig", sorted(RIGS))
@pytest.mark.parametrize("side", ["l", "r"])
def test_maps_equal_cv2_bit_for_bit(rig, side):
    r = make_euroc_rig(**RIGS[rig])
    w, h = r["width"], r["height"]
    mx, my = datasets.undistort_rectify_map(
        r[f"K_{side}"], r[f"D_{side}"], r[f"R_{side}"], r[f"P_{side}"], w, h)
    cx, cy = cv2.initUndistortRectifyMap(
        r[f"K_{side}"], r[f"D_{side}"], r[f"R_{side}"], r[f"P_{side}"][:3, :3],
        (w, h), cv2.CV_32F)
    assert mx.dtype == my.dtype == np.float32 and mx.shape == (h, w)
    np.testing.assert_array_equal(mx, cx)
    np.testing.assert_array_equal(my, cy)


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_within_1e4_of_cv2_across_every_border(seed):
    rng = np.random.default_rng(seed)
    h, w = 47, 61
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    mx = rng.uniform(-3.0, w + 2.0, (h, w)).astype(np.float32)
    my = rng.uniform(-3.0, h + 2.0, (h, w)).astype(np.float32)
    mx[0, :8] = [-1.0, -0.5, w - 1.0, w - 0.5, 0.0, -2.0, w, 3.0]
    my[0, :8] = [5.0, 5.0, 7.0, 7.0, -1.0, -2.0, h, h - 1.0]
    table = datasets.RemapTable(mx, my, h, w)
    got = table(img)
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    outside = ((np.floor(mx) < -1) | (np.floor(mx) > w - 1)
               | (np.floor(my) < -1) | (np.floor(my) > h - 1))
    assert outside.any() and (~outside).any()
    # every tap outside: all weights zero, the pixel 0
    assert (table.weights.reshape(4, h, w)[:, outside] == 0).all()
    assert (got[outside] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_sequence_gives_jax_pairs_after_wire_rounding(euroc_export):
    seq, settings = euroc_export
    stamps = os.path.join(seq, "timestamps.txt")
    rect = datasets.EurocRectifier(Settings.from_yaml(settings).rectification)
    jrect = jdatasets.EurocRectifier(
        JSettings.from_yaml(settings).rectification)
    port = list(datasets.euroc_stereo_sequence(seq, stamps, rect))
    jax_ = list(jdatasets.euroc_stereo_sequence(seq, stamps, jrect))
    assert len(port) == len(jax_) == 2
    near_half, parted = 0, 0
    for (t, l, r), (jt, jl, jr) in zip(port, jax_):
        assert t == jt
        for a, b in ((l, jl), (r, jr)):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
            half = np.abs(b - np.floor(b) - 0.5) < 1e-4
            diff = wire_image(a, rint=True) != wire_image(b, rint=True)
            assert not (diff & ~half).any()
            near_half += int(half.sum())
            parted += int(diff.sum())
    print(f"pixels within 1e-4 of a half-integer {near_half}, of which "
          f"rounded apart {parted}, of {4 * 320 * 240}")
    assert near_half <= 50


def test_rectified_pair_matches_ideal_view(euroc_export):
    seq, settings = euroc_export
    rect = datasets.EurocRectifier(Settings.from_yaml(settings).rectification)
    _, rect_l, rect_r = next(datasets.euroc_stereo_sequence(
        seq, os.path.join(seq, "timestamps.txt"), rect))
    ideal = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           baseline=0.08, planes=_planes())
    ideal_l, ideal_r, _ = ideal.render_stereo(_gt()[0])
    for got, want in ((rect_l, ideal_l), (rect_r, ideal_r)):
        a = got[20:-20, 20:-20].ravel()
        b = np.clip(want, 0, 255)[20:-20, 20:-20].ravel()
        corr = np.corrcoef(a, b)[0, 1]
        assert corr > 0.93, f"rectified/ideal correlation {corr:.3f}"
