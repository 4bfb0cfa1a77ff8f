"""The port's trackers compute on the pixels the JAX package's trackers
compute on: `wire_image` and the depth's f16 round trip (port
`slam/tracking.py::Tracker.track_rgbd`, `track_stereo`) against the JAX
package's `_pack_rgbd` and `_pack_mono` wire formats, byte for byte."""

import types

import numpy as np
import pytest

from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch.slam.tracking import wire_image


@pytest.mark.parametrize("kind", ["gray_f32", "rgb_f32", "rgb_u8", "gray_u8"])
def test_frames_are_quantized_as_the_jax_wire_does(kind):
    """`wire_image` and the depth's f16 round trip give the pixels the JAX
    tracker computes on: `_pack_rgbd`'s bytes (image truncated to uint8,
    depth as f16) and `_pack_mono`'s (rounded and clipped, as both images
    of a stereo pair), exactly."""
    rng = np.random.default_rng(5)
    H, W = 12, 16
    shape = (H, W, 3) if kind.startswith("rgb") else (H, W)
    img = rng.uniform(0.0, 255.99, shape).astype(np.float32)
    if kind.endswith("u8"):
        img = img.astype(np.uint8)
    depth = rng.uniform(0.2, 6.0, (H, W)).astype(np.float32)
    stub = types.SimpleNamespace(cfg=JConfig(width=W, height=H, fx=10.0,
                                             fy=10.0, cx=8.0, cy=6.0))
    buf = JTracker._pack_rgbd(stub, img, depth)
    ours = wire_image(img, rint=False)
    assert ours.dtype == np.uint8 and ours.shape == (H, W)
    np.testing.assert_array_equal(ours.reshape(-1), buf[:H * W])
    np.testing.assert_array_equal(
        np.asarray(depth, np.float16).view(np.uint8).reshape(-1),
        buf[H * W:])
    np.testing.assert_array_equal(wire_image(img, rint=True),
                                  JTracker._pack_mono(stub, img))
