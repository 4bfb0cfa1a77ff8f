"""The port's wire formats against the JAX package's, with no tracker run:
the DCT image codec (`ops/codec.py`), the packed RGB-D and stereo buffers
(`slam/tracking.py::pack_rgbd`, `pack_stereo`) and their plain unpack
(`Tracker._unpack`, `_unpack_stereo`), which the CPU runs where the card
runs kernel K10. JAX's functions are called through a stub holding its
`TrackerConfig`, as `tests/test_torch_wire.py` does.

Tolerances: encoded bytes and packed buffers are equal; a decoded DCT image
is within 1e-3 gray of JAX's decoders (their own gate,
`tests/test_codec.py:47`: the contractions add in another order); log8
depth is within 2 ulp of JAX's on every code (`exp` of the two libraries);
raw images and f16 depth are equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.ops import codec as jcodec
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch import kernels
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.ops import codec
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    Tracker, TrackerConfig, pack_mono, pack_rgbd, pack_stereo, wire_image)

torch.set_num_threads(1)
H, W = 240, 320
CAM = dict(width=W, height=H, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
           bf=0.08 * 260.0)


@pytest.fixture(scope="module")
def frame():
    """A rendered box-room view (uint8 image, f32 depth with 1 % noise)."""
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=W, height=H, fx=260.0, fy=260.0,
                           planes=planes, baseline=0.08)
    gt = orbit_trajectory(2, radius=0.3, yaw_amp=0.2)
    img, depth = scene.render(gt[1])
    left, right, _ = scene.render_stereo(gt[1])
    rng = np.random.default_rng(9)
    depth = (depth * (1 + rng.normal(0, 0.01, depth.shape))).astype(
        np.float32)
    return (np.clip(img, 0, 255).astype(np.uint8), depth,
            left.astype(np.float32), right.astype(np.float32))


def _jax_stub(**kw):
    """An object JAX's pack and unpack methods run on."""
    stub = types.SimpleNamespace(cfg=JConfig(**{**CAM, **kw}))
    for name in ("_pack_mono", "_packed_depth_hw", "_packed_img_nbytes"):
        setattr(stub, name, types.MethodType(getattr(JTracker, name), stub))
    return stub


def _port(**kw):
    return Tracker(TrackerConfig(**{**CAM, "n_features": 64, "n_levels": 2,
                                    "enable_local_ba": False,
                                    "map_capacity": MapCapacity(4, 256, 64),
                                    **kw}), device="cpu")


def test_encode_is_jax_byte_for_byte(frame):
    img = frame[0]
    rng = np.random.default_rng(1)
    noise = rng.uniform(0, 255.99, (48, 64)).astype(np.float32)
    for x in (img, noise, np.full((16, 24), 200, np.uint8)):
        ours = codec.encode_dct(x)
        np.testing.assert_array_equal(ours, jcodec.encode_dct(x))
        assert ours.nbytes == codec.encoded_nbytes(*x.shape) \
            == jcodec.encoded_nbytes(*x.shape) == x.size // 4
    np.testing.assert_array_equal(codec._dct_matrix(), jcodec._dct_matrix())
    assert (codec.KEEP, codec.AC_STEP, codec.BYTES_PER_BLOCK) == (
        jcodec.KEEP, jcodec.AC_STEP, jcodec.BYTES_PER_BLOCK)


def test_plain_decode_within_1e3_gray_of_jax(frame):
    img = frame[0]
    buf = codec.encode_dct(img)
    ours = codec.decode_dct_plain(torch.from_numpy(buf), H, W).numpy()
    assert ours.dtype == np.float32 and ours.shape == (H, W)
    np.testing.assert_allclose(
        ours, np.asarray(jcodec.decode_dct(jnp.asarray(buf), H, W)),
        atol=1e-3, rtol=0)
    np.testing.assert_allclose(ours, jcodec.decode_dct_np(buf, H, W),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(codec.decode_dct_np(buf, H, W),
                               jcodec.decode_dct_np(buf, H, W), atol=0)


def test_quality_floor(frame):
    """JAX's floor (`tests/test_codec.py:51-68`) on the port's decode."""
    img = frame[0]
    dec = codec.decode_dct_plain(torch.from_numpy(codec.encode_dct(img)),
                                 H, W).numpy()
    err = dec - img.astype(np.float32)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(err ** 2))
    assert psnr > 30.0, f"PSNR {psnr:.1f} dB"
    assert np.abs(err).mean() < 3.0
    flat = codec.decode_dct_plain(torch.from_numpy(codec.encode_dct(
        np.full((64, 64), 137, np.uint8))), 64, 64).numpy()
    assert np.abs(flat - 137.0).max() < 1.0


@pytest.mark.parametrize("sub", [1, 2, 8])
@pytest.mark.parametrize("image_encoding", ["raw", "dct"])
@pytest.mark.parametrize("depth_encoding", ["f16", "log8"])
def test_pack_rgbd_is_jax_byte_for_byte(frame, depth_encoding,
                                        image_encoding, sub):
    """An RGB input (gray on the host, truncated) and depths at 0, below
    0, beyond 16 m and NaN (log8's code 0); a depth that arrives
    subsampled passes as it is."""
    img, depth = frame[0], frame[1].copy()
    rgb = np.stack([img, np.roll(img, 3, 1), 255 - img], -1).astype(
        np.float32) + 0.4
    depth[:8, :16] = 0.0
    depth[8:16, :16] = -1.0
    depth[16:24, :16] = 17.5
    depth[24:32, :16] = np.nan
    depth[32:40, :16] = 16.0
    depth[40:48, :16] = 0.1
    kw = dict(depth_subsample=sub, depth_encoding=depth_encoding,
              image_encoding=image_encoding)
    cfg = TrackerConfig(**CAM, **kw)
    stub = _jax_stub(**kw)
    for d in (depth, depth[::sub, ::sub].copy()):
        ref = JTracker._pack_rgbd(stub, rgb, d)
        ours = pack_rgbd(cfg, rgb, d)
        assert ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
        out = np.empty_like(ref)
        assert pack_rgbd(cfg, rgb, d, out=out) is out
        np.testing.assert_array_equal(out, ref)
    if depth_encoding == "log8":
        q = codec.encode_log8(np.array(
            [0.0, -1.0, 17.5, np.nan, 16.0, 0.1, 0.25], np.float32))
        np.testing.assert_array_equal(q, [0, 0, 0, 0, 255, 1, 1])


@pytest.mark.parametrize("image_encoding", ["raw", "dct"])
def test_pack_stereo_and_mono_are_jax_byte_for_byte(frame, image_encoding):
    left, right = frame[2], frame[3]
    cfg = TrackerConfig(**CAM, image_encoding=image_encoding)
    stub = _jax_stub(image_encoding=image_encoding)
    ref = JTracker._pack_stereo(stub, left, right)
    np.testing.assert_array_equal(pack_stereo(cfg, left, right), ref)
    np.testing.assert_array_equal(pack_mono(left),
                                  JTracker._pack_mono(stub, left))


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("image_encoding", ["raw", "dct"])
@pytest.mark.parametrize("depth_encoding", ["f16", "log8"])
def test_plain_unpack_against_jax(frame, depth_encoding, image_encoding):
    """`Tracker._unpack` on the CPU against JAX's `_unpack_impl` on the
    same packed bytes; the log8 codes are all 256 of them."""
    kw = dict(depth_subsample=2, depth_encoding=depth_encoding,
              image_encoding=image_encoding)
    cfg = TrackerConfig(**CAM, **kw)
    img, depth = frame[0], frame[1]
    buf = pack_rgbd(cfg, img, depth)
    ib = img.size // (4 if image_encoding == "dct" else 1)
    if depth_encoding == "log8":
        buf[ib:] = np.resize(np.arange(256, dtype=np.uint8), buf.size - ib)
    j_img, j_dep = JTracker._unpack_impl(_jax_stub(**kw), jnp.asarray(buf))
    t_img, t_dep = _port(**kw)._unpack(torch.from_numpy(buf))
    j_img, j_dep = np.asarray(j_img), np.asarray(j_dep)
    assert tuple(t_img.shape) == j_img.shape
    assert tuple(t_dep.shape) == j_dep.shape == (H // 2, W // 2)
    if image_encoding == "dct":
        assert t_img.dtype == torch.float32
        np.testing.assert_allclose(t_img.numpy(), j_img, atol=1e-3, rtol=0)
    else:
        assert t_img.dtype == torch.uint8
        np.testing.assert_array_equal(t_img.numpy(), j_img)
    if depth_encoding == "log8":
        assert t_dep.dtype == torch.float32
        assert _ulps(t_dep.numpy(), j_dep).max() <= 2
        assert t_dep.numpy()[0, 0] == 0.0 and j_dep[0, 0] == 0.0
    else:
        assert t_dep.dtype == torch.float16
        np.testing.assert_array_equal(t_dep.numpy(), j_dep)


@pytest.mark.parametrize("image_encoding", ["raw", "dct"])
def test_plain_unpack_stereo_against_jax(frame, image_encoding):
    cfg_kw = dict(image_encoding=image_encoding)
    buf = pack_stereo(TrackerConfig(**CAM, **cfg_kw), frame[2], frame[3])
    j = JTracker._unpack_stereo_impl(_jax_stub(**cfg_kw), jnp.asarray(buf))
    t = _port(**cfg_kw)._unpack_stereo(torch.from_numpy(buf))
    for a, b in zip(t, j):
        if image_encoding == "dct":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("hw", [(240, 320), (13, 15)])
def test_raw_f16_unpack_is_what_the_tracker_uploaded(frame, hw):
    """For a raw image and f16 depth the unpacked tensors are exactly the
    previous two uploads' (`wire_image` truncated; depth through f16). At
    an odd H x W the f16 depth starts at an odd byte: a copy, equal."""
    h, w = hw
    img = frame[0][:h, :w].astype(np.float32) + 0.7
    depth = frame[1][:h, :w]
    t = Tracker(TrackerConfig(width=w, height=h, fx=260.0, fy=260.0,
                              cx=w / 2, cy=h / 2, bf=20.8, n_features=64,
                              n_levels=1, enable_local_ba=False,
                              map_capacity=MapCapacity(4, 256, 64)),
                device="cpu")
    u_img, u_dep = t._unpack(torch.from_numpy(pack_rgbd(t.cfg, img, depth)))
    assert u_img.dtype == torch.uint8
    np.testing.assert_array_equal(u_img.numpy(), wire_image(img, rint=False))
    np.testing.assert_array_equal(
        u_dep.to(torch.float32).numpy(),
        np.asarray(depth, np.float16).astype(np.float32))


def test_k10_wrapper_refuses_what_the_kernel_does_not_take():
    """K10's wrapper raises on a CPU tensor, a wrong type or a layout that
    overruns a row; it never falls back to the plain decode, and counts no
    launch."""
    kernels.reset_counts()
    buf = torch.zeros((2, 64), dtype=torch.uint8)
    lut = codec.log8_table("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        codec.wire_unpack(buf, dep=(0, 8, 8), lut=lut)
    with pytest.raises(ValueError, match="CUDA"):
        codec.decode_dct(buf[0], 8, 8)
    with pytest.raises(ValueError):
        codec.wire_unpack_plain(buf.to(torch.int32), dep=(0, 8, 8))
    with pytest.raises(ValueError, match="overrun|fit"):
        codec.wire_unpack_plain(buf, img=(0, 8, 40))
    assert kernels.LAUNCHES["wire_unpack"] == 0
    np.testing.assert_array_equal(
        lut.numpy(), codec.decode_log8_plain(
            torch.arange(256, dtype=torch.uint8)).numpy())


def test_unknown_encodings_raise():
    for kw in (dict(depth_encoding="log16"), dict(image_encoding="jpeg"),
               dict(image_encoding="dct", width=324, cx=162.0)):
        with pytest.raises(ValueError):
            _port(**kw)


@pytest.mark.parametrize("entry", ["_unpack", "_unpack_stereo",
                                   "track_mono_uploaded"])
def test_a_buffer_on_another_device_raises(frame, entry):
    """A tracker decodes and steps only buffers on its own device: one that
    lies elsewhere (the `meta` device stands in here for a card tracker's
    host buffer) raises before any decode, plain or K10."""
    t = _port(depth_subsample=2, depth_encoding="log8",
              image_encoding="dct")
    size = {"_unpack": pack_rgbd(t.cfg, frame[0], frame[1]).size,
            "_unpack_stereo": pack_stereo(t.cfg, frame[2], frame[3]).size,
            "track_mono_uploaded": H * W}[entry]
    buf = torch.empty(size, dtype=torch.uint8, device="meta")
    kernels.reset_counts()
    with pytest.raises(ValueError, match="tracker runs on cpu"):
        getattr(t, entry)(buf)
    assert kernels.LAUNCHES["wire_unpack"] == 0
