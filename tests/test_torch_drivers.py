"""Port parity: the PNG codec (`io/png.py`), the dataset readers
(`io/datasets.py`), the evaluation helpers and the CLI drivers.

- `io/png.py` against OpenCV (installed on the CPU machine, not on the
  card's): 8-bit gray and 16-bit images that OpenCV wrote with several
  compression strategies, and images filtered with each PNG filter type by
  an encoder written here, read byte for byte as `cv2.imread` reads them;
  RGB and RGBA images to gray as OpenCV's reader converts them, to 0 gray
  levels on these images; what `io/png.py` writes, OpenCV reads back equal.
- Each reader yields the JAX package's timestamps, images and depths on the
  same exported directories.
- The CLI `rgbd_tum` on the CPU (`--device cpu`) at the JAX driver test's
  size and gate (`tests/test_dataset_driver.py`: 40 QVGA frames, ATE of
  the saved file < 5 cm over >= 35 associated frames); `live_rgbd` on a
  watched directory. The `mono_tum` and `stereo_kitti` CLI runs (~20 s
  each here) run on the card, in `chip_smoke.py` phase 3j, to keep these
  tests inside their time.
"""

import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.io import datasets as jdatasets
from orb_slam2_refactored_tpu.io import evaluation as jevaluation
from orb_slam2_refactored_tpu_torch import drivers
from orb_slam2_refactored_tpu_torch.geometry import se3
from orb_slam2_refactored_tpu_torch.io import datasets, evaluation, png
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, export_euroc_sequence, export_kitti_sequence,
    export_tum_sequence, orbit_trajectory)

torch.set_num_threads(1)
# tests/test_dataset_driver.py's QVGA RGB-D camera
SETTINGS_YAML = """%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 30.0
Camera.bf: 20.8
Camera.RGB: 1
ThDepth: 35.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _images(seed=0):
    """A smooth and a noisy gray image, a 16-bit depth and an RGB image
    (a few pixels with equal channels)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:97, 0:131]
    base = 128 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0)
    smooth = np.clip(base, 0, 255).astype(np.uint8)
    noisy = np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(
        np.uint8)
    depth = (base * 200 + rng.integers(0, 3000, base.shape)).astype(np.uint16)
    rgb = np.clip(np.stack([base + rng.normal(0, 20, base.shape),
                            base[::-1] * 0.7, 255 - base], -1), 0, 255
                  ).astype(np.uint8)
    rgb[::7, ::5] = rgb[::7, ::5, :1]
    return smooth, noisy, depth, rgb


def _encode(img, ftype, path):
    """A PNG of gray `img` with every scanline filtered with `ftype`."""
    h = img.shape[0]
    rows = (img.astype(">u2").view(np.uint8) if img.dtype == np.uint16
            else img).reshape(h, -1).astype(np.int64)
    bpp = 2 if img.dtype == np.uint16 else 1
    out = []
    for r in range(h):
        x, up = rows[r], rows[r - 1] if r else np.zeros_like(rows[r])
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pa, pb, pc = np.abs(up - c), np.abs(a - c), np.abs(a + up - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, up, c))
        pred = [0 * x, a, up, (a + up) >> 1, paeth][ftype]
        out.append(np.concatenate([[ftype], (x - pred) & 255]))
    raw = np.concatenate(out).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    depth = 16 if img.dtype == np.uint16 else 8
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h,
                                             depth, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("strategy", [
    cv2.IMWRITE_PNG_STRATEGY_DEFAULT, cv2.IMWRITE_PNG_STRATEGY_FILTERED,
    cv2.IMWRITE_PNG_STRATEGY_HUFFMAN_ONLY, cv2.IMWRITE_PNG_STRATEGY_RLE])
def test_png_reads_what_cv2_writes(strategy, tmp_path):
    smooth, noisy, depth, rgb = _images()
    for i, img in enumerate((smooth, noisy, depth)):
        path = str(tmp_path / f"{i}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_STRATEGY, strategy,
                                cv2.IMWRITE_PNG_COMPRESSION, 3 * i])
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        out = png.read_png(path)
        assert out.dtype == ref.dtype and np.array_equal(out, ref)
        assert np.array_equal(png.read_gray(path),
                              cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    # colour to gray as OpenCV's reader converts it: 0 gray levels apart
    for img in (rgb, np.concatenate([rgb, rgb[..., :1]], -1)):
        path = str(tmp_path / "c.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_STRATEGY, strategy])
        diff = np.abs(png.read_gray(path).astype(int)
                      - cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(int))
        assert diff.max() == 0


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_undoes_every_filter_type(ftype, tmp_path):
    smooth, noisy, depth, _ = _images(1)
    for img in (noisy, depth):
        path = str(tmp_path / "f.png")
        _encode(img, ftype, path)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert np.array_equal(ref, img)  # the encoder here is right
        assert np.array_equal(png.read_png(path), img)


def test_png_writes_what_cv2_reads(tmp_path):
    smooth, _, depth, _ = _images(2)
    for img in (smooth, depth):
        path = str(tmp_path / "w.png")
        png.write_png(path, img)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert ref.dtype == img.dtype and np.array_equal(ref, img)
    # 8-bit RGB (the viewer's figures): cv2 reads it back in BGR order
    rgb = np.stack([smooth, smooth[::-1], smooth[:, ::-1]], -1).astype(
        np.uint8)
    png.write_png(path, rgb)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1],
                          rgb)
    for bad in (np.zeros((4, 4, 3), np.uint16), np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError):
            png.write_png(path, bad)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """TUM, KITTI and EuRoC layouts of a 6-frame QVGA orbit."""
    root = tmp_path_factory.mktemp("exports")
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           baseline=0.08, planes=planes)
    gt = orbit_trajectory(6, radius=0.3, yaw_amp=0.2)
    tum = export_tum_sequence(str(root / "tum"), scene, gt,
                              depth_noise=0.005)
    kitti = export_kitti_sequence(str(root / "kitti"), scene, gt)
    euroc = export_euroc_sequence(str(root / "euroc"), planes, gt)
    return tum, kitti, euroc


def _same_streams(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            assert u.dtype == v.dtype == np.float32 and np.array_equal(u, v)


def test_readers_match_jax(exports, tmp_path):
    tum, kitti, euroc = exports
    stamps = os.path.join(euroc, "timestamps.txt")
    _same_streams(datasets.tum_rgbd_sequence(tum),
                  jdatasets.tum_rgbd_sequence(tum))
    _same_streams(datasets.tum_mono_sequence(tum),
                  jdatasets.tum_mono_sequence(tum))
    _same_streams(datasets.kitti_stereo_sequence(kitti),
                  jdatasets.kitti_stereo_sequence(kitti))
    _same_streams(datasets.kitti_mono_sequence(kitti),
                  jdatasets.kitti_mono_sequence(kitti))
    _same_streams(datasets.euroc_stereo_sequence(euroc, stamps),
                  jdatasets.euroc_stereo_sequence(euroc, stamps))
    _same_streams(datasets.euroc_mono_sequence(euroc, stamps),
                  jdatasets.euroc_mono_sequence(euroc, stamps))
    # raw pairs through each package's rectifier, from the rig's settings
    # (`tests/test_torch_euroc_rectifier.py` holds the rectifier itself)
    from orb_slam2_refactored_tpu.config import Settings as JSettings
    from orb_slam2_refactored_tpu_torch.config import Settings
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        euroc_settings_yaml, make_euroc_rig)

    settings = str(tmp_path / "euroc.yaml")
    with open(settings, "w") as f:
        f.write(euroc_settings_yaml(make_euroc_rig()))
    rect = datasets.EurocRectifier(Settings.from_yaml(settings).rectification)
    jrect = jdatasets.EurocRectifier(
        JSettings.from_yaml(settings).rectification)
    got = list(datasets.euroc_stereo_sequence(euroc, stamps, rect))
    want = list(jdatasets.euroc_stereo_sequence(euroc, stamps, jrect))
    assert len(got) == len(want) == 6
    for x, y in zip(got, want):
        assert x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            assert u.dtype == v.dtype == np.float32
            np.testing.assert_allclose(u, v, rtol=0, atol=1e-4)
    # an association file, and the nearest-timestamp fallback with a
    # depth stamp that is too far
    pairs = jdatasets.load_tum_associations(tum)
    assoc = str(tmp_path / "assoc.txt")
    with open(assoc, "w") as f:
        f.write("# t rgb t depth\n" + "".join(
            f"{t:.6f} {r} {t:.6f} {d}\n" for t, r, d in pairs[:4]))
    assert datasets.load_tum_associations(tum, assoc) == \
        jdatasets.load_tum_associations(tum, assoc) == pairs[:4]
    far = str(tmp_path / "far")
    shutil.copytree(tum, far)
    lines = open(os.path.join(far, "depth.txt")).read().splitlines()
    t, name = lines[3].split()
    lines[3] = f"{float(t) + 0.05:.6f} {name}"
    with open(os.path.join(far, "depth.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    assert datasets.load_tum_associations(far) == \
        jdatasets.load_tum_associations(far)
    assert len(datasets.load_tum_associations(far)) == 5
    ts, cw = datasets.load_tum_groundtruth(os.path.join(tum,
                                                        "groundtruth.txt"))
    jts, jcw = jdatasets.load_tum_groundtruth(os.path.join(tum,
                                                           "groundtruth.txt"))
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(cw, jcw, atol=1e-6)


def test_stereo_euroc_cli_refuses_rectification_blocks(exports, tmp_path,
                                                        monkeypatch):
    """Settings with LEFT./RIGHT. blocks are no longer refused: the CLI
    builds the rectifier from them, as JAX's driver does, and tracks the
    rectified pairs (two of the export's, on the CPU)."""
    from orb_slam2_refactored_tpu_torch.config import Settings
    from orb_slam2_refactored_tpu_torch.io.synthetic import (
        euroc_settings_yaml, make_euroc_rig)
    from orb_slam2_refactored_tpu_torch.slam.system import SlamSystem

    _, _, euroc = exports
    settings = str(tmp_path / "euroc.yaml")
    with open(settings, "w") as f:
        f.write(euroc_settings_yaml(make_euroc_rig()))
    stamps = str(tmp_path / "stamps.txt")
    with open(os.path.join(euroc, "timestamps.txt")) as f:
        first = f.read().split()[:2]
    with open(stamps, "w") as f:
        f.write("\n".join(first) + "\n")
    seen, track = [], SlamSystem.track_stereo

    def spy(self, left, right, timestamp):
        seen.append((left, right))
        return track(self, left, right, timestamp)

    monkeypatch.setattr(SlamSystem, "track_stereo", spy)
    out = str(tmp_path / "t.txt")
    rc = drivers.main(["stereo_euroc", "--settings", settings, "--sequence",
                       euroc, "--timestamps", stamps, "--out", out,
                       "--no-loop-closing", "--device", "cpu"])
    assert rc == 0 and len(seen) == 2
    with open(out) as f:
        assert len(f.read().splitlines()) == 2
    rect = datasets.EurocRectifier(Settings.from_yaml(settings).rectification)
    for (l, r), (_, rl, rr) in zip(seen, datasets.euroc_stereo_sequence(
            euroc, stamps, rect)):
        assert np.array_equal(l, rl) and np.array_equal(r, rr)


def test_evaluation_association_matches_jax():
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 3, 60))
    b = np.sort(np.concatenate([a[::2] + rng.normal(0, 0.01, 30),
                                rng.uniform(0, 3, 20)]))
    for ia, ib in zip(evaluation.associate_timestamps(a, b),
                      jevaluation.associate_timestamps(a, b)):
        np.testing.assert_array_equal(ia, ib)
    assert list(evaluation.associate_timestamps(
        np.array([0.0, 1.0, 2.0, 3.0]),
        np.array([0.01, 1.5, 2.005, 2.995, 4.0]))[0]) == [0, 2, 3]
    gt = orbit_trajectory(60)
    est = gt + rng.normal(0, 1e-3, gt.shape).astype(np.float32)
    est[:, :4] /= np.linalg.norm(est[:, :4], axis=1, keepdims=True)
    r, _, n = evaluation.ate_rmse_assoc(a, est, a + 0.001, gt)
    rj, _, nj = jevaluation.ate_rmse_assoc(a, est, a + 0.001, gt)
    assert n == nj >= 55 and abs(r - rj) < 1e-6
    with pytest.raises(ValueError):
        evaluation.ate_rmse_assoc(a[:2], est[:2], a[:2], gt[:2])


def _read_tum(path):
    v = np.loadtxt(path, ndmin=2)
    poses_wc = v[:, [7, 4, 5, 6, 1, 2, 3]].astype(np.float32)
    return v[:, 0], se3.inverse(torch.from_numpy(poses_wc)).numpy()


@pytest.fixture(scope="module")
def tum_40(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tum_seq"))
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    export_tum_sequence(out, scene, orbit_trajectory(40, radius=0.3,
                                                      yaw_amp=0.2),
                        fps=30.0, depth_noise=0.005)
    return out


def test_rgbd_tum_cli_end_to_end(tum_40, tmp_path, capsys):
    """The CLI (argv -> readers -> SlamSystem -> the three files) on the
    CPU, the saved TUM file scored against groundtruth.txt with timestamp
    association: JAX's driver test's gate."""
    settings = str(tmp_path / "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS_YAML)
    out, kf, kitti = (str(tmp_path / n) for n in ("t.txt", "kf.txt",
                                                   "k.txt"))
    rc = drivers.main(["rgbd_tum", "--settings", settings, "--sequence",
                       tum_40, "--out", out, "--kf-out", kf,
                       "--kitti-out", kitti, "--no-loop-closing",
                       "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "median tracking time:" in printed and "mean tracking time:" in \
        printed
    est_ts, est_cw = _read_tum(out)
    gt_ts, gt_cw = datasets.load_tum_groundtruth(
        os.path.join(tum_40, "groundtruth.txt"))
    np.testing.assert_array_equal(est_ts, np.round(gt_ts, 6))
    rmse, _, n = evaluation.ate_rmse_assoc(est_ts, est_cw, gt_ts, gt_cw)
    assert n >= 35
    assert rmse < 0.05, f"ATE {rmse:.4f} m"
    rows = np.loadtxt(kitti, ndmin=2)
    assert rows.shape == (40, 12)
    assert len(np.loadtxt(kf, ndmin=2)) >= 2


def test_live_rgbd_cli(tum_40, tmp_path):
    """`live_rgbd` tracks the pairs dropped in a watched directory, saves
    its trajectory and map, and exits when no new frame comes; `rgbd_tum
    --load-map` starts from that map."""
    watch = tmp_path / "watch"
    for sub in ("rgb", "depth"):
        os.makedirs(watch / sub)
        for name in sorted(os.listdir(os.path.join(tum_40, sub)))[:3]:
            shutil.copy(os.path.join(tum_40, sub, name), watch / sub / name)
    settings = str(tmp_path / "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS_YAML)
    out, map_path = str(tmp_path / "t.txt"), str(tmp_path / "map.npz")
    rc = drivers.main(["live_rgbd", "--settings", settings, "--watch",
                       str(watch), "--idle-timeout", "0.2", "--out", out,
                       "--save-map", map_path, "--no-loop-closing",
                       "--device", "cpu"])
    assert rc == 0 and os.path.exists(map_path)
    ts, _ = _read_tum(out)
    assert len(ts) == 3 and ts[0] == 1000.0
    out2 = str(tmp_path / "t2.txt")
    rc = drivers.main(["rgbd_tum", "--settings", settings, "--sequence",
                       tum_40, "--out", out2, "--load-map", map_path,
                       "--max-frames", "2", "--no-loop-closing",
                       "--device", "cpu"])
    assert rc == 0 and len(_read_tum(out2)[0]) == 2
