"""Port package rules: it imports neither JAX nor the JAX package (nor PyYAML
or OpenCV, which the card's machine lacks), keeps the JAX package's frame
layout, and builds with every setting JAX's tracker takes."""

import ast
import os

import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.slam import frame as jframe
from orb_slam2_refactored_tpu_torch import convert, kernels, resolve_device
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.slam import frame as tframe
from orb_slam2_refactored_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    Tracker, TrackerConfig, TrackState)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "orb_slam2_refactored_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Nor `yaml`, `cv2` or `matplotlib`: the machine with the card has
    none of them, so the settings reader, the PNG codec, the dataset
    readers and the viewer's figures are the port's own."""
    bad = []
    srcs = _sources()
    assert len(srcs) > 15
    for path in srcs:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "orb_slam2_refactored_tpu",
                        "yaml", "cv2", "matplotlib"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def test_every_kernel_source_exists():
    for name, (src, _) in kernels.SOURCES.items():
        assert os.path.exists(os.path.join(kernels.CSRC_DIR, src)), name
    assert set(kernels.LAUNCHES) == {"hamming_best2", "fast", "orb_desc",
                                     "pose_lm", "ba_point_index",
                                     "ba_assemble", "ba_cost", "stereo_sad",
                                     "ba_assemble_w_obs", "ba_schur_cg",
                                     "orb_desc_learned", "pyramid",
                                     "spread_topk", "spread_topk_large",
                                     "ba_cg_ut", "ba_cg_ap", "ba_cg_update",
                                     "wire_unpack", "project_search",
                                     "project_features", "resolve_claims"}


def test_empty_frame_and_scale_tables_match_jax():
    ref = {k: np.asarray(v) for k, v in jframe.empty_frame(7)._asdict().items()}
    out = convert.frame_to_numpy(tframe.empty_frame(7))
    for k, v in ref.items():
        assert out[k].dtype == v.dtype, k
        np.testing.assert_array_equal(out[k], v)
    for a, b in zip(jframe.scale_factors(8, 1.2),
                    tframe.scale_factors(8, 1.2)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _cfg(**kw):
    base = dict(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0,
                bf=4.0, n_features=64, n_levels=2, enable_local_ba=False,
                map_capacity=MapCapacity(4, 256, 64))
    base.update(kw)
    return TrackerConfig(**base)


@pytest.mark.parametrize("setting", [
    dict(depth_encoding="log8"), dict(image_encoding="dct"),
])
def test_wire_settings_build(setting):
    """The wire encodings are ported: the tracker builds on the CPU with
    each, reports it, and sizes its packed frame as JAX's does."""
    t = Tracker(_cfg(**setting), device="cpu")
    for k, v in setting.items():
        assert getattr(t.cfg, k) == v
    from orb_slam2_refactored_tpu_torch.slam.tracking import (
        packed_rgbd_nbytes)
    img = 64 * 48 // (4 if "image_encoding" in setting else 1)
    dep = 64 * 48 * (1 if "depth_encoding" in setting else 2)
    assert packed_rgbd_nbytes(t.cfg) == img + dep


def test_learned_pattern_is_accepted():
    """The learned BRIEF table is ported: the tracker builds with it and
    its extractor takes the full-image path (K7), not K3's window."""
    from orb_slam2_refactored_tpu_torch.ops.orb import pattern_fits_window

    t = Tracker(_cfg(descriptor_pattern="learned"), device="cpu")
    assert t.extractor.pattern == "learned"
    assert not pattern_fits_window("learned") and pattern_fits_window("fresh")


def test_unknown_pattern_raises():
    """An unknown pattern name raises ValueError, as JAX's `get_pattern`."""
    with pytest.raises(ValueError, match="unknown BRIEF pattern"):
        Tracker(_cfg(descriptor_pattern="orbvoc"), device="cpu")


def _window_map(K=4, P=200, N=64, seed=0):
    """A map of K keyframes seeing P points (mono and stereo rows), the
    first keyframe fixed by the window: the arguments of `_ba_impl`."""
    from orb_slam2_refactored_tpu_torch.geometry import se3
    from orb_slam2_refactored_tpu_torch.slam.map_state import empty_map

    rng = np.random.default_rng(seed)
    m = empty_map(MapCapacity(K, P, N), "cpu")
    pts = torch.from_numpy(np.stack([
        rng.uniform(-1, 1, P), rng.uniform(-0.8, 0.8, P),
        rng.uniform(3, 6, P)], -1).astype(np.float32))
    m.mp_pos.copy_(pts + 0.03 * torch.from_numpy(
        rng.normal(size=(P, 3)).astype(np.float32)))
    m.mp_valid[:] = True
    for k in range(K):
        pose = se3.exp(torch.tensor([0.0, 0.02 * k, 0.0, 0.1 * k, 0.0, 0.0]))
        sel = torch.from_numpy(rng.permutation(P)[:N])
        xc = se3.transform(pose, pts[sel])
        uv = 50.0 * xc[:, :2] / xc[:, 2:] + torch.tensor([32.0, 24.0])
        m.kf_pose[k] = se3.retract(pose, torch.from_numpy(
            rng.normal(0, 0.01, 6).astype(np.float32))) if k else pose
        m.kf_valid[k] = True
        m.kf_xy[k] = uv + torch.from_numpy(
            rng.normal(0, 0.5, (N, 2)).astype(np.float32))
        stereo = torch.from_numpy(rng.uniform(size=N) < 0.5)
        m.kf_uright[k] = torch.where(stereo, uv[:, 0] - 4.0 / xc[:, 2],
                                     torch.full((N,), -1.0))
        m.kf_feat_valid[k] = True
        m.kf_mp[k] = sel.to(torch.int32)
    win = dict(win_idx=torch.arange(K, dtype=torch.int32),
               win_free=torch.arange(K) > 0,
               win_valid=torch.ones(K, dtype=torch.bool),
               pt_lut=torch.arange(P, dtype=torch.int32),
               pts_local=torch.cat([torch.arange(P, dtype=torch.int32),
                                    torch.tensor([P], dtype=torch.int32)]))
    return m, win


def test_local_ba_cg_iters_is_accepted_and_unused():
    """The JAX package accepts `local_ba_cg_iters` and never reads it (its
    window BA is dense Schur): a tracker constructs with it, and its window
    BA gives the default's result bit for bit."""
    out = []
    for cg in (12, 30):
        t = Tracker(_cfg(enable_local_ba=True, local_ba_cg_iters=cg),
                    device="cpu")
        assert t.cfg.local_ba_cg_iters == cg and t.local_mapper is not None
        m, w = _window_map()
        out.append(t.local_mapper._ba_impl(
            m, w["win_idx"], w["win_free"], w["win_valid"], w["pt_lut"],
            w["pts_local"], 3, 1e-4))
    (m12, o12, a12, b12), (m30, o30, a30, b30) = out
    assert float(b12) < float(a12)  # the solve ran and lowered the cost
    assert not torch.equal(m12.kf_pose, _window_map()[0].kf_pose)
    for x, y in ((m12.kf_pose, m30.kf_pose), (m12.mp_pos, m30.mp_pos),
                 (o12, o30), (a12, a30), (b12, b30)):
        assert torch.equal(x, y)


def test_local_mapping_is_ported():
    """Synchronous local mapping (the bench's `enable_local_ba=True`) builds
    its mapper, which starts with no deferred product."""
    t = Tracker(_cfg(enable_local_ba=True), device="cpu")
    lm = t.local_mapper
    assert lm is not None and lm.n_ba == 0
    assert all(p is None for p in (lm._pending_tri, lm._pending_fuse,
                                   lm._pending_ratio, lm._pending_ba_erase,
                                   lm._pending_tcp))
    assert Tracker(_cfg(), device="cpu").local_mapper is None


def test_device_defaults_to_the_card():
    cam = tproj.CameraIntrinsics.create(50.0, 50.0, 32.0, 24.0, 4.0)
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda:0")
        assert LocalMapper(cam, 2, 1.2).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            Tracker(_cfg())
        with pytest.raises(RuntimeError):
            LocalMapper(cam, 2, 1.2)
    assert Tracker(_cfg(dist_coeffs=(0.1, 0.0, 0.0, 0.0, 0.0)),
                   device="cpu").device == torch.device("cpu")
    assert LocalMapper(cam, 2, 1.2, device="cpu").device == torch.device(
        "cpu")


def test_lost_frame_without_an_index_stays_lost():
    """A LOST frame runs the relocalization branch; with no BoW index yet
    (fewer keyframes than the vocabulary needs) it stays lost, and the
    tracker neither raises nor resets."""
    t = Tracker(_cfg(), device="cpu")
    t.state = TrackState.LOST
    pose = t.track_rgbd(np.zeros((48, 64), np.uint8),
                        np.zeros((48, 64), np.float32))
    assert t.state == TrackState.LOST and t.loop_closer is None
    assert t.track_info[-1] == {"reloc": False, "lost": True}
    assert t.traj_entries[-1]["lost"] and pose.shape == (7,)

