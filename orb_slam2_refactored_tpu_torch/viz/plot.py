"""Headless map and frame figures, drawn without matplotlib.

Port of `orb_slam2_refactored_tpu/viz/plot.py` (the reference's MapDrawer
and FrameDrawer, `src/Viewer.cc:62-179`). JAX's figures are matplotlib
plots; the card's machine has no matplotlib, so here the same content is
rasterized into a numpy RGB image (`ar._draw_line` for lines, squares for
markers) and written with the port's PNG writer (`io/png.py`):

- `plot_map`: the top-down (x-z) view: the live landmarks (gray), the
  covisibility edges of weight >= 15 between live keyframes (light red),
  the estimated trajectory's camera centres (blue), the ground truth's
  (green, dashed), the keyframe centres (red squares);
- `plot_frame`: the frame with its tracked keypoints (green) and the
  untracked ones (blue).

Text has no font here: no axes, ticks, title or legend are drawn (`title`
is accepted and unused). `map_primitives` returns the arrays the map
figure draws, computed as JAX's figure computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3
from ..io.png import write_png
from .ar import _draw_line

LANDMARK = (136, 136, 136)
ESTIMATED = (31, 119, 180)
GROUND_TRUTH = (44, 160, 44)
KEYFRAME = (214, 39, 40)
EDGE = (240, 190, 190)
TRACKED = (44, 160, 44)
UNTRACKED = (31, 119, 180)
COVIS_MIN_WEIGHT = 15


def _centres(poses_cw) -> np.ndarray:
    """Camera centres [n,3] of world->camera poses [n,7]."""
    p = torch.as_tensor(np.asarray(poses_cw, np.float32).reshape(-1, 7))
    return se3.inverse(p)[:, 4:7].numpy()


def map_primitives(tracker, gt=None, mp_pos=None, mp_valid=None,
                   kf_pose=None) -> dict:
    """What `plot_map` draws, in world x-z: `landmarks` [n,2] (the live
    landmarks, `mp_valid`), `trajectory` [m,2] (the estimated camera
    centres), `ground_truth` [g,2] (or None), `keyframes` [k,2] (the live
    keyframes' centres), `edges` [e,2,2] (covisibility of weight >= 15
    between live keyframes, each pair once). `mp_pos`, `mp_valid` and
    `kf_pose` are the map's arrays on the host where the caller has read
    them (the viewer, through `Readback`); else they are read here."""
    m, g = tracker.map, tracker.graph
    if mp_pos is None:
        mp_pos, mp_valid = m.mp_pos.cpu().numpy(), m.mp_valid.cpu().numpy()
    if kf_pose is None:
        kf_pose = m.kf_pose.cpu().numpy()
    out = {"landmarks": np.asarray(mp_pos)[np.asarray(mp_valid)][:, [0, 2]]}
    traj = tracker.trajectory
    out["trajectory"] = (_centres(np.stack(traj))[:, [0, 2]] if traj
                         else np.zeros((0, 2), np.float32))
    out["ground_truth"] = (None if gt is None
                           else _centres(np.asarray(gt))[:, [0, 2]])
    kfs = g.alive_kfs()
    kc = (_centres(np.asarray(kf_pose)[kfs]) if len(kfs)
          else np.zeros((0, 3), np.float32))
    out["keyframes"] = kc[:, [0, 2]]
    row = {int(k): i for i, k in enumerate(kfs)}
    edges = [(kc[row[int(a)]], kc[row[int(b)]])
             for a in kfs
             for b in g.covis_neighbors(int(a), min_weight=COVIS_MIN_WEIGHT)
             if b > a and int(b) in row]
    out["edges"] = (np.asarray([[pa[[0, 2]], pb[[0, 2]]] for pa, pb in edges])
                    if edges else np.zeros((0, 2, 2), np.float32))
    return out


def _marker(img, xy, colour, half: int):
    """Filled squares of side 2 half + 1 at the pixel positions xy [n,2]."""
    h, w = img.shape[:2]
    if len(xy) == 0:
        return
    c = np.round(np.asarray(xy, np.float64)).astype(int)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            x, y = c[:, 0] + dx, c[:, 1] + dy
            keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            img[y[keep], x[keep]] = colour


def _polyline(img, xy, colour, dashed=False):
    for i in range(len(xy) - 1):
        if not dashed or i % 2 == 0:
            _draw_line(img, xy[i], xy[i + 1], colour)


def render_map(prim: dict, size: int = 800, margin: int = 20) -> np.ndarray:
    """`prim` (`map_primitives`) drawn top-down into u8[size, size, 3]: x to
    the right, z up, one scale for both axes."""
    img = np.full((size, size, 3), 255, np.uint8)
    parts = [prim[k] for k in ("landmarks", "trajectory", "keyframes")
             if len(prim[k])]
    if prim["ground_truth"] is not None and len(prim["ground_truth"]):
        parts.append(prim["ground_truth"])
    if not parts:
        return img
    allp = np.concatenate(parts).astype(np.float64)
    lo, hi = allp.min(0), allp.max(0)
    span = max(float((hi - lo).max()), 1e-6)
    scale = (size - 2 * margin) / span
    mid = (lo + hi) / 2.0

    def px(v):
        v = np.asarray(v, np.float64).reshape(-1, 2)
        return np.stack([size / 2.0 + (v[:, 0] - mid[0]) * scale,
                         size / 2.0 - (v[:, 1] - mid[1]) * scale], -1)

    for a, b in prim["edges"]:
        pa, pb = px(np.stack([a, b]))
        _draw_line(img, pa, pb, EDGE)
    _marker(img, px(prim["landmarks"]), LANDMARK, 0)
    if prim["ground_truth"] is not None:
        _polyline(img, px(prim["ground_truth"]), GROUND_TRUTH, dashed=True)
    _polyline(img, px(prim["trajectory"]), ESTIMATED)
    _marker(img, px(prim["keyframes"]), KEYFRAME, 2)
    return img


def plot_map(tracker, out_path: str, gt=None, title: str = "tpu-slam map",
             **arrays):
    """Top-down (x-z) map and trajectory figure written as a PNG to
    `out_path`; returns the path. `arrays` go to `map_primitives`."""
    write_png(out_path, render_map(map_primitives(tracker, gt, **arrays)))
    return out_path


def plot_frame(img, frame_data, feat_mp=None, out_path: str = "frame.png"):
    """The frame with its keypoints (FrameDrawer::DrawFrame): tracked ones
    (feat_mp >= 0) as green squares, the rest as blue dots; all blue
    without `feat_mp`. Returns the path."""
    g = np.asarray(img)
    out = np.stack([g] * 3, -1) if g.ndim == 2 else g.copy()
    out = np.clip(out, 0, 255).astype(np.uint8)
    xy = np.asarray(frame_data.xy.cpu() if torch.is_tensor(frame_data.xy)
                    else frame_data.xy)
    valid = np.asarray(frame_data.valid.cpu()
                       if torch.is_tensor(frame_data.valid)
                       else frame_data.valid).astype(bool)
    if feat_mp is not None:
        mp = np.asarray(feat_mp.cpu() if torch.is_tensor(feat_mp)
                        else feat_mp)
        tracked = valid & (mp >= 0)
        _marker(out, xy[tracked], TRACKED, 1)
        _marker(out, xy[valid & ~tracked], UNTRACKED, 0)
    else:
        _marker(out, xy[valid], UNTRACKED, 0)
    write_png(out_path, out)
    return out_path
