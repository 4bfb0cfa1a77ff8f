"""Tracking stage: per-frame RGB-D, stereo and monocular pose estimation
over device-resident map state.

Port of `orb_slam2_refactored_tpu/slam/tracking.py`: `_prepare_impl` (ORB
extraction + depth association),
`_prepare_stereo_impl` (left and right extraction, the row-banded stereo
association and the per-level SAD refinement, `ops/stereo.py`) and
`_prepare_mono_impl` (extraction, no depth), `_track_impl` (motion-model
matching, rotation check, pose LM, reference-keyframe fallback with Horn
RANSAC on depth or, in mono, planar-safe PnP RANSAC, whole-map projection
matching, final pose LM, found/visible statistics), the fused
`_step_impl`, `_step_stereo_impl` and `_mono_step`, keyframe insertion
(`_insert_kf_impl` / `_insert_kf_auto_impl`), the monocular bootstrap
(`_initialize_mono`: windowed matching against a reference frame, the
H/F initializer of `solvers/initializer.py`, two keyframes and their
triangulated landmarks at unit median depth, a 2-keyframe BA), the host
loops `track_rgbd`, `track_stereo` and `track_mono` (each a packed
upload and its `*_uploaded` entry), the ingest entries (`prefetch_rgbd`,
`prefetch_rgbd_batches`, `prefetch_stereo`, `prefetch_mono` on the upload
pool of `utils/upload.py`; `upload_rgbd_batch`, `track_rgbd_batch`; the
fused pair and chain steps `track_*_pair_uploaded` and
`track_*_chain_uploaded`, `_stepk`), `sync_device`, `warm_stage_programs`
and, with
`enable_local_ba=True`, the local-mapping job that follows each keyframe
(`slam/local_mapping.py`: triangulation, fusion, point culling, window BA,
keyframe culling), run by the staged pump `_pump_mapping` (JAX's stages
-1 to 3: the insert drain, then triangulation, fusion, culling and the
window BA, keyframe culling). Every keyframe is indexed in the BoW database
(`_ensure_bow_index`: the vocabulary is trained at the 4th keyframe), and a
LOST frame relocalizes against it (`_relocalize`: BoW candidates, descriptor
matching, Horn RANSAC on depth or PnP RANSAC in mono, pose LM, a
projection-guided polish). With
`enable_loop_closing=True` each keyframe runs the loop stage (BoW
detection, dispatched when the keyframe is made and resolved at its insert
drain once the index exists, as JAX does in both modes, else
`_loop_closing_stage`; then `_close_loop`: the Sim3 solve,
the projection check, the essential-graph correction and a global BA that
is merged at the next keyframe), with the implicit-loop and seam pathways
(`_implicit_loop_candidate`, `_seam_check`); with `local_map_window > 0`
the whole-map projection search sees only the covisibility window's points
(`_refresh_local_mask`). `change_calibration` swaps the camera model
mid-session, and `localization_only` (set by the facade's localization
mode) stops keyframes, and the unforced pump holds the mapping job.

Two modes, as in JAX. Synchronous (`pipelined=False`): each frame's pack
is read at once, and the mapping job is completed inside the frame that
made the keyframe (`_complete_mapping`: the pump, forced), which then
adopts the BA-refined pose of the new keyframe. Pipelined
(`pipelined=True`, the JAX bench's setting): `_run_frame_pipelined`
dispatches frame t from the device state of frame t-1 and queues its
pack's read; frames leave the queue (`_finalize_pending`, with the
keyframe decision) once more than `max(pipeline_depth, 1)` are in
flight, and the mapping job advances by up to two ready stages a frame
(`_pump_mapping`). A loss discards every frame still in flight (each keeps
one trajectory slot and one `discarded` entry); a keyframe made from a
popped frame keeps the newer frame's device state; no BA or loop
correction pose is adopted.
Only tracked frames in OK state go through the queue: initialization,
relocalization and a LOST frame drain it first (`_run_frame`), in every
sensor. `flush()` drains the queue, then the map.

Differences of form from the JAX package:
- the tracker runs on `cuda:0` unless the caller passes another device
  (the tests pass "cpu"); with no card and no explicit device it raises;
- a frame goes to the card as the JAX package's packed wire buffer
  (`pack_rgbd`, `pack_stereo`, `pack_mono`: the same bytes), one upload a
  frame or a [k, B] batch; `_unpack_rows` / `_unpack_stereo` take the raw
  image and f16 depth as views of it, and decode a DCT image and log8
  depth with ONE launch of K10 (`ops/codec.py::wire_unpack`) a buffer on
  the card (the plain decode on a CPU tracker), where JAX decodes inside
  each step program; a buffer on another device than the tracker's
  raises; the mono path sends raw bytes under every `image_encoding`, as
  JAX's does;
- `prefetch_*` futures resolve to device tensors uploaded on a stream of
  the pool's (`utils/upload.py`); the consumer's stream waits for each
  copy's event;
- a fused k-frame step (`_stepk`) is k eager steps with one stacked pack
  read, where JAX compiles one program; the near-equivalence is JAX's
  (the map and keyframe state at most k-1 finalizes staler);
- `sync_device` synchronizes the card; `warm_stage_programs` builds and
  loads every kernel library (JAX compiles its stage programs' variants);
- `jax.lax.cond(use_ref, ...)` is a Python branch on `use_ref.item()`, one
  documented host wait per frame in the middle of the step, beside the
  read of the host pack: the host cannot run a whole frame ahead of the
  card (`use_ref_waits` keeps each frame's wait on the host clock);
- a device read the host does not need at once is a
  `utils/readback.py::Readback` (a copy into a pinned buffer and a CUDA
  event; no thread), where JAX hands `np.asarray` to a fetch pool; on the
  CPU it is resolved at once, so there every pumped stage is ready and
  the pipelined schedule is deterministic, where JAX's depends on when
  its fetches land;
- in pipelined mode `Tracker.timer` reads the host clock only; in
  synchronous mode it synchronizes the card at both ends of a stage;
- the frame counter `fidx` is a Python int (it seeds the RANSAC generator);
- the mono initializer's samples are drawn from a `torch.Generator`
  seeded with the frame id (`_mono_init_samples`), where JAX uses
  `PRNGKey(frame_id)`;
- map updates at keyframe insertion happen in place;
- `flush()` drains every deferred mapping product (see its docstring);
- JAX's `last_mp` (the host copy of the last frame's landmarks, read only
  by `viz/`) has no port: the port's `viz/ar.py` reads `last_mp_dev`;
- the relocalization RANSAC draws from `torch.Generator().manual_seed(
  frame_id * 31 + kf)` where JAX folds that number into `PRNGKey(0)`: a run
  repeats itself, and its outcome, not its samples, agrees with JAX;
- a relocalization candidate's two scalars after the RANSAC and the LM
  (success, inliers) come back in one read;
- `_track_impl`, `_step_impl` and `_step_stereo_impl` take the covisibility
  window's point mask as their last argument, `local_mask` (None: every
  live point), where the JAX step takes it before `mp_seen`;
- the global BA of a loop is computed inside `_close_loop` (the JAX
  package dispatches it there); the tracker merges it at the next keyframe
  as JAX does, and `flush()` leaves a pending one pending, as JAX's does;
- the loop closer's RANSAC draws from a generator seeded with the keyframe
  slot, where JAX uses `PRNGKey(slot)`.

An unknown `depth_encoding` or `image_encoding`, or `"dct"` at a width or
height that is not a multiple of 8, raises ValueError at construction
(JAX falls back to the default or fails at the first frame).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels, resolve_device
from ..geometry import projection as proj
from ..geometry import se3, sim3
from ..ops import codec, matching
from ..ops.codec import LOG8_DMAX, LOG8_DMIN  # noqa: F401 (JAX's names)
from ..ops.orb import OrbExtractor
from ..ops.stereo import stereo_associate
from ..optim.pose_opt import pose_optimize
from ..solvers.initializer import initialize
from ..solvers.ransac import draw_samples, horn_ransac, pnp_ransac
from ..utils.readback import Readback
from ..utils.timing import StageTimer
from ..utils.upload import UploadPool, ready
from .frame import FrameData, scale_factors
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map_state import INVALID, MapArrays, MapCapacity, MapGraph, empty_map
from .system import _np_compose, _np_inverse
from .vocabulary import train_vocabulary


def wire_image(img, rint: bool) -> np.ndarray:
    """The 8-bit gray image the JAX package's tracker computes on: RGB
    goes to gray on the host in f32 (`src/System.cc:122-151`), then to
    uint8 by numpy's cast, which truncates (`_pack_rgbd`), or after a
    round to nearest and a clip to [0, 255] (`_pack_mono`, also the
    stereo pair's). A uint8 gray image passes unchanged."""
    img = np.asarray(img)
    if img.ndim == 3:
        img = (img.astype(np.float32) @
               np.array([0.299, 0.587, 0.114], np.float32))
    if rint and img.dtype != np.uint8:
        img = np.clip(np.rint(img), 0, 255)
    return np.ascontiguousarray(img, np.uint8)


@dataclasses.dataclass
class TrackerConfig:
    """Field names and defaults of the JAX package's `TrackerConfig`."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float = 0.0
    dist_coeffs: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    th_depth: float = 35.0
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    map_capacity: MapCapacity = None
    mm_radius: float = 15.0
    local_radius: float = 3.0
    local_map_window: int = 0
    min_matches_mm: int = 20
    min_inliers_track: int = 10
    kf_ref_ratio: float = 0.75
    kf_min_interval: int = 0
    kf_max_interval: int = 30
    enable_local_ba: bool = True
    local_ba_iters: int = 3
    local_ba_cg_iters: int = 12
    enable_loop_closing: bool = False
    implicit_loop_min_gap: int = 50
    seam_min_reacq: int = 15
    vocab_words: int = 512
    mono_init_min_matches: int = 100
    max_new_points_per_kf: int = 350
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 5
    pipelined: bool = False
    pipeline_depth: int = 2
    descriptor_pattern: str = "fresh"
    depth_subsample: int = 1
    depth_encoding: str = "f16"
    image_encoding: str = "raw"

    def __post_init__(self):
        if self.map_capacity is None:
            self.map_capacity = MapCapacity(
                max_keyframes=256, max_points=16384,
                max_features=self.n_features)
        if self.map_capacity.max_points >= 2 ** 24:
            raise ValueError(
                f"max_points={self.map_capacity.max_points} >= 2^24: "
                "landmark ids would lose precision in the f32 host pack")


def _packed_depth_hw(cfg: TrackerConfig) -> Tuple[int, int]:
    """The depth map's shape on the wire: subsampled s x s (ceil)."""
    s = cfg.depth_subsample
    return -(-cfg.height // s), -(-cfg.width // s)


def _packed_img_nbytes(cfg: TrackerConfig) -> int:
    """The image's bytes on the wire: raw uint8, or the DCT codec's."""
    if cfg.image_encoding == "dct":
        return codec.encoded_nbytes(cfg.height, cfg.width)
    return cfg.height * cfg.width


def packed_rgbd_nbytes(cfg: TrackerConfig) -> int:
    h, w = _packed_depth_hw(cfg)
    return _packed_img_nbytes(cfg) + h * w * (
        1 if cfg.depth_encoding == "log8" else 2)


def wire_sections(cfg: TrackerConfig):
    """What K10 decodes in a packed RGB-D row: the DCT image's section
    (offset, H, W) or None for a raw image, and the log8 depth's (offset,
    h, w) or None for f16 depth."""
    h, w = _packed_depth_hw(cfg)
    img = ((0, cfg.height, cfg.width) if cfg.image_encoding == "dct"
           else None)
    dep = ((_packed_img_nbytes(cfg), h, w) if cfg.depth_encoding == "log8"
           else None)
    return img, dep


def _into(out, n: int) -> np.ndarray:
    if out is None:
        return np.empty(n, np.uint8)
    if out.shape != (n,) or out.dtype != np.uint8:
        raise ValueError(f"a packed frame of {n} bytes does not fit "
                         f"{out.dtype} {out.shape}")
    return out


def pack_rgbd(cfg: TrackerConfig, img, depth, out=None) -> np.ndarray:
    """JAX's `_pack_rgbd`, byte for byte: the gray image (`wire_image`,
    truncated; DCT-coded under `image_encoding="dct"`), then the depth,
    subsampled s x s unless it arrives subsampled, as f16 or log8 codes
    (0 for a depth <= 0, beyond LOG8_DMAX or NaN). Written into `out` (a
    uint8 array of the packed size) when given."""
    img = wire_image(img, rint=False)
    if cfg.image_encoding == "dct":
        img = codec.encode_dct(img)
    s = cfg.depth_subsample
    depth = np.asarray(depth)
    if s > 1 and depth.shape[0] == cfg.height:
        depth = depth[::s, ::s]
    if cfg.depth_encoding == "log8":
        dep = codec.encode_log8(depth)
    else:
        dep = np.ascontiguousarray(depth, np.float16).view(np.uint8)
    hw = img.size
    out = _into(out, hw + dep.size)
    out[:hw] = img.reshape(-1)
    out[hw:] = dep.reshape(-1)
    return out


def pack_mono(img, out=None) -> np.ndarray:
    """JAX's `_pack_mono`: the gray image rounded to uint8 (`wire_image`),
    [H, W]; the raw bytes whatever `image_encoding` says, as JAX's mono
    path sends them."""
    img = wire_image(img, rint=True)
    if out is None:
        return img
    out[...] = img.reshape(out.shape)
    return out


def pack_stereo(cfg: TrackerConfig, img_l, img_r, out=None) -> np.ndarray:
    """JAX's `_pack_stereo`, byte for byte: both images rounded to uint8
    gray, each DCT-coded under `image_encoding="dct"`, left then right."""
    bufs = []
    for img in (img_l, img_r):
        img = wire_image(img, rint=True)
        if cfg.image_encoding == "dct":
            img = codec.encode_dct(img)
        bufs.append(img.reshape(-1))
    n = bufs[0].size
    out = _into(out, n + bufs[1].size)
    out[:n] = bufs[0]
    out[n:] = bufs[1]
    return out


def _check_wire(cfg: TrackerConfig):
    """The wire encodings JAX's tracker reads; an unknown name raises
    rather than falling through to the default as it does there."""
    if cfg.depth_encoding not in ("f16", "log8"):
        raise ValueError(f"depth_encoding={cfg.depth_encoding!r}: 'f16' or "
                         "'log8'")
    if cfg.image_encoding not in ("raw", "dct"):
        raise ValueError(f"image_encoding={cfg.image_encoding!r}: 'raw' or "
                         "'dct'")
    if cfg.image_encoding == "dct" and (cfg.height % codec.BLOCK
                                        or cfg.width % codec.BLOCK):
        raise ValueError(f"image_encoding='dct' needs H and W multiples of "
                         f"{codec.BLOCK}, got {cfg.height}x{cfg.width}")


def _f16_view(b: torch.Tensor) -> torch.Tensor:
    """The f16 values of a byte slice: a view, or a copy when the slice
    starts at an odd byte (odd H*W, or an odd row length in a batch)."""
    if b.storage_offset() % 2:
        b = b.clone()
    return b.view(torch.float16)


class _RowRead:
    """One row of a stacked pack read (a chain's, or the deferred packs
    of a batch): `done()`, `result()` as `Readback`'s."""

    __slots__ = ("_read", "_row")

    def __init__(self, read: Readback, row: int):
        self._read = read
        self._row = row

    def done(self) -> bool:
        return self._read.done()

    def result(self) -> np.ndarray:
        return self._read.result()[self._row]


def _make_host_pack(pose, vel_new, n_inl, n_mm, t_close, u_close, used_ref,
                    tcr, n_reacq, feat_mp):
    """One f32[27 + N] pack per frame: scalars followed by the frame's
    landmark assignments (exact in f32 below 2^24 points), so the host
    reads the frame's outcome in one transfer."""
    dev = pose.device
    scal = torch.stack([torch.as_tensor(v, device=dev).to(torch.float32)
                        for v in (n_inl, n_mm, t_close, u_close, used_ref)])
    return torch.cat([pose, vel_new, scal, tcr,
                      torch.as_tensor(n_reacq, device=dev).to(
                          torch.float32)[None],
                      feat_mp.to(torch.float32)])


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class Tracker:
    """Host-orchestrated RGB-D, stereo and mono tracking over device
    tensors."""

    def __init__(self, cfg: TrackerConfig, device=None):
        _check_wire(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        # K10's log8 table, on the tracker's device; the upload pool of
        # the `prefetch_*` entries, made at their first call
        self._log8_lut = (codec.log8_table(self.device)
                          if cfg.depth_encoding == "log8" else None)
        self._upload_pool: Optional[UploadPool] = None
        self._set_intrinsics()
        self.extractor = OrbExtractor(
            cfg.height, cfg.width, cfg.n_features, cfg.scale_factor,
            cfg.n_levels, cfg.ini_th_fast, cfg.min_th_fast,
            pattern=cfg.descriptor_pattern, device=self.device)
        self.sf, self.sigma2, self.inv_sigma2 = scale_factors(
            cfg.n_levels, cfg.scale_factor, device=self.device)
        # per-stage times of the keyframe path; in synchronous mode the
        # timer synchronizes the card at both ends of a stage, in pipelined
        # mode it reads the host clock only (a synchronization would drain
        # the frames in flight)
        self.timer = StageTimer(None if cfg.pipelined else self.device)
        # the host's wait in the step's one branch read (`use_ref.item()`),
        # a tracked frame, and the pumps that met a read not yet landed
        self.use_ref_waits: List[float] = []
        self.pumps_not_ready = 0
        if cfg.enable_local_ba:
            self.local_mapper = LocalMapper(
                self.cam, cfg.n_levels, cfg.scale_factor,
                ba_iters=cfg.local_ba_iters, cg_iters=cfg.local_ba_cg_iters,
                device=self.device)
        else:
            self.local_mapper = None
        self.last_ba_info = None
        # the BoW index (vocabulary + keyframe database): built at the
        # VOCAB_TRAIN_KFS-th keyframe, or injected with `set_vocabulary`
        self.loop_closer: Optional[LoopCloser] = None
        self.vocabulary = None
        self._vocab_pending: List[int] = []
        self.last_loop_info = None
        self.trajectory: List[np.ndarray] = []
        self.traj_entries: List[dict] = []
        self.track_info: List[dict] = []
        self.frame_id = 0
        # track-only mode (`SlamSystem.activate_localization_mode`): no
        # keyframe is made and no mapping job runs
        self.localization_only = False
        self.reset_map()

    def _set_intrinsics(self):
        """The camera model and what is built from it: the intrinsics, the
        distortion and the undistorted image bounds."""
        cfg = self.cfg
        self.cam = proj.CameraIntrinsics.create(cfg.fx, cfg.fy, cfg.cx,
                                                cfg.cy, cfg.bf)
        self._has_dist = any(float(c) != 0.0 for c in cfg.dist_coeffs)
        self.dist = proj.DistCoeffs.create(*cfg.dist_coeffs)
        if self._has_dist:
            self.image_bounds = proj.image_bounds_np(
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist_coeffs,
                cfg.width, cfg.height)
        else:
            self.image_bounds = (0.0, float(cfg.width), 0.0,
                                 float(cfg.height))

    def change_calibration(self, fx: float, fy: float, cx: float, cy: float,
                           bf: Optional[float] = None, dist_coeffs=None):
        """System::ChangeCalibration analog (`src/System.cc:869-875`): swap
        the camera model mid-session; the map and the trajectory survive.
        A half-done monocular initialization is dropped (its reference
        frame was taken under the old intrinsics); the mapping job's
        deferred products are drained, then the `LocalMapper` is rebuilt
        with the new camera, and the loop closer points at it."""
        cfg = self.cfg
        cfg.fx, cfg.fy, cfg.cx, cfg.cy = fx, fy, cx, cy
        self._mono_ref = None
        if bf is not None:
            cfg.bf = bf
        if dist_coeffs is not None:
            cfg.dist_coeffs = tuple(dist_coeffs)
        self._set_intrinsics()
        if self.local_mapper is not None:
            self._finalize_map()
            self.local_mapper = LocalMapper(
                self.cam, cfg.n_levels, cfg.scale_factor,
                ba_iters=cfg.local_ba_iters, cg_iters=cfg.local_ba_cg_iters,
                device=self.device)
        if self.loop_closer is not None:
            self.loop_closer.cam = self.cam

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    def _prepare_impl(self, img, depth_img) -> FrameData:
        """Extract ORB + associate depth (ComputeStereoFromRGBD analog):
        depth sampled at the raw keypoint, u_right from the undistorted x."""
        cfg = self.cfg
        depth_img = depth_img.to(torch.float32)
        feats = self.extractor(img)
        xi = torch.clamp(torch.round(feats.xy[:, 0]).long(), 0, cfg.width - 1)
        yi = torch.clamp(torch.round(feats.xy[:, 1]).long(), 0, cfg.height - 1)
        s = cfg.depth_subsample
        if s > 1:  # depth arrives subsampled s x s
            d = depth_img[torch.clamp(yi // s, max=depth_img.shape[0] - 1),
                          torch.clamp(xi // s, max=depth_img.shape[1] - 1)]
        else:
            d = depth_img[yi, xi]
        has_d = d > 1e-3
        xy_und = (proj.undistort_points(self.cam, self.dist, feats.xy)
                  if self._has_dist else feats.xy)
        u_right = torch.where(
            has_d, xy_und[:, 0] - cfg.bf / torch.clamp(d, min=1e-3),
            torch.full_like(d, -1.0))
        return FrameData(
            xy=xy_und, xy_raw=feats.xy, level=feats.level, angle=feats.angle,
            response=feats.response, desc=feats.desc, u_right=u_right,
            depth=torch.where(has_d, d, torch.full_like(d, -1.0)),
            valid=feats.valid,
        )

    def _prepare_stereo_impl(self, img_l, img_r) -> FrameData:
        """Left and right extraction (two calls each of K8, K2, K9 and K3)
        and the stereo association on the extractor's own pyramids (K8's
        levels; K1 under the
        dense stereo gate, then one launch of kernel B9 for the rest). The
        pair is assumed rectified: with distortion coefficients the left
        keypoints are undistorted, and u_right stays in the raw rectified
        frame."""
        cfg = self.cfg
        lf, pyr_l = self.extractor._extract_impl_pyr(img_l)
        rf, pyr_r = self.extractor._extract_impl_pyr(img_r)
        u_right, depth, _ = stereo_associate(
            pyr_l, pyr_r, lf.xy, lf.level, lf.desc, lf.valid, rf.xy,
            rf.level, rf.desc, rf.valid, self.sf, cfg.bf,
            min_z=cfg.bf / cfg.fx)
        xy_und = (proj.undistort_points(self.cam, self.dist, lf.xy)
                  if self._has_dist else lf.xy)
        return FrameData(
            xy=xy_und, xy_raw=lf.xy, level=lf.level, angle=lf.angle,
            response=lf.response, desc=lf.desc, u_right=u_right, depth=depth,
            valid=lf.valid,
        )

    def _prepare_mono_impl(self, img) -> FrameData:
        """Extract ORB (one K8, K2, K9 and K3 call each); no depth and no
        right coordinate (-1)."""
        feats = self.extractor(img)
        xy_und = (proj.undistort_points(self.cam, self.dist, feats.xy)
                  if self._has_dist else feats.xy)
        neg = torch.full_like(feats.xy[:, 0], -1.0)
        return FrameData(
            xy=xy_und, xy_raw=feats.xy, level=feats.level, angle=feats.angle,
            response=feats.response, desc=feats.desc, u_right=neg,
            depth=neg.clone(), valid=feats.valid,
        )

    def _mono_match_impl(self, curr: FrameData, ref: FrameData):
        """SearchForInitialization (`src/ORBmatcher.cc:614`): descriptor
        matching inside a 100 px window (K1's dense pair gate, both ways)
        with rotation consistency. Returns (idx i32[N] into `curr` per
        `ref` feature, keep bool[N])."""
        d2 = torch.sum((ref.xy[:, None, :] - curr.xy[None, :, :]) ** 2, -1)
        win = d2 <= 100.0 ** 2
        mm = matching.match_descriptors(
            ref.desc, curr.desc, ref.valid, curr.valid, max_dist=50,
            nn_ratio=0.9, extra_mask=win)
        midx = torch.clamp(mm.idx, 0, curr.capacity - 1).long()
        keep = matching.rotation_consistency(
            ref.angle, torch.where(mm.idx >= 0, curr.angle[midx],
                                   torch.zeros_like(ref.angle)), mm.valid)
        return mm.idx, keep

    def _seam_stats(self, found_mask, mp_seen, fidx: int):
        """Count re-acquired old landmarks and advance the last-seen array."""
        gap = max(int(self.cfg.implicit_loop_min_gap), 1)
        old = found_mask & (mp_seen >= 0) & ((fidx - mp_seen) > gap)
        n_reacq = old.sum(dtype=torch.int32)
        mp_seen_new = torch.where(found_mask,
                                  torch.full_like(mp_seen, fidx), mp_seen)
        return n_reacq, mp_seen_new, fidx + 1

    def _track_impl(self, frame: FrameData, last: FrameData, last_mp,
                    m: MapArrays, pose_last, velocity, ref_kf: int,
                    fidx: int = 0, local_mask=None):
        cfg = self.cfg
        P = m.point_capacity
        N = frame.capacity
        dev = frame.xy.device
        pred = se3.compose(velocity, pose_last)

        # ---- 1a. motion-model matching against last frame's landmarks ----
        # (B6's feature mode gathers the last frame's map points itself)
        mm = matching.search_last_frame_mapped(
            frame.xy, frame.level, frame.desc, frame.valid, last.level,
            last.desc, last_mp, m.mp_pos, m.mp_valid, pred, self.cam,
            self.sf, radius=cfg.mm_radius)
        midx = torch.clamp(mm.idx, 0, N - 1).long()
        keep = matching.rotation_consistency(
            last.angle,
            torch.where(mm.idx >= 0, frame.angle[midx],
                        torch.zeros_like(last.angle)),
            mm.valid)
        n_mm = keep.sum(dtype=torch.int32)
        neg = torch.full((N,), INVALID, dtype=torch.int32, device=dev)
        feat_pt_mm = neg.scatter_reduce(
            0, midx, torch.where(keep, last_mp, torch.full_like(last_mp,
                                                                INVALID)),
            "amax", include_self=True)

        inv_s2_feat = self.inv_sigma2[frame.level.long()]
        has_mm = feat_pt_mm >= 0
        r1_mm = pose_optimize(
            pred, m.mp_pos[torch.clamp(feat_pt_mm, 0, P - 1).long()],
            frame.xy, frame.u_right, inv_s2_feat, has_mm, self.cam,
            rounds=min(cfg.pose_opt_rounds, 2),
            iters_per_round=cfg.pose_opt_iters)
        # the one branch of the step: a host wait (jax.lax.cond in JAX)
        t0 = time.perf_counter()
        use_ref = bool(((n_mm < cfg.min_matches_mm)
                        | (r1_mm.num_inliers < 10)).item())
        self.use_ref_waits.append(time.perf_counter() - t0)

        if use_ref:
            # ---- 1b. TrackReferenceKeyFrame fallback: descriptor match
            # against the reference keyframe's landmarks, Horn RANSAC seed,
            # LM over the RANSAC inliers ----
            ref_mp = m.kf_mp[ref_kf]
            ref_ok = ((ref_mp >= 0) & m.kf_feat_valid[ref_kf]
                      & m.mp_valid[torch.clamp(ref_mp, 0, P - 1).long()])
            mref = matching.match_descriptors(
                frame.desc, m.kf_desc[ref_kf], frame.valid, ref_ok,
                max_dist=50, nn_ratio=0.7)
            ridx = torch.clamp(mref.idx, 0, ref_mp.shape[0] - 1).long()
            keep_ref = matching.rotation_consistency(
                frame.angle,
                torch.where(mref.idx >= 0, m.kf_angle[ref_kf][ridx],
                            torch.zeros_like(frame.angle)),
                mref.valid)
            feat_pt_ref = torch.where(keep_ref, ref_mp[ridx], neg)
            has_ref = feat_pt_ref >= 0
            pts_ref = m.mp_pos[torch.clamp(feat_pt_ref, 0, P - 1).long()]
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(fidx))
            if cfg.bf > 0:
                # 3D-3D Horn on the unprojected depth (planar-safe)
                xc_cur = proj.unproject(self.cam, frame.xy,
                                        torch.clamp(frame.depth, min=1e-3))
                ok3d = has_ref & (frame.depth > 0)
                res = horn_ransac(pts_ref, xc_cur, ok3d, gen,
                                  with_scale=False, inlier_th=0.05,
                                  min_inliers=10)
            else:
                res = pnp_ransac(pts_ref, frame.xy, has_ref, self.cam, gen,
                                 n_iters=256, sample_size=8)
            pose_seed = torch.where(res.success, res.pose, pose_last)
            seed_ok = torch.where(res.success, res.inliers & has_ref, has_ref)
            r = pose_optimize(
                pose_seed, pts_ref, frame.xy, frame.u_right, inv_s2_feat,
                seed_ok, self.cam, rounds=cfg.pose_opt_rounds,
                iters_per_round=cfg.pose_opt_iters)
            pose1, inl1, feat_pt0 = r.pose, r.inliers, feat_pt_ref
        else:
            pose1, inl1, feat_pt0 = r1_mm.pose, r1_mm.inliers, feat_pt_mm

        # ---- 2. whole-map projection matching (local-map tracking) ----
        taken = (feat_pt0 >= 0) & inl1
        feat_mp = torch.where(taken, feat_pt0, neg)
        # the covisibility window (all ones unless local_map_window > 0)
        mp_ok = m.mp_valid if local_mask is None else m.mp_valid & local_mask
        lm, pt_vis = matching.search_by_projection_with_vis(
            frame.xy, frame.level, frame.desc, frame.valid & ~taken,
            m.mp_pos, m.mp_desc, m.mp_normal, m.mp_min_dist, m.mp_max_dist,
            mp_ok, pose1, self.cam, self.sf,
            radius=10.0 if use_ref else cfg.local_radius,
            image_bounds=self.image_bounds)
        pidx = torch.clamp(lm.idx, 0, N - 1).long()
        feat_mp = feat_mp.scatter_reduce(
            0, pidx, torch.where(lm.valid, torch.arange(
                P, dtype=torch.int32, device=dev), torch.full_like(lm.idx,
                                                                   INVALID)),
            "amax", include_self=True)

        # ---- 3. final pose refinement over every assigned landmark ----
        has_mp = feat_mp >= 0
        pts = m.mp_pos[torch.clamp(feat_mp, 0, P - 1).long()]
        r2 = pose_optimize(
            pose1, pts, frame.xy, frame.u_right, inv_s2_feat, has_mp,
            self.cam, rounds=cfg.pose_opt_rounds,
            iters_per_round=cfg.pose_opt_iters)
        inl = r2.inliers & has_mp
        feat_mp_final = torch.where(inl, feat_mp, neg)

        # ---- 4. stats for the keyframe decision ----
        close = (frame.depth > 0) & (frame.depth < (cfg.bf / cfg.fx)
                                     * cfg.th_depth)
        tracked_close = (inl & close).sum(dtype=torch.int32)
        untracked_close = (close & ~inl & frame.valid).sum(dtype=torch.int32)
        found = torch.zeros((P,), dtype=torch.int32, device=dev).scatter_reduce(
            0, torch.clamp(feat_mp_final, 0, P - 1).long(),
            (feat_mp_final >= 0).to(torch.int32), "amax", include_self=True)
        found_mask = found > 0
        vis_mask = pt_vis | found_mask
        tcr = se3.compose(r2.pose, se3.inverse(m.kf_pose[ref_kf]))
        return (r2.pose, feat_mp_final, r2.num_inliers, n_mm, tracked_close,
                untracked_close, int(use_ref), found_mask, vis_mask, tcr)

    def _step_impl(self, img, depth_img, last: FrameData, last_mp,
                   m: MapArrays, pose_last, velocity, ref_kf: int, mp_vis,
                   mp_found, mp_seen, fidx: int, local_mask=None):
        """Fused per-frame step: extract + depth-associate + track, the
        whole-map search restricted to `local_mask` (the covisibility
        window; None: every live map point)."""
        return self._step_frame(self._prepare_impl(img, depth_img), last,
                                last_mp, m, pose_last, velocity, ref_kf,
                                mp_vis, mp_found, mp_seen, fidx, local_mask)

    def _step_stereo_impl(self, img_l, img_r, last: FrameData, last_mp,
                          m: MapArrays, pose_last, velocity, ref_kf: int,
                          mp_vis, mp_found, mp_seen, fidx: int,
                          local_mask=None):
        """Fused stereo step: extract both images + stereo-associate +
        track; returns what `_step_impl` returns."""
        return self._step_frame(self._prepare_stereo_impl(img_l, img_r),
                                last, last_mp, m, pose_last, velocity, ref_kf,
                                mp_vis, mp_found, mp_seen, fidx, local_mask)

    def _step_frame(self, frame: FrameData, last: FrameData, last_mp,
                    m: MapArrays, pose_last, velocity, ref_kf: int, mp_vis,
                    mp_found, mp_seen, fidx: int, local_mask=None):
        """Track a prepared frame: `_track_impl`, the seam statistics and
        the host pack."""
        (pose, feat_mp, n_inl, n_mm, t_close, u_close, used_ref,
         found_mask, vis_mask, tcr) = self._track_impl(
            frame, last, last_mp, m, pose_last, velocity, ref_kf, fidx,
            local_mask)
        vel_new = se3.compose(pose, se3.inverse(pose_last))
        n_reacq, mp_seen, fidx = self._seam_stats(found_mask, mp_seen, fidx)
        host_pack = _make_host_pack(pose, vel_new, n_inl, n_mm, t_close,
                                    u_close, used_ref, tcr, n_reacq, feat_mp)
        return (frame, pose, vel_new, feat_mp, host_pack,
                mp_vis + vis_mask.to(mp_vis.dtype),
                mp_found + found_mask.to(mp_found.dtype), mp_seen, fidx)

    def _insert_kf_impl(self, m: MapArrays, slot: int, frame: FrameData,
                        pose, feat_mp, new_slots):
        """Write a keyframe + newly unprojected landmarks into `m` (in
        place). new_slots: i32[N] target point slot per feature (-1 = none;
        slots >= P are dropped, never clamped)."""
        m.kf_pose[slot] = pose
        m.kf_valid[slot] = True
        m.kf_xy[slot] = frame.xy
        m.kf_level[slot] = frame.level
        m.kf_angle[slot] = frame.angle
        m.kf_desc[slot] = frame.desc
        m.kf_uright[slot] = frame.u_right
        m.kf_depth[slot] = frame.depth
        m.kf_feat_valid[slot] = frame.valid
        create = new_slots >= 0
        xc = proj.unproject(self.cam, frame.xy,
                            torch.clamp(frame.depth, min=1e-3))
        pose_wc = se3.inverse(pose)
        xw = se3.transform(pose_wc, xc)
        view = xw - se3.translation(pose_wc)[None, :]
        dist = torch.sqrt(torch.sum(view * view, dim=-1))
        max_dist = dist * self.sf[frame.level.long()]
        min_dist = max_dist / self.sf[-1]
        P = m.point_capacity
        # rows that create nothing, and out-of-range targets, are dropped
        # (never clamped): they write to one scratch row past the end
        keep = create & (new_slots < P)
        tgt = torch.where(keep, new_slots, torch.full_like(new_slots, P)).long()
        normal = view / torch.clamp(dist, min=1e-6)[:, None]
        for field, val in ((m.mp_pos, xw), (m.mp_desc, frame.desc),
                           (m.mp_normal, normal), (m.mp_min_dist, min_dist),
                           (m.mp_max_dist, max_dist),
                           (m.mp_valid, torch.ones_like(create))):
            ext = torch.cat([field, field[:1]])
            ext[tgt] = val.to(field.dtype)
            field.copy_(ext[:P])
        all_mp = torch.where(create, new_slots, feat_mp).to(torch.int32)
        m.kf_mp[slot] = all_mp
        return m, torch.stack([all_mp, frame.level.to(torch.int32)])

    def _insert_kf_auto_impl(self, m: MapArrays, slot: int, frame: FrameData,
                             pose, feat_mp, slot_buf, n_avail: int):
        """Keyframe insert with on-device new-point selection: candidates
        (valid, close depth, unassigned) ranked by depth with a stable sort,
        the first `n_avail` mapped onto `slot_buf` in feature order."""
        cfg = self.cfg
        close_th = (cfg.bf / cfg.fx) * cfg.th_depth
        cand = (frame.valid & (frame.depth > 0) & (frame.depth < close_th)
                & (feat_mp < 0))
        n = frame.capacity
        max_new = slot_buf.shape[0]
        depth_key = torch.where(cand, frame.depth,
                                torch.full_like(frame.depth, float("inf")))
        order = torch.sort(depth_key, stable=True).indices
        rank = torch.zeros((n,), dtype=torch.int32,
                           device=order.device).scatter_(
            0, order, torch.arange(n, dtype=torch.int32, device=order.device))
        create = cand & (rank < min(n_avail, max_new))
        buf_idx = torch.cumsum(create.to(torch.int32), 0) - 1
        new_slots = torch.where(
            create, slot_buf[torch.clamp(buf_idx, 0, max_new - 1).long()],
            torch.full_like(slot_buf[:1].expand(n), INVALID)).to(torch.int32)
        m, packed = self._insert_kf_impl(m, slot, frame, pose, feat_mp,
                                         new_slots)
        pack3 = torch.cat([packed, create.to(torch.int32)[None, :]], dim=0)
        return m, packed[0], pack3

    def _reloc_match_impl(self, frame: FrameData, m: MapArrays, kf: int):
        """Frame <-> keyframe descriptor matching yielding 2D-3D pairs
        (SearchByBoW KF <-> Frame, `src/ORBmatcher.cc:452`): K1 both ways."""
        P = m.point_capacity
        mp = m.kf_mp[kf]
        ok_b = (mp >= 0) & m.kf_feat_valid[kf] & m.mp_valid[
            torch.clamp(mp, 0, P - 1).long()]
        mm = matching.match_descriptors(
            frame.desc, m.kf_desc[kf], frame.valid, ok_b,
            max_dist=50, nn_ratio=0.75)
        midx = torch.clamp(mm.idx, 0, mp.shape[0] - 1).long()
        feat_pt = torch.where(mm.valid, mp[midx], torch.full_like(mm.idx,
                                                                 INVALID))
        pts3d = m.mp_pos[torch.clamp(feat_pt, 0, P - 1).long()]
        return pts3d, feat_pt, mm.valid

    def _reloc_solve_impl(self, frame: FrameData, pts3d, valid, seed: int):
        """RANSAC seed and pose LM of one relocalization candidate: 3D-3D
        Horn RANSAC on the unprojected depth (planar-safe) or, in mono,
        planar-safe PnP RANSAC (the reference's EPnP, `src/Tracking.cc:
        349-441`), then K4 over its inliers. `seed` varies the hypotheses
        per frame and candidate."""
        dev = frame.xy.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if self.cfg.bf > 0:
            xc = proj.unproject(self.cam, frame.xy,
                                torch.clamp(frame.depth, min=1e-3))
            ok3 = valid & (frame.depth > 0)
            res = horn_ransac(pts3d, xc, ok3, gen, with_scale=False,
                              inlier_th=0.05, min_inliers=10)
        else:
            res = pnp_ransac(pts3d, frame.xy, valid, self.cam, gen,
                             n_iters=256, sample_size=8)
        seed_ok = torch.where(res.success, res.inliers & valid, valid)
        r = pose_optimize(
            torch.where(res.success, res.pose, se3.identity(device=dev)),
            pts3d, frame.xy, frame.u_right,
            self.inv_sigma2[frame.level.long()], seed_ok, self.cam)
        return res.success, r.pose, r.inliers, r.num_inliers

    def _reloc_polish_impl(self, frame: FrameData, m: MapArrays, pose):
        """Projection-guided matching (radius 10, K1) around the coarse pose
        and the full pose LM (K4): the reference's second-chance search,
        `src/Tracking.cc:399-441`."""
        cfg = self.cfg
        P = m.point_capacity
        N = frame.capacity
        lm, _ = matching.search_by_projection_with_vis(
            frame.xy, frame.level, frame.desc, frame.valid,
            m.mp_pos, m.mp_desc, m.mp_normal, m.mp_min_dist, m.mp_max_dist,
            m.mp_valid, pose, self.cam, self.sf,
            radius=10.0, image_bounds=self.image_bounds)
        pidx = torch.clamp(lm.idx, 0, N - 1).long()
        neg = torch.full((N,), INVALID, dtype=torch.int32,
                         device=frame.xy.device)
        feat_mp = neg.scatter_reduce(
            0, pidx, torch.where(lm.valid, torch.arange(
                P, dtype=torch.int32, device=neg.device),
                torch.full_like(lm.idx, INVALID)),
            "amax", include_self=True)
        has = feat_mp >= 0
        r = pose_optimize(
            pose, m.mp_pos[torch.clamp(feat_mp, 0, P - 1).long()],
            frame.xy, frame.u_right, self.inv_sigma2[frame.level.long()],
            has, self.cam, rounds=cfg.pose_opt_rounds,
            iters_per_round=cfg.pose_opt_iters)
        feat_final = torch.where(r.inliers & has, feat_mp, neg)
        return r.pose, feat_final, r.num_inliers

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    # ------------------------------------------------------------------
    # the packed wire: one upload a frame (or a [k, B] batch), unpacked on
    # the device (JAX `_unpack_impl`, `_unpack_stereo_impl`)
    # ------------------------------------------------------------------

    def _unpack_rows(self, buf: torch.Tensor):
        """The (image, depth) of each row of a [k, B] packed RGB-D buffer:
        the raw image a uint8 view, f16 depth a float16 view (cast in
        `_prepare_impl`); a DCT image and log8 depth decoded by ONE K10
        launch for all rows on the card, by `wire_unpack_plain` on the
        CPU."""
        cfg = self.cfg
        buf = self._ready(buf)
        H, W = cfg.height, cfg.width
        h, w = _packed_depth_hw(cfg)
        ib = _packed_img_nbytes(cfg)
        dct = cfg.image_encoding == "dct"
        log8 = cfg.depth_encoding == "log8"
        if buf.dim() != 2 or buf.dtype != torch.uint8 \
                or buf.shape[1] != packed_rgbd_nbytes(cfg):
            raise ValueError(f"a packed RGB-D batch is uint8 [k, "
                             f"{packed_rgbd_nbytes(cfg)}], got {buf.dtype} "
                             f"{tuple(buf.shape)}")
        img = dep = None
        if dct or log8:
            sections = wire_sections(cfg)
            if self.device.type == "cpu":
                img, dep = codec.wire_unpack_plain(buf, *sections)
            else:
                img, dep = codec.wire_unpack(buf, *sections, self._log8_lut)
        rows = []
        for r in range(buf.shape[0]):
            im = img[r] if dct else buf[r, :ib].view(H, W)
            de = (dep[r] if log8
                  else _f16_view(buf[r, ib:ib + 2 * h * w]).view(h, w))
            rows.append((im, de))
        return rows

    def _ready(self, buf: torch.Tensor) -> torch.Tensor:
        """`buf` usable on the tracker's stream (`ready`). A buffer on
        another device raises: a card tracker never decodes on the host,
        nor steps on an image that lies elsewhere."""
        d = buf.device
        if d.type != self.device.type or (
                self.device.index is not None and d.index != self.device.index):
            raise ValueError(f"a packed buffer on {d}; the tracker runs on "
                             f"{self.device}")
        return ready(buf)

    def _unpack(self, buf: torch.Tensor):
        """(image, depth) of one packed RGB-D buffer ([B])."""
        return self._unpack_rows(buf.reshape(1, -1))[0]

    def _unpack_stereo(self, buf: torch.Tensor):
        """(left, right) of one packed stereo buffer: uint8 views, or both
        DCT images decoded by one K10 launch (the plain decode on the
        CPU)."""
        cfg = self.cfg
        buf = self._ready(buf)
        H, W = cfg.height, cfg.width
        ib = _packed_img_nbytes(cfg)
        if buf.dtype != torch.uint8 or buf.numel() != 2 * ib:
            raise ValueError(f"a packed stereo pair is uint8 [{2 * ib}], got "
                             f"{buf.dtype} {tuple(buf.shape)}")
        rows = buf.reshape(2, ib)
        if cfg.image_encoding != "dct":
            return rows[0].view(H, W), rows[1].view(H, W)
        unpack = (codec.wire_unpack_plain if self.device.type == "cpu"
                  else codec.wire_unpack)
        img, _ = unpack(rows, (0, H, W), None)
        return img[0], img[1]

    def _upload(self, packed: np.ndarray) -> torch.Tensor:
        """One synchronous upload of packed bytes from the calling thread."""
        return torch.from_numpy(packed).to(self.device)

    def _pool(self) -> UploadPool:
        if self._upload_pool is None:
            self._upload_pool = UploadPool(self.device)
        return self._upload_pool

    def _step_args(self):
        """The tracker's device state a step reads, after the frame."""
        return (self.last_frame, self.last_mp_dev, self.map, self.pose_dev,
                self.velocity_dev, max(self.ref_kf, 0), self.mp_vis_dev,
                self.mp_found_dev, self.mp_seen_dev, self.fidx,
                self.local_mask_dev)

    def track_rgbd(self, img, depth, timestamp: float = 0.0):
        """Process one RGB-D frame (gray or RGB image, depth in metres);
        returns the world->camera pose f32[7]. The frame is packed as the
        JAX package's `_pack_rgbd` packs it (`pack_rgbd`), uploaded in one
        copy and tracked by `track_rgbd_uploaded`."""
        return self.track_rgbd_uploaded(
            self._upload(pack_rgbd(self.cfg, img, depth)), timestamp)

    def prefetch_rgbd(self, imgs, depths):
        """Pack and upload frames on the upload pool; one Future a frame,
        resolving to its packed buffer on the device, for
        `track_rgbd_uploaded` (JAX `prefetch_rgbd`)."""
        n = packed_rgbd_nbytes(self.cfg)
        return [self._pool().submit(
            (n,), lambda out, i=i: pack_rgbd(self.cfg, imgs[i], depths[i],
                                             out=out))
            for i in range(len(imgs))]

    def prefetch_rgbd_batches(self, imgs, depths, k: int):
        """Like `prefetch_rgbd`, k frames a transfer: one Future a batch,
        resolving to a [k, B] buffer for `track_rgbd_batch(uploaded=)`."""
        n = packed_rgbd_nbytes(self.cfg)

        def fill(out, s):
            for r in range(out.shape[0]):
                pack_rgbd(self.cfg, imgs[s + r], depths[s + r], out=out[r])

        return [self._pool().submit(
            (min(s + k, len(imgs)) - s, n), lambda out, s=s: fill(out, s))
            for s in range(0, len(imgs), k)]

    def upload_rgbd_batch(self, imgs, depths) -> torch.Tensor:
        """Pack k RGB-D frames and upload them as ONE [k, B] transfer from
        the calling thread, for `track_rgbd_batch(uploaded=)`."""
        return self._upload(np.stack([pack_rgbd(self.cfg, i, d)
                                      for i, d in zip(imgs, depths)]))

    def track_rgbd_uploaded(self, buf, timestamp: float = 0.0):
        """Track one RGB-D frame from its packed buffer on the device (see
        `prefetch_rgbd`): the same step as `track_rgbd`, on the unpacked
        tensors."""
        img, dep = self._unpack(buf)
        return self._run_frame(
            lambda: self._prepare_impl(img, dep),
            lambda: self._step_impl(img, dep, *self._step_args()),
            timestamp)

    def track_rgbd_pair_uploaded(self, buf_a, buf_b, ts_a: float = 0.0,
                                 ts_b: float = 0.0):
        """Track two RGB-D frames through the fused step (`_stepk`, k = 2):
        one stacked pack read for both. Outside pipelined OK state each
        goes through `track_rgbd_uploaded`. Near-equivalent to per-frame
        stepping: frame b sees the map at most one finalize staler."""
        return self.track_rgbd_chain_uploaded([buf_a, buf_b], [ts_a, ts_b])

    def track_rgbd_chain_uploaded(self, bufs, timestamps=None):
        """Track k RGB-D frames through the chained step (`_stepk`): one
        stacked k-row pack read. Outside pipelined OK state (or for k < 2)
        each goes through `track_rgbd_uploaded`. The map the chain sees is
        up to k-1 finalizes staler (keep k <= pipeline_depth)."""
        k = len(bufs)
        timestamps = [0.0] * k if timestamps is None else list(timestamps)
        if not (self.cfg.pipelined and self.state == TrackState.OK
                and k >= 2):
            for b, ts in zip(bufs, timestamps):
                self.track_rgbd_uploaded(b, ts)
            return self.pose
        return self._run_chain([self._unpack(b) for b in bufs], timestamps)

    def track_rgbd_batch(self, imgs, depths, timestamps=None, uploaded=None,
                         paired: bool = False, mode: int = 0):
        """Track k RGB-D frames from one [k, B] upload (`upload_rgbd_batch`
        of `imgs` and `depths`, or `uploaded`, e.g. from
        `prefetch_rgbd_batches`), decoded by one K10 launch. `mode` frames
        a step (1: per frame; 2: fused pairs; 4: chained quads, then pairs,
        then single frames for the tail, in pipelined OK state);
        `paired=True` is mode 2. Per-frame stepping is `track_rgbd`'s, and
        with `TPU_SLAM_DEFER_PACKS` set (pipelined, k <= pipeline_depth)
        its pack reads become one stacked read for the batch. Returns a
        pose a frame; a fused step reports its last frame's pose for each
        of its frames."""
        k = len(imgs) if imgs is not None else int(uploaded.shape[0])
        timestamps = [0.0] * k if timestamps is None else list(timestamps)
        batch = (self.upload_rgbd_batch(imgs, depths) if uploaded is None
                 else uploaded)
        rows = self._unpack_rows(batch)
        cfg = self.cfg
        defer = (cfg.pipelined and k <= max(int(cfg.pipeline_depth), 1)
                 and bool(os.environ.get("TPU_SLAM_DEFER_PACKS")))
        mode = mode or (2 if paired else 1)

        def fused_ok():
            return cfg.pipelined and self.state == TrackState.OK

        def one(j, defer_fetch=False):
            img, dep = rows[j]
            return self._run_frame(
                lambda: self._prepare_impl(img, dep),
                lambda: self._step_impl(img, dep, *self._step_args()),
                timestamps[j], defer_fetch=defer_fetch)

        poses = []
        if mode >= 2:
            i = 0
            while mode >= 4 and i + 3 < k and fused_ok():
                self._run_chain(rows[i:i + 4], timestamps[i:i + 4])
                poses.extend([self.pose] * 4)
                i += 4
            while i + 1 < k and fused_ok():
                self._run_chain(rows[i:i + 2], timestamps[i:i + 2])
                poses.extend([self.pose] * 2)
                i += 2
            for j in range(i, k):
                poses.append(one(j))
            return poses
        for j in range(k):
            poses.append(one(j, defer_fetch=defer))
        if defer:
            self._flush_deferred_packs()
        return poses

    def track_stereo(self, img_l, img_r, timestamp: float = 0.0):
        """Process one rectified stereo pair (gray or RGB images); returns
        the world->camera pose f32[7]. The pair is packed as the JAX
        package's `_pack_stereo` packs it (`pack_stereo`), uploaded in one
        copy and tracked by `track_stereo_uploaded`."""
        return self.track_stereo_uploaded(
            self._upload(pack_stereo(self.cfg, img_l, img_r)), timestamp)

    def prefetch_stereo(self, imgs_l, imgs_r):
        """Pack and upload stereo pairs on the upload pool; one Future a
        pair (the stereo mirror of `prefetch_rgbd`)."""
        n = 2 * _packed_img_nbytes(self.cfg)
        return [self._pool().submit(
            (n,), lambda out, i=i: pack_stereo(self.cfg, imgs_l[i],
                                               imgs_r[i], out=out))
            for i in range(len(imgs_l))]

    def track_stereo_uploaded(self, buf, timestamp: float = 0.0):
        """Track one stereo pair from its packed buffer on the device."""
        left, right = self._unpack_stereo(buf)
        return self._run_frame(
            lambda: self._prepare_stereo_impl(left, right),
            lambda: self._step_stereo_impl(left, right, *self._step_args()),
            timestamp)

    def track_stereo_pair_uploaded(self, buf_a, buf_b, ts_a: float = 0.0,
                                   ts_b: float = 0.0):
        """The stereo mirror of `track_rgbd_pair_uploaded`."""
        return self.track_stereo_chain_uploaded([buf_a, buf_b], [ts_a, ts_b])

    def track_stereo_chain_uploaded(self, bufs, timestamps=None):
        """The stereo mirror of `track_rgbd_chain_uploaded`."""
        k = len(bufs)
        timestamps = [0.0] * k if timestamps is None else list(timestamps)
        if not (self.cfg.pipelined and self.state == TrackState.OK
                and k >= 2):
            for b, ts in zip(bufs, timestamps):
                self.track_stereo_uploaded(b, ts)
            return self.pose
        return self._run_chain([self._unpack_stereo(b) for b in bufs],
                               timestamps, stereo=True)

    def track_mono(self, img, timestamp: float = 0.0):
        """Process one monocular frame (gray or RGB image); returns the
        world->camera pose f32[7]. The image is rounded to uint8 gray
        (`pack_mono`: raw bytes under every `image_encoding`, as JAX's mono
        path sends them), uploaded and tracked by `track_mono_uploaded`."""
        return self.track_mono_uploaded(self._upload(pack_mono(img)),
                                        timestamp)

    def prefetch_mono(self, imgs):
        """Pack and upload mono frames on the upload pool; one Future a
        frame (the mirror of `prefetch_rgbd`)."""
        shape = (self.cfg.height, self.cfg.width)
        return [self._pool().submit(
            shape, lambda out, i=i: pack_mono(imgs[i], out=out))
            for i in range(len(imgs))]

    def track_mono_uploaded(self, img, timestamp: float = 0.0):
        """Track one mono frame from its uint8 image on the device. Until
        the map exists, each frame goes to `_initialize_mono`
        (`MonocularInitialization`, `src/Tracking.cc:1020-1185`)."""
        img = self._ready(img).reshape(self.cfg.height, self.cfg.width)
        return self._run_frame(
            lambda: self._prepare_mono_impl(img),
            lambda: self._mono_step(self._prepare_mono_impl(img)),
            timestamp, init_fn=self._initialize_mono)

    def _mono_step(self, frame: FrameData):
        """Track a prepared mono frame: `_step_frame` on the tracker's
        state."""
        return self._step_frame(
            frame, self.last_frame, self.last_mp_dev, self.map, self.pose_dev,
            self.velocity_dev, max(self.ref_kf, 0), self.mp_vis_dev,
            self.mp_found_dev, self.mp_seen_dev, self.fidx,
            self.local_mask_dev)

    def _record_frame(self, tcr=None, ref=-1, lost=False):
        """Append one trajectory slot: the track-time pose plus the
        reference-KF-relative record (ref slot, Tcr)."""
        self.trajectory.append(self.pose.copy())
        self.traj_entries.append({
            "ref": int(ref),
            "tcr": None if tcr is None else np.asarray(tcr, np.float32).copy(),
            "pose": self.pose.copy(),
            "lost": bool(lost),
        })

    def flush(self):
        """Drain the frames in flight, then every deferred mapping product
        (call before reading the trajectory or the map).

        The JAX tracker's `flush` completes the job and promises this drain
        in its docstring, but leaves the last window BA's outlier erasure
        for the next keyframe. Here it drains that too, so the map read
        after `flush` is final. The frame loop never calls `flush`, so the
        one-keyframe lag of the erasure is kept while tracking."""
        self._drain_queue()
        self._finalize_map()

    def _drain_queue(self):
        """Finalize every frame in flight, oldest first; a loss discards
        the rest."""
        q = self._pending_q
        while q:
            self._finalize_pending(q.pop(0))
            if self.state != TrackState.OK:
                break

    def _run_frame(self, prep_fn, step_fn, timestamp: float, init_fn=None,
                   defer_fetch: bool = False):
        """One frame: through the in-flight queue in pipelined OK state;
        otherwise (or synchronous) the queue and the mapping job are
        completed first, as JAX's `flush` does there."""
        if self.cfg.pipelined and self.state == TrackState.OK:
            return self._run_frame_pipelined(step_fn, timestamp,
                                              defer_fetch=defer_fetch)
        self._drain_queue()
        self._complete_mapping()
        if self.state == TrackState.NOT_INITIALIZED:
            frame = prep_fn()
            (init_fn or self._initialize)(frame, timestamp)
            ok = self.state == TrackState.OK
            self._record_frame(
                tcr=se3.identity().numpy() if ok else None,
                ref=self.ref_kf if ok else -1, lost=not ok)
            self.frame_id += 1
            return self.pose
        if self.state == TrackState.LOST:
            frame = prep_fn()
            if self._relocalize(frame):
                self.track_info.append({"reloc": True, "lost": False})
                self._record_frame(lost=False)  # absolute pose (no Tcr yet)
            else:
                self.track_info.append({"reloc": False, "lost": True})
                self._record_frame(lost=True)
            self.frame_id += 1
            return self.pose
        (frame, pose_dev, vel_dev, feat_mp_dev, host_pack,
         self.mp_vis_dev, self.mp_found_dev,
         self.mp_seen_dev, self.fidx) = step_fn()
        pack = Readback(host_pack).result()
        n_inl, n_mm = int(pack[14]), int(pack[15])
        tracked_close, untracked_close = int(pack[16]), int(pack[17])
        if n_inl < self.cfg.min_inliers_track:
            self.state = TrackState.LOST
            self._record_frame(lost=True)
            self.track_info.append({"inliers": n_inl, "lost": True})
            self._maybe_auto_reset()
            self.frame_id += 1
            return self.pose
        disp_ref = self.ref_kf
        self.pose = pack[0:7]
        self.velocity = pack[7:14]
        self.pose_dev, self.velocity_dev = pose_dev, vel_dev
        self.state = TrackState.OK
        self.frames_since_kf += 1
        need_kf = self._need_new_keyframe(n_inl, tracked_close,
                                          untracked_close)
        if self._seam_check(int(pack[26])):
            need_kf = True
        if need_kf:
            feat_np = pack[27:].astype(np.int32)
            slot = self._create_keyframe(frame, feat_np, timestamp,
                                         feat_mp_dev=feat_mp_dev)
            if slot < 0:  # capacity-frozen map: keep frame assignments
                self.last_mp_dev = feat_mp_dev
        else:
            self.last_mp_dev = feat_mp_dev
            self._maybe_refresh_local_mask()
        self.last_frame = frame
        self.track_info.append(
            {"inliers": n_inl, "mm": n_mm, "kf": bool(need_kf),
             "ref_fallback": bool(pack[18]), "lost": False})
        self._record_frame(tcr=pack[19:26], ref=disp_ref)
        self.frame_id += 1
        return self.pose

    # ------------------------------------------------------------------
    # pipelined mode: frame t is dispatched from frame t-1's device
    # outputs and its pack read while later frames are issued; the
    # keyframe decision for t lands `pipeline_depth` frames late (the
    # reference's mapping thread lags tracking too, src/System.cc:398-411)
    # ------------------------------------------------------------------

    def _run_frame_pipelined(self, step_fn, timestamp: float,
                             defer_fetch: bool = False):
        """Dispatch a frame from the previous frame's device state and queue
        its pack's read; with `defer_fetch` (a batch's per-frame steps) the
        raw pack is queued, and `_flush_deferred_packs` reads the batch's
        packs in one stacked read."""
        with self.timer.time("track.dispatch"):
            (frame, pose_dev, vel_dev, feat_mp_dev, host_pack,
             self.mp_vis_dev, self.mp_found_dev,
             self.mp_seen_dev, self.fidx) = step_fn()
        q = self._pending_q
        q.append((frame, feat_mp_dev,
                  host_pack if defer_fetch else Readback(host_pack),
                  timestamp, self.ref_kf))
        # the device-side tracking state advances at once
        self.pose_dev, self.velocity_dev = pose_dev, vel_dev
        self.last_frame = frame
        self.last_mp_dev = feat_mp_dev
        while len(q) > max(int(self.cfg.pipeline_depth), 1):
            with self.timer.time("track.finalize"):
                self._finalize_pending(q.pop(0))
            if self.state != TrackState.OK:
                break  # the loss emptied the queue
        # the mapping job advances between tracked frames
        self._pump_mapping()
        self.frame_id += 1
        return self.pose

    # ------------------------------------------------------------------
    # fused stepping: k frames stepped back to back from one map, one
    # reference keyframe and one covisibility window, their packs read in
    # one stacked read (JAX `_stepk_impl`, `_run_chain`, `_finish_chain`)
    # ------------------------------------------------------------------

    def _stepk(self, unpacked, stereo: bool = False):
        """k `_step_impl` (or `_step_stereo_impl`) calls, frame i+1 from
        frame i's outputs, with no finalize or pump between them; each
        step keeps its one `use_ref.item()` wait. Returns the k (frame,
        pose, velocity, landmarks), the stacked packs and the counters."""
        step = self._step_stereo_impl if stereo else self._step_impl
        (f, fmp, m, pose, vel, ref, mp_vis, mp_found, mp_seen, fidx,
         local_mask) = self._step_args()
        outs, packs = [], []
        for u in unpacked:
            (f, pose, vel, fmp, pack, mp_vis, mp_found, mp_seen,
             fidx) = step(*u, f, fmp, m, pose, vel, ref, mp_vis, mp_found,
                          mp_seen, fidx, local_mask)
            outs.append((f, pose, vel, fmp))
            packs.append(pack)
        return outs, torch.stack(packs), mp_vis, mp_found, mp_seen, fidx

    def _run_chain(self, unpacked, timestamps, stereo: bool = False):
        """Dispatch a chained step over the unpacked frames and queue all
        of them (`_finish_chain`)."""
        with self.timer.time("track.dispatch"):
            (outs, packs, self.mp_vis_dev, self.mp_found_dev,
             self.mp_seen_dev, self.fidx) = self._stepk(unpacked, stereo)
        return self._finish_chain(outs, packs, timestamps)

    def _finish_chain(self, outs, packs, timestamps):
        """The host epilogue of a fused step: one `Readback` of the stacked
        packs, k queue entries each reading its own row, then the per-frame
        epilogue k times (finalize past the depth, one pump, the frame
        counter), as JAX's."""
        read = Readback(packs)
        q = self._pending_q
        for i, (f, _, _, fmp) in enumerate(outs):
            q.append((f, fmp, _RowRead(read, i), timestamps[i],
                      self.ref_kf))
        f, pose, vel, fmp = outs[-1]
        self.pose_dev, self.velocity_dev = pose, vel
        self.last_frame = f
        self.last_mp_dev = fmp
        for _ in range(len(outs)):
            while len(q) > max(int(self.cfg.pipeline_depth), 1):
                with self.timer.time("track.finalize"):
                    self._finalize_pending(q.pop(0))
                if self.state != TrackState.OK:
                    break  # the loss emptied the queue
            self._pump_mapping()
            self.frame_id += 1
        return self.pose

    def _flush_deferred_packs(self):
        """Stack every still-raw pack in the queue into one tensor and one
        `Readback`; the entries get row reads. Partial batches and a queue
        a loss emptied need no special case."""
        q = self._pending_q
        raw = [i for i, e in enumerate(q) if isinstance(e[2], torch.Tensor)]
        if not raw:
            return
        read = Readback(torch.stack([q[i][2] for i in raw]))
        for row, i in enumerate(raw):
            e = q[i]
            q[i] = e[:2] + (_RowRead(read, row),) + e[3:]

    def _finalize_pending(self, pending):
        """Read a queued frame's pack and act on it: the loss check (which
        discards every frame still in flight), the pose, the keyframe
        decision and, for a keyframe, its creation with the newer frame's
        device state kept."""
        frame, feat_mp_dev, pack_read, ts, disp_ref = pending
        if isinstance(pack_read, torch.Tensor):  # a deferred pack
            pack_read = Readback(pack_read)
        pack = pack_read.result()
        n_inl = int(pack[14])
        if n_inl < self.cfg.min_inliers_track:
            self.state = TrackState.LOST
            self.pose_dev = self._t(self.pose)  # rewind the device state
            self.velocity_dev = self._t(se3.identity().numpy())
            self._record_frame(lost=True)
            self.track_info.append({"inliers": n_inl, "lost": True})
            # every frame still in flight was predicted from this state;
            # its result is discarded, but it keeps one trajectory slot
            # (the savers pair each entry with a timestamp)
            q = self._pending_q
            while q:
                q.pop(0)
                self._record_frame(lost=True)
                self.track_info.append(
                    {"inliers": 0, "lost": True, "discarded": True})
            self._maybe_auto_reset()
            return
        self.pose = pack[0:7]
        self.velocity = pack[7:14]
        self.frames_since_kf += 1
        need_kf = self._need_new_keyframe(n_inl, int(pack[16]),
                                          int(pack[17]))
        if self._seam_check(int(pack[26])):
            need_kf = True
        if need_kf:
            # the keyframe must not clobber the newer (in-flight) frame's
            # device state
            save = (self.last_frame, self.last_mp_dev, self.pose_dev,
                    self.velocity_dev)
            pose_np = self.pose.copy()
            self._create_keyframe(frame, pack[27:].astype(np.int32), ts,
                                  feat_mp_dev=feat_mp_dev)
            (self.last_frame, self.last_mp_dev, self.pose_dev,
             self.velocity_dev) = save
            self.pose = pose_np
        else:
            self._maybe_refresh_local_mask()
        self._record_frame(tcr=pack[19:26], ref=disp_ref)
        self.track_info.append(
            {"inliers": n_inl, "mm": int(pack[15]), "kf": bool(need_kf),
             "ref_fallback": bool(pack[18]), "lost": False})

    def sync_device(self):
        """A device barrier (JAX `sync_device`): waits for all the tracker
        queued on its device, the map's write chain and a pending global
        BA's poses, whose first row it reads."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        sinks = [self.map.kf_pose]
        if self._gba_pending is not None:
            sinks.append(self._gba_pending["gba_pose"])
        for t in sinks:
            Readback(t[:1]).result()

    def warm_stage_programs(self):
        """Build and load every kernel library of the port (those the
        tracker's stages launch among them), then `sync_device` (JAX's
        compiles every keyframe-stage program variant by no-op calls): no
        first use mid-run pays a build. Map, counters and trajectory are left as they were. A
        no-op on the CPU, where no kernel launches."""
        if self.device.type != "cuda":
            return
        kernels.build_all()
        for n in kernels.SOURCES:
            kernels.load(n)
        self.sync_device()

    def reset_map(self):
        """Discard the map and return to NOT_INITIALIZED, keeping the
        trajectory log (System/Tracking::Reset analog)."""
        cap = self.cfg.map_capacity
        P = cap.max_points
        self.map = empty_map(cap, self.device)
        self.graph = MapGraph(cap)
        if self.local_mapper is not None:
            self.local_mapper.clear_pending()
        self.mp_vis_dev = torch.zeros((P,), dtype=torch.int32,
                                      device=self.device)
        self.mp_found_dev = torch.zeros((P,), dtype=torch.int32,
                                        device=self.device)
        self.mp_seen_dev = torch.full((P,), -1, dtype=torch.int32,
                                      device=self.device)
        # the covisibility-window point mask (all ones: whole-map matching)
        self.local_mask_dev = torch.ones((P,), dtype=torch.bool,
                                         device=self.device)
        self.fidx = 0
        # seam-detection state must not survive into the new map: stale
        # last-seen stamps on reused point slots would read as long-gap
        # re-acquisitions
        self._seam_pending = False
        self._seam_cooldown_until = 0
        self._gba_pending = None
        # the mapping job in flight, (keyframe slot, stage), the keyframe
        # insert's read awaiting its drain, the dispatched loop detection
        # and the frames in flight
        self._map_job = None
        self._pending_insert = None
        self._loop_pending = None
        self._pending_q: List[tuple] = []
        if self.loop_closer is not None:
            self.loop_closer.db.clear()
            self.loop_closer.consistent_groups = []
        self.pose = se3.identity().numpy()
        self.velocity = se3.identity().numpy()
        self.pose_dev = self._t(self.pose)
        self.velocity_dev = self._t(self.velocity)
        self.last_frame: Optional[FrameData] = None
        self.last_mp_dev = None
        self.ref_kf = -1
        self.ref_kf_tracked = 0
        self._ref_mp_row = None
        self.frames_since_kf = 0
        # the monocular bootstrap's reference frame
        self._mono_ref: Optional[FrameData] = None
        self._mono_ref_ts = 0.0
        self.state = TrackState.NOT_INITIALIZED

    def _maybe_auto_reset(self) -> bool:
        """Auto-reset when tracking is lost with <= 5 keyframes in the map:
        a map that thin cannot support relocalization."""
        if len(self.graph.alive_kfs()) <= 5:
            self.reset_map()
            return True
        return False

    def _relocalize(self, frame: FrameData) -> bool:
        """BoW candidate retrieval, RANSAC and pose refinement
        (`Relocalizer::Relocalize`, `src/Tracking.cc:284-463`). Without a
        BoW index the tracker stays lost. On success the velocity becomes
        the identity; the reference keyframe and the keyframe interval are
        kept, as in the JAX tracker."""
        if self.loop_closer is None:
            return False
        db = self.loop_closer.db
        v, _ = db.compute_bow(frame.desc, frame.valid)
        # covisibility-group accumulated scores, shared-word 0.8 gate
        # (DetectRelocalizationCandidates, src/KeyFrameDatabase.cc:173-265),
        # no absolute score floor: there is no pose prior when lost
        cands = db.detect_candidates_grouped(
            v, exclude=set(), min_score=0.0, graph=self.graph,
            max_candidates=5)
        if not cands:  # degenerate BoW overlap: plain scoring
            cands = db.detect_candidates(v, exclude=set(), min_score=0.015,
                                         max_candidates=3)
        for kf in cands:
            pts3d, _, valid = self._reloc_match_impl(frame, self.map, kf)
            if int(valid.sum()) < 15:
                continue
            success, pose, _, n_inl = self._reloc_solve_impl(
                frame, pts3d, valid, self.frame_id * 31 + kf)
            ok, n_inl = torch.stack([success.to(torch.int32),
                                     n_inl.to(torch.int32)]).tolist()
            if not ok or n_inl < 20:
                continue
            pose, feat_final, n_inl2 = self._reloc_polish_impl(
                frame, self.map, pose)
            if int(n_inl2) < 20:
                continue
            self.pose = pose.cpu().numpy()
            self.pose_dev = self._t(self.pose)
            self.velocity = se3.identity().numpy()
            self.velocity_dev = self._t(self.velocity)
            self.last_frame = frame
            self.last_mp_dev = feat_final
            self.state = TrackState.OK
            return True
        return False

    def set_vocabulary(self, voc):
        """Inject a pre-trained vocabulary (the reference loads ORBvoc.txt,
        `src/System.cc:343`; training on live descriptors is the
        default)."""
        self.vocabulary = voc

    # keyframes whose descriptors accumulate before vocabulary training: a
    # single view's words alias badly; 4 views give the k-majority
    # clustering real appearance diversity
    VOCAB_TRAIN_KFS = 4

    def _ensure_bow_index(self, slot: int, train_kfs: int = 0):
        """Create the vocabulary and the BoW database once `train_kfs`
        (default VOCAB_TRAIN_KFS) keyframes have accumulated, and index
        keyframe `slot`. Returns its BoW row, or None while the vocabulary
        is warming up. Training reads the pending keyframes' descriptors
        once a session; indexing reads nothing back."""
        if self.loop_closer is None:
            pending = self._vocab_pending
            pending.append(slot)
            if self.vocabulary is None:
                if len(pending) < (train_kfs or self.VOCAB_TRAIN_KFS):
                    return None
                idx = self._t(np.asarray(pending, np.int64))
                kf_desc = self.map.kf_desc[idx].cpu().numpy()
                kf_val = self.map.kf_feat_valid[idx].cpu().numpy()
                desc = np.concatenate([kf_desc[i][kf_val[i]]
                                       for i in range(len(pending))])
                if len(desc) < 32:
                    return None
                self.vocabulary = train_vocabulary(
                    desc, n_words=min(self.cfg.vocab_words, len(desc)),
                    iters=6, device=self.device)
            # the Sim3 scale is observable only in monocular mode
            self.loop_closer = LoopCloser(
                self.vocabulary, self.cam, self.cfg.map_capacity.max_keyframes,
                self.cfg.n_levels, self.cfg.scale_factor,
                fix_scale=self.cfg.bf > 0)
            # index every pending keyframe still alive (the current one
            # below)
            for k in pending[:-1]:
                if self.graph.kf_alive[k]:
                    self.loop_closer.add_keyframe_bow(self.map, int(k))
            self._vocab_pending = []
        return self.loop_closer.add_keyframe_bow(self.map, slot)

    def force_bow_index(self) -> bool:
        """Train the vocabulary and build the BoW index now from every alive
        keyframe, without the VOCAB_TRAIN_KFS warm-up (`save_map` calls it,
        so that a short session's map can be relocalized into). True when
        an index exists afterwards."""
        if self.loop_closer is not None:
            return True
        alive = [int(k) for k in self.graph.alive_kfs()]
        if not alive:
            return False
        self._vocab_pending = list(alive[:-1])
        return self._ensure_bow_index(alive[-1], train_kfs=1) is not None

    def _ref_kf_tracked_points(self) -> int:
        """TrackedMapPoints(minObs) of the reference KF."""
        if self.ref_kf < 0 or self._ref_mp_row is None:
            return max(self.ref_kf_tracked, 1)
        min_obs = 2 if len(self.graph.alive_kfs()) > 2 else 1
        n = 0
        for pt in self._ref_mp_row:
            if (pt >= 0 and self.graph.pt_alive[pt]
                    and self.graph.n_obs(pt) >= min_obs):
                n += 1
        return max(n, 1)

    def _seam_check(self, n_reacq: int) -> bool:
        """Seam trigger: force a keyframe the moment tracking re-acquires a
        batch of long-unseen landmarks (`seam_min_reacq`, loop closing
        only). True when a keyframe should be forced this frame."""
        cfg = self.cfg
        if (cfg.seam_min_reacq <= 0 or not cfg.enable_loop_closing
                or self.loop_closer is None
                or n_reacq < cfg.seam_min_reacq):
            return False
        if self.frame_id < self._seam_cooldown_until:
            return False
        if (self.ref_kf >= 0 and self.graph.kf_seq[self.ref_kf]
                - self.loop_closer.last_loop_seq < 10):
            return False
        self._seam_cooldown_until = self.frame_id + 30
        self._seam_pending = True
        return True

    def _refresh_local_mask(self, center_slot: int):
        """Rebuild the covisibility-window point mask around `center_slot`
        (the reference's local map, `src/Tracking.cc:55-185`): the points
        of the keyframe and its `local_map_window` best covisibles."""
        P = self.cfg.map_capacity.max_points
        kfs = [center_slot] + self.graph.covis_neighbors(
            center_slot, top_k=self.cfg.local_map_window)
        mask = np.zeros(P, bool)
        rows = self.graph.kf_row[kfs]
        mask[rows[rows >= 0]] = True
        self.local_mask_dev = self._t(mask)

    def _maybe_refresh_local_mask(self):
        """Between keyframes, rebuild the window mask around the reference
        keyframe every 8 frames (long keyframe intervals age it)."""
        if (self.cfg.local_map_window > 0 and self.ref_kf >= 0
                and self.frames_since_kf > 0
                and self.frames_since_kf % 8 == 0):
            self._refresh_local_mask(self.ref_kf)

    # ------------------------------------------------------------------
    # the loop stage
    # ------------------------------------------------------------------

    def _loop_closing_stage(self, frame: FrameData, slot: int):
        bow = self._ensure_bow_index(slot)
        if bow is None or not self.cfg.enable_loop_closing:
            return
        loop_kf = self.loop_closer.detect(self.map, self.graph, slot, bow)
        if loop_kf is None:
            return
        self._close_loop(frame, slot, loop_kf)

    def _implicit_loop_candidate(self, slot: int,
                                 min_weight: int = 15) -> Optional[int]:
        """A silent re-acquisition: a strong covisibility edge from the new
        keyframe to a keyframe more than `implicit_loop_min_gap` frames
        older that the previous keyframe's context was not connected to.
        Whole-map matching makes such edges on revisits under moderate
        drift; the drifted middle of the chain stays uncorrected, which is
        what the loop edge and the global BA repair."""
        g = self.graph
        gap = self.cfg.implicit_loop_min_gap
        lc = self.loop_closer
        if (gap <= 0 or lc is None
                or g.kf_seq[slot] - lc.last_loop_seq < 10):
            return None
        if len(g.alive_kfs()) < 10:
            return None
        fid = g.kf_frame_id
        cur = fid[slot]
        nbs = g.covis_neighbors(slot, min_weight=min_weight, top_k=30)
        old = [n for n in nbs if cur - fid[n] > gap]
        if not old:
            return None
        # the previous (temporal) keyframe: if its context already held the
        # old region, the camera lingered; no revisit
        prev, best_fid = None, -1
        for k in g.alive_kfs():
            if k != slot and best_fid < fid[k] < cur:
                prev, best_fid = k, fid[k]
        if prev is None:
            return None
        prev_ctx = set(g.covis_neighbors(prev, top_k=30)) | {prev}
        for n in old:
            if n not in prev_ctx:
                return int(n)
        return None

    def _close_loop(self, frame: FrameData, slot: int, loop_kf: int,
                    implicit: bool = False):
        """The Sim3, its verification and the loop correction of a detected
        candidate (FindLoopInCandidateKFs + LoopCorrector::Correct,
        `src/LoopClosing.cc:62-155,521-692`), inline (the reference stalls
        mapping for the correction too, `:532-544`).

        `implicit`: whole-map matching already aligned this keyframe to the
        revisited region, so the relative Sim3 is the tracked relative pose
        at scale 1; after a strict projection check (25 matches) only the
        loop edge and a global BA follow."""
        lc = self.loop_closer
        if implicit:
            kf_poses = self.map.kf_pose.cpu().numpy()
            rel = _np_compose(kf_poses[slot], _np_inverse(kf_poses[loop_kf]))
            S = sim3.from_se3(self._t(rel))
            ok, n_proj = lc.verify_by_projection(
                self.map, self.graph, slot, loop_kf, S, min_matches=25)
            if not ok:
                return
            self.graph.loop_edges.setdefault(slot, set()).add(loop_kf)
            self.graph.loop_edges.setdefault(loop_kf, set()).add(slot)
            self._gba_pending = lc.launch_gba(self.map, self.graph)
            lc.last_loop_kf = slot
            lc.last_loop_seq = int(self.graph.kf_seq[slot])
            lc.loops_closed += 1
            self.last_loop_info = {"loop_kf": loop_kf, "kf": slot,
                                   "implicit": True, "n_proj": int(n_proj)}
            return
        out = lc.compute_sim3(self.map, slot, loop_kf, slot)
        if out is None:
            return
        S, inl, pt_a, pt_b = out
        ok, _ = lc.verify_by_projection(self.map, self.graph, slot, loop_kf,
                                        S)
        if not ok:
            return
        self.map, info = lc.correct(self.map, self.graph, slot, loop_kf, S,
                                    inl, pt_a, pt_b)
        self._gba_pending = info.pop("gba_pending", None)
        self.last_loop_info = {"loop_kf": loop_kf, "kf": slot, **info}
        # pipelined mode keeps the in-flight frames' device state: their
        # predictions predate the correction, and tracking re-acquires
        # against the corrected map
        if not self.cfg.pipelined:
            self.pose_dev = self.map.kf_pose[slot].clone()
            self.pose = self.pose_dev.cpu().numpy()

    def _need_new_keyframe(self, n_inl, tracked_close, untracked_close) -> bool:
        """NeedNewKeyFrame policy: ratio vs reference KF, close-point
        pressure, interval gates. Localization-only mode suppresses
        keyframes outright (`src/Tracking.cc:470-471`)."""
        if self.localization_only:
            return False
        if self.frames_since_kf < self.cfg.kf_min_interval:
            return False
        need_close = (tracked_close < 100) and (untracked_close > 70)
        ratio_gate = n_inl < self.cfg.kf_ref_ratio * self._ref_kf_tracked_points()
        interval_gate = self.frames_since_kf >= self.cfg.kf_max_interval
        return (ratio_gate or interval_gate or need_close) and n_inl > 15

    def _initialize(self, frame: FrameData, timestamp: float):
        """RGB-D bootstrap: first frame at the origin; every feature with
        depth becomes a landmark."""
        valid = frame.valid.cpu().numpy()
        depth = frame.depth.cpu().numpy()
        create = valid & (depth > 0)
        if create.sum() < 50:
            return  # not enough structure yet
        self.pose = se3.identity().numpy()
        self.pose_dev = self._t(self.pose)
        self.velocity_dev = self._t(self.velocity)
        self._create_keyframe(frame, np.full(frame.capacity, INVALID, np.int64),
                              timestamp, create_mask=create)
        self.last_frame = frame
        self.state = TrackState.OK

    def _mono_init_samples(self, valid):
        """The initializer's 200 samples of 8 matches, drawn from a
        generator seeded with the frame id."""
        gen = torch.Generator(device=valid.device)
        gen.manual_seed(int(self.frame_id))
        return draw_samples(valid, 200, 8, gen)

    def _initialize_mono(self, frame: FrameData, timestamp: float):
        """Monocular bootstrap (`MonocularInitialization` +
        `CreateInitialMapMonocular`, `src/Tracking.cc:1020-1185`): the first
        frame with enough features becomes the reference; a later one
        matched to it (windowed) runs the H/F initializer. On success the
        structure is scaled to unit median depth, both frames become
        keyframes with the triangulated landmarks and their observations,
        and a 2-keyframe BA refines them. Too few matches restart from the
        current frame."""
        cfg = self.cfg
        if int(frame.valid.sum()) < cfg.mono_init_min_matches:
            self._mono_ref = None
            return
        if self._mono_ref is None:
            self._mono_ref, self._mono_ref_ts = frame, timestamp
            return
        ref = self._mono_ref
        idx, keep = self._mono_match_impl(frame, ref)
        if int(keep.sum()) < cfg.mono_init_min_matches:
            # the reference is too old: restart (:1044)
            self._mono_ref, self._mono_ref_ts = frame, timestamp
            return
        midx = torch.clamp(idx, 0, frame.capacity - 1).long()
        res = initialize(ref.xy, frame.xy[midx], keep, self.cam,
                         samples=self._mono_init_samples(keep))
        if not bool(res.success):
            return
        good = res.is_good.cpu().numpy()
        n_good = int(good.sum())
        if n_good < 50:
            return
        # unit median scene depth (:1138-1163)
        X = res.points3d.cpu().numpy()
        med_depth = float(np.median(X[good][:, 2]))
        if med_depth <= 0:
            return
        X = X / med_depth
        pose21 = res.pose21.cpu().numpy().copy()
        pose21[4:7] /= med_depth

        # the bootstrap map: two keyframes and the triangulated landmarks
        N = frame.capacity
        none = self._t(np.full(N, INVALID, np.int32))
        slot0 = self.graph.alloc_kf_slot()
        self.map, p0 = self._insert_kf_impl(
            self.map, slot0, ref, se3.identity(device=self.device), none,
            none)
        slot1 = self.graph.alloc_kf_slot()
        self.map, p1 = self._insert_kf_impl(
            self.map, slot1, frame, self._t(pose21), none, none)
        self.graph.set_levels(slot0, p0[1].cpu().numpy())
        self.graph.set_levels(slot1, p1[1].cpu().numpy())
        slots_np = np.full(N, -1, np.int32)
        new_slots = self.graph.alloc_point_slots(n_good)
        if len(new_slots) < n_good:
            sel = np.nonzero(good)[0][: len(new_slots)]
            good = np.zeros_like(good)
            good[sel] = True
        slots_np[np.nonzero(good)[0]] = new_slots
        lm = self.local_mapper
        if lm is None:  # local BA off: a mapper for the bootstrap's BA
            lm = LocalMapper(self.cam, cfg.n_levels, cfg.scale_factor,
                             device=self.device)
            self.local_mapper = lm
        self.map = lm._tri_insert_impl(
            self.map, slot0, slot1, self._t(slots_np), midx,
            self._t(X, torch.float32))
        idx_np = midx.cpu().numpy()
        for k, (slot, ts) in enumerate([(slot0, self._mono_ref_ts),
                                        (slot1, timestamp)]):
            self.graph.set_kf_alive(slot, True)
            self.graph.kf_frame_id[slot] = self.frame_id - (1 - k)
            self.graph.kf_timestamp[slot] = ts
        self.graph.origin_kf = slot0
        for f, s in zip(np.nonzero(good)[0], new_slots):
            s = int(s)
            self.graph.pt_alive[s] = True
            self.graph.note_new_point(s, slot0)
            self.graph.add_observation(s, slot0, int(f), False)
            self.graph.add_observation(s, slot1, int(idx_np[f]), False)
        self.graph.update_connections(slot1, self.graph.kf_row[slot1])

        # refine the bootstrap with a 2-keyframe BA
        # (GlobalBundleAdjustemnt(20) at :1128)
        self.map, _ = lm.local_ba(self.map, self.graph, slot1)

        self.pose_dev = self.map.kf_pose[slot1].clone()
        self.pose = self.pose_dev.cpu().numpy()
        self.velocity = se3.identity().numpy()
        self.velocity_dev = self._t(self.velocity)
        self.last_frame = frame
        self.last_mp_dev = self.map.kf_mp[slot1].clone()
        self.ref_kf = slot1
        self.ref_kf_tracked = n_good
        self._ref_mp_row = self.graph.kf_row[slot1].copy()
        self.frames_since_kf = 0
        self._mono_ref = None
        self.state = TrackState.OK

    def _create_keyframe(self, frame: FrameData, feat_mp: np.ndarray,
                         timestamp: float,
                         create_mask: Optional[np.ndarray] = None,
                         feat_mp_dev=None):
        cfg = self.cfg
        # complete the previous keyframe's mapping job and drain its
        # deferred products FIRST: they free and allocate point slots, so
        # they must precede this keyframe's own allocations (the
        # reference's mapping thread finishes one keyframe before it takes
        # the next, src/LocalMapping.cc:79)
        if self.local_mapper is not None:
            with self.timer.time("kf.drain"):
                self._finalize_map()
        if not self.graph.can_alloc_kf():
            # keep tracking against the frozen map instead of crashing
            self.frames_since_kf = 0
            return -1
        slot = self.graph.alloc_kf_slot()
        if create_mask is None:
            # steady-state keyframes: new-point selection on the device,
            # graph bookkeeping replayed from one pack read
            max_new = cfg.max_new_points_per_kf
            got = self.graph.alloc_point_slots(max_new)
            P = cfg.map_capacity.max_points
            slot_buf = np.full(max_new, P, np.int32)
            slot_buf[: len(got)] = got
            if feat_mp_dev is None:
                feat_mp_dev = self._t(feat_mp.astype(np.int32))
            self.map, all_mp_dev, pack_dev = self._insert_kf_auto_impl(
                self.map, slot, frame, self._t(self.pose), feat_mp_dev,
                self._t(slot_buf), len(got))
            self.graph.set_kf_alive(slot, True)
            self.graph.kf_frame_id[slot] = self.frame_id
            self.graph.kf_timestamp[slot] = timestamp
            if self.graph.origin_kf < 0:
                self.graph.origin_kf = slot
            self.ref_kf = slot
            self.ref_kf_tracked = max(int((feat_mp >= 0).sum()), 1)
            self._ref_mp_row = None  # refined at drain
            self.frames_since_kf = 0
            self.last_mp_dev = all_mp_dev
            # the loop-detection query needs device arrays only: dispatch
            # it now, its read lands with the insert pack's
            self._loop_pending = None
            if (cfg.enable_loop_closing and self.loop_closer is not None
                    and self.local_mapper is not None):
                self._loop_pending = self.loop_closer.dispatch_detection(
                    self.map, slot)
            # the graph bookkeeping waits for the insert pack's read: the
            # pump's stage -1 (`_drain_insert`)
            self._pending_insert = (slot, frame, Readback(pack_dev), got,
                                    timestamp)
            self._map_job = (slot, -1)
            if self.local_mapper is None:
                # no mapping pump to drain the insert: resolve it here
                with self.timer.time("kf.insert_drain"):
                    self._drain_insert()
                self._map_job = None
            elif not cfg.pipelined:
                self._complete_mapping()
            return slot
        # ---- explicit-mask path (bootstrap initialization) ----
        n_new = int(create_mask.sum())
        new_slots = np.full(frame.capacity, INVALID, np.int64)
        if n_new:
            got = self.graph.alloc_point_slots(n_new)
            if len(got) < n_new:
                # capacity-tight: keep only the closest candidate points
                cand = np.nonzero(create_mask)[0]
                depth_np = frame.depth.cpu().numpy()
                keep = cand[np.argsort(depth_np[cand])[: len(got)]]
                create_mask = np.zeros_like(create_mask)
                create_mask[keep] = True
            new_slots[create_mask] = got[: int(create_mask.sum())]
        self.map, packed_dev = self._insert_kf_impl(
            self.map, slot, frame, self._t(self.pose),
            self._t(feat_mp.astype(np.int32)), self._t(new_slots, torch.int32))
        packed = packed_dev.cpu().numpy()
        all_mp, levels = packed[0], packed[1]
        self.graph.set_levels(slot, levels)
        self.graph.set_kf_alive(slot, True)
        self.graph.kf_frame_id[slot] = self.frame_id
        self.graph.kf_timestamp[slot] = timestamp
        if self.graph.origin_kf < 0:
            self.graph.origin_kf = slot
        for f in np.nonzero(all_mp >= 0)[0]:
            pt = int(all_mp[f])
            if create_mask[f]:
                self.graph.pt_alive[pt] = True
                self.graph.note_new_point(pt, slot)
            self.graph.add_observation(pt, slot, int(f), False)
        self.graph.update_connections(slot, all_mp)
        self.ref_kf = slot
        self.ref_kf_tracked = int((all_mp >= 0).sum())
        self._ref_mp_row = all_mp.copy()
        self.frames_since_kf = 0
        self.last_mp_dev = packed_dev[0].contiguous()
        self._post_insert(slot, frame)
        if self._map_job is not None and not cfg.pipelined:
            self._complete_mapping()
        return slot

    def _drain_insert(self):
        """Graph bookkeeping of a device-selected keyframe insert, once its
        pack's read has landed (the work the reference's mapping thread
        does when it dequeues a keyframe, src/LocalMapping.cc:303-333):
        replay the device's slot mapping (created features consumed
        slot_buf[:n] in feature order) and return the unused slots; then
        the post-insert work."""
        slot, frame, pack_read, got, _ = self._pending_insert
        self._pending_insert = None
        pack = pack_read.result()
        all_mp, levels, created = pack[0], pack[1], pack[2].astype(bool)
        n_created = int(created.sum())
        if n_created < len(got):
            self.graph.return_point_slots(got[n_created:])
        self.graph.set_levels(slot, levels)
        for f in np.nonzero(all_mp >= 0)[0]:
            pt = int(all_mp[f])
            if created[f]:
                self.graph.pt_alive[pt] = True
                self.graph.note_new_point(pt, slot)
            self.graph.add_observation(pt, slot, int(f), False)
        self.graph.update_connections(slot, all_mp)
        if self.ref_kf == slot:
            self.ref_kf_tracked = int((all_mp >= 0).sum())
            self._ref_mp_row = all_mp.copy()
        self._post_insert(slot, frame)

    def _post_insert(self, slot: int, frame: FrameData):
        """Post-insert work: merge a pending global BA (`kf.gba_merge`),
        rebuild the covisibility window's mask, zero the found/visible
        counters and last-seen stamps of recycled point slots, then, under
        `kf.loop`, index the keyframe in the BoW database and, with loop
        closing on, run the loop stage (BoW detection first: the query
        dispatched at the keyframe's creation, else `_loop_closing_stage`;
        when it closes nothing, the implicit pathway: after a seam keyframe
        the explicit Sim3 correction, the implicit one if that is refused),
        then dispatch the local-mapping job (reference order,
        src/LocalMapping.cc:93-130: triangulate -> fuse neighbours -> cull
        points -> local BA -> cull KFs) as the pump's stage 0."""
        cfg = self.cfg
        # merge a pending global BA before the map grows further (the
        # reference's GBA thread merges under the map mutex,
        # src/LoopClosing.cc:370-452)
        if self._gba_pending is not None and self.loop_closer is not None:
            with self.timer.time("kf.gba_merge"):
                self.map, ginfo = self.loop_closer.merge_gba(
                    self.map, self.graph, self._gba_pending)
                self._gba_pending = None
                if self.last_loop_info is not None:
                    self.last_loop_info.update(ginfo)
        if cfg.local_map_window > 0:
            self._refresh_local_mask(slot)
        rec = self.graph.recycled_log
        if rec:
            self.graph.recycled_log = []
            idx = self._t(np.asarray(rec, np.int64))
            self.mp_vis_dev[idx] = 0
            self.mp_found_dev[idx] = 0
            self.mp_seen_dev[idx] = -1
        with self.timer.time("kf.loop"):
            pend = self._loop_pending
            self._loop_pending = None
            before = (self.loop_closer.loops_closed
                      if self.loop_closer is not None else 0)
            if pend is not None:
                loop_kf = self.loop_closer.resolve_detection(self.graph, slot,
                                                             pend)
                if loop_kf is not None:
                    self._close_loop(frame, slot, loop_kf)
            elif cfg.enable_loop_closing:
                self._loop_closing_stage(frame, slot)
            else:
                self._ensure_bow_index(slot)
            # a candidate refused by the Sim3 or projection gates closed
            # nothing: the implicit check still runs
            fired = (self.loop_closer is not None
                     and self.loop_closer.loops_closed > before)
            # the seam flag is consumed whatever happens, so it never
            # relaxes a later keyframe's covisibility gate
            seam = self._seam_pending
            self._seam_pending = False
            if cfg.enable_loop_closing and not fired:
                cand = self._implicit_loop_candidate(
                    slot, min_weight=(8 if seam else 15))
                if cand is not None:
                    if seam:
                        # a seam caught at its first frame: the explicit
                        # Sim3 correction (which also fuses the drifted
                        # duplicates), the implicit one if it is refused
                        before2 = self.loop_closer.loops_closed
                        self._close_loop(frame, slot, cand, implicit=False)
                        if self.loop_closer.loops_closed == before2:
                            self._close_loop(frame, slot, cand,
                                             implicit=True)
                    else:
                        self._close_loop(frame, slot, cand, implicit=True)
        if self.local_mapper is not None and len(self.graph.alive_kfs()) >= 2:
            with self.timer.time("kf.triangulate"):
                self.map, _ = self.local_mapper.triangulate_new_points(
                    self.map, self.graph, slot)
            if slot % 2 == 0:
                # snapshot the found/visible counters now; the ratio-cull
                # rule drains them right before local BA (stage 2)
                self.local_mapper.queue_ratio_cull(slot, self.mp_vis_dev,
                                                   self.mp_found_dev)
            self._map_job = (slot, 0)
        else:
            self._map_job = None

    def _pump_mapping(self, force: bool = False, max_stages: int = 2):
        """Advance the mapping job by up to `max_stages` stages whose reads
        have landed; `force` waits for them instead. Pipelined mode pumps
        once a frame, two stages at most."""
        for _ in range(max(max_stages, 1)):
            before = self._map_job
            self._pump_mapping_once(force)
            if self._map_job == before:
                break

    def _pump_mapping_once(self, force: bool = False):
        """One stage of the mapping job (JAX's `_pump_mapping_once`): -1 the
        insert drain, 0 the triangulation drain and the fusion dispatch, 1
        the fusion drain, 2 the point refresh, the culls and the window BA,
        3 the keyframe cull. Unforced, a stage whose read has not landed
        leaves the job where it is; localization mode holds it."""
        lm = self.local_mapper
        job = self._map_job
        if lm is None or job is None:
            return
        if self.localization_only and not force:
            # localization mode froze the map: a job made here (a seam
            # keyframe's) is held until deactivation or a forced pump
            return
        slot, stage = job
        if stage == -1:
            pend = self._pending_insert
            if pend is None:
                self._map_job = (slot, 0)
                return
            if not force and not pend[2].done():
                self.pumps_not_ready += 1
                return
            with self.timer.time("kf.insert_drain"):
                self._drain_insert()
            return
        ready = (lm.tri_ready, lm.fuse_ready, lm.ratio_ready)
        if stage < 3 and not force and not ready[stage]():
            self.pumps_not_ready += 1
            return
        if stage == 0:
            # triangulation results: insert points, then neighbour fusion
            # over the refreshed covisibility ring
            with self.timer.time("kf.tri_drain"):
                self.map = lm._drain_tri(self.map, self.graph)
            with self.timer.time("kf.fuse"):
                self.map, _ = lm.fuse_neighbors(self.map, self.graph, slot)
            self._map_job = (slot, 1)
        elif stage == 1:
            with self.timer.time("kf.fuse_drain"):
                self.map = lm._drain_fuse(self.map, self.graph)
            self._map_job = (slot, 2)
        elif stage == 2:
            # refresh point stats, run the host culling rules (the ratio
            # rule BEFORE BA, so doomed points don't pollute the solve),
            # window BA
            with self.timer.time("kf.refresh_points"):
                self.map = lm.refresh_points(self.map, self.graph, slot)
            with self.timer.time("kf.cull_points"):
                self.map, _ = lm.cull_points(self.map, self.graph, slot)
                self.map = lm._drain_ratio_cull(self.map, self.graph)
            if self._gba_pending is None:
                with self.timer.time("kf.local_ba"):
                    self.map, self.last_ba_info = lm.local_ba(
                        self.map, self.graph, slot)
            else:
                # a global BA is pending: its merge overwrites every
                # launched pose, and a window solve now would drag the
                # loop-corrected seam back toward the still-drifted fixed
                # frontier (the reference stops local mapping across the
                # correction and GBA, src/LoopClosing.cc:532-544)
                self.last_ba_info = None
            self._map_job = (slot, 3)
        else:
            # the BA outlier erasure stays pending until the NEXT
            # keyframe's drain (the reference's mapping-thread lag)
            with self.timer.time("kf.cull_kfs"):
                self.map, killed = lm.cull_keyframes(self.map, self.graph,
                                                     slot)
            if killed and self.loop_closer is not None:
                for k in killed:
                    self.loop_closer.db.erase(k)
            self._map_job = None
            if self.last_ba_info is not None and not self.cfg.pipelined:
                # adopt the BA-refined pose of the new keyframe as the
                # tracker's current pose (the reference's map-update
                # hand-off, src/Tracking.cc:1196): exact in synchronous
                # mode, which completes the job in the keyframe's frame;
                # pipelined mode skips it (the frames in flight own the
                # device state)
                self.pose_dev = self.map.kf_pose[slot].clone()
                self.pose = self.pose_dev.cpu().numpy()

    def _complete_mapping(self):
        """Run the mapping job to completion (the pump, forced). The BA
        outlier erasure may stay pending; `_finalize_map` drains it."""
        while self._map_job is not None:
            self._pump_mapping(force=True)

    def _finalize_map(self):
        """Complete the mapping job and drain every deferred product."""
        self._complete_mapping()
        if self.local_mapper is not None:
            self.map = self.local_mapper.drain_pending(self.map, self.graph)
