"""Device-resident SoA map storage + host-side sparse graph bookkeeping.

Port of `orb_slam2_refactored_tpu/slam/map_state.py`:

- `MapArrays`: padded, statically-shaped tensors (keyframe poses and
  measurements, landmark states) that every matcher consumes directly.
  Descriptors are int32[..., 8] (bit-identical to the JAX package's uint32).
- `MapGraph`: the covisibility graph, spanning tree, observation lists and
  lifecycle counters kept in numpy + dicts on the host; a copy of the JAX
  package's pure-Python `MapGraph`, the tracker's graph.
  `native.py::NativeMapGraph`, the JAX package's C++ arena, presents the
  same interface; the tracker does not take it yet (ROADMAP.md, A1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Set

import numpy as np
import torch

INVALID = -1


@dataclasses.dataclass(frozen=True)
class MapCapacity:
    max_keyframes: int = 256
    max_points: int = 32768
    max_features: int = 1024  # per keyframe; must match extractor capacity


class MapArrays(NamedTuple):
    """All device-resident map state. KF = max keyframes, P = max points,
    N = features per keyframe."""

    # -- keyframes --------------------------------------------------------
    kf_pose: torch.Tensor       # f32[KF,7]  Tcw (world->camera)
    kf_valid: torch.Tensor      # bool[KF]
    kf_xy: torch.Tensor         # f32[KF,N,2] undistorted keypoints
    kf_level: torch.Tensor      # i32[KF,N]
    kf_angle: torch.Tensor      # f32[KF,N]
    kf_desc: torch.Tensor       # i32[KF,N,8]
    kf_uright: torch.Tensor     # f32[KF,N]
    kf_depth: torch.Tensor      # f32[KF,N]
    kf_feat_valid: torch.Tensor  # bool[KF,N]
    kf_mp: torch.Tensor         # i32[KF,N] map-point id per feature (INVALID none)

    # -- map points -------------------------------------------------------
    mp_pos: torch.Tensor        # f32[P,3] world position
    mp_valid: torch.Tensor      # bool[P]
    mp_desc: torch.Tensor       # i32[P,8] distinctive descriptor
    mp_normal: torch.Tensor     # f32[P,3] mean viewing direction
    mp_min_dist: torch.Tensor   # f32[P] scale-invariance band lower edge
    mp_max_dist: torch.Tensor   # f32[P]
    mp_nobs: torch.Tensor       # i32[P] observation count

    @property
    def kf_capacity(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def point_capacity(self) -> int:
        return self.mp_pos.shape[0]


def empty_map(cap: MapCapacity, device=None) -> MapArrays:
    KF, P, N = cap.max_keyframes, cap.max_points, cap.max_features
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    kf_pose = torch.zeros((KF, 7), **f32)
    kf_pose[:, 0] = 1.0
    return MapArrays(
        kf_pose=kf_pose,
        kf_valid=torch.zeros((KF,), **b),
        kf_xy=torch.zeros((KF, N, 2), **f32),
        kf_level=torch.zeros((KF, N), **i32),
        kf_angle=torch.zeros((KF, N), **f32),
        kf_desc=torch.zeros((KF, N, 8), **i32),
        kf_uright=-torch.ones((KF, N), **f32),
        kf_depth=-torch.ones((KF, N), **f32),
        kf_feat_valid=torch.zeros((KF, N), **b),
        kf_mp=torch.full((KF, N), INVALID, **i32),
        mp_pos=torch.zeros((P, 3), **f32),
        mp_valid=torch.zeros((P,), **b),
        mp_desc=torch.zeros((P, 8), **i32),
        mp_normal=torch.zeros((P, 3), **f32),
        mp_min_dist=torch.zeros((P,), **f32),
        mp_max_dist=torch.zeros((P,), **f32),
        mp_nobs=torch.zeros((P,), **i32),
    )


class MapGraph:
    """Host-side sparse graph + lifecycle state (numpy / python containers).

    Replaces: covisibility graph (`reference src/KeyFrame.cc:235-309`),
    spanning tree + loop edges (`:311-348`), keyframe id bookkeeping, and the
    per-point observation lists (`src/MapPoint.cc:109-150`). These are small,
    irregular, and mutation-heavy — the wrong shape for device arrays — while
    every O(N_features) quantity lives in `MapArrays`.
    """

    def __init__(self, cap: MapCapacity):
        self.cap = cap
        # `num_kfs` counts keyframes EVER CREATED (monotonic creation
        # sequence); `next_kf_slot` is the fresh-slot cursor. They differ
        # once culled slots start being recycled (KITTI-length sequences).
        self.num_kfs = 0
        self.next_kf_slot = 0
        self.next_point = 0
        # per-slot creation sequence number: the temporal ordering that slot
        # indices provided before recycling ("how many KFs ago" comparisons
        # must use kf_seq, never slot arithmetic)
        self.kf_seq: np.ndarray = np.full(cap.max_keyframes, -1, np.int64)
        # dead KF slots age in quarantine (like points) before reuse: any
        # in-flight reference — pipelined ref_kf scalars, pending BA erasures
        # keyed by slot — must have cycled out first
        self.kf_quarantine: List = []
        # free slots from culled KFs / points are recycled
        self.free_kf_slots: List[int] = []
        self.free_pt_slots: List[int] = []
        self.kf_alive: np.ndarray = np.zeros(cap.max_keyframes, bool)
        self.kf_frame_id: np.ndarray = np.full(cap.max_keyframes, -1, np.int64)
        self.kf_timestamp: np.ndarray = np.zeros(cap.max_keyframes, np.float64)
        # covisibility: weight[i][j] = # shared map points (>= threshold 15
        # when queried, matching src/KeyFrame.cc:268)
        self.covis_weight: Dict[int, Dict[int, int]] = {}
        # spanning tree (parent per KF, children sets) + loop edges
        self.parent: np.ndarray = np.full(cap.max_keyframes, -1, np.int64)
        self.children: Dict[int, Set[int]] = {}
        self.loop_edges: Dict[int, Set[int]] = {}
        # per-point observations: point -> {kf: feat_idx}
        self.obs: Dict[int, Dict[int, int]] = {}
        # host mirrors of device-side per-KF state. kf_row mirrors kf_mp
        # (feature -> point) and kf_levels the keypoint pyramid levels, so
        # the host never reads those device arrays back: the graph
        # maintains them as observations change.
        self.kf_row: np.ndarray = np.full(
            (cap.max_keyframes, cap.max_features), -1, np.int32
        )
        self.kf_levels: np.ndarray = np.zeros(
            (cap.max_keyframes, cap.max_features), np.int32
        )
        # MapPoint lifecycle counters (found/visible ratio culling,
        # src/MapPoint.cc:322-339 & src/LocalMapping.cc:335-369)
        self.pt_visible: np.ndarray = np.zeros(cap.max_points, np.int32)
        self.pt_found: np.ndarray = np.zeros(cap.max_points, np.int32)
        # creation SEQUENCE (kf_seq of the creating keyframe), not a slot:
        # ages stay well-defined after slot recycling
        self.pt_first_kf: np.ndarray = np.full(cap.max_points, -1, np.int64)
        # (pt, creation_seq) of recently created points — the culling scans
        # iterate this instead of a next_point range (allocation is not
        # contiguous once slots recycle)
        self.young_pts: List = []
        self.pt_alive: np.ndarray = np.zeros(cap.max_points, bool)
        self.kf_watermark: np.ndarray = np.zeros(cap.max_keyframes, np.int64)
        # dead point slots enter quarantine and become reusable a few
        # keyframes later (stale device references — last-frame assignments,
        # in-flight feat_mp — must all have cycled out first)
        self.pt_quarantine: List = []
        self.recycled_log: List[int] = []
        self.origin_kf: int = -1
        self.big_change_counter = 0
        # culled keyframe -> (parent slot, Tcp f32[7]) recorded at cull time
        # (KeyFrame::SetBadFlag's mTcp, src/KeyFrame.cc:464)
        self.kf_tcp: Dict[int, tuple] = {}

    # -- slot allocation --------------------------------------------------

    def _pop_recyclable_kf(self):
        """Oldest quarantined dead KF slot aged >= 3 creations, or None."""
        for i, (k, stamp) in enumerate(self.kf_quarantine):
            if self.num_kfs - stamp >= 3:
                del self.kf_quarantine[i]
                return int(k)
        return None

    def can_alloc_kf(self) -> bool:
        return (self.next_kf_slot < self.cap.max_keyframes
                or any(self.num_kfs - st >= 3 for _, st in self.kf_quarantine))

    def _reset_kf_slot(self, slot: int):
        """Scrub host state of a recycled slot (the device row is fully
        overwritten by the insert scatter). Covis/observations were already
        detached by kill_keyframe; the spanning-tree linkage and identity
        fields must not leak into the new tenant."""
        self.parent[slot] = -1
        self.children.pop(slot, None)
        for other in self.loop_edges.pop(slot, set()):
            self.loop_edges.get(other, set()).discard(slot)
        self.kf_frame_id[slot] = -1
        self.kf_timestamp[slot] = 0.0
        self.kf_row[slot] = -1

    def alloc_kf_slot(self) -> int:
        """Fresh slots first; at capacity, recycle quarantined dead slots
        aged >= 3 keyframe creations (in-flight slot references — pipelined
        ref_kf scalars, one-KF-deferred BA erasures — have cycled out by
        then). The reference's shared_ptr graph tolerates unbounded growth +
        culling (`reference src/Map.cc:37-68`); a static SoA index
        space gets the same unbounded-sequence behavior from quarantined
        reuse. Temporal comparisons must use kf_seq, not slot order."""
        if self.next_kf_slot < self.cap.max_keyframes:
            slot = self.next_kf_slot
            self.next_kf_slot += 1
        else:
            slot = self._pop_recyclable_kf()
            if slot is None:
                raise RuntimeError(
                    f"keyframe capacity {self.cap.max_keyframes} exhausted "
                    f"(no culled slots to recycle)"
                )
            self._reset_kf_slot(slot)
        self.kf_seq[slot] = self.num_kfs
        self.num_kfs += 1
        # point-allocation watermark: slots >= kf_watermark[s] were created
        # at/after keyframe s (bounds MapPointCulling's candidate scan)
        self.kf_watermark[slot] = self.next_point
        return slot

    def alloc_point_slots(self, n: int) -> np.ndarray:
        """Allocate UP TO n point slots (callers must handle fewer).

        Fresh slots first; at capacity, recycle quarantined dead slots that
        have aged >= 3 keyframes (graceful degradation instead of the
        round-1 RuntimeError: when nothing is recyclable the map simply
        stops growing, like the reference under memory pressure)."""
        fresh = min(n, self.cap.max_points - self.next_point)
        slots = list(range(self.next_point, self.next_point + fresh))
        self.next_point += fresh
        if len(slots) < n and self.pt_quarantine:
            ready = [p for p, stamp in self.pt_quarantine
                     if self.num_kfs - stamp >= 3]
            take = ready[: n - len(slots)]
            if take:
                taken = set(take)
                self.pt_quarantine = [
                    (p, st) for p, st in self.pt_quarantine if p not in taken
                ]
                slots.extend(take)
                # the tracker zeroes found/visible counters of reused slots
                self.recycled_log.extend(take)
        return np.asarray(slots, np.int64)

    def return_point_slots(self, slots):
        """Give back allocated-but-unused point slots (the async keyframe
        insert over-allocates, then the device reports how many it consumed).
        Returned slots re-enter via the quarantine with an aged stamp, so
        they are immediately re-allocatable."""
        for s in slots:
            self.pt_quarantine.insert(0, (int(s), self.num_kfs - 3))

    # -- covisibility -----------------------------------------------------

    def set_covis(self, a: int, b: int, w: int):
        if w <= 0:
            self.covis_weight.get(a, {}).pop(b, None)
            self.covis_weight.get(b, {}).pop(a, None)
            return
        self.covis_weight.setdefault(a, {})[b] = w
        self.covis_weight.setdefault(b, {})[a] = w

    def covis_neighbors(self, kf: int, min_weight: int = 0, top_k: int = 0):
        """Ordered covisible KFs (best first) — GetBestCovisibilityKeyFrames /
        GetCovisiblesByWeight analog (src/KeyFrame.cc:136-150)."""
        items = [
            (j, w)
            for j, w in self.covis_weight.get(kf, {}).items()
            if w >= min_weight and self.kf_alive[j]
        ]
        items.sort(key=lambda t: -t[1])
        if top_k:
            items = items[:top_k]
        return [j for j, _ in items]

    def update_connections(self, kf: int, kf_mp_row: np.ndarray, obs_for_new=True):
        """Rebuild covisibility for `kf` from its point associations and wire
        the spanning tree (src/KeyFrame.cc:235-309). `kf_mp_row` is i32[N]."""
        counter: Dict[int, int] = {}
        for pt in kf_mp_row:
            if pt < 0 or not self.pt_alive[pt]:
                continue
            for other in self.obs.get(int(pt), {}):
                if other != kf and self.kf_alive[other]:
                    counter[other] = counter.get(other, 0) + 1
        # wholesale replace (the reference rebuilds the KF's connection map
        # each UpdateConnections): stale entries whose shared-point count
        # dropped below threshold after culling/fusion must not linger
        for other in list(self.covis_weight.get(kf, {})):
            self.covis_weight.get(other, {}).pop(kf, None)
        self.covis_weight.pop(kf, None)
        th = 15
        best, best_w = -1, 0
        any_connected = False
        for other, w in counter.items():
            if w > best_w:
                best, best_w = other, w
            if w >= th:
                self.set_covis(kf, other, w)
                any_connected = True
        if not any_connected and best >= 0:
            self.set_covis(kf, best, best_w)
        # spanning tree: first connection becomes parent (src/KeyFrame.cc:300-306)
        if obs_for_new and self.parent[kf] < 0 and kf != self.origin_kf and best >= 0:
            self.set_parent(kf, best)

    def set_parent(self, kf: int, p: int):
        """`parent[kf] = p`, with kf recorded among p's children (as the
        C++ arena's `mg_set_parent`)."""
        self.parent[kf] = p
        if p >= 0:
            self.children.setdefault(p, set()).add(kf)

    # -- observations -----------------------------------------------------

    def add_observation(self, pt: int, kf: int, feat_idx: int, is_stereo: bool):
        self.obs.setdefault(pt, {})[kf] = feat_idx
        self.kf_row[kf, feat_idx] = pt

    def erase_observation(self, pt: int, kf: int):
        feat = self.obs.get(pt, {}).pop(kf, None)
        if feat is not None and self.kf_row[kf, feat] == pt:
            self.kf_row[kf, feat] = -1

    def set_levels(self, kf: int, levels: np.ndarray):
        self.kf_levels[kf] = levels

    def n_obs(self, pt: int) -> int:
        return len(self.obs.get(pt, {}))

    # -- lifecycle --------------------------------------------------------

    def note_new_point(self, pt: int, creating_kf: int):
        """Record a newly created landmark's creation sequence (MapPoint
        birth bookkeeping, src/MapPoint.cc:35-60): powers the young-point
        trial-window culling scans."""
        sq = int(self.kf_seq[creating_kf])
        self.pt_first_kf[pt] = sq
        self.young_pts.append((int(pt), sq))

    def young_points(self, cur_seq: int, max_age: int):
        """Points created within `max_age` keyframe creations of `cur_seq`
        (deduped, alive only); prunes entries too old for any caller.

        The prune horizon is GRAPH-level (the largest trial window any
        caller has ever requested, floor 6): two culling rules share this
        list, and pruning with one caller's smaller window would silently
        truncate the other's trial period (ADVICE r3)."""
        keep, out, seen = [], [], set()
        self.young_horizon = max(
            getattr(self, "young_horizon", 6), max_age + 2
        )
        horizon = self.young_horizon
        for pt, sq in self.young_pts:
            if cur_seq - sq > horizon or not self.pt_alive[pt]:
                continue
            keep.append((pt, sq))
            if cur_seq - sq <= max_age and pt not in seen:
                seen.add(pt)
                out.append(pt)
        self.young_pts = keep
        return out

    def kill_point(self, pt: int):
        """Returns the (kf, feat) observation pairs so callers can clear the
        device-side kf_mp references. Idempotent: a second kill of the same
        slot must not enqueue a duplicate quarantine entry (that would let
        one slot be recycled to two different landmarks)."""
        if not self.pt_alive[pt]:
            return []
        self.pt_alive[pt] = False
        pairs = list(self.obs.pop(pt, {}).items())
        for kf, feat in pairs:
            if self.kf_row[kf, feat] == pt:
                self.kf_row[kf, feat] = -1
        self.pt_quarantine.append((pt, self.num_kfs))
        return pairs

    # -- accessor interface shared with native.NativeMapGraph -------------

    def set_kf_alive(self, kf: int, alive: bool):
        self.kf_alive[kf] = alive

    def obs_pairs(self, pt: int):
        return list(self.obs.get(pt, {}).items())

    def obs_feat_in_kf(self, pt: int, kf: int) -> int:
        return self.obs.get(pt, {}).get(kf, -1)

    def refresh_export(self, mp_row: np.ndarray, min_obs: int, M: int,
                       B: int):
        """Batched observation export (python fallback of the native
        `mg_refresh_export`): (pts, obs_kf [B,M], obs_ft [B,M], nob, n)."""
        pts = np.zeros(B, np.int32)
        okf = np.zeros((B, M), np.int32)
        oft = np.zeros((B, M), np.int32)
        nob = np.zeros(B, np.int32)
        b = 0
        for p in mp_row[mp_row >= 0]:
            if b >= B:
                break
            p = int(p)
            if not self.pt_alive[p]:
                continue
            o = self.obs.get(p, {})
            if len(o) < min_obs:
                continue
            pts[b] = p
            for j, (kf, ft) in enumerate(o.items()):
                if j >= M:
                    break
                okf[b, j] = kf
                oft[b, j] = ft
                nob[b] = min(len(o), M)
            b += 1
        return pts, okf, oft, nob, b

    def apply_fuse(self, srcs, dsts, idx_all, dst_pt_all, keep_all,
                   src_mp_all):
        """The fuse decisions of `LocalMapper._drain_fuse` applied to the
        graph: for each pair row bi (srcs[bi] == dsts[bi] rows are padding)
        and each kept feature, the source point joins the destination
        keyframe where that feature has no point, or the less observed of
        two live points merges into the other. The JAX package's per-feature
        loop, with the C++ arena's return (`native.NativeMapGraph.
        apply_fuse`): (adds (kf, ft, pt), merges (src, dst resolved along
        merge chains), killed points), int32 arrays in decision order."""
        adds, merge_src, merge_dst = [], [], []
        for bi, (a, b) in enumerate(zip(srcs, dsts)):
            if a == b:
                continue
            b = int(b)
            for f_src in np.nonzero(keep_all[bi])[0]:
                p_src = int(src_mp_all[bi, f_src])
                f_dst = int(idx_all[bi, f_src])
                p_dst = int(dst_pt_all[bi, f_src])
                if not self.pt_alive[p_src]:
                    continue
                if p_dst < 0:
                    # dst feature has no landmark: add observation
                    if self.obs_feat_in_kf(p_src, b) < 0:
                        self.add_observation(p_src, b, f_dst, False)
                        adds.append((b, f_dst, p_src))
                elif p_dst != p_src and self.pt_alive[p_dst]:
                    # duplicate landmark: keep the better-observed one
                    if self.n_obs(p_dst) >= self.n_obs(p_src):
                        lo, hi = p_src, p_dst
                    else:
                        lo, hi = p_dst, p_src
                    for okf, feat in self.obs_pairs(lo):
                        if self.obs_feat_in_kf(hi, okf) < 0:
                            self.add_observation(hi, okf, feat, False)
                    self.kill_point(lo)
                    merge_src.append(lo)
                    merge_dst.append(hi)
        # resolve merge chains (x->y then y->z must land on z, matching the
        # sequential merges above)
        remap = dict(zip(merge_src, merge_dst))

        def _resolve(d):
            while d in remap:
                d = remap[d]
            return d

        i32 = np.int32
        adds = np.asarray(adds, i32).reshape(-1, 3)
        return ((adds[:, 0], adds[:, 1], adds[:, 2]),
                (np.asarray(merge_src, i32),
                 np.asarray([_resolve(d) for d in merge_dst], i32)),
                np.asarray(merge_src, i32))

    def points_with_obs(self):
        return [p for p, o in self.obs.items() if o]

    def covis_w(self, a: int, b: int) -> int:
        return self.covis_weight.get(a, {}).get(b, 0)

    def redundant_obs(self, kf: int, mp_row: np.ndarray, levels_all: np.ndarray):
        """(n_redundant, n_total) for KeyFrameCulling (python fallback)."""
        redundant = total = 0
        for f in np.nonzero(mp_row >= 0)[0]:
            pt = int(mp_row[f])
            if not self.pt_alive[pt]:
                continue
            total += 1
            lvl = levels_all[kf, f]
            n_better = 0
            for okf, ofeat in self.obs.get(pt, {}).items():
                if okf == kf or not self.kf_alive[okf]:
                    continue
                if levels_all[okf, ofeat] <= lvl + 1:
                    n_better += 1
                    if n_better >= 3:
                        break
            if n_better >= 3:
                redundant += 1
        return redundant, total

    def kill_keyframe(self, kf: int):
        """SetBadFlag analog with spanning-tree child re-parenting
        (src/KeyFrame.cc:379-470, simplified: children adopt best covisible
        candidate among {remaining parents}, fallback to grandparent)."""
        if kf == self.origin_kf:
            return
        self.kf_row[kf] = -1
        # detach covisibility
        for other in list(self.covis_weight.get(kf, {})):
            self.covis_weight[other].pop(kf, None)
        self.covis_weight.pop(kf, None)
        # re-parent children: candidates start with kf's parent
        kids = self.children.pop(kf, set())
        parent = int(self.parent[kf])
        candidates = {parent} if parent >= 0 else set()
        for child in kids:
            best_w, best_p = 0, parent
            for cand in candidates:
                w = self.covis_weight.get(child, {}).get(cand, 0)
                if w > best_w:
                    best_w, best_p = w, cand
            self.set_parent(child, best_p)
            if best_p >= 0:
                candidates.add(child)
        if parent >= 0:
            self.children.get(parent, set()).discard(kf)
        self.kf_alive[kf] = False
        self.kf_quarantine.append((kf, self.num_kfs))

    def alive_kfs(self) -> np.ndarray:
        return np.nonzero(self.kf_alive)[0]

    def alive_points(self) -> np.ndarray:
        return np.nonzero(self.pt_alive)[0]
