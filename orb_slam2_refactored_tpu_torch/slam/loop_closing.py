"""Loop closing: detection, Sim3 estimation, correction, pose graph, global BA.

Port of `orb_slam2_refactored_tpu/slam/loop_closing.py` (the reference's
`LoopClosing`, `src/LoopClosing.cc`):
- detection from BoW scores and covisibility consistency over consecutive
  keyframes (`detect`, `_detect_policy`; minConsistency 3), or split in
  two: `dispatch_detection` indexes the keyframe and starts the scores'
  read when it is created, `resolve_detection` runs the policy at the
  insert drain;
- the Sim3 between the current and the loop keyframe: descriptor matching
  (K1), Horn RANSAC on the landmark pairs, guided matching through S0 and
  S0^-1 (K1 under a dense window mask), mutual agreement and
  `optimize_sim3` (`compute_sim3`), then the projection check
  (`verify_by_projection`, K1);
- the correction: the essential graph (`pose_graph_solve`), the landmarks
  moved with their reference keyframe, the matched duplicates fused, the
  loop edges recorded (`correct`);
- global BA over the whole map (`launch_gba`, `merge_gba`): matrix-free CG
  with K5 in its `w_obs` mode and K6, on the map's live points compacted.

Differences of form from the JAX package:
- the global BA is computed when `launch_gba` is called (the JAX package
  dispatches it there and waits for it later); either way the result is a
  function of the map at launch, and the tracker merges it at the next
  keyframe (`merge_gba`), as JAX does;
- the RANSAC of `compute_sim3` draws from a `torch.Generator` seeded with
  the caller's seed where JAX takes a PRNG key: its samples differ, its
  outcome agrees;
- the global BA's problem holds the live points only (`compact_points`,
  in index order), scattered back after the solve; on the card a map with
  more live points than K5's index holds raises;
- the scores' read is a `utils/readback.py::Readback` (a CUDA event on a
  pinned buffer), where `dispatch_detection` in JAX takes the mapper's
  fetch function;
- the `TPU_SLAM_DEBUG_LOOP` prints and `correct`'s synchronous global-BA
  branch (`async_gba=False`, which nothing calls) are not ported.

Faults of the JAX package that are kept, so that parity holds: `correct`
moves each landmark with its lowest-slot observer (not the earliest by
creation sequence), and essential-graph edges can be entered twice
(parent edges are not entered in `seen`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..geometry import projection as proj
from ..geometry import se3, sim3
from ..ops import hamming, matching
from ..optim.ba import ba_solve, compact_points, problem_from_map
from ..optim.pose_graph import (PoseGraphProblem, edge_measurement,
                                pose_graph_solve)
from ..optim.sim3_opt import optimize_sim3
from ..solvers.ransac import horn_ransac
from ..utils.readback import Readback
from .frame import scale_factors
from .map_state import MapArrays, MapGraph
from .system import _np_compose, _np_inverse
from .vocabulary import KeyFrameDatabase, Vocabulary


class LoopCloser:
    MIN_CONSISTENCY = 3    # src/LoopClosing.cc:60
    MIN_SIM3_INLIERS = 20  # :137 (>= 20 accepts the Sim3)

    def __init__(self, voc: Vocabulary, cam: proj.CameraIntrinsics,
                 kf_capacity: int, n_levels: int = 8,
                 scale_factor: float = 1.2, fix_scale: bool = True,
                 gba_iters: int = 10, gba_cg_iters: int = 40):
        self.db = KeyFrameDatabase(voc, kf_capacity)
        self.cam = cam
        # stereo/RGB-D: the Sim3 scale is fixed to 1
        self.fix_scale = fix_scale
        self.gba_iters = gba_iters
        self.gba_cg_iters = gba_cg_iters
        dev = voc.words.device
        self._sf_arr, _, self.inv_sigma2 = scale_factors(
            n_levels, scale_factor, device=dev)
        # consistency groups: list of (set_of_kfs, count)
        self.consistent_groups: List = []
        self.last_loop_kf = -1
        # cooldowns compare creation sequence numbers (graph.kf_seq), not
        # slot indices: slots are recycled on long sequences
        self.last_loop_seq = -1
        self.loops_closed = 0
        self._n_indexed = 0

    # ------------------------------------------------------------------

    def add_keyframe_bow(self, m: MapArrays, kf: int):
        """Compute and store the BoW row of keyframe `kf` (ComputeBoW);
        refit the idf to the live corpus every 8 indexed keyframes (the
        reference's idf comes with ORBvoc.txt; a live-trained vocabulary
        tracks its own document frequencies). No host read."""
        v, _ = self.db.compute_bow(m.kf_desc[kf], m.kf_feat_valid[kf])
        self.db.add(kf, v)
        self._n_indexed += 1
        if self._n_indexed % 8 == 0:
            self.db.refit_idf()
        return v

    def dispatch_detection(self, m: MapArrays, kf: int):
        """Index keyframe `kf` and start the scoring query's read (scores
        and common-word counts in one stack: counts below 2^24 are exact
        in f32); `resolve_detection` consumes it at the insert drain."""
        v = self.add_keyframe_bow(m, kf)
        s, cw = self.db.score_query(v)
        return kf, Readback(torch.stack([s, cw.to(torch.float32)]))

    def resolve_detection(self, graph: MapGraph, kf: int,
                          pending) -> Optional[int]:
        """Finish a `dispatch_detection` query: the host-side active mask,
        then the detection policy."""
        pkf, read = pending
        assert pkf == kf
        packed = read.result()
        s = packed[0].copy()
        cw = packed[1].astype(np.int32)
        s[~self.db.active] = -1.0
        cw[~self.db.active] = 0
        return self._detect_policy(graph, kf, s, cw)

    def detect(self, m: MapArrays, graph: MapGraph, kf: int,
               bow_vec) -> Optional[int]:
        """A loop keyframe when a consistent candidate exists
        (`LoopDetector::Detect`, `src/LoopClosing.cc:157-296`): >= 10
        keyframes since the last loop, a score floor from the covisible
        neighbours, consistency over MIN_CONSISTENCY detections."""
        if (graph.kf_seq[kf] - self.last_loop_seq < 10
                or len(graph.alive_kfs()) < 10):
            return None  # still indexed; no detection this early
        s, cw = self.db._score_common(bow_vec)
        return self._detect_policy(graph, kf, s, cw)

    def _detect_policy(self, graph: MapGraph, kf: int, scores,
                       common) -> Optional[int]:
        """The detection policy over host (score, common-word) arrays. As
        in the JAX package, the floor is 0.8 x the lowest covisible score
        (top 30), at least 0.02, where the reference takes the raw lowest
        score (the live-trained vocabularies score covisibles higher)."""
        if (graph.kf_seq[kf] - self.last_loop_seq < 10
                or len(graph.alive_kfs()) < 10):
            return None
        neighbors = graph.covis_neighbors(kf, top_k=30)
        min_score = 1.0
        for nb in neighbors:
            if scores[nb] >= 0:
                min_score = min(min_score, float(scores[nb]))
        min_score = max(min_score * 0.8, 0.02)
        exclude = set(neighbors) | {kf}
        cands = self.db.candidates_from_scores(scores, common, exclude,
                                               min_score, graph)
        if not cands:
            self.consistent_groups = []
            return None
        # covisibility-consistency bookkeeping (:194-241)
        new_groups = []
        loop_kf = None
        for c in cands:
            group = set(graph.covis_neighbors(c, top_k=30)) | {c}
            count = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= self.MIN_CONSISTENCY and loop_kf is None:
                loop_kf = c
        self.consistent_groups = new_groups
        return loop_kf

    # ------------------------------------------------------------------

    def _match_kfs_impl(self, m: MapArrays, kf_a: int, kf_b: int):
        """Descriptor-match two keyframes' features that carry landmarks
        (K1 both ways); the 3D-3D landmark pairs in each keyframe's camera
        frame (SearchByBoW KF <-> KF, `src/ORBmatcher.cc:696`)."""
        P = m.point_capacity
        mp_a, mp_b = m.kf_mp[kf_a], m.kf_mp[kf_b]
        ok_a = (mp_a >= 0) & m.mp_valid[torch.clamp(mp_a, 0, P - 1).long()]
        ok_b = (mp_b >= 0) & m.mp_valid[torch.clamp(mp_b, 0, P - 1).long()]
        mm = matching.match_descriptors(m.kf_desc[kf_a], m.kf_desc[kf_b],
                                        ok_a, ok_b, max_dist=50, nn_ratio=0.9)
        idx_b = torch.clamp(mm.idx, 0, mp_b.shape[0] - 1).long()
        pt_a = torch.clamp(mp_a, 0, P - 1)
        pt_b = torch.clamp(mp_b[idx_b], 0, P - 1)
        xa = se3.transform(m.kf_pose[kf_a], m.mp_pos[pt_a.long()])
        xb = se3.transform(m.kf_pose[kf_b], m.mp_pos[pt_b.long()])
        return xa, xb, pt_a, pt_b, mm.valid

    def _guided(self, x_src, ok_src, desc_src, xy_dst, lvl_dst, ok_dst,
                desc_dst, S):
        """Project source-camera points through S into the destination
        image and window-match them (K1 under the dense window mask,
        radius 7.5 x the destination feature's scale): the best
        destination feature of each source point, or -1."""
        xc = sim3.transform(S, x_src)
        uv = proj.project(self.cam, xc)
        in_front = xc[:, 2] > 0.05
        sf = self._sf_arr
        r = 7.5 * sf[torch.clamp(lvl_dst, 0, sf.shape[0] - 1).long()]
        d2 = torch.sum((uv[:, None, :] - xy_dst[None, :, :]) ** 2, -1)
        win = d2 <= (r[None, :] ** 2)
        row_ok = ok_src & in_front
        idx, best, _ = hamming.masked_best2_gated(
            desc_src, desc_dst, row_ok.contiguous(), ok_dst.contiguous(),
            pair_ok=win.contiguous())
        return torch.where(row_ok & (best <= hamming.TH_HIGH), idx,
                           torch.full_like(idx, -1))

    def _sim3_refine_impl(self, m: MapArrays, kf_a: int, kf_b: int, S0):
        """Guided Sim3 matching and relative-Sim3 refinement (SearchBySim3,
        `src/ORBmatcher.cc:1090-1277`, then OptimizeSim3): each keyframe's
        landmarks projected through S0 (resp. S0^-1) into the other image
        and window-matched, the mutually agreeing pairs kept, S0 refined
        over their paired reprojections. Per b-feature pair arrays."""
        P = m.point_capacity
        mp_a, mp_b = m.kf_mp[kf_a], m.kf_mp[kf_b]
        pa = torch.clamp(mp_a, 0, P - 1).long()
        pb = torch.clamp(mp_b, 0, P - 1).long()
        ok_a = (mp_a >= 0) & m.kf_feat_valid[kf_a] & m.mp_valid[pa]
        ok_b = (mp_b >= 0) & m.kf_feat_valid[kf_b] & m.mp_valid[pb]
        xa = se3.transform(m.kf_pose[kf_a], m.mp_pos[pa])
        xb = se3.transform(m.kf_pose[kf_b], m.mp_pos[pb])
        lvl_a, lvl_b = m.kf_level[kf_a], m.kf_level[kf_b]
        b_to_a = self._guided(xb, ok_b, m.kf_desc[kf_b], m.kf_xy[kf_a], lvl_a,
                              ok_a, m.kf_desc[kf_a], S0)
        a_to_b = self._guided(xa, ok_a, m.kf_desc[kf_a], m.kf_xy[kf_b], lvl_b,
                              ok_b, m.kf_desc[kf_b], sim3.inverse(S0))
        # mutual agreement (`src/ORBmatcher.cc:1238-1260`)
        Nb = mp_b.shape[0]
        a_sel = torch.clamp(b_to_a, 0, mp_a.shape[0] - 1).long()
        agree = (b_to_a >= 0) & (a_to_b[a_sel] == torch.arange(
            Nb, dtype=a_to_b.dtype, device=a_to_b.device))
        res = optimize_sim3(
            S0, xa[a_sel], xb, m.kf_xy[kf_a][a_sel], m.kf_xy[kf_b],
            self.inv_sigma2[lvl_a[a_sel].long()],
            self.inv_sigma2[lvl_b.long()], agree, self.cam,
            fix_scale=self.fix_scale)
        pairs_ok = res.inliers & agree
        return (res.S, pairs_ok, mp_a[a_sel], mp_b, res.num_inliers,
                agree.sum(dtype=torch.int32))

    def compute_sim3(self, m: MapArrays, kf: int, loop_kf: int, seed: int):
        """S_{kf <- loop_kf}: descriptor matching, Horn RANSAC, guided Sim3
        matching, relative-Sim3 LM (`FindLoopInCandidateKFs`,
        `src/LoopClosing.cc:62-155`). None, or (S, pair mask, point ids in
        kf, point ids in loop_kf) as host arrays."""
        xa, xb, pt_a, pt_b, valid = self._match_kfs_impl(m, kf, loop_kf)
        if int(valid.sum()) < self.MIN_SIM3_INLIERS:
            return None
        gen = torch.Generator(device=xa.device)
        gen.manual_seed(int(seed))
        res = horn_ransac(xb, xa, valid, gen, with_scale=not self.fix_scale,
                          inlier_th=0.09, min_inliers=self.MIN_SIM3_INLIERS)
        if not bool(res.success):
            return None
        # S0: loop-keyframe camera coordinates -> current-keyframe camera
        S0 = sim3.from_se3(res.pose, res.scale)
        S, pairs_ok, pt_a2, pt_b2, n_inl, _ = self._sim3_refine_impl(
            m, kf, loop_kf, S0)
        # the reference accepts the refined Sim3 at >= 20 inliers (:137);
        # when guided matching starves but RANSAC was confident, keep the
        # RANSAC estimate
        if int(n_inl) >= self.MIN_SIM3_INLIERS:
            return (S, pairs_ok.cpu().numpy(), pt_a2.cpu().numpy(),
                    pt_b2.cpu().numpy())
        return (S0, res.inliers.cpu().numpy(), pt_a.cpu().numpy(),
                pt_b.cpu().numpy())

    def verify_by_projection(self, m: MapArrays, graph: MapGraph, kf: int,
                             loop_kf: int, S_cl, min_matches: int = 40):
        """Project the loop neighbourhood's landmarks through the corrected
        pose into the current keyframe and count the matches (K1): the
        reference's final acceptance gate (`src/LoopClosing.cc:259-295`,
        SearchByProjection via Scw, >= 40 matches), TH_LOW and the
        viewing-angle gate."""
        S_loop_cw = sim3.from_se3(m.kf_pose[loop_kf])
        pose_corr = sim3.to_se3(sim3.compose(S_cl, S_loop_cw))
        loop_mask = np.zeros(m.point_capacity, bool)
        group = [loop_kf] + graph.covis_neighbors(loop_kf, top_k=10)
        kf_mp = m.kf_mp[torch.as_tensor(group, device=m.kf_mp.device)]
        rows = kf_mp.cpu().numpy()
        loop_mask[rows[rows >= 0]] = True
        res = matching.search_by_projection(
            m.kf_xy[kf], m.kf_level[kf], m.kf_desc[kf], m.kf_feat_valid[kf],
            m.mp_pos, m.mp_desc, m.mp_normal, m.mp_min_dist, m.mp_max_dist,
            m.mp_valid & torch.as_tensor(loop_mask, device=m.mp_valid.device),
            pose_corr, self.cam, self._sf_arr, radius=10.0, max_dist=50,
            check_view_angle=True)
        n = int(res.valid.sum())
        return n >= min_matches, n

    # ------------------------------------------------------------------

    def correct(self, m: MapArrays, graph: MapGraph, kf: int, loop_kf: int,
                S_cl, inliers, pt_a, pt_b):
        """Loop correction, essential-graph optimization and the launch of
        global BA (`LoopCorrector::Correct`, `src/LoopClosing.cc:521-692`);
        the info dict's `gba_pending` is for `merge_gba`.

        S_cl maps the loop keyframe's camera frame to the current
        keyframe's; the corrected current pose is S_cl * S_loop_cw."""
        dev = m.kf_pose.device
        alive = graph.alive_kfs()
        K = m.kf_capacity
        poses_s = sim3.from_se3(m.kf_pose)
        S_corr_cw = sim3.compose(S_cl, poses_s[loop_kf])

        # ---- the essential graph over every alive keyframe ----
        fixed = np.ones(K, bool)
        fixed[alive] = False
        fixed[loop_kf] = True  # gauge: the loop keyframe holds (:773)
        ei, ej, w = [], [], []
        seen = set()
        # spanning-tree, strong-covisibility and loop edges; parent edges
        # are not entered in `seen` (the JAX package's, kept for parity)
        for a in alive:
            pa = int(graph.parent[a])
            if pa >= 0 and graph.kf_alive[pa]:
                ei.append(int(a)); ej.append(pa); w.append(1.0)
            for b in graph.covis_neighbors(int(a), min_weight=100):
                if (b, a) not in seen:
                    seen.add((int(a), int(b)))
                    ei.append(int(a)); ej.append(int(b)); w.append(1.0)
            for b in graph.loop_edges.get(int(a), set()):
                if (b, a) not in seen:
                    seen.add((int(a), int(b)))
                    ei.append(int(a)); ej.append(int(b)); w.append(1.0)
        ei_t = torch.as_tensor(ei, dtype=torch.int32, device=dev)
        ej_t = torch.as_tensor(ej, dtype=torch.int32, device=dev)
        # measurements from the current (pre-correction) estimates, and the
        # new loop edge from S_cl
        rels = edge_measurement(poses_s[ei_t.long()], poses_s[ej_t.long()])
        loop_rel = edge_measurement(S_corr_cw, poses_s[loop_kf])
        prob = PoseGraphProblem(
            poses=torch.cat([poses_s[:kf], S_corr_cw[None],
                             poses_s[kf + 1:]]),
            fixed=torch.as_tensor(fixed, device=dev),
            edge_i=torch.cat([ei_t, torch.tensor([kf], dtype=torch.int32,
                                                 device=dev)]),
            edge_j=torch.cat([ej_t, torch.tensor([loop_kf],
                                                 dtype=torch.int32,
                                                 device=dev)]),
            edge_rel=torch.cat([rels, loop_rel[None]]),
            edge_w=torch.as_tensor(w + [5.0], dtype=torch.float32,
                                   device=dev))
        new_poses_s, c0, c1 = pose_graph_solve(prob, iters=20, cg_iters=50)

        # ---- poses, and each landmark moved with its reference keyframe:
        # x' = S_new^-1 S_old x (src/Optimizer.cc:925-941), the reference
        # keyframe being the lowest slot that observes it ----
        ref_kf = np.zeros(m.point_capacity, np.int64)
        for pt in graph.points_with_obs():
            if graph.pt_alive[pt]:
                pairs = graph.obs_pairs(pt)
                if pairs:
                    ref_kf[pt] = min(k for k, _ in pairs)
        ref_t = torch.as_tensor(ref_kf, device=dev)
        corr = sim3.compose(sim3.inverse(new_poses_s[ref_t]), poses_s[ref_t])
        new_pts = sim3.transform(corr, m.mp_pos)
        new_pts = torch.where(m.mp_valid[:, None], new_pts, m.mp_pos)
        m = m._replace(kf_pose=sim3.to_se3(new_poses_s), mp_pos=new_pts)

        # ---- fuse the matched loop landmark pairs (Replace, :615-658):
        # the loop keyframe's landmark (older, better observed) is kept ----
        merged_src, merged_dst = [], []
        for a, b, ok in zip(pt_a, pt_b, inliers):
            if not ok:
                continue
            a, b = int(a), int(b)
            if a == b or not graph.pt_alive[a] or not graph.pt_alive[b]:
                continue
            for okf, feat in graph.obs_pairs(a):
                if graph.obs_feat_in_kf(b, okf) < 0:
                    graph.add_observation(b, okf, feat, False)
            graph.kill_point(a)
            merged_src.append(a)
            merged_dst.append(b)
        # the device remap follows exactly the pairs merged on the host
        if merged_src:
            P = m.point_capacity
            src = torch.as_tensor(merged_src, dtype=torch.long, device=dev)
            lut = torch.arange(P, dtype=torch.int32, device=dev)
            lut[src] = torch.as_tensor(merged_dst, dtype=torch.int32,
                                       device=dev)
            kf_mp = torch.where(
                m.kf_mp >= 0, lut[torch.clamp(m.kf_mp, 0, P - 1).long()],
                m.kf_mp)
            mp_valid = m.mp_valid.clone()
            mp_valid[src] = False
            m = m._replace(kf_mp=kf_mp, mp_valid=mp_valid)

        # loop edges recorded both ways (:684-685)
        graph.loop_edges.setdefault(kf, set()).add(loop_kf)
        graph.loop_edges.setdefault(loop_kf, set()).add(kf)
        self.last_loop_kf = kf
        self.last_loop_seq = int(graph.kf_seq[kf])
        self.loops_closed += 1
        pg = torch.stack([c0, c1]).tolist()
        return m, {"pg_cost": (pg[0], pg[1]),
                   "gba_pending": self.launch_gba(m, graph)}

    def _merge_gba_impl(self, m: MapArrays, new_pose, gba_pts, pt_launched,
                        pt_ref_kf):
        """Global-BA result merge (`GlobalBA::_Run`,
        `src/LoopClosing.cc:393-446`): `new_pose` holds every keyframe's
        final pose; points created since the launch move with their
        reference keyframe's correction, launched points take the BA
        positions."""
        new_pose = torch.where(m.kf_valid[:, None], new_pose, m.kf_pose)
        ref = torch.clamp(pt_ref_kf, 0, m.kf_capacity - 1).long()
        corr = se3.compose(se3.inverse(new_pose[ref]), m.kf_pose[ref])
        moved = se3.transform(corr, m.mp_pos)
        new_pts = torch.where(pt_launched[:, None], gba_pts, moved)
        new_pts = torch.where(m.mp_valid[:, None], new_pts, m.mp_pos)
        return m._replace(kf_pose=new_pose, mp_pos=new_pts)

    def launch_gba(self, m: MapArrays, graph: MapGraph):
        """Global BA over the whole map, computed now (the reference's
        detached GBA thread, `src/LoopClosing.cc:309-347`); the pending
        result is merged by `merge_gba`."""
        K = m.kf_capacity
        alive = graph.alive_kfs()
        free = np.zeros(K, bool)
        free[alive] = True
        free[graph.origin_kf] = False
        kf_pose2, pt_pos2, _, g0, g1 = self._gba_impl(
            m, torch.as_tensor(free, device=m.kf_pose.device))
        kf_launched = np.zeros(K, bool)
        kf_launched[alive] = True
        pt_launched = np.zeros(m.point_capacity, bool)
        pt_launched[graph.alive_points()] = True
        return {"gba_pose": kf_pose2, "gba_pts": pt_pos2,
                "kf_launched": kf_launched, "pt_launched": pt_launched,
                "costs": (g0, g1)}

    def merge_gba(self, m: MapArrays, graph: MapGraph, pending):
        """Apply a pending global-BA result to the (possibly grown) map.

        Keyframes created since the launch are corrected through the
        spanning tree relative to their parent's pose at merge time (the
        reference records TcwBefGBA during the merge walk), in creation
        order, so that chains of late keyframes cascade."""
        cur = m.kf_pose.cpu().numpy()
        gba = pending["gba_pose"].cpu().numpy()
        kl = pending["kf_launched"]
        new_pose = np.where(kl[:, None], gba, cur).astype(np.float32)
        late = sorted((int(k) for k in graph.alive_kfs() if not kl[k]),
                      key=lambda k: graph.kf_seq[k])
        for k in late:
            p = graph.parent[k]
            p = int(p) if p >= 0 else graph.origin_kf
            rel = _np_compose(cur[k], _np_inverse(cur[p]))
            new_pose[k] = _np_compose(rel, new_pose[p])
        pt_ref = np.zeros(m.point_capacity, np.int32)
        kf_seq = graph.kf_seq
        for pt in graph.points_with_obs():
            pairs = graph.obs_pairs(pt)
            if pairs:
                # earliest observer by creation sequence
                pt_ref[pt] = min((k for k, _ in pairs),
                                 key=lambda k: kf_seq[k])
        dev = m.kf_pose.device
        m = self._merge_gba_impl(
            m, torch.as_tensor(new_pose, device=dev), pending["gba_pts"],
            torch.as_tensor(pending["pt_launched"], device=dev),
            torch.as_tensor(pt_ref, device=dev))
        g = torch.stack(list(pending["costs"])).tolist()
        return m, {"gba_cost": (g[0], g[1])}

    def _gba_impl(self, m: MapArrays, free_mask):
        """Global BA (`GlobalBundleAdjustment`, `src/Optimizer.cc:204-343`)
        on the whole map's live points: (poses [K,7], points [P,3], the
        final chi2 gate [K,N], initial cost, final cost)."""
        prob, live = compact_points(
            problem_from_map(m, free_mask, self.inv_sigma2))
        res = ba_solve(prob, self.cam, iters=self.gba_iters,
                       cg_iters=self.gba_cg_iters, lambda0=1e-3,
                       dense_schur=False)
        pts = m.mp_pos.clone()
        pts[live] = res.pt_pos[:live.numel()]
        return res.kf_pose, pts, res.obs_inlier, res.initial_cost, \
            res.final_cost
