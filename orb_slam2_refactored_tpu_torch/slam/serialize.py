"""Map checkpoint and resume: save and load the whole SLAM state.

Port of `orb_slam2_refactored_tpu/slam/serialize.py`. The map's tensors go
to one compressed `.npz`, the host graph (observations, covisibility,
spanning tree, loop edges, lifecycle state) flattens to index arrays, and
the vocabulary with the keyframes' BoW rows travels with the map, so that a
loaded map can relocalize at once.

The schema is the JAX package's key for key and dtype for dtype:
descriptors and vocabulary words are written as uint32 (`convert.py`), so a
file saved by either package loads in the other. The graph goes through the
accessors both host graphs share, so a file saved from the Python
`MapGraph` or the C++ arena (`native.py`) loads into either.
"""

from __future__ import annotations

import numpy as np

from .. import convert
from .loop_closing import LoopCloser
from .tracking import Tracker, TrackState


def save_map(tracker: Tracker, path: str):
    # drain the deferred mapping products so that the saved graph matches
    # the saved tensors
    tracker._finalize_map()
    # a checkpoint without place-recognition state could never be
    # relocalized into: build the BoW index now if the session was too
    # short for the lazy trainer
    tracker.force_bow_index()
    g = tracker.graph
    arrays = {f"map_{k}": v
              for k, v in convert.map_to_numpy(tracker.map).items()}

    obs = []
    for pt in g.points_with_obs():
        for kf, feat in g.obs_pairs(pt):
            obs.append((pt, kf, feat))
    obs = np.asarray(obs, np.int64).reshape(-1, 3)

    alive_kfs = g.alive_kfs()
    covis = []
    for a in alive_kfs:
        for b in g.covis_neighbors(int(a)):
            if b > a:
                covis.append((a, b, g.covis_w(int(a), int(b))))
    covis = np.asarray(covis, np.int64).reshape(-1, 3)

    parent = np.asarray(
        [g.parent[k] for k in range(g.cap.max_keyframes)], np.int64)
    loops = []
    for a in alive_kfs:
        for b in g.loop_edges.get(int(a), set()):
            if b > a:
                loops.append((a, b))
    loops = np.asarray(loops, np.int64).reshape(-1, 2)

    pt_alive = np.zeros(g.cap.max_points, bool)
    for p in g.alive_points():
        pt_alive[p] = True
    pt_first = np.asarray(
        [g.pt_first_kf[p] for p in np.nonzero(pt_alive)[0]], np.int64)
    pt_first_idx = np.nonzero(pt_alive)[0]

    # place-recognition state: the vocabulary is live-trained, so it must
    # travel with the map (the reference reloads ORBvoc.txt at startup)
    voc_arrays = {}
    lc = tracker.loop_closer
    if lc is not None:
        voc = convert.vocabulary_to_numpy(lc.db.voc)
        voc_arrays = {
            "voc_words": voc["words"],
            "voc_idf": voc["idf"],
            "voc_bow_ids": lc.db.bow_ids.cpu().numpy(),  # sparse rows
            "voc_bow_cnt": lc.db.bow_cnt.cpu().numpy(),
            "voc_db_idf": lc.db.idf.cpu().numpy(),  # live-refit idf
            "voc_active": lc.db.active,
            "voc_fix_scale": np.int64(lc.fix_scale),
        }

    np.savez_compressed(
        path,
        **arrays,
        **voc_arrays,
        graph_obs=obs,
        graph_covis=covis,
        graph_parent=parent,
        graph_loops=loops,
        graph_kf_alive=g.kf_alive,
        graph_kf_frame_id=g.kf_frame_id,
        graph_kf_timestamp=g.kf_timestamp,
        graph_pt_alive=pt_alive,
        graph_pt_first_idx=pt_first_idx,
        graph_pt_first_val=pt_first,
        graph_origin=np.int64(g.origin_kf),
        graph_num_kfs=np.int64(g.num_kfs),
        graph_next_kf_slot=np.int64(g.next_kf_slot),
        graph_kf_seq=np.asarray(g.kf_seq, np.int64),
        graph_kf_quarantine=np.asarray(
            [(k, st) for k, st in g.kf_quarantine], np.int64).reshape(-1, 2),
        # young-point trial windows and the point-slot quarantine: without
        # them a loaded map would skip min-obs culling of in-trial points
        graph_young_pts=np.asarray(
            [(p, sq) for p, sq in g.young_pts], np.int64).reshape(-1, 2),
        graph_pt_quarantine=np.asarray(
            [(p, st) for p, st in g.pt_quarantine], np.int64).reshape(-1, 2),
        graph_next_point=np.int64(g.next_point),
        graph_watermark=np.asarray(g.kf_watermark, np.int64),
        tracker_pose=np.asarray(tracker.pose, np.float32),
        tracker_state=np.int64(tracker.state),
        tracker_ref_kf=np.int64(tracker.ref_kf),
    )


def load_map(tracker: Tracker, path: str):
    """Restore a saved map into a freshly constructed Tracker of the same
    configuration, on its device. Returns the tracker, LOST (so that the
    next frame relocalizes against the loaded map) unless the map was saved
    before initialization."""
    z = np.load(path, allow_pickle=False)
    tracker.map = convert.map_from_numpy(
        {k[len("map_"):]: z[k] for k in z.files if k.startswith("map_")},
        tracker.device)
    g = tracker.graph
    g.num_kfs = int(z["graph_num_kfs"])
    g.next_kf_slot = (int(z["graph_next_kf_slot"])
                      if "graph_next_kf_slot" in z.files else g.num_kfs)
    if "graph_kf_seq" in z.files:
        g.kf_seq[:] = z["graph_kf_seq"]
    else:  # legacy checkpoint: slots were allocated monotonically
        g.kf_seq[: g.num_kfs] = np.arange(g.num_kfs)
    if "graph_kf_quarantine" in z.files:
        g.kf_quarantine = [(int(a), int(b))
                           for a, b in z["graph_kf_quarantine"]]
    if "graph_young_pts" in z.files:
        g.young_pts = [(int(p), int(sq)) for p, sq in z["graph_young_pts"]]
    if "graph_pt_quarantine" in z.files:
        g.pt_quarantine = [(int(p), int(st))
                           for p, st in z["graph_pt_quarantine"]]
    g.next_point = int(z["graph_next_point"])
    g.origin_kf = int(z["graph_origin"])
    if "graph_watermark" in z.files:
        g.kf_watermark[:] = z["graph_watermark"]
    kf_alive = z["graph_kf_alive"]
    for k in np.nonzero(kf_alive)[0]:
        g.set_kf_alive(int(k), True)
    g.kf_frame_id[:] = z["graph_kf_frame_id"]
    g.kf_timestamp[:] = z["graph_kf_timestamp"]
    for p in np.nonzero(z["graph_pt_alive"])[0]:
        g.pt_alive[int(p)] = True
    for p, v in zip(z["graph_pt_first_idx"], z["graph_pt_first_val"]):
        g.pt_first_kf[int(p)] = int(v)
    for pt, kf, feat in z["graph_obs"]:
        g.add_observation(int(pt), int(kf), int(feat), False)
    # covisibility rebuilds exactly from the stored rows
    kf_mp = z["map_kf_mp"]
    for k in np.nonzero(kf_alive)[0]:
        g.update_connections(int(k), kf_mp[k], obs_for_new=False)
    for k, p in enumerate(z["graph_parent"]):
        if p >= 0:
            # keyframe culling's re-parenting needs the children
            g.set_parent(int(k), int(p))
    for a, b in z["graph_loops"]:
        g.loop_edges.setdefault(int(a), set()).add(int(b))
        g.loop_edges.setdefault(int(b), set()).add(int(a))

    # place recognition: the vocabulary and the BoW rows make a ready
    # LoopCloser, so the loaded map relocalizes on the next frame
    if "voc_words" in z.files:
        voc = convert.vocabulary_from_numpy(
            {"words": z["voc_words"], "idf": z["voc_idf"]}, tracker.device)
        tracker.vocabulary = voc
        cap = tracker.cfg.map_capacity.max_keyframes
        lc = LoopCloser(voc, tracker.cam, cap, tracker.cfg.n_levels,
                        tracker.cfg.scale_factor,
                        fix_scale=bool(z["voc_fix_scale"]))
        if "voc_bow_ids" in z.files:  # sparse rows (current format)
            ids, cnt = z["voc_bow_ids"], z["voc_bow_cnt"]
        else:  # legacy dense [KF, W] checkpoint: convert to sparse rows
            dense = np.asarray(z["voc_bow"])
            T = lc.db.row_capacity
            W = dense.shape[1]
            ids = np.argsort(-dense, axis=1)[:, :T].astype(np.int32)
            cnt = np.take_along_axis(dense, ids, axis=1).astype(np.float32)
            ids[cnt <= 0] = W
            cnt[cnt <= 0] = 0.0
        lc.db = convert.database_from_numpy(
            voc, cap, ids, cnt, z["voc_active"],
            z["voc_db_idf"] if "voc_db_idf" in z.files else z["voc_idf"])
        tracker.loop_closer = lc

    tracker.pose = np.asarray(z["tracker_pose"], np.float32)
    tracker.pose_dev = tracker._t(tracker.pose)
    tracker.ref_kf = int(z["tracker_ref_kf"])
    tracker.ref_kf_tracked = 1
    tracker._ref_mp_row = kf_mp[tracker.ref_kf] if tracker.ref_kf >= 0 else None
    # resume LOST: the first tracked frame relocalizes against the map
    tracker.state = (
        TrackState.LOST if int(z["tracker_state"]) != TrackState.NOT_INITIALIZED
        else TrackState.NOT_INITIALIZED)
    return tracker
