"""Port parity for relocalization and map save/load (`slam/tracking.py`'s
LOST branch, `slam/serialize.py`), module by module and as a whole.

One module fixture: the port's tracker maps a short QVGA clip on the CPU
(local BA on, a keyframe every 4 frames, so more than 5 alive keyframes and
a trained vocabulary) and saves its map; a few blank frames lose tracking;
the clip resumes at an early, mapped view. A JAX `Tracker` of the same
configuration (the Python graph, `TPU_SLAM_NATIVE_GRAPH=0`) loads the port's
file and runs no tracking; a fresh port tracker loads it too. Both packages
then relocalize the same converted frame of the first resume view.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.slam.frame import FrameData as JFrame
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.serialize import load_map as jax_load_map
from orb_slam2_refactored_tpu.slam.serialize import save_map as jax_save_map
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.geometry import se3
from orb_slam2_refactored_tpu_torch.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.serialize import load_map, save_map
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    Tracker, TrackerConfig, TrackState)

torch.set_num_threads(1)
KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
          bf=0.08 * 260.0, n_features=500, n_levels=4, enable_local_ba=True,
          pipelined=False, kf_max_interval=4)
N_MAP = 28            # mapped frames: 7 keyframes
N_BLANK = 3
RESUME = range(4, 12)  # an early view, mapped in the first phase


def _port_tracker():
    return Tracker(TrackerConfig(map_capacity=MapCapacity(16, 4096, 500),
                                 **KW), device="cpu")


def _jax_tracker(monkeypatch_ctx):
    monkeypatch_ctx.setenv("TPU_SLAM_NATIVE_GRAPH", "0")
    return JTracker(JConfig(map_capacity=JCap(16, 4096, 500), **KW))


def _pose_gap(a, b):
    """(translation m, rotation rad) of a * b^-1."""
    d = se3.log(se3.compose(torch.tensor(np.asarray(a, np.float32)),
                            se3.inverse(torch.tensor(
                                np.asarray(b, np.float32)))))
    return float(d[3:].norm()), float(d[:3].norm())


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    planes = box_room(half_x=1.7, half_y=1.3, z_far=2.7, z_near=-2.7,
                      distinct_textures=True)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(160, radius=0.5, yaw_amp=0.35)
    rng = np.random.default_rng(5)

    def frame(i):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
        return (np.clip(img, 0, 255).astype(np.uint8),
                depth.astype(np.float16).astype(np.float32))

    t = _port_tracker()
    for i in range(N_MAP):
        t.track_rgbd(*frame(i))
    out = {"gt": gt, "tracker": t, "n_kfs": len(t.graph.alive_kfs())}
    path = str(tmp_path_factory.mktemp("maps") / "port.npz")
    save_map(t, path)
    out["path"] = path
    blank = np.zeros((240, 320), np.uint8)
    out["blank_states"] = []
    for _ in range(N_BLANK):
        t.track_rgbd(blank, np.zeros((240, 320), np.float32))
        out["blank_states"].append(int(t.state))
    out["n_kfs_after_blank"] = len(t.graph.alive_kfs())

    # record the frame (and frame id) of every relocalization attempt
    real = t._relocalize
    attempts = []

    def relocalize(fr):
        ok = real(fr)
        attempts.append((fr, t.frame_id, ok, t.pose.copy()))
        return ok

    t._relocalize = relocalize
    out["resume_states"] = []
    for i in RESUME:
        t.track_rgbd(*frame(i))
        out["resume_states"].append(int(t.state))
    out["attempts"] = attempts

    # the same file in a fresh port tracker and in a JAX tracker, each of
    # which saves it again
    d = tmp_path_factory.mktemp("maps")
    out["port_loaded"] = load_map(_port_tracker(), path)
    out["path_port2"] = str(d / "port2.npz")
    save_map(out["port_loaded"], out["path_port2"])
    with pytest.MonkeyPatch.context() as mp:
        jt = _jax_tracker(mp)
    jax_load_map(jt, path)
    out["jax_loaded"] = jt
    out["path_jax2"] = str(d / "jax2.npz")
    jax_save_map(jt, out["path_jax2"])
    return out


def _jax_frame(fr):
    return JFrame(**{k: jnp.asarray(v)
                     for k, v in convert.frame_to_numpy(fr).items()})


def test_blackout_loses_tracking_without_reset(session):
    assert session["n_kfs"] > 5
    assert all(s == TrackState.LOST for s in session["blank_states"])
    assert session["n_kfs_after_blank"] == session["n_kfs"]


def test_every_keyframe_is_indexed(session):
    t = session["tracker"]
    assert t.loop_closer is not None and t.vocabulary is not None
    assert t.vocabulary.n_words == 512
    alive = t.graph.alive_kfs()
    assert t.loop_closer.db.active[alive].all()
    assert t.loop_closer._n_indexed >= len(alive)


def test_relocalizes_within_the_kidnap_bound(session):
    states = session["resume_states"]
    assert TrackState.OK in states, states
    first_ok = states.index(TrackState.OK)
    assert first_ok <= 20 and states[-1] == TrackState.OK, states
    n = len(RESUME)
    t = session["tracker"]
    est = np.stack(t.trajectory[-(n - first_ok):])
    gt = session["gt"][RESUME.start + first_ok: RESUME.stop]
    rmse, _ = ate_rmse(est, gt, align="se3")
    print(f"[reloc] after {first_ok} resume frames, post-recovery ATE "
          f"{rmse:.4f} m over {len(gt)} frames")
    assert rmse < 0.08
    assert t.track_info[-n + first_ok].get("reloc") is True


@pytest.fixture(scope="module")
def both_relocalize(session):
    """Both loaded trackers relocalize the first resume frame (the port's
    own frame, converted), with the same frame id; their candidate lists
    are recorded."""
    fr, frame_id, _, _ = session["attempts"][0]
    pt, jt = session["port_loaded"], session["jax_loaded"]
    cands = {}
    for name, trk in (("port", pt), ("jax", jt)):
        db = trk.loop_closer.db
        real = db.detect_candidates_grouped

        def grouped(*a, _real=real, _name=name, **k):
            cands[_name] = _real(*a, **k)
            return cands[_name]

        db.detect_candidates_grouped = grouped
        trk.frame_id = frame_id
    ok_p = pt._relocalize(fr)
    ok_j = jt._relocalize(_jax_frame(fr))
    return ok_p, ok_j, cands, fr


def test_relocalize_equal_on_the_shared_map(both_relocalize, session):
    ok_p, ok_j, cands, _ = both_relocalize
    pt, jt = session["port_loaded"], session["jax_loaded"]
    assert ok_p and ok_j
    assert cands["port"] == cands["jax"] and cands["port"]
    dt, dr = _pose_gap(pt.pose, jt.pose)
    print(f"[reloc] candidates {cands['port']}; port vs JAX final pose "
          f"{dt * 1e3:.3f} mm, {dr:.2e} rad")
    assert dt <= 5e-3 and dr <= 5e-3
    assert pt.state == TrackState.OK
    np.testing.assert_array_equal(pt.velocity, se3.identity().numpy())


def test_reloc_match_exact(both_relocalize, session):
    _, _, cands, fr = both_relocalize
    pt, jt = session["port_loaded"], session["jax_loaded"]
    kf = cands["port"][0]
    p3, fp, v = pt._reloc_match_impl(fr, pt.map, kf)
    j3, jfp, jv = JTracker._reloc_match_impl(jt, _jax_frame(fr), jt.map,
                                             jnp.int32(kf))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(p3.numpy(), np.asarray(j3))
    assert int(v.sum()) >= 15


def test_reloc_polish_from_the_same_pose(both_relocalize, session):
    _, _, _, fr = both_relocalize
    pt, jt = session["port_loaded"], session["jax_loaded"]
    pose = np.asarray(pt.pose, np.float32)
    p_pose, p_feat, p_n = pt._reloc_polish_impl(fr, pt.map,
                                                torch.from_numpy(pose))
    j_pose, j_feat, j_n = JTracker._reloc_polish_impl(
        jt, _jax_frame(fr), jt.map, jnp.asarray(pose))
    dt, dr = _pose_gap(p_pose.numpy(), np.asarray(j_pose))
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    np.testing.assert_array_equal(p_feat.numpy(), np.asarray(j_feat))
    assert int(p_n) == int(j_n) >= 20


def test_force_bow_index_with_an_injected_vocabulary(session):
    """`set_vocabulary` skips the training: `force_bow_index` indexes every
    alive keyframe of a loaded map with the given words, and the rows equal
    the saved ones."""
    t = load_map(_port_tracker(), session["path"])
    saved = t.loop_closer.db
    t.loop_closer, t.vocabulary = None, None
    t.set_vocabulary(session["tracker"].vocabulary)
    assert t.force_bow_index()
    db = t.loop_closer.db
    alive = t.graph.alive_kfs()
    assert db.voc is session["tracker"].vocabulary
    assert t.loop_closer._n_indexed == len(alive)
    assert (db.active == saved.active).all()
    assert torch.equal(db.bow_ids[alive], saved.bow_ids[alive])
    assert torch.equal(db.bow_cnt[alive], saved.bow_cnt[alive])


def test_legacy_dense_bow_file_loads_equal_in_both_packages(session,
                                                            tmp_path):
    """A checkpoint with dense [KF, W] rows (`voc_bow`, no `voc_db_idf`)
    converts to the same sparse rows in the port as in the JAX package."""
    z = dict(np.load(session["path"]))
    ids, cnt = z.pop("voc_bow_ids"), z.pop("voc_bow_cnt")
    z.pop("voc_db_idf")
    W = z["voc_words"].shape[0]
    dense = np.zeros((ids.shape[0], W + 1), np.float32)
    np.put_along_axis(dense, ids.astype(np.int64), cnt, axis=1)
    z["voc_bow"] = dense[:, :W]
    path = str(tmp_path / "legacy.npz")
    np.savez_compressed(path, **z)
    t = load_map(_port_tracker(), path)
    with pytest.MonkeyPatch.context() as mp:
        jt = _jax_tracker(mp)
    jax_load_map(jt, path)
    db, jdb = t.loop_closer.db, jt.loop_closer.db
    np.testing.assert_array_equal(db.bow_ids.numpy(), np.asarray(jdb.bow_ids))
    np.testing.assert_array_equal(db.bow_cnt.numpy(), np.asarray(jdb.bow_cnt))
    np.testing.assert_array_equal(db.idf.numpy(), np.asarray(jdb.idf))
    np.testing.assert_array_equal(db.active, jdb.active)


def _rows(a):
    a = np.asarray(a)
    return a[np.lexsort(a.T[::-1])] if a.ndim == 2 and len(a) else a


def test_map_files_round_trip_both_ways(session):
    """The port's file, and its re-saves by a JAX tracker and by a port
    tracker that loaded it: the same keys with the same dtypes and values
    (but the state: a loaded tracker is LOST). Covisibility is rebuilt
    from the keyframes' rows at load, so the re-saves' weights are held
    against each other, not against the live graph's. The JAX-written file
    loaded by the port gives the map back."""
    a = np.load(session["path"])
    b = np.load(session["path_jax2"])
    c = np.load(session["path_port2"])
    assert set(a.files) == set(b.files) == set(c.files)
    assert a["map_kf_desc"].dtype == np.uint32
    assert a["voc_words"].dtype == np.uint32
    for k in a.files:
        assert a[k].dtype == b[k].dtype == c[k].dtype, k
        if k == "graph_covis":
            np.testing.assert_array_equal(_rows(b[k]), _rows(c[k]), k)
        elif k == "tracker_state":  # saved tracking, loaded LOST
            assert int(a[k]) == TrackState.OK
            assert int(b[k]) == int(c[k]) == TrackState.LOST
        elif k in ("graph_obs", "graph_loops"):
            np.testing.assert_array_equal(_rows(a[k]), _rows(b[k]), k)
        else:
            np.testing.assert_array_equal(a[k], b[k], k)
            np.testing.assert_array_equal(a[k], c[k], k)
    back = load_map(_port_tracker(), session["path_jax2"])
    saved = {k[4:]: a[k] for k in a.files if k.startswith("map_")}
    for k, v in convert.map_to_numpy(back.map).items():
        np.testing.assert_array_equal(v, saved[k], k)
    t = session["port_loaded"]
    assert sorted(back.graph.alive_kfs()) == sorted(t.graph.alive_kfs())
    for p in back.graph.points_with_obs():
        assert sorted(back.graph.obs_pairs(p)) == sorted(t.graph.obs_pairs(p))
    for k in back.graph.alive_kfs():
        assert back.graph.covis_neighbors(int(k)) == \
            t.graph.covis_neighbors(int(k))
    assert back.state == TrackState.LOST
    db, db0 = back.loop_closer.db, t.loop_closer.db
    assert torch.equal(db.bow_ids, db0.bow_ids)
    assert torch.equal(db.bow_cnt, db0.bow_cnt)
    assert torch.equal(db.idf, db0.idf)
    assert (db.active == db0.active).all()
