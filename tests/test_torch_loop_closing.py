"""Port parity for loop closing (`slam/loop_closing.py`) and the tracker's
loop stage (`slam/tracking.py`), module by module.

One module fixture: the port's tracker maps a short QVGA orbit on the CPU
(local BA off) and saves its map; a fresh port tracker and a JAX `Tracker`
(the Python graph, `TPU_SLAM_NATIVE_GRAPH=0`) load the file, so both hold
the same map, graph and vocabulary. Both packages then run the forced loop
of `tests/test_loop_closing.py` (the last keyframe against the first), each
with its own `LoopCloser` (4 global-BA iterations of 20 CG iterations):
- `_sim3_refine` from the same S0: the pair masks and point ids equal, S
  within 1e-4;
- `compute_sim3`: both succeed (the RANSAC draws differ,
  `solvers/ransac.py`), S within 5 mm / 5e-3 rad;
- `verify_by_projection` on JAX's S: equal counts;
- `correct`: the pose-graph costs within 1e-3 relative, keyframe poses
  within 1e-4 m, points within 1e-3 m, the `kf_mp` remap, `mp_valid` and
  the loop edges equal; its global BA's costs within 1e-3 relative, poses
  within 1e-3 m and points within 1e-2 m (40 f32 CG solves apart);
- `merge_gba` with a launched keyframe moved and two late keyframes (JAX's
  `TestGbaMergeLateKeyframes`): poses within 1e-4 m, points within 1e-2 m,
  and each late child's pose relative to its parent kept within 1e-4.
Then, on a seeded host graph of 14 alive keyframes: `_detect_policy` over 4
scripted score vectors (consistency groups and returned candidates equal),
`_implicit_loop_candidate`, `_seam_check` over a scripted frame sequence,
and the covisibility window's mask (`_refresh_local_mask`,
`_maybe_refresh_local_mask`), equal to JAX's.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.slam.loop_closing import LoopCloser as JLC
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.map_state import MapGraph as JGraph
from orb_slam2_refactored_tpu.slam.serialize import load_map as jax_load_map
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu.slam.vocabulary import Vocabulary as JVoc
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu_torch.slam.map_state import MapGraph
from orb_slam2_refactored_tpu_torch.slam.serialize import load_map, save_map
from orb_slam2_refactored_tpu_torch.slam.system import (
    _np_compose, _np_inverse)
from orb_slam2_refactored_tpu_torch.slam.tracking import (
    Tracker, TrackerConfig)
from orb_slam2_refactored_tpu_torch.slam.vocabulary import Vocabulary

torch.set_num_threads(1)
KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
          bf=0.08 * 260.0, n_features=600, n_levels=4, enable_local_ba=False)
CAP = (64, 8192, 600)
GBA = dict(gba_iters=4, gba_cg_iters=20)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(50, radius=0.35, yaw_amp=0.3)
    rng = np.random.default_rng(11)
    t = Tracker(TrackerConfig(map_capacity=MapCapacity(*CAP), **KW),
                device="cpu")
    for i in range(50):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.01, depth.shape).astype(
            np.float32))
        t.track_rgbd(img, depth, timestamp=i / 30.0)
    assert t.state == 1
    path = str(tmp_path_factory.mktemp("maps") / "port.npz")
    save_map(t, path)
    pt = load_map(Tracker(TrackerConfig(map_capacity=MapCapacity(*CAP), **KW),
                          device="cpu"), path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_SLAM_NATIVE_GRAPH", "0")
        jt = JTracker(JConfig(map_capacity=JCap(*CAP), **KW))
    jax_load_map(jt, path)
    kfs = [int(k) for k in pt.graph.alive_kfs()]
    np.testing.assert_array_equal(kfs, jt.graph.alive_kfs())
    lc = LoopCloser(pt.vocabulary, pt.cam, CAP[0], 4, 1.2, **GBA)
    jlc = JLC(jt.vocabulary, jt.cam, CAP[0], 4, 1.2, **GBA)
    return dict(pt=pt, jt=jt, lc=lc, jlc=jlc, kf=kfs[-1], loop=kfs[0],
                kfs=kfs)


def _rel_s0(m, a, b):
    """The tracked relative pose of keyframe a to b as a Sim3 (numpy)."""
    kp = m.kf_pose.numpy()
    return np.concatenate([_np_compose(kp[a], _np_inverse(kp[b])),
                           np.zeros(1, np.float32)])


def test_sim3_refine_from_the_same_seed(session):
    pt, jt, lc, jlc = session["pt"], session["jt"], session["lc"], \
        session["jlc"]
    kf, loop = session["kf"], session["loop"]
    S0 = _rel_s0(pt.map, kf, loop)
    out = lc._sim3_refine_impl(pt.map, kf, loop, torch.as_tensor(S0))
    ref = jlc._sim3_refine(jt.map, jnp.int32(kf), jnp.int32(loop),
                           jnp.asarray(S0))
    ok, rok = out[1].numpy(), np.asarray(ref[1])
    np.testing.assert_array_equal(ok, rok)
    assert ok.sum() >= 20
    np.testing.assert_array_equal(out[2].numpy()[ok], np.asarray(ref[2])[ok])
    np.testing.assert_array_equal(out[3].numpy()[ok], np.asarray(ref[3])[ok])
    assert int(out[4]) == int(ref[4]) and int(out[5]) == int(ref[5])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-4)


@pytest.fixture(scope="module")
def sim3s(session):
    pt, jt, lc, jlc = session["pt"], session["jt"], session["lc"], \
        session["jlc"]
    kf, loop = session["kf"], session["loop"]
    out = lc.compute_sim3(pt.map, kf, loop, kf)
    import jax
    ref = jlc.compute_sim3(jt.map, kf, loop, jax.random.PRNGKey(kf))
    return out, ref


def _gap(a, b):
    """(translation m, rotation rad) between two Sim3 (scale ignored)."""
    d = np.asarray(jse3.log(jse3.compose(jnp.asarray(a[:7]),
                                         jse3.inverse(jnp.asarray(b[:7])))))
    return np.abs(d[3:]).max(), np.abs(d[:3]).max()


def test_compute_sim3_same_outcome(sim3s):
    out, ref = sim3s
    assert out is not None and ref is not None
    assert out[1].sum() >= 20 and np.asarray(ref[1]).sum() >= 20
    dt, dr = _gap(out[0].numpy(), np.asarray(ref[0]))
    assert dt <= 5e-3 and dr <= 5e-3, (dt, dr)


def test_verify_by_projection_equal_counts(session, sim3s):
    pt, jt, lc, jlc = session["pt"], session["jt"], session["lc"], \
        session["jlc"]
    kf, loop = session["kf"], session["loop"]
    S = np.asarray(sim3s[1][0])
    ok, n = lc.verify_by_projection(pt.map, pt.graph, kf, loop,
                                    torch.as_tensor(S))
    rok, rn = jlc.verify_by_projection(jt.map, jt.graph, kf, loop,
                                       jnp.asarray(S))
    assert (ok, n) == (rok, rn)
    assert n > 0


@pytest.fixture(scope="module")
def corrected(session, sim3s):
    """Both packages' `correct` on JAX's Sim3 and pairs, each on a copy of
    its graph."""
    pt, jt, lc, jlc = session["pt"], session["jt"], session["lc"], \
        session["jlc"]
    kf, loop = session["kf"], session["loop"]
    S, inl, pa, pb = (np.asarray(a) for a in sim3s[1])
    g, jg = copy.deepcopy(pt.graph), copy.deepcopy(jt.graph)
    m, info = lc.correct(pt.map, g, kf, loop, torch.as_tensor(S), inl, pa,
                         pb)
    jm, jinfo = jlc.correct(jt.map, jg, kf, loop, jnp.asarray(S), inl, pa, pb)
    return dict(m=m, info=info, g=g, jm=jm, jinfo=jinfo, jg=jg)


def test_correct_matches_jax(corrected, session):
    c = corrected
    for a, b in zip(c["info"]["pg_cost"], c["jinfo"]["pg_cost"]):
        assert abs(a - b) <= 1e-3 * max(abs(b), 1e-6), (a, b)
    kfs = session["kfs"]
    np.testing.assert_allclose(c["m"].kf_pose.numpy()[kfs],
                               np.asarray(c["jm"].kf_pose)[kfs], atol=1e-4)
    valid = np.asarray(c["jm"].mp_valid)
    np.testing.assert_array_equal(c["m"].mp_valid.numpy(), valid)
    np.testing.assert_allclose(c["m"].mp_pos.numpy()[valid],
                               np.asarray(c["jm"].mp_pos)[valid], atol=1e-3)
    np.testing.assert_array_equal(c["m"].kf_mp.numpy(),
                                  np.asarray(c["jm"].kf_mp))
    assert c["g"].loop_edges == c["jg"].loop_edges
    assert session["loop"] in c["g"].loop_edges[session["kf"]]
    np.testing.assert_array_equal(c["g"].pt_alive, c["jg"].pt_alive)
    # the pending global BA
    pend, jpend = c["info"]["gba_pending"], c["jinfo"]["gba_pending"]
    for a, b in zip(pend["costs"], jpend["costs"]):
        assert abs(float(a) - float(b)) <= 1e-3 * float(b)
    assert float(pend["costs"][1]) < float(pend["costs"][0])
    np.testing.assert_array_equal(pend["kf_launched"], jpend["kf_launched"])
    np.testing.assert_array_equal(pend["pt_launched"], jpend["pt_launched"])
    np.testing.assert_allclose(pend["gba_pose"].numpy()[kfs],
                               np.asarray(jpend["gba_pose"])[kfs], atol=1e-3)
    np.testing.assert_allclose(pend["gba_pts"].numpy()[valid],
                               np.asarray(jpend["gba_pts"])[valid], atol=1e-2)


def test_merge_gba_with_late_keyframes_matches_jax(corrected, session):
    c = corrected
    lc, jlc = session["lc"], session["jlc"]
    g, jg = copy.deepcopy(c["g"]), copy.deepcopy(c["jg"])
    kfs = session["kfs"]
    cur = c["m"].kf_pose.numpy().copy()
    moved = kfs[-2]
    bump = np.asarray(jse3.exp(jnp.asarray(
        [0.02, -0.01, 0.03, 0.15, -0.1, 0.08], jnp.float32)))
    cur[moved] = _np_compose(bump, cur[moved])
    step = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 0.05, 0, 0],
                                           jnp.float32)))
    late = []
    parent = moved
    for _ in range(2):
        slots = []
        for gr in (g, jg):
            s = gr.alloc_kf_slot()
            gr.set_kf_alive(s, True)
            gr.parent[s] = parent
            slots.append(s)
        assert slots[0] == slots[1]
        cur[slots[0]] = _np_compose(step, cur[parent])
        late.append((slots[0], parent))
        parent = slots[0]
    valid_kf = c["m"].kf_valid.clone()
    valid_kf[[s for s, _ in late]] = True
    m = c["m"]._replace(kf_pose=torch.as_tensor(cur), kf_valid=valid_kf)
    jm = c["jm"]._replace(kf_pose=jnp.asarray(cur),
                          kf_valid=jnp.asarray(valid_kf.numpy()))
    m2, info = lc.merge_gba(m, g, c["info"]["gba_pending"])
    jm2, jinfo = jlc.merge_gba(jm, jg, c["jinfo"]["gba_pending"])
    new, jnew = m2.kf_pose.numpy(), np.asarray(jm2.kf_pose)
    rows = kfs + [s for s, _ in late]
    np.testing.assert_allclose(new[rows], jnew[rows], atol=1e-4)
    valid = m2.mp_valid.numpy()
    np.testing.assert_allclose(m2.mp_pos.numpy()[valid],
                               np.asarray(jm2.mp_pos)[valid], atol=1e-2)
    for child, par in late:
        before = _np_compose(cur[child], _np_inverse(cur[par]))
        after = _np_compose(new[child], _np_inverse(new[par]))
        err = np.abs(np.asarray(jse3.log(jse3.compose(
            jnp.asarray(after), jse3.inverse(jnp.asarray(before)))))).max()
        assert err < 1e-4, (child, par, err)
    assert abs(info["gba_cost"][1] - jinfo["gba_cost"][1]) \
        <= 1e-3 * jinfo["gba_cost"][1]


# ---------------------------------------------------------------------------
# the detection policy, the implicit and seam pathways, the window mask, on
# a seeded host graph
# ---------------------------------------------------------------------------

N_KF, N_FEAT, N_PTS = 14, 40, 400


def _host_graph(cls, cap_cls, seed=9):
    rng = np.random.default_rng(seed)
    g = cls(cap_cls(16, N_PTS, N_FEAT))
    for k in range(N_KF):
        s = g.alloc_kf_slot()
        g.set_kf_alive(s, True)
        g.kf_frame_id[s] = 8 * k
        g.kf_row[s] = np.where(rng.uniform(size=N_FEAT) < 0.7,
                               rng.integers(0, N_PTS, N_FEAT), -1)
        if k:
            g.parent[s] = s - 1
    for a in range(N_KF):
        for b in range(a + 1, min(a + 4, N_KF)):
            g.set_covis(a, b, int(rng.integers(10, 120)))
    # a revisit of the start, and one to the middle
    g.set_covis(13, 1, 40)
    g.set_covis(13, 0, 20)
    g.set_covis(12, 2, 9)
    g.set_covis(11, 5, 16)
    return g


def _voc_pair():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2 ** 31, (32, 8)).astype(np.int32)
    return (Vocabulary(words=torch.as_tensor(words), idf=torch.ones(32)),
            JVoc(words=jnp.asarray(words.view(np.uint32)),
                 idf=jnp.ones(32, jnp.float32)))


def _closers():
    from orb_slam2_refactored_tpu.geometry.projection import (
        CameraIntrinsics as JCam)
    from orb_slam2_refactored_tpu_torch.geometry.projection import (
        CameraIntrinsics)
    voc, jvoc = _voc_pair()
    return (LoopCloser(voc, CameraIntrinsics.create(200, 200, 160, 120), 16,
                       n_levels=4),
            JLC(jvoc, JCam.create(200, 200, 160, 120), 16, n_levels=4))


def test_detect_policy_matches_jax_over_four_calls():
    lc, jlc = _closers()
    g, jg = _host_graph(MapGraph, MapCapacity), _host_graph(JGraph, JCap)
    rng = np.random.default_rng(4)
    fired = []
    for call, kf in enumerate((10, 11, 12, 13)):
        scores = rng.uniform(0.0, 0.05, 16).astype(np.float32)
        scores[[0, 1, 2]] = [0.30, 0.25, 0.2]  # the revisited start
        scores[14:] = -1.0  # not indexed
        if call == 1:
            scores[[0, 1, 2]] = 0.01  # one call without the start
        common = rng.integers(1, 30, 16).astype(np.int32)
        common[[0, 1, 2]] = 40
        common[14:] = 0
        out = lc._detect_policy(g, kf, scores.copy(), common.copy())
        ref = jlc._detect_policy(jg, kf, scores.copy(), common.copy())
        assert out == ref
        assert ([(sorted(a), n) for a, n in lc.consistent_groups]
                == [(sorted(a), n) for a, n in jlc.consistent_groups])
        fired.append(out)
    assert any(f is not None for f in fired) or lc.consistent_groups
    # JAX's state carried into a fresh port closer decides a fifth call the
    # same way
    fresh, _ = _closers()
    convert.set_loop_state(fresh, convert.loop_state(jlc))
    assert convert.loop_state(fresh) == convert.loop_state(jlc)
    scores = np.full(16, 0.01, np.float32)
    scores[[0, 1]] = 0.3
    common = np.full(16, 40, np.int32)
    assert (fresh._detect_policy(g, 13, scores.copy(), common.copy())
            == jlc._detect_policy(jg, 13, scores.copy(), common.copy()))
    assert convert.loop_state(fresh) == convert.loop_state(jlc)


def test_dispatch_then_resolve_matches_jax_over_four_calls():
    """The pipelined detection (`dispatch_detection` when the keyframe is
    made, `resolve_detection` at its insert drain) on the same four
    scripted calls: each package's database returns the scripted scores,
    rows 14 and 15 are not indexed (the active mask), JAX's read is
    resolved at once. The candidates and the consistency groups equal
    JAX's, and the policy's own on the same scores."""
    from orb_slam2_refactored_tpu.slam.tracking import _Resolved

    lc, jlc = _closers()
    ref_lc, _ = _closers()
    g, jg = _host_graph(MapGraph, MapCapacity), _host_graph(JGraph, JCap)
    for c in (lc, jlc):
        c.add_keyframe_bow = lambda m, kf: None
        c.db.active[:14] = True
    rng = np.random.default_rng(4)
    fired = []
    for call, kf in enumerate((10, 11, 12, 13)):
        scores = rng.uniform(0.0, 0.05, 16).astype(np.float32)
        scores[[0, 1, 2]] = [0.30, 0.25, 0.2]
        if call == 1:
            scores[[0, 1, 2]] = 0.01
        common = rng.integers(1, 30, 16).astype(np.int32)
        common[[0, 1, 2]] = 40
        lc.db.score_query = lambda v, s=scores, c=common: (
            torch.from_numpy(s), torch.from_numpy(c))
        jlc.db.score_query = lambda v, s=scores, c=common: (
            jnp.asarray(s), jnp.asarray(c))
        out = lc.resolve_detection(g, kf, lc.dispatch_detection(None, kf))
        ref = jlc.resolve_detection(jg, kf, jlc.dispatch_detection(
            None, kf, lambda a: _Resolved(np.asarray(a))))
        masked = scores.copy()
        masked[14:] = -1.0
        cw = common.copy()
        cw[14:] = 0
        assert out == ref == ref_lc._detect_policy(g, kf, masked, cw)
        assert ([(sorted(a), n) for a, n in lc.consistent_groups]
                == [(sorted(a), n) for a, n in jlc.consistent_groups])
        fired.append(out)
    assert any(f is not None for f in fired) or lc.consistent_groups


def test_loop_configuration_constructs_and_tracks():
    """`enable_loop_closing=True` with the covisibility window constructs
    and tracks on the CPU: a few frames of the orbit, tracking OK."""
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(50, radius=0.35, yaw_amp=0.3)
    t = Tracker(TrackerConfig(map_capacity=MapCapacity(*CAP),
                              **{**KW, "enable_local_ba": True,
                                 "enable_loop_closing": True,
                                 "local_map_window": 10,
                                 "kf_max_interval": 2}), device="cpu")
    for i in range(6):
        img, depth = scene.render(gt[i])
        t.track_rgbd(img, depth, timestamp=i / 30.0)
    assert t.state == 1 and len(t.graph.alive_kfs()) >= 3
    assert not t.local_mask_dev.all()  # the window was rebuilt


def _trackers(**kw):
    base = dict(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0,
                bf=4.0, n_features=N_FEAT, n_levels=2, enable_local_ba=False,
                enable_loop_closing=True, local_map_window=4,
                implicit_loop_min_gap=50, seam_min_reacq=15)
    base.update(kw)
    t = Tracker(TrackerConfig(map_capacity=MapCapacity(16, N_PTS, N_FEAT),
                              **base), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_SLAM_NATIVE_GRAPH", "0")
        jt = JTracker(JConfig(map_capacity=JCap(16, N_PTS, N_FEAT), **base))
    t.graph = _host_graph(MapGraph, MapCapacity)
    jt.graph = _host_graph(JGraph, JCap)
    t.loop_closer, jt.loop_closer = _closers()
    return t, jt


def test_implicit_loop_candidate_matches_jax():
    t, jt = _trackers()
    seen = []
    for slot in range(N_KF):
        for mw in (8, 15):
            for last in (-1, 5):
                t.loop_closer.last_loop_seq = last
                jt.loop_closer.last_loop_seq = last
                a = t._implicit_loop_candidate(slot, min_weight=mw)
                b = jt._implicit_loop_candidate(slot, min_weight=mw)
                assert a == b, (slot, mw, last)
                seen.append(a)
    assert any(s is not None for s in seen)
    assert any(s is None for s in seen)


def test_seam_check_matches_jax():
    t, jt = _trackers()
    script = [(20, 3, 16), (21, 3, 20), (30, 3, 30), (51, 13, 15),
              (52, 13, 40), (90, 12, 16), (95, 4, 16)]
    out = []
    for frame_id, ref_kf, n_reacq in script:
        for trk in (t, jt):
            trk.frame_id = frame_id
            trk.ref_kf = ref_kf
        t.loop_closer.last_loop_seq = jt.loop_closer.last_loop_seq = 2
        a, b = t._seam_check(n_reacq), jt._seam_check(n_reacq)
        assert a == b, (frame_id, ref_kf, n_reacq)
        # JAX's tracker sets both attributes at its first seam
        assert t._seam_pending == getattr(jt, "_seam_pending", False)
        assert t._seam_cooldown_until == getattr(jt, "_seam_cooldown_until",
                                                 0)
        out.append(a)
    assert True in out and False in out
    t2, jt2 = _trackers(enable_loop_closing=False)
    assert t2._seam_check(100) is jt2._seam_check(100) is False


def test_local_mask_matches_jax():
    t, jt = _trackers()
    np.testing.assert_array_equal(t.local_mask_dev.numpy(),
                                  np.asarray(jt.local_mask_dev))
    assert t.local_mask_dev.all()
    for slot in (0, 7, 13):
        t._refresh_local_mask(slot)
        jt._refresh_local_mask(slot)
        np.testing.assert_array_equal(t.local_mask_dev.numpy(),
                                      np.asarray(jt.local_mask_dev))
    assert 0 < int(t.local_mask_dev.sum()) < N_PTS
    # between keyframes the window follows the reference keyframe every 8
    # frames
    for since in (7, 8):
        for trk in (t, jt):
            trk.ref_kf, trk.frames_since_kf = 3, since
            trk._maybe_refresh_local_mask()
        np.testing.assert_array_equal(t.local_mask_dev.numpy(),
                                      np.asarray(jt.local_mask_dev))
