"""Port parity: the device programs of `LocalMapper` against the JAX package.

The map states and arguments are those the JAX tracker really passed its
mapper on the QVGA clip (local BA on, Python `MapGraph`), captured over the
first four frames (keyframes at frames 0, 1 and 3); the culling, fusion and
insertion scatters also run on index lists padded the way the JAX package
pads them (out-of-range values that must be dropped, never clamped).

Tolerances:
- `_triangulate_impl`: (idx_b, good) equal on >= 99 % of the features of a;
  xw within 1e-4 m where both sides call a feature good, or within
  2e-6 / sin^2(parallax) m where that is larger (see `_xw_tolerance`: the
  f32 midpoint solve amplifies one-ulp differences in the rays, and JAX
  compiled against JAX op by op already differs by more than 1e-4 m there);
  >= 80 % of the good points agree within 1e-4 m;
- `_fuse_pair_impl`: (idx, keep) equal on >= 99.5 %;
- `_refresh_points_impl`: descriptors exactly equal, normals and distance
  bands within 1e-5 relative. C4: `jnp.median` of an even count is the mean
  of the two middle values, which a lower-median port would get wrong; the
  synthetic case holds points on which the two rules choose differently;
- `_cull_impl`, `_fuse_apply_impl`, `_kill_kf_impl`: exactly equal;
  `_tri_insert_impl`: integers equal, floats within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.slam.map_state import MapArrays as JMap
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity as JCap
from orb_slam2_refactored_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_refactored_tpu.slam.tracking import TrackerConfig as JConfig
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.geometry import se3 as tse3
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.ops import hamming as tham
from orb_slam2_refactored_tpu_torch.slam.local_mapping import LocalMapper

torch.set_num_threads(1)
CAM = (260.0, 260.0, 160.0, 120.0, 0.08 * 260.0)


def _np_map(m):
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def _jmap(m_np):
    return JMap(**{k: jnp.asarray(v) for k, v in m_np.items()})


def _port_mapper():
    return LocalMapper(tproj.CameraIntrinsics.create(*CAM), 4, 1.2,
                       ba_iters=3, device="cpu")


@pytest.fixture(scope="module")
def captured():
    return _capture()


def _capture():
    """Every triangulation, fusion and refresh program the JAX mapper ran
    on the first four frames of the clip, with the map it ran on."""
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    gt = orbit_trajectory(20, radius=0.35, yaw_amp=0.25)
    rng = np.random.default_rng(0)
    rec = {"tri": [], "fuse": [], "refresh": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_SLAM_NATIVE_GRAPH", "0")
        jt = JTracker(JConfig(
            width=320, height=240, fx=CAM[0], fy=CAM[1], cx=CAM[2],
            cy=CAM[3], bf=CAM[4], n_features=500, n_levels=4,
            map_capacity=JCap(16, 4096, 500), enable_local_ba=True))
        lm = jt.local_mapper
        tri, fuse = lm._tri_batch, lm._fuse_batch
        refresh = jax.jit(lm._refresh_points_impl)

        def rec_tri(m, kf, nbs):
            out = tri(m, kf, nbs)
            rec["tri"].append((_np_map(m), int(kf), np.asarray(nbs),
                               [np.asarray(o) for o in out]))
            return out

        def rec_fuse(m, srcs, dsts):
            out = fuse(m, srcs, dsts)
            rec["fuse"].append((_np_map(m), np.asarray(srcs),
                                np.asarray(dsts), np.asarray(out)))
            return out

        def rec_refresh(m, pts, okf, oft, nob):
            m_np = _np_map(m)
            out = refresh(m, pts, okf, oft, nob)
            rec["refresh"].append((m_np, {
                "pts": np.asarray(pts), "obs_kf": np.asarray(okf),
                "obs_feat": np.asarray(oft), "n_obs": np.asarray(nob)},
                _np_map(out)))
            return out

        lm._tri_batch, lm._fuse_batch, lm._refresh = (rec_tri, rec_fuse,
                                                      rec_refresh)
        for i in range(4):
            img, depth = scene.render(gt[i])
            depth = depth * (1 + rng.normal(0, 0.01, depth.shape))
            jt.track_rgbd(np.clip(img, 0, 255).astype(np.uint8),
                          depth.astype(np.float16).astype(np.float32))
    assert all(len(v) == 2 for v in rec.values()), {
        k: len(v) for k, v in rec.items()}
    return rec, lm, _np_map(jt.map)


def _xw_tolerance(m_np, kf, nb, xw):
    """1e-4 m, or 2e-6 / sin^2(parallax) m where that is larger. The
    midpoint solve divides by 1 - cos^2 of the angle between the two rays,
    so a difference of a few f32 ulps (6e-8 each) in that cosine moves a
    point at 3 m by ~1e-6 / sin^2: JAX compiled and JAX op by op differ that
    much on the same inputs (`test_triangulation_spread_is_jax_own`)."""
    c = [tse3.translation(tse3.inverse(torch.tensor(m_np["kf_pose"][k])))
         .numpy().astype(np.float64) for k in (kf, nb)]
    va, vb = xw - c[0], xw - c[1]
    cos = np.sum(va * vb, -1) / (np.linalg.norm(va, axis=-1)
                                 * np.linalg.norm(vb, axis=-1))
    return np.maximum(1e-4, 2e-6 / np.maximum(1.0 - cos * cos, 1e-12))


def _check_triangulation(lm, jlm, m_np, kf, nb):
    xw, idx_b, good = (x.numpy() for x in lm._triangulate_impl(
        convert.map_from_numpy(m_np, "cpu"), kf, nb))
    xw_j, idx_j, good_j = (np.asarray(x) for x in jlm._triangulate_impl(
        _jmap(m_np), jnp.int32(kf), jnp.int32(nb)))
    same = (idx_b == idx_j) & (good == good_j)
    assert same.mean() >= 0.99, same.mean()
    both = good & good_j
    err = np.abs(xw - xw_j).max(-1)[both]
    tol = _xw_tolerance(m_np, kf, nb, xw_j.astype(np.float64))[both]
    assert np.all(err <= tol), (err - tol).max()
    return int(both.sum()), int((err <= 1e-4).sum())


def test_triangulate_matches_jax(captured):
    """On the captured calls (every feature of the new keyframe already has
    a landmark there, so nothing is triangulated), and on the same map with
    40 % of both keyframes' features freed of their landmarks: those
    features re-match across the pair through the epipolar gate."""
    rec, jlm, _ = captured
    lm = _port_mapper()
    n_good = n_close = 0
    for m_np, kf, nb in _tri_cases(rec):
        good, close = _check_triangulation(lm, jlm, m_np, kf, nb)
        n_good, n_close = n_good + good, n_close + close
    assert n_good > 100 and n_close >= 0.8 * n_good, (n_good, n_close)


def _tri_cases(rec):
    """(map, kf, nb): each captured pair as it was, then with 40 % of both
    keyframes' features freed."""
    rng = np.random.default_rng(3)
    for m_np, kf, nbs, _ in rec["tri"]:
        for nb in sorted({int(nb) for nb in nbs if nb != kf}):
            yield m_np, kf, nb
            freed = {k: v.copy() for k, v in m_np.items()}
            for k in (kf, nb):
                drop = rng.uniform(size=freed["kf_mp"].shape[1]) < 0.4
                freed["kf_mp"][k, drop] = -1
            yield freed, kf, nb


def test_triangulation_spread_is_jax_own(captured):
    """The cause of the wider xw tolerance: the JAX function compiled
    (`jax.jit`, as the JAX mapper runs it) and op by op differ by more than
    1e-4 m on the same low-parallax points, and by no more than the
    tolerance allows."""
    rec, jlm, _ = captured
    jit_tri = jax.jit(jlm._triangulate_impl)
    worst = 0.0
    for m_np, kf, nb in _tri_cases(rec):
        args = (_jmap(m_np), jnp.int32(kf), jnp.int32(nb))
        xa, ia, ga = (np.asarray(x) for x in jlm._triangulate_impl(*args))
        xb, ib, gb = (np.asarray(x) for x in jit_tri(*args))
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ga, gb)
        err = np.abs(xa - xb).max(-1)[ga]
        assert np.all(err <= _xw_tolerance(m_np, kf, nb,
                                           xa.astype(np.float64))[ga])
        worst = max(worst, float(err.max(initial=0.0)))
    assert worst > 1e-4, worst


def test_fuse_pair_matches_jax(captured):
    rec, _, _ = captured
    lm = _port_mapper()
    n_keep = n_pairs = 0
    for m_np, srcs, dsts, packed in rec["fuse"]:
        m = convert.map_from_numpy(m_np, "cpu")
        for b, (a, d) in enumerate(zip(srcs, dsts)):
            if a == d:
                continue  # the JAX package's padding self-pair
            idx, dst_pt, keep, src_mp = lm._fuse_pair_impl(m, int(a), int(d))
            same = ((idx.numpy() == packed[b, :, 0])
                    & (keep.numpy() == (packed[b, :, 2] > 0)))
            assert same.mean() >= 0.995, same.mean()
            np.testing.assert_array_equal(src_mp.numpy(), packed[b, :, 3])
            n_keep += int(keep.sum())
            n_pairs += 1
    assert n_pairs >= 2 and n_keep > 20, (n_pairs, n_keep)


def _check_refresh(out_np, ref_np, pts):
    P = ref_np["mp_pos"].shape[0]
    rows = pts[pts < P]
    np.testing.assert_array_equal(out_np["mp_desc"], ref_np["mp_desc"])
    np.testing.assert_array_equal(out_np["mp_nobs"], ref_np["mp_nobs"])
    for k in ("mp_normal", "mp_min_dist", "mp_max_dist"):
        a, b = out_np[k][rows], ref_np[k][rows]
        assert np.all(np.abs(a - b) <= 1e-5 * np.maximum(np.abs(b), 1e-3)), k


def test_refresh_points_matches_jax(captured):
    rec, _, _ = captured
    lm = _port_mapper()
    for m_np, args, ref_np in rec["refresh"]:
        a = convert.mapper_inputs_from_numpy(args, "cpu")
        out = lm._refresh_points_impl(convert.map_from_numpy(m_np, "cpu"),
                                      a["pts"], a["obs_kf"], a["obs_feat"],
                                      a["n_obs"])
        _check_refresh(convert.map_to_numpy(out), ref_np, args["pts"])
        assert (args["n_obs"] >= 2).sum() > 20


def test_refresh_median_of_even_count(captured):
    """C4 on a synthetic batch: observer descriptors drawn as few-bit
    variants of one base, so distances tie and the mean of the two middle
    values and the lower middle value pick different observers."""
    _, jlm, m_np = captured
    rng = np.random.default_rng(4)
    B, M = 64, LocalMapper.MAXOBS
    m_np = {k: v.copy() for k, v in m_np.items()}
    K, N = m_np["kf_mp"].shape
    alive = np.nonzero(m_np["kf_valid"])[0]
    n_obs = rng.integers(1, M + 1, B).astype(np.int32)
    n_obs[:48] = 6  # even counts
    okf = rng.choice(alive, (B, M)).astype(np.int32)
    oft = np.stack([rng.permutation(N)[:M] for _ in range(B)]).astype(np.int32)
    base = rng.integers(0, 2 ** 32, (B, 1, 8), dtype=np.uint64)
    flips = np.zeros((B, M, 8), np.uint64)
    for b in range(B):
        for j in range(M):
            for bit in rng.choice(256, rng.integers(0, 96), replace=False):
                flips[b, j, bit // 32] |= np.uint64(1) << np.uint64(bit % 32)
    desc = (base ^ flips).astype(np.uint32)
    m_np["kf_desc"][okf, oft] = desc
    pts = rng.choice(m_np["mp_pos"].shape[0], B, replace=False).astype(
        np.int32)
    pts[-2:] = m_np["mp_pos"].shape[0]  # padding rows scatter nowhere
    ref = jlm._refresh_points_impl(_jmap(m_np), jnp.asarray(pts),
                                   jnp.asarray(okf), jnp.asarray(oft),
                                   jnp.asarray(n_obs))
    lm = _port_mapper()
    out = lm._refresh_points_impl(
        convert.map_from_numpy(m_np, "cpu"), *(torch.from_numpy(x) for x in
                                               (pts, okf, oft, n_obs)))
    _check_refresh(convert.map_to_numpy(out), _np_map(ref), pts)

    # the lower-median rule would pick another observer on some points
    xor = np.ascontiguousarray(desc[:, :, None, :] ^ desc[:, None, :, :])
    d = np.unpackbits(xor.view(np.uint8), axis=-1).sum(-1).astype(np.int64)
    valid = np.arange(M)[None, :] < n_obs[:, None]
    d = np.where(valid[:, None, :], d, tham.BIG)
    srt = np.sort(d, axis=2)
    mean_mid = 0.5 * (srt[..., M // 2 - 1] + srt[..., M // 2])
    lower_mid = srt[..., M // 2 - 1]
    pick_mean = np.argmin(np.where(valid, mean_mid, 1e9), 1)
    pick_lower = np.argmin(np.where(valid, lower_mid, 1e9), 1)
    assert (pick_mean != pick_lower).sum() >= 3


def test_cull_matches_jax(captured):
    _, jlm, m_np = captured
    rng = np.random.default_rng(5)
    K, N = m_np["kf_mp"].shape
    P = m_np["mp_pos"].shape[0]
    alive = np.nonzero(m_np["mp_valid"])[0]
    kill = np.full(512, P, np.int32)  # padded as `_pad_bucket` pads
    kill[:40] = rng.choice(alive, 40, replace=False)
    kill[40] = -3  # counts from the end, as JAX indexes
    cells = np.argwhere(m_np["kf_mp"] >= 0)[:60]
    pk = np.full(512, K, np.int32)
    pf = np.zeros(512, np.int32)
    pk[:60], pf[:60] = cells[:, 0], cells[:, 1]
    pf[60], pk[60] = N + 3, cells[0, 0]  # feature out of range: dropped
    ref = jlm._cull_impl(_jmap(m_np), jnp.asarray(kill), jnp.asarray(pk),
                         jnp.asarray(pf))
    out = _port_mapper()._cull_impl(convert.map_from_numpy(m_np, "cpu"),
                                    *(torch.from_numpy(x)
                                      for x in (kill, pk, pf)))
    for k, v in convert.map_to_numpy(out).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)), k)


def test_fuse_apply_and_kill_kf_match_jax(captured):
    _, jlm, m_np = captured
    rng = np.random.default_rng(6)
    K, N = m_np["kf_mp"].shape
    P = m_np["mp_pos"].shape[0]
    kfs = np.nonzero(m_np["kf_valid"])[0]
    alive = np.nonzero(m_np["mp_valid"])[0]
    free = np.argwhere(m_np["kf_feat_valid"])
    free = free[rng.permutation(len(free))[:30]]
    add_kf = np.full(512, K, np.int32)
    add_ft = np.zeros(512, np.int32)
    add_pt = np.full(512, -1, np.int32)
    add_kf[:30], add_ft[:30] = free[:, 0], free[:, 1]
    add_pt[:30] = rng.choice(alive, 30)
    src, dst = np.split(rng.choice(alive, 40, replace=False), 2)
    rm_src = np.full(512, P, np.int32)
    rm_dst = np.full(512, P, np.int32)
    rm_src[:20], rm_dst[:20] = src, dst
    args = (add_kf, add_ft, add_pt, rm_src, rm_dst)
    ref = jlm._fuse_apply_impl(_jmap(m_np), *(jnp.asarray(a) for a in args))
    lm = _port_mapper()
    out = lm._fuse_apply_impl(convert.map_from_numpy(m_np, "cpu"),
                              *(torch.from_numpy(a) for a in args))
    for k, v in convert.map_to_numpy(out).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)), k)
    ref = jlm._kill_kf_impl(ref, jnp.int32(kfs[1]))
    out = lm._kill_kf_impl(out, int(kfs[1]))
    for k, v in convert.map_to_numpy(out).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)), k)


def test_tri_insert_matches_jax(captured):
    rec, jlm, _ = captured
    m_np, kf, nb = list(_tri_cases(rec))[-1]
    P = m_np["mp_pos"].shape[0]
    xw_j, idx_j, good = (np.asarray(x) for x in jlm._triangulate_impl(
        _jmap(m_np), jnp.int32(kf), jnp.int32(nb)))
    slots = np.full(good.shape[0], -1, np.int32)
    free = np.nonzero(~m_np["mp_valid"])[0]
    slots[good] = free[-int(good.sum()):]
    args = (slots, idx_j.astype(np.int32), xw_j)
    ref = _np_map(jlm._tri_insert_impl(_jmap(m_np), jnp.int32(kf),
                                       jnp.int32(nb),
                                       *(jnp.asarray(a) for a in args)))
    out = convert.map_to_numpy(_port_mapper()._tri_insert_impl(
        convert.map_from_numpy(m_np, "cpu"), kf, nb,
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)))
    assert good.sum() > 10 and (slots < P).all()
    for k, v in out.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, ref[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, ref[k], k)


def test_epipolar_gate_runs_in_full_f32(captured, monkeypatch):
    """The epipolar gate compares a product of two matmuls with its
    threshold, so TF32 would flip pairs on the rim: `_triangulate_impl`
    runs it at "highest" matmul precision whatever the process-wide
    setting, and restores that setting."""
    from orb_slam2_refactored_tpu_torch.slam import local_mapping

    rec, _, _ = captured
    m_np, kf, nbs, _ = rec["tri"][0]
    seen = []
    real = local_mapping.se3.quat_to_matrix

    def spy(q):
        seen.append(torch.get_float32_matmul_precision())
        return real(q)

    monkeypatch.setattr(local_mapping.se3, "quat_to_matrix", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        _port_mapper()._triangulate_impl(convert.map_from_numpy(m_np, "cpu"),
                                         kf, int(nbs[0] if nbs[0] != kf
                                                 else nbs[1]))
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
