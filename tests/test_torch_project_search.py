"""Port parity of the projection search's gates and compaction (kernel
B6's plain version), of the motion-model search's gates (B6's feature
mode, plain) and of the claim resolution (kernel R's plain version, in its
keep and rows-with-index modes), against the JAX package on the CPU.

Exact equality: the gates are the same f32 operations in both packages and
the rest is integer work. The compaction is held at its edges (no point
passes, every point passes, exactly `cap` pass, `cap >= P`, `cap = 0`),
its rows against `jax.lax.top_k` over JAX's own gates, and the search's
per-point results and visibility against JAX's `search_by_projection`.
The kernels themselves are held to these plain versions on the card
(`tests/test_torch_kernels_gpu.py`, `chip_smoke.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import projection as jproj
from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.ops import hamming as jh
from orb_slam2_refactored_tpu.ops import matching as jm
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.ops import hamming as th
from orb_slam2_refactored_tpu_torch.ops import matching as tm
from torch_b6_cases import (B6_CASES, CX, CY, FX, FEATURE_CASES, R_CASES,
                            SF, as_torch, b6_case, feature_case, r_case)

torch.set_num_threads(1)
MP_KEYS = ("mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
           "mp_valid")
FRAME_KEYS = ("frame_xy", "frame_level", "frame_desc", "frame_valid")


def _jax_gates(mp, pose, cam, kw):
    """JAX's per-point gates of `search_by_projection`
    (orb_slam2_refactored_tpu/ops/matching.py:116-148): (point_ok, vis)."""
    pos, pose = jnp.asarray(mp["mp_pos"]), jnp.asarray(pose)
    xc = jse3.transform(pose, pos)
    uv = jproj.project(cam, xc)
    vis = jnp.asarray(mp["mp_valid"]) & (xc[..., 2] > 0.05)
    if kw["image_bounds"] is not None:
        x0, x1, y0, y1 = kw["image_bounds"]
        vis = vis & ((uv[..., 0] >= x0) & (uv[..., 0] < x1)
                     & (uv[..., 1] >= y0) & (uv[..., 1] < y1))
    po = pos - jse3.translation(jse3.inverse(pose))[None, :]
    dist = jnp.linalg.norm(po, axis=-1)
    vis = vis & (dist >= jnp.asarray(mp["mp_min_dist"]) * 0.8) & (
        dist <= jnp.asarray(mp["mp_max_dist"]) * 1.2)
    ok = vis
    if kw["check_view_angle"]:
        n = jnp.asarray(mp["mp_normal"])
        cosang = jnp.sum(po * n, axis=-1) / jnp.maximum(
            dist * jnp.linalg.norm(n, axis=-1), 1e-6)
        ok = ok & (cosang > 0.5)
    return np.asarray(ok), np.asarray(vis)


@pytest.mark.parametrize("name", list(B6_CASES))
def test_projection_search_plain_matches_jax(name):
    mp, frame, pose, kw = b6_case(name)
    jc = jproj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0)
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0)
    ref = jm.search_by_projection(
        *(jnp.asarray(frame[k]) for k in FRAME_KEYS),
        *(jnp.asarray(mp[k]) for k in MP_KEYS), jnp.asarray(pose), jc,
        jnp.asarray(SF), **kw)
    targs = dict(as_torch({**mp, **frame}), pose_cw=torch.from_numpy(pose),
                 cam=tc, scale_factors=torch.from_numpy(SF), **kw)
    out, vis = tm.search_by_projection_with_vis_plain(**targs)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the dispatching entry takes the plain version on the CPU
    for a, b in zip(out, tm.search_by_projection_with_vis(**targs)[0]):
        assert torch.equal(a, b)

    ok, vis_ref = _jax_gates(mp, pose, jc, kw)
    np.testing.assert_array_equal(vis.numpy(), vis_ref)
    c = tm.project_candidates_plain(
        **{k: targs[k] for k in MP_KEYS}, pose_cw=targs["pose_cw"], cam=tc,
        scale_factors=targs["scale_factors"], **kw)
    P, cap = len(ok), kw["candidate_cap"]
    if cap and cap < P:
        _, top = jax.lax.top_k(jnp.asarray(ok.astype(np.float32)), cap)
        np.testing.assert_array_equal(c.cand.numpy(), np.asarray(top))
    else:
        np.testing.assert_array_equal(c.cand.numpy(), np.arange(P))
    np.testing.assert_array_equal(c.ok.numpy(), ok[c.cand.numpy()])
    slot = np.full(P, -1)
    slot[c.cand.numpy()] = np.arange(len(c.cand))
    np.testing.assert_array_equal(c.slot.numpy(), slot)
    n_ok = int(ok.sum())
    expect = {"none_pass": 0, "all_pass": P, "exactly_cap": cap}
    if name in expect:
        assert n_ok == expect[name]
    else:
        assert n_ok > 512  # the compaction truncates at cap = 512
    if n_ok:
        assert int(out.valid.sum()) > 20


@pytest.mark.parametrize("name", list(R_CASES))
def test_resolve_duplicates_plain_matches_jax(name):
    idx, dist, valid, N = r_case(name)
    ref = jh.resolve_duplicates(jnp.asarray(idx), jnp.asarray(dist),
                                jnp.asarray(valid), N)
    out = th.resolve_duplicates_plain(torch.from_numpy(idx),
                                      torch.from_numpy(dist),
                                      torch.from_numpy(valid), N)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert torch.equal(out, th.resolve_duplicates(
        torch.from_numpy(idx), torch.from_numpy(dist),
        torch.from_numpy(valid), N))
    if name == "all_invalid":
        assert not out.any()
    if name == "many_claimants":
        assert out[400] and int(out[:500].sum()) == 1


@jax.jit
def _jax_project_jit(xc):
    return jproj.project(jproj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0),
                         xc)


def _jax_feature_gates(pos, ok, level, pose):
    """The pieces of JAX's `search_last_frame` before its best-2
    (orb_slam2_refactored_tpu/ops/matching.py:246-251): uv, the radius (7)
    at each feature's level, and ok_pt for a validity `ok` (last_valid and
    last_has_point together). The transform runs op by op and the
    projection compiled, the two roundings the port follows on the CPU
    (`tests/test_torch_geometry.py`: XLA fuses the projection's
    multiply-adds, which the port's `_fma` writes out; the compiled
    transform fuses too, and moves xc by an ulp on ~1 % of points)."""
    xc = jse3.transform(jnp.asarray(pose), jnp.asarray(pos))
    uv = _jax_project_jit(xc)
    ok_pt = jnp.asarray(ok) & jnp.asarray(ok) & (xc[..., 2] > 0.05)
    r = 7.0 * jnp.asarray(SF)[jnp.asarray(level)]
    return np.asarray(uv), np.asarray(r), np.asarray(ok_pt)


def _gathered(f):
    """The tracker's gather of the last frame's map points, in numpy."""
    q = np.clip(f["last_mp"], 0, len(f["mp_pos"]) - 1)
    return f["mp_pos"][q], (f["last_mp"] >= 0) & f["mp_valid"][q]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.int32), b.view(np.int32))
    return np.array_equal(a, b)


@pytest.mark.parametrize("name", list(FEATURE_CASES))
def test_feature_gates_plain_match_jax(name):
    """B6's feature mode (plain) against the pieces of JAX's
    `search_last_frame` bit for bit (uv, radius, ok_pt): with the tracker's
    gather (map point ids and the map's arrays) and with the positions and
    both validities given per feature (JAX's signature)."""
    f, pose = feature_case(name)
    pos, ok = _gathered(f)
    ref = _jax_feature_gates(pos, ok, f["last_level"], pose)
    t = as_torch(f)
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0)
    common = dict(level=t["last_level"], pose_cw=torch.from_numpy(pose),
                  cam=tc, scale_factors=torch.from_numpy(SF), radius=7.0)
    mapped = tm.project_features_plain(
        t["mp_pos"], feat_idx=t["last_mp"], pos_valid=t["mp_valid"],
        **common)
    given = tm.project_features_plain(
        torch.from_numpy(pos), feat_valid=torch.from_numpy(ok), **common)
    for out in (mapped, given,
                tm.project_features(t["mp_pos"], feat_idx=t["last_mp"],
                                    pos_valid=t["mp_valid"], **common)):
        for a, b in zip(ref, out):
            assert _same_bits(b.numpy(), a)
    if name == "none_pass":
        assert not ref[2].any()
    elif name != "one":
        assert 0 < ref[2].sum() < len(ref[2])


@pytest.mark.parametrize("name", list(FEATURE_CASES))
def test_search_last_frame_mapped_plain_matches_jax(name):
    """The tracker's motion-model entry (plain: B6's feature mode, K1's
    plain version, R's rows mode) against JAX's `search_last_frame` on the
    gathered points, and the JAX-signature entry against both."""
    f, pose = feature_case(name)
    pos, ok = _gathered(f)
    jc = jproj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0)
    ref = jm.search_last_frame(
        jnp.asarray(f["curr_xy"]), jnp.asarray(f["curr_level"]),
        jnp.asarray(f["curr_desc"]), jnp.asarray(f["curr_valid"]), None,
        jnp.asarray(f["last_level"]), jnp.asarray(f["last_desc"]),
        jnp.asarray(ok), jnp.asarray(ok), jnp.asarray(pos),
        jnp.asarray(pose), jc, jnp.asarray(SF))
    t = as_torch(f)
    tc = tproj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0)
    curr = (t["curr_xy"], t["curr_level"], t["curr_desc"], t["curr_valid"])
    rest = (torch.from_numpy(pose), tc, torch.from_numpy(SF))
    mapped = tm.search_last_frame_mapped_plain(
        *curr, t["last_level"], t["last_desc"], t["last_mp"], t["mp_pos"],
        t["mp_valid"], *rest)
    okt = torch.from_numpy(ok)
    given = tm.search_last_frame(
        *curr, None, t["last_level"], t["last_desc"], okt, okt,
        torch.from_numpy(pos), *rest)
    for out in (mapped, given, tm.search_last_frame_mapped(
            *curr, t["last_level"], t["last_desc"], t["last_mp"],
            t["mp_pos"], t["mp_valid"], *rest)):
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if name != "none_pass":
        assert int(mapped.valid.sum()) > 0


@pytest.mark.parametrize("name", list(R_CASES))
def test_resolve_rows_plain_matches_jax(name):
    """R's rows-with-index mode (plain) against JAX's
    `resolve_duplicates` over valid & dist <= max_dist, then
    `where(keep, idx, -1)`, at two distance gates and none."""
    idx, dist, valid, N = r_case(name)
    for max_dist in (50, th.TH_HIGH, th.NO_GATE):
        keep = jh.resolve_duplicates(
            jnp.asarray(idx), jnp.asarray(dist),
            jnp.asarray(valid) & (jnp.asarray(dist) <= max_dist), N)
        ref_idx = jnp.where(keep, jnp.asarray(idx), -1)
        args = (torch.from_numpy(idx), torch.from_numpy(dist),
                torch.from_numpy(valid), max_dist, N)
        out = th.resolve_rows_plain(*args)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(keep))
        assert all(torch.equal(a, b) for a, b in zip(out,
                                                     th.resolve_rows(*args)))
