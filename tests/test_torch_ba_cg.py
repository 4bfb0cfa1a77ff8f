"""Port parity: matrix-free CG bundle adjustment (global BA) and its pieces.

(a) `ba_solve(dense_schur=False)` on a small seeded problem (8 keyframes, 2
    fixed; 300 points, 10 frozen, 5 dead; mono and stereo observations; 5 %
    outliers) against JAX's CG branch: poses within 1e-4 m / 1e-4 rad,
    points within 1e-3 m, initial cost within 1e-5 relative, final cost
    within 1e-3 relative, the final chi2 gate equal on >= 99.9 % of slots
    (the sides differ in the order of f32 sums only).
(b) K5's `w_obs` mode (plain): W_obs equals (w Jp)^T Jl built from JAX's
    own Jacobians and Huber weights (within 1e-4 of the largest entry), is
    zero on dead slots, and Hpp, g_p and Hll|g_l equal the dense mode's bit
    for bit.
(c) K6's plain versions: `ba_schur_mv_plain` equals the dense reduced
    camera matrix S built from the same blocks applied to v (within 1e-5
    of |S||v|), `ba_schur_u_plain` and `ba_schur_ut_plain` are adjoint;
    `cg_solve_plain` solves the dense system in f64 (0, 1 and 40
    iterations, within 2e-4 of the largest entry), and `ba_schur_cg`
    routes CPU tensors to it.
(e) the card's layouts: the point index's `place` inverts `slots` on the
    live slots and is -1 elsewhere, and the plain W_obs gathered into
    point order through `slots` puts slot s's row at `place[s]`, the
    layout in which K5 writes the rows on the card (`LiveRows`;
    `w_obs_slot_rows` takes it back).
(d) `compact_points`: the live points in index order, observations
    remapped, the solve on the compacted problem equal to the solve on the
    whole one within 1e-5, and the global BA's scatter-back
    (`LoopCloser._gba_impl`) leaves dead points where they were; at the
    bench's map capacity (P = 32,768) with 30,000 live points, past the
    27,904 that the card's index once held, every live point is kept, the
    compacted rows pad to the bucket, and the plain index holds each live
    slot once, by point, ascending.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import projection as jproj
from orb_slam2_refactored_tpu.geometry import se3 as jse3
from orb_slam2_refactored_tpu.optim import ba as jba
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.optim import ba as tba

torch.set_num_threads(1)
FX, CX, CY, BF = 400.0, 160.0, 120.0, 32.0
JCAM = jproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)
TCAM = tproj.CameraIntrinsics.create(FX, FX, CX, CY, BF)


def _problem(seed=0, K=8, P=300, N=160):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                    rng.uniform(4, 9, P)], -1).astype(np.float32)
    poses = np.stack([np.asarray(jse3.exp(jnp.asarray(np.array(
        [0, 0.02 * k, 0, 0.25 * k, 0, 0], np.float32)))) for k in range(K)])
    obs_uv = np.zeros((K, N, 2), np.float32)
    obs_ur = -np.ones((K, N), np.float32)
    obs_pt = np.full((K, N), -1, np.int32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, (K, N))).astype(np.float32)
    for k in range(K):
        sel = rng.permutation(P)[:N]
        xc = np.asarray(jse3.transform(jnp.asarray(poses[k]),
                                       jnp.asarray(pts[sel])))
        uvr = np.stack([FX * xc[:, 0] / xc[:, 2] + CX,
                        FX * xc[:, 1] / xc[:, 2] + CY,
                        FX * xc[:, 0] / xc[:, 2] + CX - BF / xc[:, 2]], -1)
        vis = (xc[:, 2] > 0.5) & (rng.uniform(size=N) > 0.1)
        obs_pt[k, vis] = sel[vis]
        obs_uv[k] = uvr[:, :2] + rng.normal(0, 0.5, (N, 2))
        stereo = rng.uniform(size=N) < 0.6
        obs_ur[k] = np.where(stereo, uvr[:, 2] + rng.normal(0, 0.5, N), -1.0)
    bad = rng.uniform(size=(K, N)) < 0.05
    obs_uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
    poses0 = poses.copy()
    for k in range(1, K):
        poses0[k] = np.asarray(jse3.retract(jnp.asarray(poses[k]), jnp.asarray(
            rng.normal(0, 0.02, 6).astype(np.float32))))
    pts0 = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    valid = np.ones(P, bool)
    valid[-5:] = False
    # a point seen by one keyframe has no depth constraint (its update is
    # set by the damping alone): left out, as in test_torch_ba.py
    valid &= np.bincount(obs_pt[obs_pt >= 0], minlength=P) >= 2
    frozen = np.zeros(P, bool)
    frozen[rng.permutation(P)[:10]] = True
    return dict(kf_pose=poses0, kf_fixed=fixed, obs_uv=obs_uv, obs_ur=obs_ur,
                obs_pt=obs_pt, obs_inv_s2=inv_s2, pt_pos=pts0, pt_valid=valid,
                pt_frozen=frozen)


def _pose_err(a, b):
    d = np.asarray(jse3.log(jse3.compose(jnp.asarray(a),
                                         jse3.inverse(jnp.asarray(b)))))
    return np.abs(d[..., :3]).max(), np.abs(d[..., 3:]).max()


@pytest.mark.parametrize("iters,cg_iters,use_huber",
                         [(3, 20, True), (6, 40, True), (4, 40, False)])
def test_ba_solve_cg_matches_jax(iters, cg_iters, use_huber):
    d = _problem()
    ref = jba.ba_solve(jba.BAProblem(**{k: jnp.asarray(v)
                                        for k, v in d.items()}),
                       JCAM, iters=iters, cg_iters=cg_iters,
                       use_huber=use_huber, dense_schur=False)
    out = tba.ba_solve(convert.ba_problem_from_numpy(d, "cpu"), TCAM,
                       iters=iters, cg_iters=cg_iters, use_huber=use_huber,
                       dense_schur=False)
    rot, trans = _pose_err(out.kf_pose.numpy(), np.asarray(ref.kf_pose))
    assert rot <= 1e-4 and trans <= 1e-4, (rot, trans)
    assert np.abs(out.pt_pos.numpy() - np.asarray(ref.pt_pos)).max() <= 1e-3
    c0, r0 = float(out.initial_cost), float(ref.initial_cost)
    assert abs(c0 - r0) <= 1e-5 * abs(r0), (c0, r0)
    c1, r1 = float(out.final_cost), float(ref.final_cost)
    assert abs(c1 - r1) <= 1e-3 * abs(r1), (c1, r1)
    assert (out.obs_inlier.numpy() == np.asarray(ref.obs_inlier)).mean() \
        >= 0.999
    assert c1 < 0.5 * c0
    np.testing.assert_array_equal(out.kf_pose.numpy()[:2], d["kf_pose"][:2])


def _asm_args(d):
    p = convert.ba_problem_from_numpy(d, "cpu")
    P = p.pt_pos.shape[0]
    ok = (p.obs_pt >= 0) & p.pt_valid[torch.clamp(p.obs_pt, 0, P - 1).long()]
    return p, ok


def test_w_obs_mode_matches_jax_jacobians():
    d = _problem(seed=2)
    p, ok = _asm_args(d)
    dense = tba.ba_assemble_plain(p.kf_pose, p.pt_pos, p, ok, TCAM, True)
    Hpp, g_p, acc, W = tba.ba_assemble_plain(p.kf_pose, p.pt_pos, p, ok,
                                             TCAM, True, w_obs=True)
    for a, b in zip((Hpp, g_p, acc), dense[:3]):
        assert torch.equal(a, b)
    K, N = d["obs_pt"].shape
    assert W.shape == (K * N, 18)
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    r, Jp, Jl = jba._residuals_jacobians(jp.kf_pose, jp.pt_pos, jp, JCAM)
    has_ur = d["obs_ur"] > 0
    delta = np.sqrt(np.where(has_ur, jba.CHI2_STEREO, jba.CHI2_MONO))
    chi2 = np.sum(np.asarray(r) ** 2, -1) * d["obs_inv_s2"]
    s = np.sqrt(np.maximum(chi2, 1e-12))
    w = d["obs_inv_s2"] * np.where(s > delta, delta / s, 1.0)
    w = np.where(ok.numpy(), w, 0.0)
    ref = np.einsum("knci,kncj->knij", np.asarray(Jp) * w[..., None, None],
                    np.asarray(Jl)).reshape(K * N, 18)
    W = W.numpy()
    assert np.abs(W - ref).max() <= 1e-4 * np.abs(ref).max()
    assert not W[~ok.numpy().reshape(-1)].any()


def _schur_inputs(seed=4):
    d = _problem(seed=seed)
    p, ok = _asm_args(d)
    Hpp, g_p, acc, W = tba.ba_assemble_plain(p.kf_pose, p.pt_pos, p, ok,
                                             TCAM, True, w_obs=True)
    P = p.pt_pos.shape[0]
    eye3, eye6 = torch.eye(3), torch.eye(6)
    Hll = acc[:, :9].reshape(P, 3, 3)
    Hpp_d = Hpp + (1e-3 * torch.diagonal(Hpp, dim1=1, dim2=2)
                   + 1e-6)[:, :, None] * eye6
    Hll_d = Hll + (1e-3 * torch.diagonal(Hll, dim1=1, dim2=2)
                   + 1e-6)[:, :, None] * eye3
    G = tba._inv3x3(Hll_d + 1e-9 * eye3)
    return p, ok, Hpp_d, G, W


def _dense_reduced(p, ok, Hpp_d, G, W):
    """In f64: T [P, K*6, 3] (each point's camera-block sums of W_obs) and
    the dense S = blockdiag(Hpp_d) - sum_p T_p G_p T_p^T."""
    K, N = p.obs_pt.shape
    P = G.shape[0]
    T = np.zeros((P, K * 6, 3))
    Wn = W.double().numpy().reshape(K, N, 6, 3)
    okn, ptn = ok.numpy(), p.obs_pt.numpy()
    for k in range(K):
        for n in np.nonzero(okn[k])[0]:
            T[ptn[k, n], k * 6:(k + 1) * 6] += Wn[k, n]
    S = -np.einsum("pdi,pij,pej->de", T, G.double().numpy(), T)
    for k in range(K):
        S[k * 6:(k + 1) * 6, k * 6:(k + 1) * 6] += Hpp_d[k].double().numpy()
    return T, S


def test_schur_mv_plain_equals_dense_reduced_matrix():
    p, ok, Hpp_d, G, W = _schur_inputs()
    K, N = p.obs_pt.shape
    P = G.shape[0]
    free = ~p.kf_fixed
    v = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, (K, 6)).astype(np.float32))
    out = tba.ba_schur_mv_plain(v, free, Hpp_d, G, W, p.obs_pt, ok)
    _, S = _dense_reduced(p, ok, Hpp_d, G, W)
    fm = np.repeat(free.numpy(), 6).astype(np.float64)
    ref = ((S * fm[:, None] * fm[None, :]) @ v.double().numpy().reshape(-1))
    scale = np.abs(S).max() * np.abs(v.numpy()).max()
    assert np.abs(out.double().numpy().reshape(-1) - ref).max() <= 1e-5 * scale
    assert not out[~free].any()
    # the CG's one wrapper and its plain version on the CPU
    g_p = torch.as_tensor(np.random.default_rng(2).normal(
        0, 1, (K, 6)).astype(np.float32))
    g_l = torch.as_tensor(np.random.default_rng(3).normal(
        0, 1, (P, 3)).astype(np.float32))
    args = (Hpp_d, g_p, g_l, G, W, p.obs_pt, ok, free, 10)
    assert all(torch.equal(a, b) for a, b in zip(
        tba.ba_schur_cg(*args), tba.cg_solve_plain(*args)))


def test_schur_u_and_ut_are_adjoint():
    p, ok, _, G, W = _schur_inputs(seed=5)
    K = p.obs_pt.shape[0]
    P = G.shape[0]
    rng = np.random.default_rng(1)
    v = torch.as_tensor(rng.normal(0, 1, (K, 6)).astype(np.float32))
    y = torch.as_tensor(rng.normal(0, 1, (P, 3)).astype(np.float32))
    ut = tba.ba_schur_ut_plain(v, W, p.obs_pt, ok, P)
    u = tba.ba_schur_u_plain(y, W, p.obs_pt, ok)
    a = float((ut.double() * y.double()).sum())
    b = float((v.double() * u.double()).sum())
    assert abs(a - b) <= 1e-5 * max(abs(a), 1.0)
    # U^T v is zero on points no live slot observes, U y on keyframes
    # with no live slot
    seen = torch.zeros(P, dtype=torch.bool)
    seen[p.obs_pt[ok].long()] = True
    assert not ut[~seen].any() and ut[seen].abs().sum() > 0
    assert not u[~ok.any(1)].any()


@pytest.mark.parametrize("seed,cg_iters", [(4, 40), (5, 1), (6, 0)])
def test_cg_solve_plain_solves_the_reduced_system(seed, cg_iters):
    """`cg_solve_plain` against the reduced camera system built densely in
    f64 from the same blocks: rhs = -(g_p - T^T G g_l) on the free
    keyframes; no iteration gives dp = 0; one gives the preconditioned
    steepest-descent step alpha z0, alpha = r.z0 / z0.S z0, z0 = Minv r;
    40 (more than the 36 free unknowns) give S^-1 rhs. U^T dp is T dp."""
    p, ok, Hpp_d, G, W = _schur_inputs(seed)
    _, g_p, acc, _ = tba.ba_assemble_plain(p.kf_pose, p.pt_pos, p, ok, TCAM,
                                           True, w_obs=True)
    g_l = acc[:, 9:]
    free = ~p.kf_fixed
    G = torch.where(p.pt_frozen[:, None, None], torch.zeros_like(G), G)
    x, ut = tba.cg_solve_plain(Hpp_d, g_p, g_l, G, W, p.obs_pt, ok, free,
                               cg_iters)
    assert not x[~free].any()
    T, S = _dense_reduced(p, ok, Hpp_d, G, W)
    f = np.repeat(free.numpy(), 6)
    Gg = np.einsum("pij,pj->pi", G.double().numpy(), g_l.double().numpy())
    rhs = -(g_p.double().numpy().reshape(-1)
            - np.einsum("pdi,pi->d", T, Gg))[f]
    if cg_iters == 0:
        ref = np.zeros_like(rhs)
    elif cg_iters == 1:
        Minv = np.linalg.inv(Hpp_d.double().numpy()
                             + 1e-9 * np.eye(6))[free.numpy()]
        z = np.einsum("kij,kj->ki", Minv, rhs.reshape(-1, 6)).reshape(-1)
        ref = (rhs @ z) / (z @ S[np.ix_(f, f)] @ z) * z
    else:
        ref = np.linalg.solve(S[np.ix_(f, f)], rhs)
    dp = x.double().numpy().reshape(-1)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(dp[f] - ref).max() <= 2e-4 * scale, (
        np.abs(dp[f] - ref).max(), scale)
    if cg_iters:
        assert np.abs(dp[f]).max() > 0
    ut_ref = np.einsum("pdi,d->pi", T, dp)
    assert np.abs(ut.double().numpy() - ut_ref).max() <= 1e-5 * max(
        np.abs(ut_ref).max(), 1e-30)


def _place_case(name):
    d = _problem(seed=9)
    p, ok = _asm_args(d)
    obs_pt, Q = p.obs_pt.clone(), p.pt_pos.shape[0]
    if name == "repeats":  # a point three times in one keyframe, 24 in all
        obs_pt[:8, 3:6] = 7
        ok[:8, 3:6] = True
    elif name == "beyond_q":  # clamped to [0, Q) as the assembly does
        obs_pt[2, :5] = Q + 3
        obs_pt[3, :5] = -4
        ok[2:4, :5] = True
    elif name == "all_dead":
        ok[:] = False
    return obs_pt, ok, Q


@pytest.mark.parametrize("name", ["problem", "repeats", "beyond_q",
                                  "all_dead"])
def test_point_index_place_inverts_slots(name):
    obs_pt, ok, Q = _place_case(name)
    idx = tba.ba_point_index_plain(obs_pt, ok, Q)
    L = int(idx.offsets[-1])
    assert idx.place.dtype == torch.int32 and idx.place.shape == ok.reshape(
        -1).shape
    live = torch.nonzero(ok.reshape(-1)).reshape(-1)
    assert L == live.numel()
    assert torch.equal(idx.slots[idx.place[live].long()].long(), live)
    assert torch.equal(idx.place[idx.slots[:L].long()],
                       torch.arange(L, dtype=torch.int32))
    assert (idx.place[~ok.reshape(-1)] == -1).all()
    # a point's rows are contiguous: place falls in its point's range
    q = torch.clamp(obs_pt.reshape(-1)[live], 0, Q - 1).long()
    pl = idx.place[live].long()
    assert ((idx.offsets[q] <= pl) & (pl < idx.offsets[q + 1])).all()


def test_w_obs_rows_in_point_order():
    d = _problem(seed=10)
    p, ok = _asm_args(d)
    Q = p.pt_pos.shape[0]
    W = tba.ba_assemble_plain(p.kf_pose, p.pt_pos, p, ok, TCAM, True,
                              w_obs=True)[3]
    idx = tba.ba_point_index_plain(p.obs_pt, ok, Q)
    L = int(idx.offsets[-1])
    W_live = W[idx.slots[:L].long()]
    live = torch.nonzero(ok.reshape(-1)).reshape(-1)
    assert torch.equal(W_live[idx.place[live].long()], W[live])
    # point q's rows are W_live[offsets[q]:offsets[q + 1]], slot ids
    # ascending
    for q in torch.nonzero(idx.offsets[1:] > idx.offsets[:-1])[:20, 0]:
        a, b = int(idx.offsets[q]), int(idx.offsets[q + 1])
        s = idx.slots[a:b].long()
        assert (s[1:] > s[:-1]).all()
        assert (p.obs_pt.reshape(-1)[s] == q).all()
        assert torch.equal(W_live[a:b], W[s])
    # and back to the slot layout, as the card's rows are for the plain CG
    padded = torch.full_like(W, float("nan"))
    padded[:L] = W_live
    assert torch.equal(tba.w_obs_slot_rows(tba.LiveRows(padded, idx)), W)


def test_compact_points_keeps_every_live_point_in_order():
    d = _problem(seed=6)
    p = convert.ba_problem_from_numpy(d, "cpu")
    pc, live = tba.compact_points(p)
    n = live.numel()
    np.testing.assert_array_equal(live.numpy(), np.nonzero(d["pt_valid"])[0])
    assert pc.pt_pos.shape[0] == tba.POINT_BUCKET > n
    assert pc.pt_valid[:n].all() and not pc.pt_valid[n:].any()
    np.testing.assert_array_equal(pc.pt_pos[:n].numpy(),
                                  d["pt_pos"][d["pt_valid"]])
    np.testing.assert_array_equal(pc.pt_frozen[:n].numpy(),
                                  d["pt_frozen"][d["pt_valid"]])
    # every observation of a live point points at its compacted row
    obs, obs_c = d["obs_pt"], pc.obs_pt.numpy()
    live_obs = (obs >= 0) & d["pt_valid"][np.clip(obs, 0, None)]
    np.testing.assert_array_equal(live.numpy()[obs_c[live_obs]],
                                  obs[live_obs])
    assert (obs_c[~live_obs] == -1).all()
    whole = tba.ba_solve(p, TCAM, iters=4, cg_iters=30, dense_schur=False)
    part = tba.ba_solve(pc, TCAM, iters=4, cg_iters=30, dense_schur=False)
    np.testing.assert_allclose(part.kf_pose.numpy(), whole.kf_pose.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(part.pt_pos[:n].numpy(),
                               whole.pt_pos[live].numpy(), atol=1e-5)
    assert abs(float(part.final_cost) - float(whole.final_cost)) \
        <= 1e-5 * float(whole.final_cost)


def test_compact_points_keeps_every_point_at_full_capacity():
    K, N, P, n_live = 128, 1000, 32768, 30000
    rng = np.random.default_rng(11)
    live_ids = np.sort(rng.permutation(P)[:n_live])
    valid = np.zeros(P, bool)
    valid[live_ids] = True
    # every live point seen by 2-5 keyframes; dead points observed too
    obs_pt = np.full((K, N), -1, np.int32)
    flat = rng.permutation(K * N)
    per = rng.integers(2, 6, n_live)
    ends = np.cumsum(per)
    assert ends[-1] < K * N - 2000
    pt_of = np.repeat(live_ids, per)
    obs_pt.reshape(-1)[flat[:ends[-1]]] = pt_of
    dead = np.nonzero(~valid)[0]
    obs_pt.reshape(-1)[flat[ends[-1]:ends[-1] + 1000]] = rng.choice(dead, 1000)
    p = tba.BAProblem(
        kf_pose=torch.zeros((K, 7)), kf_fixed=torch.zeros(K, dtype=torch.bool),
        obs_uv=torch.zeros((K, N, 2)), obs_ur=-torch.ones((K, N)),
        obs_pt=torch.from_numpy(obs_pt), obs_inv_s2=torch.ones((K, N)),
        pt_pos=torch.from_numpy(rng.normal(0, 1, (P, 3)).astype(np.float32)),
        pt_valid=torch.from_numpy(valid), pt_frozen=None)
    pc, live = tba.compact_points(p)
    Q = pc.pt_pos.shape[0]
    assert Q == 30 * tba.POINT_BUCKET and Q % tba.POINT_BUCKET == 0
    np.testing.assert_array_equal(live.numpy(), live_ids)
    assert int(pc.pt_valid.sum()) == n_live and not pc.pt_valid[n_live:].any()
    np.testing.assert_array_equal(pc.pt_pos[:n_live].numpy(),
                                  p.pt_pos.numpy()[live_ids])
    obs_c = pc.obs_pt.numpy()
    on_live = (obs_pt >= 0) & valid[np.clip(obs_pt, 0, None)]
    np.testing.assert_array_equal(live_ids[obs_c[on_live]], obs_pt[on_live])
    assert (obs_c[~on_live] == -1).all()
    ok = (pc.obs_pt >= 0) & pc.pt_valid[pc.obs_pt.clamp(0, Q - 1).long()]
    idx = tba.ba_point_index_plain(pc.obs_pt, ok, Q)
    counts = np.bincount(obs_c[on_live], minlength=Q)
    np.testing.assert_array_equal(np.diff(idx.offsets.numpy()), counts)
    n_obs = int(counts.sum())
    assert n_obs == ends[-1]
    slots = idx.slots.numpy()
    assert (slots[n_obs:] == -1).all()
    np.testing.assert_array_equal(obs_c.reshape(-1)[slots[:n_obs]],
                                  np.repeat(np.arange(Q), counts))
    off = idx.offsets.numpy()
    for q in (0, 1, n_live - 1, 27904, 29999):
        run = slots[off[q]:off[q + 1]]
        assert (np.diff(run) > 0).all()
    np.testing.assert_array_equal(idx.place.numpy()[slots[:n_obs]],
                                  np.arange(n_obs))


def test_gba_scatter_back_leaves_dead_points():
    from orb_slam2_refactored_tpu_torch.slam.loop_closing import LoopCloser
    from orb_slam2_refactored_tpu_torch.slam.map_state import (
        MapCapacity, empty_map)
    from orb_slam2_refactored_tpu_torch.slam.vocabulary import Vocabulary

    d = _problem(seed=8, K=6, P=200, N=120)
    K, N = d["obs_pt"].shape
    m = empty_map(MapCapacity(K, 256, N), "cpu")
    m.kf_pose[:] = torch.as_tensor(d["kf_pose"])
    m.kf_valid[:] = True
    m.kf_xy[:] = torch.as_tensor(d["obs_uv"])
    m.kf_uright[:] = torch.as_tensor(d["obs_ur"])
    m.kf_mp[:] = torch.as_tensor(d["obs_pt"])
    m.mp_pos[:200] = torch.as_tensor(d["pt_pos"])
    m.mp_valid[:200] = torch.as_tensor(d["pt_valid"])
    m.mp_pos[200:] = 7.0
    voc = Vocabulary(words=torch.zeros((4, 8), dtype=torch.int32),
                     idf=torch.ones(4))
    lc = LoopCloser(voc, TCAM, K, n_levels=1, gba_iters=3, gba_cg_iters=20)
    free = torch.ones(K, dtype=torch.bool)
    free[0] = False
    pose, pts, _, c0, c1 = lc._gba_impl(m, free)
    assert float(c1) < float(c0)
    dead = ~m.mp_valid
    assert torch.equal(pts[dead], m.mp_pos[dead])
    assert not torch.equal(pts[m.mp_valid], m.mp_pos[m.mp_valid])
    np.testing.assert_array_equal(pose[0].numpy(), d["kf_pose"][0])
