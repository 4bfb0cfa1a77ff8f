"""Port parity: Sim(3) geometry, the relative-Sim3 LM and the pose graph.

(a) `geometry/sim3.py`: every function on seeded inputs against JAX's,
    within 2e-6 (f32 rounding of the same formulas).
(b) `optim/sim3_opt.py::optimize_sim3` on 300 seeded landmark pairs (10 %
    outliers), scale fixed and free: S within 1e-4, the inlier masks equal,
    the final cost within 1e-4 relative. The Jacobian is one jacfwd of the
    whole residual vector here, pair by pair in JAX: the same arithmetic.
(c) `optim/pose_graph.py::pose_graph_solve` on a 12-keyframe ring with
    accumulated drift and one loop edge (weight 5): poses within 1e-5, both
    costs within 1e-4 of the initial cost; the loop is closed (the final
    cost below
    5 % of the initial). The fixed-order segment sum gives the same bits on
    a second solve, and the segment table holds every edge end once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu.geometry import projection as jproj
from orb_slam2_refactored_tpu.geometry import sim3 as jsim3
from orb_slam2_refactored_tpu.optim import pose_graph as jpg
from orb_slam2_refactored_tpu.optim import sim3_opt as jopt
from orb_slam2_refactored_tpu_torch import convert
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_refactored_tpu_torch.optim import pose_graph as tpg
from orb_slam2_refactored_tpu_torch.optim import sim3_opt as topt

torch.set_num_threads(1)


def _sims(rng, n):
    t = rng.normal(0, 0.3, (n, 7)).astype(np.float32)
    t[:, 6] *= 0.5
    return np.asarray(jsim3.exp(jnp.asarray(t)))


def _t(a):
    return torch.as_tensor(np.array(a))


CASES = {
    "from_se3": lambda m, a, b, x, d, s: m.from_se3(a[..., :7]),
    "from_se3_scaled": lambda m, a, b, x, d, s: m.from_se3(a[..., :7], s),
    "make": lambda m, a, b, x, d, s: m.make(a[..., :4], a[..., 4:7], s),
    "to_se3": lambda m, a, b, x, d, s: m.to_se3(a),
    "transform_rows": lambda m, a, b, x, d, s: m.transform(a, x),
    "transform_bcast": lambda m, a, b, x, d, s: m.transform(a[0], x),
    "compose": lambda m, a, b, x, d, s: m.compose(a, b),
    "inverse": lambda m, a, b, x, d, s: m.inverse(a),
    "exp": lambda m, a, b, x, d, s: m.exp(d),
    "retract": lambda m, a, b, x, d, s: m.retract(a, d),
    "log": lambda m, a, b, x, d, s: m.log(a),
    "identity": lambda m, a, b, x, d, s: m.identity((3,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sim3_functions_match_jax(name):
    rng = np.random.default_rng(3)
    a, b = _sims(rng, 6), _sims(rng, 6)
    x = rng.normal(0, 2, (6, 3)).astype(np.float32)
    d = rng.normal(0, 0.1, (6, 7)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    ref = np.asarray(CASES[name](jsim3, *(jnp.asarray(v)
                                          for v in (a, b, x, d, s))))
    out = CASES[name](tsim3, *(_t(v) for v in (a, b, x, d, s))).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=2e-6)


CAM = (300.0, 300.0, 160.0, 120.0)


def _sim3_problem(seed, with_scale):
    rng = np.random.default_rng(seed)
    n = 300
    t = np.array([0.05, -0.1, 0.08, 0.3, -0.1, 0.2,
                  0.1 if with_scale else 0.0], np.float32)
    S_true = np.asarray(jsim3.exp(jnp.asarray(t)))
    x2 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                   rng.uniform(2.5, 6, n)], -1).astype(np.float32)
    x1 = np.asarray(jsim3.transform(jnp.asarray(S_true), jnp.asarray(x2)))
    cam = jproj.CameraIntrinsics.create(*CAM)
    uv1 = np.asarray(jproj.project(cam, jnp.asarray(x1)))
    uv2 = np.asarray(jproj.project(cam, jnp.asarray(x2)))
    uv1 = (uv1 + rng.normal(0, 0.7, uv1.shape)).astype(np.float32)
    uv2 = (uv2 + rng.normal(0, 0.7, uv2.shape)).astype(np.float32)
    bad = rng.uniform(size=n) < 0.1
    uv1[bad] += rng.uniform(15, 40, (int(bad.sum()), 2)).astype(np.float32)
    x1 = (x1 + rng.normal(0, 0.01, x1.shape)).astype(np.float32)
    inv1 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    inv2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    S0 = np.asarray(jsim3.retract(jnp.asarray(S_true), jnp.asarray(
        rng.normal(0, 0.02, 7).astype(np.float32) * np.array(
            [1, 1, 1, 1, 1, 1, 1 if with_scale else 0], np.float32))))
    return S0, x1, x2, uv1, uv2, inv1, inv2, valid


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_matches_jax(fix_scale):
    args = _sim3_problem(7, not fix_scale)
    ref = jopt.optimize_sim3(*(jnp.asarray(a) for a in args),
                             jproj.CameraIntrinsics.create(*CAM),
                             fix_scale=fix_scale)
    out = topt.optimize_sim3(*(_t(a) for a in args),
                             tproj.CameraIntrinsics.create(*CAM),
                             fix_scale=fix_scale)
    np.testing.assert_allclose(out.S.numpy(), np.asarray(ref.S), atol=1e-4)
    np.testing.assert_array_equal(out.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(out.num_inliers) == int(ref.num_inliers) > 200
    c, r = float(out.final_cost), float(ref.final_cost)
    assert abs(c - r) <= 1e-4 * r, (c, r)
    if fix_scale:
        assert float(out.S[7]) == float(args[0][7])


def _ring(seed=0, K=12):
    rng = np.random.default_rng(seed)
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        gt.append(np.asarray(jsim3.exp(jnp.asarray(np.array(
            [0, a, 0, 2 * np.sin(a), 0, 2 * np.cos(a), 0], np.float32)))))
    gt = np.stack(gt)
    # odometry with accumulated drift
    drift = gt.copy()
    for k in range(1, K):
        step = rng.normal(0, 0.004 * k, 7).astype(np.float32)
        step[6] = 0.0
        drift[k] = np.asarray(jsim3.retract(jnp.asarray(gt[k]),
                                            jnp.asarray(step)))
    ei, ej = list(range(K - 1)), list(range(1, K))
    rel = [np.asarray(jpg.edge_measurement(jnp.asarray(drift[i]),
                                           jnp.asarray(drift[j])))
           for i, j in zip(ei, ej)]
    ei.append(K - 1)
    ej.append(0)
    rel.append(np.asarray(jpg.edge_measurement(jnp.asarray(gt[K - 1]),
                                               jnp.asarray(gt[0]))))
    w = np.ones(len(ei), np.float32)
    w[-1] = 5.0
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(poses=drift, fixed=fixed, edge_i=np.asarray(ei, np.int32),
                edge_j=np.asarray(ej, np.int32), edge_rel=np.stack(rel),
                edge_w=w)


def test_pose_graph_solve_matches_jax():
    d = _ring()
    pj = jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    pt = convert.pose_graph_problem_from_numpy(d, "cpu")
    rp, r0, r1 = jpg.pose_graph_solve(pj, iters=20, cg_iters=50)
    op, o0, o1 = tpg.pose_graph_solve(pt, iters=20, cg_iters=50)
    np.testing.assert_allclose(op.numpy(), np.asarray(rp), atol=1e-5)
    assert abs(float(o0) - float(r0)) <= 1e-4 * float(r0)
    assert abs(float(o1) - float(r1)) <= 1e-4 * float(r0)
    assert float(o1) < 0.05 * float(o0)
    # the gauge keyframe holds
    np.testing.assert_array_equal(op.numpy()[0], d["poses"][0])
    again = tpg.pose_graph_solve(pt, iters=20, cg_iters=50)[0]
    assert torch.equal(again, op)


def test_segment_table_holds_every_edge_end_once():
    rng = np.random.default_rng(1)
    K, E = 9, 25
    ei = rng.integers(0, K, E).astype(np.int32)
    ej = rng.integers(0, K, E).astype(np.int32)
    table = tpg._segment_table(ei, ej, K)
    ends = np.concatenate([ei, ej])
    for k in range(K):
        rows = table[k][table[k] < 2 * E]
        np.testing.assert_array_equal(rows, np.nonzero(ends == k)[0])
    assert (table < 2 * E).sum() == 2 * E
