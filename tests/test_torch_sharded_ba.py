"""The port's keyframe-sharded BA (`parallel/sharded_ba.py`, `ba_solve(...,
group=)`) against JAX's `sharded_ba_solve` on the conftest's 8-device CPU
mesh, on `tests/test_ba.py::build_problem`'s problems, and the split CG's
plain entries against `cg_solve_plain`.

The port's ranks run in this process, one thread each, over gloo with a
`HashStore`. Tolerances are JAX's own test's (`tests/test_sharded_ba.py`):
poses 1e-3, final cost 1e-2 relative; the ranks must agree bit for bit."""

import datetime
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from orb_slam2_refactored_tpu.parallel.sharded_ba import (
    make_mesh, sharded_ba_solve as jax_sharded_ba_solve)
from orb_slam2_refactored_tpu_torch import convert, kernels
from orb_slam2_refactored_tpu_torch.geometry import projection as tproj
from orb_slam2_refactored_tpu_torch.geometry import se3 as tse3
from orb_slam2_refactored_tpu_torch.optim import ba as tba
from orb_slam2_refactored_tpu_torch.parallel.sharded_ba import (
    pad_problem, sharded_ba_solve)

from test_ba import build_problem

torch.set_num_threads(1)
RANKS = 2


def thread_groups(n):
    """n gloo process groups over one HashStore, one a rank, made in n
    threads (a rank's rendezvous waits for the others)."""
    store = dist.HashStore()
    out = [None] * n

    def make(r):
        be = dist.ProcessGroupGloo(store, r, n, datetime.timedelta(seconds=60))
        pg = dist.ProcessGroup(store, r, n)
        pg._set_default_backend(dist.ProcessGroup.BackendType.GLOO)
        pg._register_backend(torch.device("cpu"),
                             dist.ProcessGroup.BackendType.GLOO, be)
        out[r] = pg

    threads = [threading.Thread(target=make, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def on_ranks(n, fn):
    """fn(group) on each of n ranks, one thread each; the results in rank
    order."""
    groups = thread_groups(n)
    res, errors = [None] * n, []

    def run(r):
        try:
            torch.set_num_threads(1)
            res[r] = fn(groups[r])
        except Exception as e:  # raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return res


def _port(prob, cam):
    d = {k: np.asarray(v) for k, v in prob._asdict().items() if v is not None}
    tc = tproj.CameraIntrinsics.create(float(cam.fx), float(cam.fy),
                                       float(cam.cx), float(cam.cy),
                                       float(cam.bf))
    return convert.ba_problem_from_numpy(d, "cpu"), tc


def _solve_on_ranks(prob, cam, n=RANKS, **kw):
    tp, tc = _port(prob, cam)
    res = on_ranks(n, lambda g: sharded_ba_solve(tp, tc, group=g, **kw))
    for r in res[1:]:
        for a, b in zip(res[0], r):
            assert torch.equal(a, b), "the ranks' results differ"
    return res[0], tp, tc


def _hold_to_jax(res, jres):
    np.testing.assert_allclose(res.kf_pose.numpy(), np.asarray(jres.kf_pose),
                               atol=1e-3)
    np.testing.assert_allclose(float(res.final_cost),
                               float(jres.final_cost), rtol=1e-2)


def test_matches_jax_sharded_solve():
    cam, prob, _, _ = build_problem(np.random.default_rng(0), K=8, P=64,
                                    N=64)
    res, tp, tc = _solve_on_ranks(prob, cam, iters=8, cg_iters=30)
    _hold_to_jax(res, jax_sharded_ba_solve(prob, cam, make_mesh(), iters=8,
                                           cg_iters=30))
    single = tba.ba_solve(tp, tc, iters=8, cg_iters=30)
    np.testing.assert_allclose(res.kf_pose.numpy(), single.kf_pose.numpy(),
                               atol=1e-3)


def test_padding_neutral():
    """K = 6 over 4 ranks: two dummy keyframes, sliced off again."""
    cam, prob, _, _ = build_problem(np.random.default_rng(1), K=6, P=64,
                                    N=64)
    res, tp, tc = _solve_on_ranks(prob, cam, n=4, iters=6, cg_iters=25)
    assert res.kf_pose.shape[0] == 6 and res.obs_inlier.shape == (6, 64)
    single = tba.ba_solve(tp, tc, iters=6, cg_iters=25)
    np.testing.assert_allclose(res.kf_pose.numpy(), single.kf_pose.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(float(res.final_cost),
                               float(single.final_cost), rtol=1e-2)
    padded = pad_problem(tp, 4)
    assert padded.kf_pose.shape[0] == 8 and bool(padded.kf_fixed[6:].all())
    assert bool((padded.obs_pt[6:] == -1).all())


def test_converges_on_ranks():
    cam, prob, poses_gt, _ = build_problem(np.random.default_rng(2), K=8,
                                           P=64, N=64, px_noise=0.0)
    res, _, _ = _solve_on_ranks(prob, cam, iters=15, cg_iters=40)
    err = tse3.log(tse3.compose(res.kf_pose.double(), tse3.inverse(
        torch.as_tensor(poses_gt).double())))
    assert float(err.norm(dim=1).max()) < 1e-3


def test_pt_frozen_threads_through_padding():
    cam, prob, _, _ = build_problem(np.random.default_rng(3), K=6, P=64,
                                    N=64)
    frozen = np.zeros(64, bool)
    frozen[::3] = True
    prob = prob._replace(pt_frozen=jnp.asarray(frozen))
    res, tp, _ = _solve_on_ranks(prob, cam, iters=6, cg_iters=25)
    _hold_to_jax(res, jax_sharded_ba_solve(prob, cam, make_mesh(), iters=6,
                                           cg_iters=25))
    np.testing.assert_array_equal(res.pt_pos.numpy()[frozen],
                                  tp.pt_pos.numpy()[frozen])


@pytest.mark.parametrize("dense", [False, True])
def test_group_of_one_gives_the_unsharded_bits(dense):
    cam, prob, _, _ = build_problem(np.random.default_rng(4), K=6, P=64,
                                    N=64)
    tp, tc = _port(prob, cam)
    kw = dict(iters=4, cg_iters=20, dense_schur=dense)
    ref = tba.ba_solve(tp, tc, **kw)
    (got,) = on_ranks(1, lambda g: tba.ba_solve(tp, tc, group=g, **kw))
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_dense_branch_with_a_group():
    """The dense branch over two ranks gathers every rank's keyframe rows
    (JAX psums T, whose keyframe axis is the rank's own, a path its sharded
    solve never takes) and solves the whole system: held to the unsharded
    dense solve (poses 1e-3, cost 1e-2 relative), a step taken (c1 < c0),
    and the same points and costs on both ranks."""
    cam, prob, _, _ = build_problem(np.random.default_rng(5), K=8, P=64,
                                    N=64)
    tp, tc = _port(prob, cam)
    kw = dict(iters=4, dense_schur=True)
    halves = [tp._replace(**{f: getattr(tp, f)[r * 4:(r + 1) * 4]
                             for f in ("kf_pose", "kf_fixed", "obs_uv",
                                       "obs_ur", "obs_pt", "obs_inv_s2")})
              for r in range(2)]
    res = on_ranks(2, lambda g: tba.ba_solve(halves[g.rank()], tc, group=g,
                                             **kw))
    for f in ("pt_pos", "initial_cost", "final_cost"):
        assert torch.equal(getattr(res[0], f), getattr(res[1], f)), f
    single = tba.ba_solve(tp, tc, **kw)
    assert float(single.final_cost) < float(single.initial_cost)
    assert float(res[0].final_cost) < float(res[0].initial_cost)
    assert not torch.equal(res[0].pt_pos, tp.pt_pos)
    np.testing.assert_allclose(
        torch.cat([res[0].kf_pose, res[1].kf_pose]).numpy(),
        single.kf_pose.numpy(), atol=1e-3)
    np.testing.assert_allclose(res[0].pt_pos.numpy(), single.pt_pos.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(float(res[0].final_cost),
                               float(single.final_cost), rtol=1e-2)


def _cg_problem(seed=6, K=8, P=64, N=64):
    """One LM iteration's reduced system, assembled by the plain K5."""
    cam, prob, _, _ = build_problem(np.random.default_rng(seed), K=K, P=P,
                                    N=N)
    tp, tc = _port(prob, cam)
    ok = tp.obs_pt >= 0
    Hpp, g_p, acc, W = tba.ba_assemble_plain(tp.kf_pose, tp.pt_pos, tp, ok,
                                             tc, True, w_obs=True)
    eye3, eye6 = torch.eye(3), torch.eye(6)
    Hll = acc[:, :9].reshape(P, 3, 3)
    Hpp_d = Hpp + (1e-4 * torch.diagonal(Hpp, dim1=1, dim2=2)
                   + 1e-6)[:, :, None] * eye6
    Hll_d = Hll + (1e-4 * torch.diagonal(Hll, dim1=1, dim2=2)
                   + 1e-6)[:, :, None] * eye3
    return dict(Hpp_d=Hpp_d, g_p=g_p, g_l=acc[:, 9:].contiguous(),
                G=tba._inv3x3(Hll_d + 1e-9 * eye3), W_obs=W,
                obs_pt=tp.obs_pt, obs_ok=ok, free=~tp.kf_fixed,
                cg_iters=12), acc


def test_split_cg_plain_entries_equal_cg_solve_plain():
    """The three entries' plain versions, driven as the kernels are, give
    `cg_solve_plain`'s bits without a group."""
    a, _ = _cg_problem()
    ref = tba.cg_solve_plain(**a)
    got = tba.sharded_cg_solve_plain(**a)
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
    # the CPU path of the wrapper is the plain version
    got = tba.sharded_cg_solve(**a)
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])


def _f64(a):
    return {k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in a.items()}


@pytest.mark.parametrize("P", [64, 65])
def test_split_cg_over_ranks(P):
    """Two ranks, each with half the keyframes and the partial sums of its
    own observations (P = 64 shards the points, 65 does not). The sums run
    in other orders than the whole problem's, so the yardstick is
    `cg_solve_plain` in f64: dp and U^T dp within twice the f32 plain
    solve's distance from it, plus 1e-5 of its largest magnitude."""
    a, _ = _cg_problem(P=P)
    ref = tba.cg_solve_plain(**a)
    exact = tba.cg_solve_plain(**_f64(a))
    K = a["obs_pt"].shape[0]

    def rank(g):
        r = g.rank()
        ks = slice(r * K // 2, (r + 1) * K // 2)
        mine = {k: (v[ks] if k in ("Hpp_d", "g_p", "obs_pt", "obs_ok",
                                   "free") else v) for k, v in a.items()}
        mine["W_obs"] = a["W_obs"].reshape(K, -1, 18)[ks].reshape(-1, 18)
        comm = tba.ShardComm(g, P)
        mine["g_l"] = comm.my_rows(a["g_l"]).contiguous()
        mine["G"] = comm.my_rows(a["G"]).contiguous()
        return tba.sharded_cg_solve(**mine, comm=comm)

    kernels.reset_counts()
    res = on_ranks(2, rank)
    calls = kernels.collective_counts()
    if P % 2:
        # U^T dp all-reduced: the whole of it on both ranks
        assert torch.equal(res[0][1], res[1][1])
        ut = res[0][1]
    else:
        ut = torch.cat([res[0][1], res[1][1]])  # each rank's point rows
    for got, r, e in zip((torch.cat([res[0][0], res[1][0]]), ut), ref,
                         exact):
        bound = 2 * float((r.double() - e).abs().max()) + 1e-5 * float(
            e.abs().max())
        assert float((got.double() - e).abs().max()) <= bound
    # a rank's: three all_reduces a CG iteration (U^T p, p.Ap, r.z) and
    # r.z of the setup; with the points sharded, G and g_l gathered before
    # the CG and U^T dp reduce-scattered after it, else U^T dp all-reduced
    # (both ranks count into `kernels.COLLECTIVES`)
    it = a["cg_iters"]
    assert calls == {n: 2 * v for n, v in (
        {"all_reduce": 3 * it + 2, "reduce_scatter": 0, "all_gather": 0}
        if P % 2 else
        {"all_reduce": 3 * it + 1, "reduce_scatter": 1,
         "all_gather": 2}).items()}, calls
