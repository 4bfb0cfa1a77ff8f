"""Port parity for the stereo ops (`ops/stereo.py`) against the JAX
package's, on a rendered QVGA pair (500 features, 4 levels) and on
constructed cases.

- `stereo_match`: fed JAX's extracted features, u_right, depth and ok are
  equal (the gate is K1's dense `pair_ok`, the median the JAX midpoint).
- The two medians (C4): `jnp.median` and `jnp.nanmedian` take the mean of
  the two middle values of an even count; misses count at BIG, and no
  valid SAD gives no filter (inf).
- `refine_subpixel_pyramid`: fed JAX's pyramid levels, the ok sets are
  equal, u_right within 1e-4 px and depth within 1e-6 relative. Upper
  levels are not integers, so XLA's sum order and the kernel's may differ
  by an ulp; the only rows allowed to differ are those whose two smallest
  SADs lie within 1e-5 relative (counted and printed; expected 0; the SADs
  are the plain version's, within an ulp of JAX's).
- The plain version of kernel B9 against a numpy loop on the constructed
  cases of `torch_sad_cases.py`: a tie (the lowest index wins), argmin at
  r = 0 and r = 10 (rejected), a flat SAD row (rejected), keypoints at a
  level's rim (where the clips bind), keypoints on the top level.
- `refine_subpixel` (level 0) against JAX's.
- `stereo_associate` (the tracker's entry) on CPU tensors: bit-equal to
  JAX's `stereo_match` then `refine_subpixel_pyramid` on JAX's levels, and
  no host read (no `aten._local_scalar_dense` under a dispatch mode).
- `associate_from_best2` (everything after K1, on CPU its plain version)
  on the constructed cases of `torch_sad_cases.py` against JAX's
  `stereo_match` tail and `refine_subpixel_pyramid`, bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from orb_slam2_refactored_tpu.ops import hamming as jhamming
from orb_slam2_refactored_tpu.ops import stereo as jst
from orb_slam2_refactored_tpu.ops.orb import OrbExtractor as JExtractor
from orb_slam2_refactored_tpu.slam.frame import scale_factors as jscale
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, box_room, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.ops import hamming
from orb_slam2_refactored_tpu_torch.ops import stereo as tst
from torch_sad_cases import (ASSOC_CASES, SAD_CASES, as_tensors, assoc_case,
                             assoc_tensors, sad_case, sad_ref)

torch.set_num_threads(1)
BF = 0.08 * 260.0
N_LEVELS = 4


def _q8(img):
    """The 8-bit quantization of the JAX tracker's wire packing."""
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def pair():
    """JAX's features and pyramids of a rendered QVGA pair, its stereo
    association and its per-level refinement."""
    planes = box_room(half_x=1.5, half_y=1.2, z_far=2.5, z_near=-2.5)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes, baseline=0.08)
    left, right, _ = scene.render_stereo(
        orbit_trajectory(4, radius=0.35, yaw_amp=0.25)[1])
    ext = jax.jit(JExtractor(240, 320, n_features=500,
                             n_levels=N_LEVELS)._extract_impl_pyr)
    lf, pyr_l = ext(jnp.asarray(_q8(left)))
    rf, pyr_r = ext(jnp.asarray(_q8(right)))
    sf = jscale(N_LEVELS, 1.2)[0]
    match = jax.jit(jst.stereo_match, static_argnames=("bf", "min_z"))(
        lf.xy, lf.level, lf.desc, lf.valid, rf.xy, rf.level, rf.desc,
        rf.valid, sf, bf=BF, min_z=BF / 260.0)
    refined = jax.jit(jst.refine_subpixel_pyramid, static_argnames=("bf",))(
        pyr_l, pyr_r, lf.xy, lf.level, match[0], match[2], bf=BF,
        scale_factors=sf)
    return {"lf": lf, "rf": rf, "pyr_l": pyr_l, "pyr_r": pyr_r, "sf": sf,
            "match": [np.array(a) for a in match],
            "refined": [np.array(a) for a in refined],
            "img": (_q8(left), _q8(right))}


def test_stereo_match_equals_jax(pair):
    lf, rf = pair["lf"], pair["rf"]
    out = tst.stereo_match(
        _t(lf.xy), _t(lf.level), _t(lf.desc), _t(lf.valid), _t(rf.xy),
        _t(rf.level), _t(rf.desc), _t(rf.valid), _t(pair["sf"]), BF,
        min_z=BF / 260.0)
    for name, a, b in zip(("u_right", "depth", "ok"), out, pair["match"]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert pair["match"][2].sum() > 150


def _median_cases():
    rng = np.random.default_rng(3)
    # sorted, elements 499 and 500 are 40 and 41: the two middle values
    best = rng.permutation(np.r_[rng.integers(0, 41, 499), 40, 41,
                                 rng.integers(41, 90, 499)]).astype(np.int32)
    hit = np.ones(1000, bool)
    sad = rng.uniform(50, 900, 1000).astype(np.float32)
    return {
        "even_middle_pair_differs": (best, hit, sad, hit),
        "all_misses": (best, np.zeros(1000, bool), sad,
                       np.zeros(1000, bool)),
        "under_half_matched": (best, rng.uniform(size=1000) < 0.4, sad,
                               rng.uniform(size=1000) < 0.4),
        "even_valid_sads": (best, rng.uniform(size=1000) < 0.7, sad,
                            np.arange(1000) < 618),
        "odd_valid_sads": (best, hit, sad, np.arange(1000) < 617),
        "one_valid_sad": (best, hit, sad, np.arange(1000) == 17),
    }


@pytest.mark.parametrize("case", list(_median_cases()))
def test_medians_match_jnp(case):
    """C4: both medians against `jnp.median` / `jnp.nanmedian` of the
    arrays the two filters build (misses at BIG; rejected SADs NaN, and no
    valid SAD -> inf)."""
    best, hit, sad, good = _median_cases()[case]
    dist = np.where(hit, best, hamming.BIG).astype(np.int32)
    want = np.float32(jnp.median(jnp.asarray(dist)))
    got = tst._median_midpoint(torch.from_numpy(dist))
    assert got.dtype == torch.float32
    assert got.item() == want, (got.item(), want)
    if case == "even_middle_pair_differs":
        assert want != np.float32(np.sort(dist)[499])  # not the lower one
    masked = np.where(good, sad, np.nan).astype(np.float32)
    jmed = jnp.nanmedian(jnp.asarray(masked))
    want = np.float32(jnp.where(jnp.isnan(jmed), jnp.inf, jmed))
    got = tst._nanmedian_midpoint(torch.from_numpy(masked))
    got = torch.where(torch.isnan(got), torch.full_like(got, np.inf), got)
    assert got.item() == want, (got.item(), want)
    if not good.any():
        assert want == np.inf


def test_refine_subpixel_pyramid_matches_jax(pair):
    lf = pair["lf"]
    u0, _, ok0 = pair["match"]
    u, depth, ok = tst.refine_subpixel_pyramid(
        [_t(a) for a in pair["pyr_l"]], [_t(a) for a in pair["pyr_r"]],
        _t(lf.xy), _t(lf.level), _t(u0), _t(ok0), BF, _t(pair["sf"]))
    ju, jd, jok = pair["refined"]
    u, depth, ok = u.numpy(), depth.numpy(), ok.numpy()
    # the SADs (the plain version's, within an ulp of JAX's) to find the
    # rows whose argmin is a near-tie
    lvl, yl, xl, ur0 = tst.level_coordinates(
        [_t(a) for a in pair["pyr_l"]], _t(lf.xy), _t(lf.level), _t(u0),
        _t(pair["sf"]))
    sads = tst._sads_plain([_t(a) for a in pair["pyr_l"]],
                           [_t(a) for a in pair["pyr_r"]], lvl, yl, xl,
                           ur0).numpy()
    two = np.sort(sads, axis=1)[:, :2]
    near_tie = (two[:, 1] - two[:, 0]) <= 1e-5 * np.abs(two[:, 1])
    both = ok & jok
    bad = (ok != jok)
    bad[both] |= ((np.abs(u - ju)[both] > 1e-4)
                  | (np.abs(depth - jd)[both] > 1e-6 * np.abs(jd[both])))
    print(f"refine_subpixel_pyramid: {int(jok.sum())} accepted by JAX, "
          f"{int(bad.sum())} rows differ, all at near-ties: "
          f"{bool((~bad | near_tie).all())}; near-tie rows "
          f"{int(near_tie[ok0].sum())}")
    assert (~bad | near_tie).all()
    assert jok.sum() > 100
    assert (lf.level[jok] > 0).any()  # upper levels are on the path


@pytest.mark.parametrize("name", SAD_CASES)
def test_stereo_sad_plain_matches_numpy_loop(name):
    """The plain version of kernel B9 on the constructed cases of
    `torch_sad_cases.py`, bit-equal to a numpy loop in f32."""
    case = sad_case(name)
    ur, sad, ok, best = sad_ref(*case[:6])
    if case[6] is not None:
        np.testing.assert_array_equal(best, case[6])
    out = tst.refine_subpixel_sad_plain(*as_tensors(case))
    np.testing.assert_array_equal(out[0].numpy(), ur)
    np.testing.assert_array_equal(out[1].numpy(), sad)
    np.testing.assert_array_equal(out[2].numpy(), ok)
    if name in ("argmin_at_0", "argmin_at_10", "flat"):
        assert not ok.any()
    if name in ("interior", "top_level", "tie_lowest_index"):
        assert ok.all()


def test_refine_subpixel_level0_matches_jax(pair):
    lf = pair["lf"]
    u0, _, ok0 = pair["match"]
    left, right = pair["img"]
    want = jax.jit(jst.refine_subpixel, static_argnames=("bf",))(
        jnp.asarray(left), jnp.asarray(right), lf.xy, jnp.asarray(u0),
        jnp.asarray(ok0), bf=BF)
    got = tst.refine_subpixel(torch.from_numpy(left), torch.from_numpy(right),
                              _t(lf.xy), _t(u0), _t(ok0), BF)
    ju, jd, jok = (np.array(a) for a in want)
    np.testing.assert_array_equal(got[2].numpy(), jok)
    np.testing.assert_allclose(got[0].numpy(), ju, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), jd, rtol=1e-6, atol=0)
    assert jok.sum() > 100


def _associate_args(pair):
    lf, rf = pair["lf"], pair["rf"]
    return ([_t(a) for a in pair["pyr_l"]], [_t(a) for a in pair["pyr_r"]],
            _t(lf.xy), _t(lf.level), _t(lf.desc), _t(lf.valid), _t(rf.xy),
            _t(rf.level), _t(rf.desc), _t(rf.valid), _t(pair["sf"]), BF)


def test_stereo_associate_equals_jax(pair):
    """The tracker's entry on CPU tensors against JAX's `stereo_match` then
    `refine_subpixel_pyramid` on JAX's levels: bit-equal."""
    out = tst.stereo_associate(*_associate_args(pair), min_z=BF / 260.0)
    for name, a, b in zip(("u_right", "depth", "ok"), out, pair["refined"]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert pair["refined"][2].sum() > 100


class _Ops(TorchDispatchMode):
    """The names of the aten operators run inside the block."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_stereo_associate_plain_reads_nothing_to_the_host(pair):
    """On CPU tensors `stereo_associate` is its plain version; no operator
    of it reads a value to the host (on the card each such read would be a
    device-to-host copy that stalls the host)."""
    with _Ops() as ops:
        out = tst.stereo_associate(*_associate_args(pair), min_z=BF / 260.0)
    assert "aten._local_scalar_dense.default" not in ops.names
    assert len(ops.names) > 50 and bool(out[2].any())


@functools.partial(jax.jit, static_argnames=("bf", "max_dist"))
def _jax_after_best2(levels_l, levels_r, l_xy, l_level, r_xy, idx, best,
                     scale_factors, bf, max_dist):
    """JAX's `stereo_match` after its best-2 (`ops/stereo.py:46-59` of the
    JAX package, inline there), then its `refine_subpixel_pyramid`."""
    ok = best <= max_dist
    matched_ur = jnp.where(
        ok, r_xy[jnp.clip(idx, 0, r_xy.shape[0] - 1), 0], -1.0)
    med = jnp.median(jnp.where(ok, best, jhamming.BIG))
    ok = ok & (best < 1.5 * 1.4 * med)
    return jst.refine_subpixel_pyramid(
        levels_l, levels_r, l_xy, l_level, jnp.where(ok, matched_ur, -1.0),
        ok, bf, scale_factors)


@pytest.mark.parametrize("name", ASSOC_CASES)
def test_associate_from_best2_plain_matches_jax(name):
    """Everything after K1 on the constructed cases (both medians: all
    missed, no good SAD, even and odd counts, ties, N = 13, 1, 0), the
    plain version against JAX, bit-equal."""
    case = assoc_case(name)
    u, depth, ok = tst.associate_from_best2(**assoc_tensors(case))
    assert (u.dtype, depth.dtype, ok.dtype) == (torch.float32,
                                                torch.float32, torch.bool)
    n = case["l_xy"].shape[0]
    assert u.shape == depth.shape == ok.shape == (n,)
    if n == 0:
        return
    want = _jax_after_best2(**{k: ([jnp.asarray(a) for a in v]
                                   if isinstance(v, list) else v)
                               for k, v in case.items()})
    for what, a, b in zip(("u_right", "depth", "ok"), (u, depth, ok), want):
        np.testing.assert_array_equal(a.numpy(), np.array(b), err_msg=what)
    if name in ("all_missed", "no_good_sad"):
        assert not ok.any()
    else:
        assert ok.any()
    if name in ("mixed_even", "mixed_odd", "tied_medians", "n13"):
        assert not ok.all()
