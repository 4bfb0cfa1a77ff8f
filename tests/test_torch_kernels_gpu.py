"""The CUDA kernels against their plain versions, on the card: K1 (in its
three gate modes), K2 and K3 (on one level and on a whole pyramid in one
call), K8 (the pyramid) and K9 (the per-level spread top-k), K7 (the
learned pattern, given the angles and whole, at the borders, on empty
levels, with one keypoint, and through its launch table), K4 (pose LM), K5
(BA assembly and cost, both modes), K6 (the fused CG
solve of global BA) and K6 split at its reductions (the sharded solve's
CG), and B9 (the stereo SAD
refinement alone, and the whole stereo association after K1 in one
launch), and the BoW vocabulary on K1 (quantization, training,
compute_bow), B6 (the projection search's gates and compaction, and its
feature mode: the motion-model search's gates) and R (the claim
resolution, in its three modes).

These tests need a CUDA card and skip elsewhere. The file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

(`chip_smoke.py` holds the same kernels against their plain versions at the
main path's full shapes.)
"""

import numpy as np
import pytest
import torch

from orb_slam2_refactored_tpu_torch import kernels
from orb_slam2_refactored_tpu_torch.geometry import projection as proj
from orb_slam2_refactored_tpu_torch.geometry import se3
from orb_slam2_refactored_tpu_torch.io.synthetic import (
    SyntheticScene, orbit_trajectory)
from orb_slam2_refactored_tpu_torch.ops import fast, hamming, orb, stereo
from orb_slam2_refactored_tpu_torch.ops import image as image_ops
from orb_slam2_refactored_tpu_torch.optim import ba, pose_opt
from orb_slam2_refactored_tpu_torch.slam.frame import scale_factors
from torch_b6_cases import (B6_CASES, CARD_CASES, CX, CY, FEATURE_CASES, FX,
                            R_CASES, SF, as_torch, b6_case, feature_case,
                            r_case)
from torch_k1_cases import k1_grid_cases
from torch_sad_cases import (ASSOC_CASES, SAD_CASES, as_tensors, assoc_case,
                             assoc_tensors, sad_case, sad_ref)

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _image():
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0)
    img, _ = scene.render(orbit_trajectory(4)[1])
    return torch.from_numpy(np.clip(img, 0, 255).astype(np.float32))


@pytest.mark.parametrize("gated", [False, True, "pair"])
def test_hamming_kernel_equals_plain(gated):
    dev = _card()
    rng = np.random.default_rng(9)
    M, N = 700, 450
    q = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (M, 8), dtype=np.int64)
                         .astype(np.int32))
    t = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (N, 8), dtype=np.int64)
                         .astype(np.int32))
    t[300:350] = t[100:150]  # equal minima at two indices
    q[:50] = t[100:150]
    args = [q, t, torch.from_numpy(rng.uniform(size=M) > 0.1),
            torch.from_numpy(rng.uniform(size=N) > 0.1)]
    if gated:
        xy = torch.from_numpy(rng.uniform(0, 80, (N, 2)).astype(np.float32))
        uv = xy[torch.arange(M) % N] + torch.from_numpy(
            rng.normal(0, 3, (M, 2)).astype(np.float32))
        args += [uv.contiguous(),
                 torch.from_numpy(rng.choice([3.0, 4.8, 15.0], M)
                                  .astype(np.float32)),
                 torch.from_numpy(rng.integers(0, 4, M).astype(np.int32)),
                 xy, torch.from_numpy(rng.integers(0, 4, N).astype(np.int32))]
    kw = {}
    if gated == "pair":  # triangulation's dense epipolar gate
        kw["pair_ok"] = torch.from_numpy(rng.uniform(size=(M, N)) > 0.7)
        kw["pair_ok"][3] = False
    ref = hamming.masked_best2_gated_plain(*args, **kw)
    out = hamming.masked_best2_gated(*(a.to(dev) for a in args),
                                     **{k: v.to(dev) for k, v in kw.items()})
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.cpu().numpy(), a.numpy())


@pytest.mark.parametrize("name", ["lattice", "chunked", "all_rows_invalid"])
def test_hamming_window_search_equals_plain(name):
    """K1's cell scan: exact on targets on cell edges and on the grid's far
    edge, d2 == r2, equal minima in different cells, empty windows, blocks
    of invalid rows, two binning chunks, whole-grid and infinite radii, NaN
    and infinite coordinates; one launch a call; every valid row searched."""
    dev = _card()
    a = {k: torch.from_numpy(v) for k, v in k1_grid_cases()[name].items()}
    ref = hamming.masked_best2_gated_plain(**a)
    before = kernels.counts()["hamming_best2"]
    out = hamming.masked_best2_gated(**{k: v.to(dev) for k, v in a.items()})
    torch.cuda.synchronize()
    assert kernels.counts()["hamming_best2"] == before + 1
    for x, y in zip(ref, out):
        np.testing.assert_array_equal(y.cpu().numpy(), x.numpy())
    work = hamming.hamming_work(**{k: v.to(dev) for k, v in a.items()}).cpu()
    assert int(work[0]) == int(a["row_ok"].sum()), work


def test_hamming_dense_search_equals_plain():
    """The dense search (no window, with and without the pair gate) equals
    the plain version; N = 1100 is not a multiple of the 256-target tile,
    and rows 64-95 (four blocks of 8) are all invalid."""
    dev = _card()
    rng = np.random.default_rng(16)
    M, N = 300, 1100
    q = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (M, 8),
                                      dtype=np.int64).astype(np.int32))
    t = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (N, 8),
                                      dtype=np.int64).astype(np.int32))
    t[600:650] = t[100:150]
    q[:50] = t[100:150]
    row_ok = torch.from_numpy(rng.uniform(size=M) > 0.1)
    row_ok[64:96] = False
    col_ok = torch.from_numpy(rng.uniform(size=N) > 0.1)
    for kw in ({}, {"pair_ok": torch.from_numpy(rng.uniform(size=(M, N))
                                                > 0.7)}):
        ref = hamming.masked_best2_gated_plain(q, t, row_ok, col_ok, **kw)
        out = hamming.masked_best2_gated(
            q.to(dev), t.to(dev), row_ok.to(dev), col_ok.to(dev),
            **{k: v.to(dev) for k, v in kw.items()})
        for x, y in zip(ref, out):
            np.testing.assert_array_equal(y.cpu().numpy(), x.numpy())


def test_fast_kernel_equals_plain():
    dev = _card()
    img = _image()
    for margin in (0, 19):
        ref = fast.detect_two_threshold_plain(img, 20.0, 7.0, margin=margin)
        out = fast.detect_two_threshold(img.to(dev), 20.0, 7.0, margin=margin)
        np.testing.assert_array_equal(out.cpu().numpy(), ref.numpy())


def test_orb_kernel_matches_plain():
    dev = _card()
    img = _image()
    ys = torch.arange(19, 220, 5, dtype=torch.int32)
    xs = torch.arange(40, 40 + 5 * len(ys), 5, dtype=torch.int32)
    ap, dp = orb.angles_and_descriptors_plain(img, ys, xs)
    ak, dk = orb.angles_and_descriptors_raw(img.to(dev), ys.to(dev),
                                            xs.to(dev))
    bins = lambda a: (np.floor((a + np.pi) * (64 / (2 * np.pi)))
                      .astype(np.int64) % 64)
    assert (bins(ak.cpu().numpy()) == bins(ap.numpy())).mean() >= 0.99
    xor = np.bitwise_xor(dk.cpu().numpy(), dp.numpy()).view(np.uint8)
    assert 1.0 - np.unpackbits(xor).mean() >= 0.999


def _vga_pyramid():
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0)
    img, _ = scene.render(orbit_trajectory(4)[2])
    img = torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8))
    return image_ops.build_pyramid(image_ops.to_gray(img), 8, 1.2)


def test_fast_levels_kernel_equals_plain():
    """The one-call K2 over a whole VGA pyramid: every score plane, raw and
    pos exactly equal to the plain version, and so every level's selected
    (ys, xs, response, valid); one launch a call."""
    dev = _card()
    levels = _vga_pyramid()
    ks = orb.features_per_level(1000, 8, 1.2)
    ref = fast.detect_and_rank_plain(levels, 20.0, 7.0, ks, margin=19)
    before = kernels.counts()["fast"]
    out = fast.detect_and_rank([lvl.to(dev) for lvl in levels], 20.0, 7.0,
                               ks, margin=19)
    torch.cuda.synchronize()
    assert kernels.counts()["fast"] == before + 1
    for lvl, k, a, b in zip(levels, ks, out, ref):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
        h, w = lvl.shape
        for x, y in zip(orb.topk_from_ranks(a[1], a[2], k, h, w),
                        orb.topk_from_ranks(b[1], b[2], k, h, w)):
            np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())


def test_orb_levels_kernel_matches_plain():
    """The one-launch K3 over the concatenated keypoints of a VGA pyramid:
    >= 99.9 % of descriptor bits and >= 99 % of angle bins equal to the
    plain version (the moments sum in another order); one launch a call."""
    dev = _card()
    levels = _vga_pyramid()
    ks = orb.features_per_level(1000, 8, 1.2)
    ys_all, xs_all = [], []
    for lvl, k, (_, raw, pos) in zip(
            levels, ks, fast.detect_and_rank_plain(levels, 20.0, 7.0, ks,
                                                   margin=19)):
        h, w = lvl.shape
        ys, xs, _, _ = orb.topk_from_ranks(raw, pos, k, h, w)
        ys_all.append(torch.clamp(ys, 19, h - 20).to(torch.int32))
        xs_all.append(torch.clamp(xs, 19, w - 20).to(torch.int32))
    ys, xs = torch.cat(ys_all), torch.cat(xs_all)
    ap, dp = orb.angles_and_descriptors_levels_plain(levels, ys, xs, ks)
    before = kernels.counts()["orb_desc"]
    ak, dk = orb.angles_and_descriptors_levels(
        [lvl.to(dev) for lvl in levels], ys.to(dev), xs.to(dev), ks)
    torch.cuda.synchronize()
    assert kernels.counts()["orb_desc"] == before + 1
    bins = lambda a: (np.floor((a + np.pi) * (64 / (2 * np.pi)))
                      .astype(np.int64) % 64)
    assert (bins(ak.cpu().numpy()) == bins(ap.numpy())).mean() >= 0.99
    xor = np.bitwise_xor(dk.cpu().numpy(), dp.numpy()).view(np.uint8)
    assert 1.0 - np.unpackbits(xor).mean() >= 0.999


def test_extractor_launches_k2_and_k3_once():
    """A VGA extraction on the card is one K2 and one K3 call."""
    dev = _card()
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0)
    img, _ = scene.render(orbit_trajectory(4)[2])
    img = torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)).to(dev)
    before = kernels.counts()
    feats = orb.OrbExtractor(480, 640)(img)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert after["fast"] == before["fast"] + 1
    assert after["orb_desc"] == before["orb_desc"] + 1
    assert feats.desc.shape == (1000, 8) and bool(feats.valid.any())


def _vga_keypoints(levels, ks):
    ys_all, xs_all = [], []
    for lvl, k, (_, raw, pos) in zip(
            levels, ks, fast.detect_and_rank_plain(levels, 20.0, 7.0, ks,
                                                   margin=19)):
        h, w = lvl.shape
        ys, xs, _, _ = orb.topk_from_ranks(raw, pos, k, h, w)
        ys_all.append(torch.clamp(ys, 19, h - 20).to(torch.int32))
        xs_all.append(torch.clamp(xs, 19, w - 20).to(torch.int32))
    return torch.cat(ys_all), torch.cat(xs_all)


def _k7_case():
    dev = _card()
    levels = [lvl.to(dev) for lvl in _vga_pyramid()]
    ks = orb.features_per_level(1000, 8, 1.2)
    ys, xs = _vga_keypoints([lvl.cpu() for lvl in levels], ks)
    return levels, ys.to(dev), xs.to(dev), ks


def test_orb_learned_kernel_equals_plain_given_angles():
    """K7 fed the plain version's angles gives its descriptors bit for bit
    (the blur's products and sums and the rotation's are rounded one by
    one in both, cosf/sinf are torch's), and returns the angles as they
    are; one launch a call."""
    levels, ys, xs, ks = _k7_case()
    ap, dp = orb.angles_and_descriptors_learned_plain(levels, ys, xs, ks)
    before = kernels.counts()["orb_desc_learned"]
    ak, dk = orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks,
                                                       angles=ap)
    torch.cuda.synchronize()
    assert kernels.counts()["orb_desc_learned"] == before + 1
    assert torch.equal(ak, ap) and torch.equal(dk, dp)


def test_orb_learned_kernel_matches_plain():
    """Whole K7 (its own angles) against the plain version: level-0 angles
    equal (integer moments are exact), the others within 3e-5 rad (the
    moments of a resized level sum in another order); every descriptor bit
    equal outside `learned_tie_gate`, widened by 18 px times a keypoint's
    angle difference; and a table with one pair swapped must fail that
    hold."""
    levels, ys, xs, ks = _k7_case()
    ap, dp = orb.angles_and_descriptors_learned_plain(levels, ys, xs, ks)
    ak, dk = orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks)
    torch.cuda.synchronize()
    assert torch.equal(ak[:ks[0]], ap[:ks[0]])
    d = torch.remainder(ak - ap + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) < 3e-5
    gate = orb.learned_tie_gate(levels, ys, xs, ks, ap,
                                half_tol=1e-4 + 18 * d.abs().double()
                                ).cpu().numpy()
    assert (~gate).mean() > 0.75

    def bits(d):
        return np.unpackbits(d.cpu().numpy().view(np.uint8), axis=1,
                             bitorder="little").astype(bool)

    assert not ((bits(dk) != bits(dp)) & ~gate).any()
    pat = orb.learned_pattern().copy()
    pat[5] = pat[5, ::-1]
    _, dx = orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks,
                                                      pattern=pat)
    assert ((bits(dx) != bits(dp)) & ~gate).sum() > 100


def _k7_edge_case(name):
    """(levels, ys, xs, counts) of the VGA pyramid: "borders", keypoints
    19, 20 and 21 px from each border and in each corner of every level
    (windows reaching 2, 1 and 0 px past the border); "empty_levels",
    frame keypoints with no keypoint on levels 2 and 7; "one", K = 1."""
    levels, ys, xs, ks = _k7_case()
    if name == "one":
        return levels, ys[:1], xs[:1], [1] + [0] * (len(ks) - 1)
    if name == "empty_levels":
        parts = list(zip(ys.split(ks), xs.split(ks)))
        counts = [0 if l in (2, 7) else k for l, k in enumerate(ks)]
        keep = [p for l, p in enumerate(parts) if counts[l]]
        return (levels, torch.cat([y for y, _ in keep]),
                torch.cat([x for _, x in keep]), counts)
    yy, xx, counts = [], [], []
    for lvl in levels:
        h, w = lvl.shape
        ey = [19, 20, 21, h - 22, h - 21, h - 20]
        ex = [19, 20, 21, w - 22, w - 21, w - 20]
        y = ey + ey + [h // 2] * 6 + ey + [19, 19, h - 20, h - 20]
        x = ex + ex[::-1] + ex + [w // 2] * 6 + [19, w - 20, 19, w - 20]
        yy += y
        xx += x
        counts.append(len(y))
    dev = levels[0].device
    return (levels, torch.tensor(yy, dtype=torch.int32, device=dev),
            torch.tensor(xx, dtype=torch.int32, device=dev), counts)


@pytest.mark.parametrize("name", ["borders", "empty_levels", "one"])
def test_orb_learned_kernel_at_borders_empty_levels_and_one(name):
    """K7 at the edges of what it takes: given the plain version's angles,
    its descriptors bit for bit and the angles returned as given; with its
    own angles, level 0's equal and the others within 3e-5 rad; one launch
    a call."""
    levels, ys, xs, counts = _k7_edge_case(name)
    ap, dp = orb.angles_and_descriptors_learned_plain(levels, ys, xs, counts)
    before = kernels.counts()["orb_desc_learned"]
    ag, dg = orb.angles_and_descriptors_learned_levels(levels, ys, xs,
                                                       counts, angles=ap)
    ak, _ = orb.angles_and_descriptors_learned_levels(levels, ys, xs, counts)
    torch.cuda.synchronize()
    assert kernels.counts()["orb_desc_learned"] == before + 2
    assert torch.equal(ag, ap) and torch.equal(dg, dp)
    assert torch.equal(ak[:counts[0]], ap[:counts[0]])
    d = torch.remainder(ak - ap + np.pi, 2 * np.pi) - np.pi
    assert float(d.abs().max()) < 3e-5


def test_orb_learned_kernel_reads_the_pyramid_buffer():
    """Levels as kernel K8 writes them take the launch table built once for
    the geometry; the same levels copied apart take a table built on the
    call; both give the same angles and descriptors."""
    dev = _card()
    levels = image_ops.build_pyramid(_vga_pyramid()[0].to(dev), 8, 1.2)
    ks = orb.features_per_level(1000, 8, 1.2)
    ys, xs = _vga_keypoints([lvl.cpu() for lvl in levels], ks)
    ys, xs = ys.to(dev), xs.to(dev)
    plan = orb.prepare_learned(480, 640, 1000, 1.2, 8, "learned", dev)
    assert orb.learned_sources(levels, plan)[2] == plan.address
    apart = [lvl.clone() for lvl in levels]
    assert orb.learned_sources(apart, plan)[2] != plan.address
    a, d = orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks)
    b, e = orb.angles_and_descriptors_learned_levels(apart, ys, xs, ks)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(d, e)


def test_extractor_builds_learned_table_when_constructed(monkeypatch):
    """An extractor with the learned pattern given the card builds K7's
    launch table of its geometry when it is constructed, so its frames
    build none (not even one of addresses) and launch K7 once each."""
    dev = _card()
    plans = orb._learned_plan.cache_info
    ext = orb.OrbExtractor(208, 304, 500, 1.2, 5, pattern="learned",
                           device=dev)
    built = plans().misses
    calls = []
    real = orb._learned_call_table
    monkeypatch.setattr(orb, "_learned_call_table",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(9)
    before = kernels.counts()["orb_desc_learned"]
    for _ in range(2):
        img = torch.from_numpy(rng.integers(0, 256, (208, 304),
                                            dtype=np.uint8))
        feats = ext(img.to(dev))
    torch.cuda.synchronize()
    assert plans().misses == built and not calls
    assert kernels.counts()["orb_desc_learned"] == before + 2
    assert feats.desc.shape == (500, 8) and bool(feats.valid.any())


def test_extractor_with_the_learned_pattern_launches_k7_not_k3():
    dev = _card()
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0)
    img, _ = scene.render(orbit_trajectory(4)[2])
    img = torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)).to(dev)
    before = kernels.counts()
    feats = orb.OrbExtractor(480, 640, pattern="learned")(img)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert after["fast"] == before["fast"] + 1
    assert after["orb_desc_learned"] == before["orb_desc_learned"] + 1
    assert after["orb_desc"] == before["orb_desc"]
    assert feats.desc.shape == (1000, 8) and bool(feats.valid.any())


def test_orb_learned_wrapper_refuses_what_the_kernel_does_not_take():
    levels, ys, xs, ks = _k7_case()
    far = orb.learned_pattern().copy()
    far[0, 0] = (19, 0)  # radius 19 leaves the 18-px window
    with pytest.raises(ValueError, match="radius"):
        orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks,
                                                  pattern=far)
    with pytest.raises(ValueError):
        orb.angles_and_descriptors_learned_levels(levels, ys.long(), xs, ks)
    with pytest.raises(ValueError):
        orb.angles_and_descriptors_learned_levels(levels, ys, xs, ks[:-1])


# K8: (image, h, w, levels) - the bench's VGA frame, random images at the
# camera sizes, odd sizes down to levels a few pixels wide (9x5: a level
# keeps its size, one tap of 1.0)
PYR_CASES = [("rendered", 480, 640, 8), ("random", 480, 640, 8),
             ("random", 376, 1241, 8), ("random", 480, 752, 8),
             ("random", 37, 23, 8), ("random", 9, 5, 6),
             ("random", 1, 97, 4)]


@pytest.mark.parametrize("kind,h,w,n_levels", PYR_CASES)
def test_pyramid_kernel_matches_plain(kind, h, w, n_levels):
    """K8 against the plain pyramid on the card: every level within 1e-4
    gray (the bit-equal share printed), and equal bit for bit where the
    split finder explained every output of the GEMM's shapes; level 0 the
    image itself, each level 16-byte aligned for K2's vector loads, one
    launch a call."""
    dev = _card()
    if kind == "rendered":
        img = _vga_pyramid()[0]
    else:
        rng = np.random.default_rng(h * w)
        img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(
            np.float32))
    img = img.to(dev)
    ref = image_ops.build_pyramid_plain(img, n_levels, 1.2)
    before = kernels.counts()["pyramid"]
    out = image_ops.build_pyramid(img, n_levels, 1.2)
    torch.cuda.synchronize()
    assert kernels.counts()["pyramid"] == before + 1
    assert out[0] is img and len(out) == n_levels
    shares = []
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert a.is_contiguous() and a.data_ptr() % 16 == 0
        assert float((a - b).abs().max()) <= 1e-4
        shares.append(int((a == b).sum()) / a.numel())
    print(f"K8 {kind} {h}x{w}: bit-equal share per level {shares}")
    if not any(image_ops.SPLIT_MISSES.values()):
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_extractor_builds_pyramid_tables_when_constructed():
    """An extractor given the card builds K8's tables of its geometry (the
    GEMM's probes) when it is constructed, so its first frame builds
    nothing and launches K8 once."""
    dev = _card()
    h, w, n_levels = 200, 296, 5  # a geometry no other test builds
    plans = image_ops._pyramid_plan.cache_info
    ext = orb.OrbExtractor(h, w, 500, 1.2, n_levels, device=dev)
    built = plans().misses
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    before = kernels.counts()["pyramid"]
    feats = ext(img.to(dev))
    torch.cuda.synchronize()
    assert plans().misses == built
    assert kernels.counts()["pyramid"] == before + 1
    assert feats.xy.shape == (500, 2) and bool(feats.valid.any())


def test_extractor_builds_spread_plan_when_constructed():
    """An extractor given the card builds K9's launch table of its
    geometry when it is constructed, so its frames build none and launch
    K9 once each."""
    dev = _card()
    plans = orb._spread_plan.cache_info
    ext = orb.OrbExtractor(208, 304, 500, 1.2, 5, device=dev)
    built = plans().misses
    rng = np.random.default_rng(8)
    before = kernels.counts()["spread_topk"]
    for _ in range(2):
        img = torch.from_numpy(rng.integers(0, 256, (208, 304),
                                            dtype=np.uint8))
        feats = ext(img.to(dev))
    torch.cuda.synchronize()
    assert plans().misses == built
    assert kernels.counts()["spread_topk"] == before + 2
    assert feats.xy.shape == (500, 2) and bool(feats.valid.any())


def test_pyramid_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    img = torch.zeros((48, 64), device=dev)
    with pytest.raises(ValueError):
        image_ops.pyramid_levels(img.double(), 4, 1.2)
    with pytest.raises(ValueError):
        image_ops.pyramid_levels(img[None], 4, 1.2)
    with pytest.raises(ValueError):
        image_ops.pyramid_levels(img, kernels.MAX_LEVELS + 1, 1.2)
    with pytest.raises(ValueError, match="taps"):
        image_ops.pyramid_levels(img, 2, 5.0)


def _ranked(score, k, rank_rounds=4):
    """K2's rank rounds of one level (plain, int32 pos), or none (k = 0)."""
    if k == 0:
        C = fast.n_cells(*score.shape, 32)
        return (torch.empty((0, C)), torch.empty((0, C), dtype=torch.int32))
    raw, pos = fast.cell_rank_rounds(torch.from_numpy(score), k, 32,
                                     rank_rounds)
    return raw, pos.to(torch.int32)


def _topk_case(name):
    """(ranked, budgets, level ids, shapes): the rendered VGA frame's
    levels as extraction ranks them; all-tie keys; empty levels (no
    corner, and a budget of 0); k larger than the corners; 16 levels in one
    launch; k = 1 on tie-heavy levels; k equal to a level's candidates (a
    whole round of ties); a level of exactly SPREAD_MAX_KEYS candidates
    with k past SPREAD_RANK_MAX (the sorted branch); k at SPREAD_RANK_MAX
    and one past it."""
    rng = np.random.default_rng(len(name))

    def ties(h, w, p=0.2):
        return (rng.integers(1, 4, (h, w)) * (rng.uniform(size=(h, w)) < p)
                ).astype(np.float32)

    if name == "rendered":
        levels = _vga_pyramid()
        ks = orb.features_per_level(1000, 8, 1.2)
        ranked = fast.detect_and_rank_plain(levels, 20.0, 7.0, ks, margin=19)
        scores, ids = [s.numpy() for s, _, _ in ranked], list(range(8))
    elif name == "all_ties":
        scores, ks, ids = [np.full((134, 179), 3.0, np.float32),
                           np.full((240, 320), 1.0, np.float32)], [60, 217], \
            [0, 1]
    elif name == "empty_levels":
        scores, ks, ids = [np.zeros((96, 128), np.float32),
                           rng.uniform(1, 9, (64, 96)).astype(np.float32),
                           np.zeros((40, 60), np.float32)], [40, 0, 25], \
            [0, 1, 2]
    elif name == "k_above_corners":
        s = np.zeros((134, 179), np.float32)
        s[rng.integers(0, 134, 7), rng.integers(0, 179, 7)] = 11.0
        scores, ks, ids = [s], [60], [5]
    elif name == "sixteen_levels":  # a scale-1.1 pyramid's sizes
        shapes = [(int(round(300 / 1.1 ** l)), int(round(400 / 1.1 ** l)))
                  for l in range(16)]
        scores = [(rng.integers(0, 5, sh) * (rng.uniform(size=sh) < 0.1))
                  .astype(np.float32) for sh in shapes]
        ks, ids = [30 + 3 * l for l in range(16)], list(range(16))
    elif name == "k_one":
        scores, ks, ids = [ties(134, 179), np.full((64, 96), 2.0, np.float32)
                           ], [1, 1], [2, 3]
    elif name == "k_all":  # rank rounds as they are, k = rounds x C
        C = fast.n_cells(64, 96, 32)
        raw = (rng.integers(0, 3, (4, C)) * 5.0).astype(np.float32)
        raw[1] = 5.0
        pos = rng.integers(0, 1024, (4, C)).astype(np.int32)
        return ([(torch.from_numpy(raw), torch.from_numpy(pos))], [4 * C],
                [4], [(64, 96)])
    elif name == "max_keys":  # 32 rounds x 256 cells
        scores, ks, ids = [ties(512, 512, 0.3)], [1400], [0]
    elif name == "large_9120":  # 1920x1200's level 0 (the large kernel)
        # beside a level of the register kernel, tie-heavy
        scores, ks, ids = [ties(1200, 1920, 0.05), ties(1000, 1600, 0.05)], \
            [217, 181], [0, 1]
    elif name == "large_32640":  # 3840x2160's level 0, and all-tie keys
        scores = [ties(2160, 3840, 0.02), np.full((1800, 3200), 2.0,
                                                  np.float32)]
        ks, ids = [217, 181], [0, 1]
    elif name == "large_sorted":  # 1920x1200 at 6,000 features: level 0's
        # budget past SPREAD_RANK_MAX (the large kernel's sorted branch)
        scores, ks, ids = [ties(1200, 1920, 0.3)], [1303], [0]
    else:  # "rank_max": k at the counting branch's limit and one past it
        scores = [ties(480, 640, 0.3), ties(480, 640, 0.3)]
        ks, ids = [orb.SPREAD_RANK_MAX, orb.SPREAD_RANK_MAX + 1], [0, 1]
    return ([_ranked(s, k) for s, k in zip(scores, ks)], ks, ids,
            [s.shape for s in scores])


@pytest.mark.parametrize("name", ["rendered", "all_ties", "empty_levels",
                                  "k_above_corners", "sixteen_levels",
                                  "k_one", "k_all", "max_keys", "rank_max",
                                  "large_9120", "large_32640",
                                  "large_sorted"])
def test_spread_topk_kernel_equals_plain(name):
    """K9 against `spread_topk_levels_plain`, every output bit for bit, in
    one launch a call, or two where a level has more than SPREAD_MAX_KEYS
    candidates (the rank rounds packed into two buffers first: they do not
    lie in K2's)."""
    dev = _card()
    ranked, ks, ids, shapes = _topk_case(name)
    n_keys = [r.numel() for r, _ in ranked]
    if name == "max_keys":
        assert n_keys == [orb.SPREAD_MAX_KEYS]
    large = name.startswith("large")
    if large:
        assert n_keys[0] == {"large_9120": 9120, "large_32640": 32640,
                             "large_sorted": 9120}[name]
    want = {"spread_topk": int(any(0 < k and n <= orb.SPREAD_MAX_KEYS
                                   for k, n in zip(ks, n_keys))),
            "spread_topk_large": int(large)}
    scales = [1.2 ** l for l in ids]
    ref = orb.spread_topk_levels_plain(ranked, ks, shapes, ids, scales)
    before = kernels.counts()
    out = orb.spread_topk_levels([(r.to(dev), p.to(dev)) for r, p in ranked],
                                 ks, shapes, ids, scales)
    torch.cuda.synchronize()
    assert {k: kernels.counts()[k] - before[k] for k in want} == want
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b)
    if name == "k_above_corners":
        assert int(out.valid.sum()) == 7


def test_spread_topk_kernel_reads_k2_buffers():
    """On the rank rounds of one K2 call (each level a view of K2's two
    buffers, which K9 reads as they are) K9 equals its plain version bit
    for bit."""
    dev = _card()
    levels = [lvl.to(dev) for lvl in _vga_pyramid()]
    ks = orb.features_per_level(1000, 8, 1.2)
    ranked = [(r, p) for _, r, p in fast.detect_and_rank(levels, 20.0, 7.0,
                                                          ks, margin=19)]
    assert all(r._base is ranked[0][0]._base for r, _ in ranked)
    args = (ranked, ks, [tuple(x.shape) for x in levels], list(range(8)),
            [1.2 ** l for l in range(8)])
    out = orb.spread_topk_levels(*args)
    ref = orb.spread_topk_levels_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_spread_topk_refuses_past_its_key_limit():
    """Past its limits (a budget of SPREAD_MAX_BUDGET on a level; 8,192
    candidates no longer is one) K9 raises and names the limit; it never
    falls back to the plain version."""
    dev = _card()
    raw = torch.ones((55, 300), device=dev)
    pos = torch.zeros((55, 300), dtype=torch.int32, device=dev)
    before = kernels.counts()
    with pytest.raises(ValueError, match=str(orb.SPREAD_MAX_BUDGET)):
        orb.spread_topk_levels([(raw, pos)], [orb.SPREAD_MAX_BUDGET + 1],
                               [(480, 640)], [0], [1.0])
    with pytest.raises(ValueError):
        orb.spread_topk_levels([(raw, pos.long())], [100], [(480, 640)], [0],
                               [1.0])
    assert kernels.counts() == before


@pytest.mark.parametrize("h,w", [(1200, 1920), (1088, 2048), (2160, 3840)])
def test_pyramid_kernel_at_large_geometries(h, w):
    """K8 at cameras past VGA (3840x2160's grid is past 4 x 132 blocks):
    bit-equal to the plain version where the card's GEMM splits of the
    geometry's products are all explained (`SPLIT_MISSES` 0), else within
    1e-4 gray, the tolerance `chip_smoke.py` holds it to."""
    dev = _card()
    image_ops.prepare_pyramid(h, w, 8, 1.2, dev)
    shapes = image_ops.pyramid_shapes(h, w, 8, 1.2)
    keys = {(a, b, o, v, str(dev)) for (ih, iw), (oh, ow) in
            zip(shapes[:-1], shapes[1:])
            for a, b, o, v in ((ih, oh, iw, True), (iw, ow, oh, False))
            if a != b}
    misses = sum(image_ops.SPLIT_MISSES.get(k, 0) for k in keys)
    rng = np.random.default_rng(h)
    img = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)
                           .astype(np.float32)).to(dev)
    before = kernels.counts()["pyramid"]
    out = image_ops.build_pyramid(img, 8, 1.2)
    ref = image_ops.build_pyramid_plain(img, 8, 1.2)
    torch.cuda.synchronize()
    assert kernels.counts()["pyramid"] == before + 1
    for a, b in zip(out, ref):
        if misses == 0:
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.parametrize("h,w", [(1200, 1920), (1088, 2048), (2160, 3840)])
def test_tracker_constructs_at_large_geometries(h, w):
    """A tracker on the card at 1000 features and 8 levels builds K8's and
    K9's tables of these cameras (it refused them before K9's large kernel
    and K8's search past 4 x 132 blocks), and tracks a frame."""
    from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu_torch.slam.tracking import (
        Tracker, TrackerConfig)

    dev = _card()
    fx = 520.0 * w / 640
    cfg = TrackerConfig(width=w, height=h, fx=fx, fy=fx, cx=w / 2, cy=h / 2,
                        bf=0.08 * fx, n_features=1000, n_levels=8,
                        map_capacity=MapCapacity(16, 4096, 1000),
                        enable_local_ba=False, enable_loop_closing=False,
                        pipelined=False)
    tracker = Tracker(cfg, device=dev)
    plan = orb.prepare_spread_topk(h, w, 1000, 1.2, 8)
    assert plan.launches == ("spread_topk", "spread_topk_large")
    scene = SyntheticScene(width=w, height=h, fx=fx, fy=fx)
    img, depth = scene.render(orbit_trajectory(4)[0])
    before = kernels.counts()
    tracker.track_rgbd(np.clip(img, 0, 255).astype(np.uint8), depth)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert after["spread_topk_large"] == before["spread_topk_large"] + 1
    assert after["pyramid"] == before["pyramid"] + 1


def test_extractor_is_four_launches():
    """A VGA extraction on the card is one launch each of K8, K2, K9 and
    K3, and gives the plain extraction's features (the same pyramid bits
    where K8 equals the plain product, checked above)."""
    dev = _card()
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0)
    img, _ = scene.render(orbit_trajectory(4)[2])
    img = torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)).to(dev)
    before = kernels.counts()
    feats, levels = orb.OrbExtractor(480, 640)._extract_impl_pyr(img)
    torch.cuda.synchronize()
    after = kernels.counts()
    for k in ("pyramid", "fast", "spread_topk", "orb_desc"):
        assert after[k] == before[k] + 1, k
    assert feats.xy.shape == (1000, 2) and bool(feats.valid.any())
    assert len(levels) == 8


CAM = proj.CameraIntrinsics.create(520.0, 520.0, 320.0, 240.0, 41.6)


def _project(pose, pts):
    xc = se3.transform(pose, pts)
    u = CAM.fx * xc[..., 0] / xc[..., 2] + CAM.cx
    v = CAM.fy * xc[..., 1] / xc[..., 2] + CAM.cy
    return torch.stack([u, v, u - CAM.bf / xc[..., 2]], -1)


def _pose_problem(seed, n=1000):
    """A tracked frame's pose LM: 1000 matches, 70 % with a right
    coordinate, 15 % outliers, a start 2 cm / 1 degree off."""
    g = np.random.default_rng(seed)
    pts = torch.from_numpy(np.stack([g.uniform(-2, 2, n), g.uniform(-1.5, 1.5, n),
                                     g.uniform(1, 6, n)], -1).astype(np.float32))
    gt = se3.exp(torch.from_numpy(g.normal(0, 0.05, 6).astype(np.float32)))
    uvr = _project(gt, pts) + torch.from_numpy(
        g.normal(0, 0.7, (n, 3)).astype(np.float32))
    bad = torch.from_numpy(g.uniform(size=n) < 0.15)
    uvr[bad, :2] += torch.from_numpy(
        g.uniform(-40, 40, (int(bad.sum()), 2)).astype(np.float32))
    ur = torch.where(torch.from_numpy(g.uniform(size=n) < 0.7), uvr[:, 2],
                     torch.full((n,), -1.0))
    inv_s2 = torch.from_numpy((1.0 / 1.44 ** g.integers(0, 8, n))
                              .astype(np.float32))
    valid = torch.from_numpy(g.uniform(size=n) > 0.05)
    pose0 = se3.compose(se3.exp(torch.from_numpy(
        np.array([0.01, -0.01, 0.005, 0.02, -0.01, 0.01], np.float32))), gt)
    return [pose0, pts, uvr[:, :2].contiguous(), ur, inv_s2, valid]


@pytest.mark.parametrize("seed,rounds", [(0, 4), (1, 2)])
def test_pose_lm_kernel_matches_plain(seed, rounds):
    """K4: pose within 1e-5 m / 1e-5 rad; inliers >= 99.9 % equal, a flip
    only where chi2 is within 1e-4 relative of its threshold."""
    dev = _card()
    args = [a.to(dev) for a in _pose_problem(seed)]
    before = kernels.counts()["pose_lm"]
    out = pose_opt.pose_optimize(*args, CAM, rounds=rounds, iters_per_round=5)
    ref = pose_opt.pose_optimize_plain(*args, CAM, rounds=rounds,
                                       iters_per_round=5)
    torch.cuda.synchronize()
    assert kernels.counts()["pose_lm"] == before + 1
    work = pose_opt.pose_lm_work(*args, CAM, rounds=rounds,
                                 iters_per_round=5).cpu()
    assert work.shape == (rounds, 2)
    assert bool(((work[:, 0] >= 1) & (work[:, 0] <= 5)).all()), work
    assert int(work[0, 1]) == int(args[-1].sum()), work
    d = se3.log(se3.compose(out.pose, se3.inverse(ref.pose))).cpu()
    assert d[:3].abs().max() <= 1e-5 and d[3:].abs().max() <= 1e-5, d
    flips = (out.inliers != ref.inliers).cpu().numpy()
    assert flips.mean() <= 1e-3
    if flips.any():
        pose, pts, uv, ur, inv_s2, valid = args
        pred = _project(ref.pose, pts)
        r = torch.cat([uv, ur[:, None]], -1) - pred
        r[:, 2] = torch.where(ur > 0, r[:, 2], torch.zeros_like(ur))
        chi2 = ((r * r).sum(-1) * inv_s2).cpu().numpy()
        th = np.where(ur.cpu().numpy() > 0, 7.815, 5.991)
        assert np.all(np.abs(chi2[flips] - th[flips]) <= 1e-4 * th[flips])
    assert int(out.num_inliers) == int(out.inliers.sum())
    assert abs(float(out.final_cost) - float(ref.final_cost)) <= 1e-4 * float(
        ref.final_cost)


@pytest.mark.parametrize("n", [300, 1500, 3000])
def test_pose_lm_kernel_at_any_observation_count(n):
    """K4 keeps up to 4 observations a thread in registers (n <= 2048) and
    reads them from memory in every pass beyond: pose within 1e-5 m / 1e-5
    rad of the plain version, inlier count and cost agreeing."""
    dev = _card()
    args = [a.to(dev) for a in _pose_problem(7, n)]
    out = pose_opt.pose_optimize(*args, CAM, rounds=4, iters_per_round=5)
    ref = pose_opt.pose_optimize_plain(*args, CAM, rounds=4,
                                       iters_per_round=5)
    torch.cuda.synchronize()
    d = se3.log(se3.compose(out.pose, se3.inverse(ref.pose))).cpu()
    assert d[:3].abs().max() <= 1e-5 and d[3:].abs().max() <= 1e-5, d
    assert abs(int(out.num_inliers) - int(ref.num_inliers)) <= max(1, n // 1000)
    assert int(out.num_inliers) == int(out.inliers.sum())
    assert abs(float(out.final_cost) - float(ref.final_cost)) <= 1e-4 * float(
        ref.final_cost)


def _ba_problem(seed=0, K=32, P=1500, N=1000, Q=2048, turn=0.01):
    """A window BA at the main path's shapes: 32 keyframes (6 fixed, 2
    padding rows), 1000 feature slots each, points in a 2048 bucket; each
    keyframe turns `turn` rad and moves 5 `turn` m from the last."""
    g = np.random.default_rng(seed)
    pts = torch.from_numpy(np.stack([g.uniform(-2, 2, Q), g.uniform(-1.5, 1.5, Q),
                                     g.uniform(3, 8, Q)], -1).astype(np.float32))
    poses = se3.exp(torch.from_numpy(np.stack(
        [[0, turn * k, 0, 5 * turn * k, 0, 0] for k in range(K)]).astype(
            np.float32)))
    obs_pt = np.full((K, N), -1, np.int32)
    for k in range(K - 2):
        sel = g.permutation(P)[:N]
        seen = g.uniform(size=N) < 0.8
        obs_pt[k, seen] = sel[seen]
    obs_pt[3, :10] = obs_pt[3, 10:20]  # two features on one landmark
    pt = torch.from_numpy(np.clip(obs_pt, 0, Q - 1)).long()
    uvr = _project(poses[:, None], pts[pt]) + torch.from_numpy(
        g.normal(0, 0.5, (K, N, 3)).astype(np.float32))
    bad = torch.from_numpy(g.uniform(size=(K, N)) < 0.05)
    uvr[..., :2][bad] += 30.0
    ur = torch.where(torch.from_numpy(g.uniform(size=(K, N)) < 0.6),
                     uvr[..., 2], torch.full((K, N), -1.0))
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[-6:] = True
    valid = torch.zeros(Q, dtype=torch.bool)
    valid[:P] = True
    frozen = torch.from_numpy(g.uniform(size=Q) < 0.05) | ~valid
    pose0 = se3.retract(poses, torch.from_numpy(
        g.normal(0, 0.005, (K, 6)).astype(np.float32)))
    return ba.BAProblem(
        kf_pose=pose0, kf_fixed=fixed, obs_uv=uvr[..., :2].contiguous(),
        obs_ur=ur.contiguous(), obs_pt=torch.from_numpy(obs_pt),
        obs_inv_s2=torch.from_numpy((1.0 / 1.44 ** g.integers(0, 8, (K, N)))
                                    .astype(np.float32)),
        pt_pos=pts + torch.from_numpy(g.normal(0, 0.02, (Q, 3))
                                      .astype(np.float32)),
        pt_valid=valid, pt_frozen=frozen)


def test_ba_assembly_kernel_matches_plain():
    """K5: every entry of Hpp, g_p, Hll|g_l, T, the cost and chi2 within
    1e-4 x the largest magnitude of its array (f32 atomics sum in no fixed
    order, and the kernel contracts products into FMAs). g_p, the one sum
    that cancels, may instead lie no further from the same assembly
    computed in f64 than twice the plain version."""
    dev = _card()
    p = ba.BAProblem(*(t.to(dev) for t in _ba_problem()))
    p64 = ba.BAProblem(*(t.double() if t.is_floating_point() else t
                         for t in p))
    obs_ok = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(min=0).long()]

    def close(k, r):
        return bool((k - r).abs().max() <= 1e-4 * r.abs().max())

    for use_huber in (True, False):
        args = (p.kf_pose, p.pt_pos, p, obs_ok, CAM, use_huber)
        out = ba.ba_assemble(*args)
        ref = ba.ba_assemble_plain(*args)
        for name, a, b in zip(("Hpp", "g_p", "Hll|g_l", "T"), out, ref):
            assert a.shape == b.shape, name
            assert name == "g_p" or close(a, b), name
        if not close(out[1], ref[1]):
            exact = ba.ba_assemble_plain(p64.kf_pose, p64.pt_pos, p64,
                                         obs_ok, CAM, use_huber)[1]
            e_k = (out[1].double() - exact).abs().max()
            e_p = (ref[1].double() - exact).abs().max()
            assert e_k <= max(1e-4 * exact.abs().max(), 2 * e_p), "g_p"
        for a, b in zip(ba.ba_cost(*args), ba.ba_cost_plain(*args)):
            assert close(a.reshape(-1), b.reshape(-1))


def test_window_ba_with_kernel_matches_plain_assembly(monkeypatch):
    """The whole dense-Schur solve with K5 against the same solve with the
    plain assembly, both on the card: poses within 1e-4 m / 1e-4 rad."""
    dev = _card()
    p = ba.BAProblem(*(t.to(dev) for t in _ba_problem(1)))
    before = kernels.counts()["ba_assemble"]
    out = ba.ba_solve(p, CAM, iters=3, dense_schur=True)
    assert kernels.counts()["ba_assemble"] == before + 3
    monkeypatch.setattr(ba, "ba_assemble", ba.ba_assemble_plain)
    monkeypatch.setattr(ba, "ba_cost", ba.ba_cost_plain)
    ref = ba.ba_solve(p, CAM, iters=3, dense_schur=True)
    d = se3.log(se3.compose(out.kf_pose, se3.inverse(ref.kf_pose))).cpu()
    assert d[:, :3].abs().max() <= 1e-4 and d[:, 3:].abs().max() <= 1e-4
    assert float(out.final_cost) < float(out.initial_cost)
    assert (out.obs_inlier == ref.obs_inlier).float().mean() >= 0.999


def _k5_case(name):
    """The K5 card cases: both point buckets, a point with 72 live
    observations (three in each of 24 keyframes), every slot dead,
    windows of 20 and 13 keyframes (an odd W writes T without float4) and
    of 40 (more keyframes than a warp has lanes)."""
    if name == "q8192":
        return _ba_problem(2, P=6000, Q=8192)
    if name == "w20":
        return _ba_problem(3, K=20)
    if name == "w13":
        return _ba_problem(4, K=13, N=700)
    if name == "w40":
        return _ba_problem(6, K=40)
    p = _ba_problem(5)
    if name == "many_obs":
        obs_pt = p.obs_pt.clone()
        obs_pt[:24, 100:103] = 0
        return p._replace(obs_pt=obs_pt)
    if name == "all_dead":
        return p._replace(pt_valid=torch.zeros_like(p.pt_valid))
    return p


@pytest.mark.parametrize("Q", [27904, 27905, 32768])
def test_k5_point_index_past_shared_rows(Q):
    """Past 27,904 points a row's counts live in the index's `table`
    scratch, not in shared memory (a global BA over the whole map): the
    index still equals its plain version, and two builds the same bits.
    Slots repeat their point inside a keyframe, as the map's do."""
    dev = _card()
    gen = torch.Generator().manual_seed(Q)
    K, N = 128, 1000
    obs_pt = torch.randint(0, Q, (K, N), generator=gen, dtype=torch.int32)
    obs_pt[:, ::7] = obs_pt[:, 1::7][:, : obs_pt[:, ::7].shape[1]]
    obs_ok = torch.rand((K, N), generator=gen) < 0.8
    idx = ba.ba_point_index(obs_pt.to(dev), obs_ok.to(dev), Q)
    ref = ba.ba_point_index_plain(obs_pt, obs_ok, Q)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(idx, ref))
    again = ba.ba_point_index(obs_pt.to(dev), obs_ok.to(dev), Q)
    assert all(torch.equal(a, b) for a, b in zip(idx, again))


@pytest.mark.parametrize("name", ["q2048", "q8192", "many_obs", "all_dead",
                                  "w20", "w13", "w40"])
def test_k5_point_major_assembly(name):
    """K5's point index equals its plain version; `ba_assemble` and
    `ba_cost` agree with their plain versions as
    `test_ba_assembly_kernel_matches_plain` holds them; two calls on the
    same arguments, and an index built by the wrapper or passed in, give
    the same bits; each call is one launch."""
    dev = _card()
    p = ba.BAProblem(*(t.to(dev) for t in _k5_case(name)))
    Q = p.pt_pos.shape[0]
    obs_ok = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(0, Q - 1).long()]
    idx = ba.ba_point_index(p.obs_pt, obs_ok, Q)
    ref_idx = ba.ba_point_index_plain(p.obs_pt.cpu(), obs_ok.cpu(), Q)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(idx, ref_idx))
    if name == "many_obs":
        assert int(idx.offsets[1] - idx.offsets[0]) >= 72

    def close(k, r):
        return bool((k - r).abs().max() <= 1e-4 * r.abs().max())

    args = (p.kf_pose, p.pt_pos, p, obs_ok, CAM, True)
    ref = ba.ba_assemble_plain(*args)
    p64 = ba.BAProblem(*(t.double() if t.is_floating_point() else t
                         for t in p))
    exact = ba.ba_assemble_plain(p64.kf_pose, p64.pt_pos, p64, obs_ok, CAM,
                                 True)
    before = kernels.counts()
    out = ba.ba_assemble(*args, index=idx)
    again = ba.ba_assemble(*args, index=idx)
    built = ba.ba_assemble(*args)
    after = kernels.counts()
    assert after["ba_assemble"] == before["ba_assemble"] + 3
    assert after["ba_point_index"] == before["ba_point_index"] + 2
    for n, a, b, c, r, e in zip(("Hpp", "g_p", "Hll|g_l", "T"), out,
                                again, built, ref, exact):
        assert torch.equal(a, b) and torch.equal(a, c), n
        assert a.shape == r.shape, n
        if n == "g_p" and not close(a, r):
            e_k = (a.double() - e).abs().max()
            e_p = (r.double() - e).abs().max()
            assert e_k <= max(1e-4 * e.abs().max(), 2 * e_p), n
        else:
            assert close(a, r), n
    cost, chi2 = ba.ba_cost(*args)
    cost2, chi2_2 = ba.ba_cost(*args)
    cost3, none = ba.ba_cost(*args, want_chi2=False)
    assert none is None
    assert torch.equal(cost, cost2) and torch.equal(cost, cost3)
    assert torch.equal(chi2, chi2_2)
    rc, rchi2 = ba.ba_cost_plain(*args)
    assert close(cost.reshape(1), rc.reshape(1)) and close(chi2, rchi2)


def _cg_case(name):
    """The fused CG's card cases: the K5 cases below, and "small": 12
    keyframes (6 fixed, 2 without observations), 5 % of the points frozen,
    point 0 with at least 40 live slots (four in each of the 10 observing
    keyframes, more than a warp has lanes), Q = 1003 points (not a multiple
    of the 8 warps a block)."""
    if name != "small":
        # the whole map: slower turns, so that every point stays in front
        return _ba_problem(7, K=128, P=20000, Q=20000, turn=0.002) \
            if name == "global" else _k5_case(name)
    p = _ba_problem(11, K=12, P=900, N=300, Q=1003)
    obs_pt = p.obs_pt.clone()
    obs_pt[:10, 40:44] = 0
    return p._replace(obs_pt=obs_pt)


def _cg_args(p, out):
    """`ba_schur_cg`'s arguments from one LM iteration's assembly, as
    `_ba_solve_f32` forms them (lambda 1e-3, frozen points out of the
    elimination)."""
    Hpp, g_p, acc, W = out
    Q = acc.shape[0]
    eye3 = torch.eye(3, device=Hpp.device)
    eye6 = torch.eye(6, device=Hpp.device)
    Hll = acc[:, :9].reshape(Q, 3, 3)
    Hpp_d = Hpp + (1e-3 * torch.diagonal(Hpp, dim1=1, dim2=2)
                   + 1e-6)[:, :, None] * eye6
    Hll_d = Hll + (1e-3 * torch.diagonal(Hll, dim1=1, dim2=2)
                   + 1e-6)[:, :, None] * eye3
    G = ba._inv3x3(Hll_d + 1e-9 * eye3)
    G = torch.where(p.pt_frozen[:, None, None], torch.zeros_like(G), G)
    obs_ok = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(0, Q - 1).long()]
    return dict(Hpp_d=Hpp_d, g_p=g_p, g_l=acc[:, 9:], G=G, W_obs=W,
                obs_pt=p.obs_pt, obs_ok=obs_ok, free=~p.kf_fixed,
                cg_iters=40)


def _cg_agrees(args):
    """The fused CG against `cg_solve_plain` on the same arguments (W_obs
    in the slot layout): two calls bit-equal, one launch a call; the
    yardstick is the plain solve in f64: the kernel's largest difference
    from it, in dp and in U^T dp, at most twice the f32 plain version's
    plus 1e-4 of the f64 result's largest magnitude (40 f32 CG iterations
    amplify rounding the same way in both). The plain solves run in
    torch's deterministic mode, so that their scatter sums in one order."""
    before = kernels.counts()["ba_schur_cg"]
    out = ba.ba_schur_cg(**args)
    again = ba.ba_schur_cg(**args)
    assert kernels.counts()["ba_schur_cg"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    plain_args = {**args, "W_obs": ba.w_obs_slot_rows(args["W_obs"])}
    torch.use_deterministic_algorithms(True)
    try:
        ref = ba.cg_solve_plain(**plain_args)
        exact = ba.cg_solve_plain(**{
            n: v.double() if isinstance(v, torch.Tensor)
            and v.is_floating_point() else v for n, v in plain_args.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    for name, k, r, e in zip(("dp", "U^T dp"), out, ref, exact):
        assert k.shape == e.shape, name
        e_k = float((k.double() - e).abs().max())
        e_p = float((r.double() - e).abs().max())
        assert e_k <= 2 * e_p + 1e-4 * float(e.abs().max()), (name, e_k, e_p)
    assert not out[0][~args["free"]].any()
    return out


@pytest.mark.parametrize("name", ["q2048", "w40", "global", "small"])
def test_k5_w_obs_and_k6_match_plain(name):
    """K5's `w_obs` mode: Hpp, g_p and Hll|g_l bit-equal to the dense
    mode's launch; its live rows (in the point index's order) within 1e-4 x
    the largest entry of the plain version's rows gathered through the
    index; `place` equal to the plain index's; two calls bit-equal. K6: the
    fused CG solve against `cg_solve_plain` (`_cg_agrees`). "global" is a
    whole-map shape: 128 keyframes x 1000 slots over 20000 points."""
    dev = _card()
    p = ba.BAProblem(*(t.to(dev) for t in _cg_case(name)))
    Q = p.pt_pos.shape[0]
    obs_ok = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(0, Q - 1).long()]
    idx = ba.ba_point_index(p.obs_pt, obs_ok, Q)
    ref_idx = ba.ba_point_index_plain(p.obs_pt.cpu(), obs_ok.cpu(), Q)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(idx, ref_idx))
    L = int(idx.offsets[-1])
    if name == "small":
        assert int(idx.offsets[1] - idx.offsets[0]) > 32 and Q % 8
    args = (p.kf_pose, p.pt_pos, p, obs_ok, CAM, True)
    before = kernels.counts()
    out = ba.ba_assemble(*args, index=idx, w_obs=True)
    again = ba.ba_assemble(*args, index=idx, w_obs=True)
    assert kernels.counts()["ba_assemble_w_obs"] == \
        before["ba_assemble_w_obs"] + 2
    dense = ba.ba_assemble(*args, index=idx) if Q * p.obs_pt.shape[0] \
        <= 2 ** 22 else None
    ref = ba.ba_assemble_plain(*args, w_obs=True)
    assert isinstance(out[3], ba.LiveRows) and out[3].index is idx
    assert all(torch.equal(a, b) for a, b in zip(out[:3], again[:3]))
    assert torch.equal(out[3].rows[:L], again[3].rows[:L])
    if dense is not None:
        assert all(torch.equal(a, b) for a, b in zip(out[:3], dense[:3]))
    W_live = out[3].rows
    assert W_live.shape == ref[3].shape
    ref_rows = ref[3][idx.slots[:L].long()]
    assert (W_live[:L] - ref_rows).abs().max() <= 1e-4 * ref_rows.abs().max()
    _cg_agrees(_cg_args(p, out))


def test_cg_ba_with_kernels_matches_plain(monkeypatch):
    """The CG solve with K5 (`w_obs`) and K6 against the same solve with
    the plain assembly and CG, both on the card (torch's deterministic
    mode for the plain scatter): poses within 1e-3 m / 1e-3 rad, final
    costs within 1e-3 relative; one K6 and one K5 `w_obs` launch an LM
    iteration."""
    dev = _card()
    p = ba.BAProblem(*(t.to(dev) for t in _ba_problem(8)))
    p = p._replace(pt_frozen=None)
    before = kernels.counts()
    out = ba.ba_solve(p, CAM, iters=3, cg_iters=20, dense_schur=False)
    after = kernels.counts()
    assert after["ba_schur_cg"] == before["ba_schur_cg"] + 3
    assert after["ba_assemble_w_obs"] == before["ba_assemble_w_obs"] + 3
    monkeypatch.setattr(ba, "ba_assemble", ba.ba_assemble_plain)
    monkeypatch.setattr(ba, "ba_cost", ba.ba_cost_plain)
    monkeypatch.setattr(ba, "ba_schur_cg", ba.cg_solve_plain)
    torch.use_deterministic_algorithms(True)
    try:
        ref = ba.ba_solve(p, CAM, iters=3, cg_iters=20, dense_schur=False)
    finally:
        torch.use_deterministic_algorithms(False)
    d = se3.log(se3.compose(out.kf_pose, se3.inverse(ref.kf_pose))).cpu()
    assert d[:, :3].abs().max() <= 1e-3 and d[:, 3:].abs().max() <= 1e-3
    assert abs(float(out.final_cost) - float(ref.final_cost)) <= 1e-3 * \
        float(ref.final_cost)
    assert float(out.final_cost) < float(out.initial_cost)


def test_schur_cg_wrapper_refuses_what_the_kernel_does_not_take():
    """The fused CG's wrapper raises on shapes and types the kernel does
    not take (K over its limit, W_obs of the wrong width or in the plain
    version's slot layout, an index without `place`), and never falls back
    to the plain solve."""
    dev = _card()
    p = ba.BAProblem(*(t.to(dev) for t in _cg_case("small")))
    Q = p.pt_pos.shape[0]
    obs_ok = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(0, Q - 1).long()]
    idx = ba.ba_point_index(p.obs_pt, obs_ok, Q)
    out = ba.ba_assemble(p.kf_pose, p.pt_pos, p, obs_ok, CAM, True,
                         index=idx, w_obs=True)
    args = _cg_args(p, out)
    live = args["W_obs"]
    with pytest.raises(ValueError):
        ba.ba_schur_cg(**{**args, "W_obs": live._replace(
            rows=live.rows[:, :9])})
    with pytest.raises(TypeError):
        ba.ba_schur_cg(**{**args, "W_obs": ba.w_obs_slot_rows(live)})
    with pytest.raises(ValueError):
        ba.ba_schur_cg(**{**args, "G": args["G"].double()})
    with pytest.raises(ValueError):
        ba.ba_schur_cg(**{**args, "W_obs": live._replace(
            index=idx._replace(place=idx.place[:-1]))})
    K = 2 * kernels.bind("ba_schur", "ba_schur_cg_max_k", [])()
    big = {**args, "Hpp_d": args["Hpp_d"][:1].expand(K, 6, 6),
           "obs_pt": args["obs_pt"][:1].expand(K, -1)}
    with pytest.raises(ValueError, match="K <="):
        ba.ba_schur_cg(**big)



@pytest.mark.parametrize("name", ["w40", "global", "small"])
def test_split_cg_kernels_match_plain(name):
    """K6 split at its reductions (`ba_cg_ut`, `ba_cg_ap`, `ba_cg_update`,
    the CG of a sharded solve), with no group: three launches a CG
    iteration, two more for the setup and one for U^T dp; two calls
    bit-equal; dp and U^T dp within the f64 yardstick of `_cg_agrees`. The
    wrappers take K5's `LiveRows` only, and raise on the slot layout."""
    dev = _card()
    p = ba.BAProblem(*(t.to(dev) for t in _cg_case(name)))
    Q = p.pt_pos.shape[0]
    obs_ok = (p.obs_pt >= 0) & p.pt_valid[p.obs_pt.clamp(0, Q - 1).long()]
    out = ba.ba_assemble(p.kf_pose, p.pt_pos, p, obs_ok, CAM, True,
                         w_obs=True)
    args = _cg_args(p, out)
    args["g_l"] = args["g_l"].contiguous()
    names = ("ba_cg_ut", "ba_cg_ap", "ba_cg_update")
    before = kernels.counts()
    got = ba.sharded_cg_solve(**args)
    after = kernels.counts()
    it = args["cg_iters"]
    assert [after[n] - before[n] for n in names] == [it + 1, it + 1, it + 1]
    again = ba.sharded_cg_solve(**args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain_args = {**args, "W_obs": ba.w_obs_slot_rows(args["W_obs"])}
    torch.use_deterministic_algorithms(True)
    try:
        ref = ba.cg_solve_plain(**plain_args)
        exact = ba.cg_solve_plain(**{
            n: v.double() if isinstance(v, torch.Tensor)
            and v.is_floating_point() else v for n, v in plain_args.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    for k, r, e in zip(got, ref, exact):
        e_k = float((k.double() - e).abs().max())
        e_p = float((r.double() - e).abs().max())
        assert e_k <= 2 * e_p + 1e-4 * float(e.abs().max()), (e_k, e_p)
    with pytest.raises(TypeError):
        ba.sharded_cg_solve(**plain_args)


VGA_SHAPES = image_ops.pyramid_shapes(480, 640, 8, 1.2)


def _sad_bit_equal(args):
    """B9 on the card against its plain version (on the card too): every
    output bit-equal, two calls bit-equal, one launch a call."""
    before = kernels.counts()["stereo_sad"]
    out = stereo.refine_subpixel_sad(*args)
    again = stereo.refine_subpixel_sad(*args)
    ref = stereo.refine_subpixel_sad_plain(*args)
    torch.cuda.synchronize()
    assert kernels.counts()["stereo_sad"] == before + 2
    for a, b, r in zip(out, again, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert torch.equal(a, b) and torch.equal(a, r)
    return out


@pytest.mark.parametrize("name", SAD_CASES)
def test_stereo_sad_kernel_on_constructed_cases(name):
    """The constructed cases of `torch_sad_cases.py` on a VGA pyramid's 8
    level shapes: the kernel bit-equal to its plain version and to the numpy
    loop (ties to the lowest index, border argmins and flat rows rejected,
    rim and top-level reads in place)."""
    dev = _card()
    case = sad_case(name, VGA_SHAPES)
    out = _sad_bit_equal(as_tensors(case, dev))
    ur, sad, ok, best = sad_ref(*case[:6])
    if case[6] is not None:
        np.testing.assert_array_equal(best, case[6])
    for a, b in zip(out, (ur, sad, ok)):
        np.testing.assert_array_equal(a.cpu().numpy(), b)


def test_stereo_sad_kernel_on_a_rendered_vga_pair():
    """B9 as the stereo step calls it: a rendered VGA pair, 8 levels, 1000
    features a side through the extractor and the stereo association on
    the card; the kernel bit-equal to its plain version."""
    dev = _card()
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           baseline=0.08)
    left, right, _ = scene.render_stereo(orbit_trajectory(4)[2])
    ext = orb.OrbExtractor(480, 640)
    sf = scale_factors(8, 1.2, device=dev)[0]
    lf, pyr_l = ext._extract_impl_pyr(torch.from_numpy(
        np.clip(left, 0, 255).astype(np.uint8)).to(dev))
    rf, pyr_r = ext._extract_impl_pyr(torch.from_numpy(
        np.clip(right, 0, 255).astype(np.uint8)).to(dev))
    u_right, _, ok = stereo.stereo_match(
        lf.xy, lf.level, lf.desc, lf.valid, rf.xy, rf.level, rf.desc,
        rf.valid, sf, 41.6, min_z=41.6 / 520.0)
    assert int(ok.sum()) > 200
    coords = stereo.level_coordinates(pyr_l, lf.xy, lf.level, u_right, sf)
    _, _, delta_ok = _sad_bit_equal([pyr_l, pyr_r, *coords])
    assert int((delta_ok & ok).sum()) > 100
    assert int(coords[0][ok].max()) > 0  # matches on upper levels too


def test_stereo_sad_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    levels_l, levels_r, lvl, yl, xl, ur0 = as_tensors(
        sad_case("interior", VGA_SHAPES), dev)
    with pytest.raises(ValueError):  # a CPU tensor beside CUDA levels
        stereo.refine_subpixel_sad(levels_l, levels_r, lvl.cpu(), yl, xl,
                                   ur0)
    with pytest.raises(ValueError):  # int64 coordinates
        stereo.refine_subpixel_sad(levels_l, levels_r, lvl.long(), yl, xl,
                                   ur0)
    with pytest.raises(ValueError):  # f64 levels
        stereo.refine_subpixel_sad([a.double() for a in levels_l], levels_r,
                                   lvl, yl, xl, ur0)
    with pytest.raises(ValueError):  # right level of another shape
        stereo.refine_subpixel_sad(levels_l, [levels_r[0][:, :-1]]
                                   + levels_r[1:], lvl, yl, xl, ur0)
    with pytest.raises(ValueError):  # coordinates of another length
        stereo.refine_subpixel_sad(levels_l, levels_r, lvl, yl[:3], xl, ur0)


def _assoc_bit_equal(fused, plain, args):
    """B9's association launch (`fused`) against its plain version on the
    card: every output bit-equal, three back-to-back calls bit-equal (the
    last block resets its ticket), one launch a call (none for N = 0)."""
    before = kernels.counts()["stereo_sad"]
    outs = [fused(**args) for _ in range(3)]
    ref = plain(**args)
    torch.cuda.synchronize()
    n = ref[0].shape[0]
    assert kernels.counts()["stereo_sad"] == before + (3 if n else 0)
    for o in outs:
        for a, r in zip(o, ref):
            assert a.dtype == r.dtype and a.shape == r.shape
            assert torch.equal(a, r)
    return outs[0]


@pytest.mark.parametrize("name", ASSOC_CASES)
def test_stereo_associate_kernel_on_constructed_cases(name):
    """Everything after K1 in one launch on the constructed cases of
    `torch_sad_cases.py` at a VGA pyramid's 8 level shapes (both medians:
    all missed, no good SAD, even and odd counts, ties, N = 13, 1, 0),
    bit-equal to `associate_from_best2_plain`."""
    dev = _card()
    case = assoc_case(name, VGA_SHAPES)
    _, _, ok = _assoc_bit_equal(stereo.associate_from_best2,
                                stereo.associate_from_best2_plain,
                                assoc_tensors(case, dev))
    if name in ("all_missed", "no_good_sad", "n0"):
        assert not ok.any()
    else:
        assert ok.any()


def test_stereo_associate_kernel_on_a_rendered_vga_pair():
    """The stereo step's association on a rendered VGA pair (8 levels, 1000
    features a side through the extractor on the card): the gate, K1 and
    one B9 launch, bit-equal to `stereo_associate_plain` (the same K1, then
    plain torch)."""
    dev = _card()
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0,
                           baseline=0.08)
    left, right, _ = scene.render_stereo(orbit_trajectory(4)[2])
    ext = orb.OrbExtractor(480, 640)
    sf = scale_factors(8, 1.2, device=dev)[0]
    lf, pyr_l = ext._extract_impl_pyr(torch.from_numpy(
        np.clip(left, 0, 255).astype(np.uint8)).to(dev))
    rf, pyr_r = ext._extract_impl_pyr(torch.from_numpy(
        np.clip(right, 0, 255).astype(np.uint8)).to(dev))
    args = dict(levels_l=pyr_l, levels_r=pyr_r, l_xy=lf.xy, l_level=lf.level,
                l_desc=lf.desc, l_valid=lf.valid, r_xy=rf.xy,
                r_level=rf.level, r_desc=rf.desc, r_valid=rf.valid,
                scale_factors=sf, bf=41.6, min_z=41.6 / 520.0)
    _, _, ok = _assoc_bit_equal(stereo.stereo_associate,
                                stereo.stereo_associate_plain, args)
    assert int(ok.sum()) > 100
    assert int(lf.level[ok].max()) > 0  # matches on upper levels too


def test_stereo_associate_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    a = assoc_tensors(assoc_case("mixed_even", VGA_SHAPES), dev)
    bad = {"l_level": a["l_level"].cpu(),  # a CPU tensor beside CUDA ones
           "idx": a["idx"].long(),  # int64 indices
           "scale_factors": a["scale_factors"].double(),
           "levels_r": a["levels_r"][:-1],  # 7 right levels for 8 left
           "best": a["best"][:3]}  # distances of another length
    for k, v in bad.items():
        with pytest.raises(ValueError):
            stereo.associate_from_best2(**{**a, k: v})


@pytest.mark.parametrize("W,N", [(512, 1000), (70_000, 200)])
def test_quantize_on_k1_equals_plain(W, N):
    """Quantization is one dense K1 call over all W words on the card; the
    plain version chunks at 65,536 words. Equal minima (a word repeated
    across the chunk boundary) resolve to the lower id in both."""
    from orb_slam2_refactored_tpu_torch.slam import vocabulary as vocab

    dev = _card()
    rng = np.random.default_rng(17)
    words = rng.integers(-2 ** 31, 2 ** 31, (W, 8), dtype=np.int64).astype(
        np.int32)
    words[W - 5:] = words[:5]
    desc = rng.integers(-2 ** 31, 2 ** 31, (N, 8), dtype=np.int64).astype(
        np.int32)
    desc[:5] = words[:5]
    voc = vocab.Vocabulary(torch.from_numpy(words), torch.ones(W))
    ref = vocab.quantize(voc, torch.from_numpy(desc))
    before = kernels.LAUNCHES["hamming_best2"]
    out = vocab.quantize(vocab.Vocabulary(voc.words.to(dev), voc.idf.to(dev)),
                         torch.from_numpy(desc).to(dev))
    assert kernels.LAUNCHES["hamming_best2"] == before + 1
    assert torch.equal(out.cpu(), ref)
    assert ref[:5].tolist() == list(range(5))


def test_vocabulary_training_and_bow_on_the_card_equal_plain():
    """`train_vocabulary` with K1's assignment equals the plain path bit for
    bit, and `compute_bow` and the scores on the card equal the plain
    version (rows exactly, scores to 1e-6)."""
    from orb_slam2_refactored_tpu_torch.slam import vocabulary as vocab

    dev = _card()
    rng = np.random.default_rng(18)
    centres = rng.integers(0, 2 ** 32, (60, 8), dtype=np.uint32)
    desc = centres[rng.integers(0, 60, 3000)]
    desc ^= (rng.random((3000, 8)) < 0.05).astype(np.uint32) << np.uint32(3)
    card = vocab.train_vocabulary(desc, n_words=256, iters=4, device=dev)
    plain = vocab.train_vocabulary(desc, n_words=256, iters=4, device="cpu")
    assert torch.equal(card.words.cpu(), plain.words)
    dbs = [vocab.KeyFrameDatabase(v, 8) for v in (card, plain)]
    q = torch.from_numpy(desc[:1000].view(np.int32).copy())
    valid = torch.from_numpy(rng.random(1000) < 0.9)
    rows = []
    for db, d in zip(dbs, (dev, "cpu")):
        for k in range(5):
            v, _ = db.compute_bow(q[k * 200:(k + 1) * 200 + 300].to(d),
                                  valid[k * 200:(k + 1) * 200 + 300].to(d))
            db.add(k, v)
        db.refit_idf()
        rows.append((db.compute_bow(q.to(d), valid.to(d)),
                     db.score_query(db.compute_bow(q.to(d), valid.to(d))[0])))
    (bow_k, s_k), (bow_p, s_p) = rows
    for x, y in zip((*bow_k[0], bow_k[1]), (*bow_p[0], bow_p[1])):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(dbs[0].bow_ids.cpu(), dbs[1].bow_ids)
    assert float((s_k[0].cpu() - s_p[0]).abs().max()) <= 1e-6
    assert torch.equal(s_k[1].cpu(), s_p[1])


# K10 (`csrc/wire_unpack.cu`): the packed frame's decode

def _dct_buffer(h, w, k=1, seed=21):
    """k rows of a rendered (VGA-scaled) view's DCT code, the last row a
    noise image's (every coefficient byte in use)."""
    from orb_slam2_refactored_tpu_torch.ops import codec

    rng = np.random.default_rng(seed)
    scene = SyntheticScene(width=w, height=h, fx=0.8125 * w, fy=0.8125 * w)
    rows = []
    for r in range(k):
        if r == k - 1 and k > 1:
            img = rng.uniform(0, 255.99, (h, w)).astype(np.float32)
        else:
            img = np.clip(scene.render(orbit_trajectory(4)[r % 4])[0], 0, 255)
        rows.append(codec.encode_dct(img.astype(np.uint8)))
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("hw,k", [((480, 640), 1), ((480, 752), 1),
                                  ((1200, 1920), 1), ((2160, 3840), 1),
                                  ((480, 640), 4)])
def test_wire_unpack_dct_equals_plain(hw, k):
    """The DCT image within 1e-3 gray of the plain decode (the sums are
    added in another order), one launch for k rows."""
    from orb_slam2_refactored_tpu_torch.ops import codec

    dev = _card()
    h, w = hw
    buf = _dct_buffer(h, w, k)
    kernels.reset_counts()
    img, dep = codec.wire_unpack(buf.to(dev), img=(0, h, w))
    torch.cuda.synchronize()
    assert dep is None and kernels.LAUNCHES["wire_unpack"] == 1
    ref, _ = codec.wire_unpack_plain(buf, img=(0, h, w))
    assert img.shape == (k, h, w) and img.dtype == torch.float32
    assert float((img.cpu() - ref).abs().max()) <= 1e-3
    one = codec.decode_dct(buf[0].to(dev), h, w)
    assert torch.equal(one, img[0])


def test_wire_unpack_log8_equals_plain_bit_for_bit():
    """Every code, and a VGA frame's raw + log8 rows at subsample 8 and
    at 1, decoded through the card's table: the plain decode on the card
    bit for bit."""
    from orb_slam2_refactored_tpu_torch.ops import codec
    from orb_slam2_refactored_tpu_torch.slam.tracking import (
        TrackerConfig, pack_rgbd)

    dev = _card()
    lut = codec.log8_table(dev)
    codes = torch.arange(256, dtype=torch.uint8).reshape(1, 256).to(dev)
    _, dep = codec.wire_unpack(codes, dep=(0, 16, 16), lut=lut)
    plain = codec.decode_log8_plain(codes).reshape(1, 16, 16)
    assert torch.equal(dep, plain)
    scene = SyntheticScene(width=640, height=480, fx=520.0, fy=520.0)
    img, depth = scene.render(orbit_trajectory(4)[1])
    for sub in (8, 1):
        cfg = TrackerConfig(width=640, height=480, fx=520.0, fy=520.0,
                            cx=320.0, cy=240.0, depth_subsample=sub,
                            depth_encoding="log8")
        row = pack_rgbd(cfg, np.clip(img, 0, 255), depth)
        buf = torch.from_numpy(np.stack([row, row[::-1].copy()])).to(dev)
        h, w = -(-480 // sub), -(-640 // sub)
        _, dep = codec.wire_unpack(buf, dep=(640 * 480, h, w), lut=lut)
        _, ref = codec.wire_unpack_plain(buf, dep=(640 * 480, h, w))
        assert torch.equal(dep, ref)


def test_wire_unpack_refuses_what_the_kernel_does_not_take():
    from orb_slam2_refactored_tpu_torch.ops import codec

    dev = _card()
    lut = codec.log8_table(dev)
    buf = torch.zeros((2, 4096), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        codec.wire_unpack(buf.cpu(), dep=(0, 8, 8), lut=lut)
    with pytest.raises(ValueError):
        codec.wire_unpack(buf.to(torch.int32), dep=(0, 8, 8), lut=lut)
    with pytest.raises(ValueError):
        codec.wire_unpack(buf, dep=(0, 8, 8), lut=lut.cpu())
    with pytest.raises(ValueError):
        codec.wire_unpack(buf, img=(0, 128, 160))  # 5120 bytes: overruns
    with pytest.raises(ValueError):
        codec.wire_unpack(buf[:, ::2], img=(0, 8, 8))
    with pytest.raises(ValueError):
        codec.decode_dct(buf[0].cpu(), 8, 8)


def test_tracker_uploads_land_on_the_card():
    """`prefetch_rgbd` futures resolve to card tensors of the packed bytes;
    a tracker on the card decodes a log8 buffer with one K10 launch and
    equals the plain unpack of the same bytes, and refuses a buffer on the
    host."""
    from orb_slam2_refactored_tpu_torch.slam.map_state import MapCapacity
    from orb_slam2_refactored_tpu_torch.slam.tracking import (
        Tracker, TrackerConfig, pack_rgbd)

    dev = _card()
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0)
    img, depth = scene.render(orbit_trajectory(4)[1])
    kw = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
              bf=20.8, n_features=400, n_levels=4, depth_subsample=2,
              depth_encoding="log8", image_encoding="dct",
              map_capacity=MapCapacity(8, 1024, 400))
    t = Tracker(TrackerConfig(**kw), device=dev)
    futs = t.prefetch_rgbd([img] * 3, [depth] * 3)
    bufs = [f.result() for f in futs]
    packed = pack_rgbd(t.cfg, img, depth)
    kernels.reset_counts()
    for b in bufs:
        assert b.device == dev
        t_img, t_dep = t._unpack(b)
        assert torch.equal(b.cpu(), torch.from_numpy(packed))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wire_unpack"] == 3
    c = Tracker(TrackerConfig(**kw), device="cpu")
    p_img, p_dep = c._unpack(torch.from_numpy(packed))
    assert float((t_img.cpu() - p_img).abs().max()) <= 1e-3
    assert torch.equal(t_dep.cpu(), p_dep.to(torch.float32)) or \
        float((t_dep.cpu() - p_dep).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="tracker runs on"):
        t._unpack(torch.from_numpy(packed))
    assert kernels.LAUNCHES["wire_unpack"] == 3


B6_KEYS = ("mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
           "mp_valid")


def _same_bits(a, b):
    """Equal values, floats compared by their bits (NaN included)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a.long() if a.dtype == torch.int32 else a,
                       b.long() if b.dtype == torch.int32 else b)


def _b6_args(name, dev):
    mp, frame, pose, kw = b6_case(name)
    a = {k: v.to(dev) for k, v in as_torch({**mp, **frame}).items()}
    return dict(a, pose_cw=torch.from_numpy(pose).to(dev),
                cam=proj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0),
                scale_factors=torch.from_numpy(SF).to(dev), **kw)


@pytest.mark.parametrize("name", list(B6_CASES) + list(CARD_CASES))
def test_project_search_kernel_equals_plain(name):
    """B6 bit for bit against its plain version at the compaction's edges
    (no point passes, all pass, exactly `cap`, `cap >= P`, `cap = 0`), at
    P not a multiple of a block's threads (one and two points a thread)
    and at the bench's P = 32,768, cap = 8,192: every row's (uv, radius,
    level, ok, descriptor, point), each point's visibility and row; then
    the whole search (B6, K1, R: three launches) against its plain
    version."""
    from orb_slam2_refactored_tpu_torch.ops import matching

    dev = _card()
    a = _b6_args(name, dev)
    b6 = {k: a[k] for k in B6_KEYS + ("pose_cw", "cam", "scale_factors",
                                      "radius", "check_view_angle",
                                      "image_bounds", "candidate_cap")}
    before = kernels.counts()
    got = matching.project_candidates(**b6)
    assert kernels.counts()["project_search"] == before["project_search"] + 1
    ref = matching.project_candidates_plain(**b6)
    torch.cuda.synchronize()
    for f in matching.Candidates._fields:
        assert _same_bits(getattr(got, f), getattr(ref, f)), f
    before = kernels.counts()
    out, vis = matching.search_by_projection_with_vis(**a)
    after = kernels.counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"project_search": 1, "hamming_best2": 1,
                  "resolve_claims": 1}
    ref_out, ref_vis = matching.search_by_projection_with_vis_plain(**a)
    assert all(torch.equal(x, y) for x, y in zip(out, ref_out))
    assert torch.equal(vis, ref_vis)
    if name not in ("none_pass",):
        assert int(out.valid.sum()) > 20


def test_project_search_refuses_what_one_launch_cannot_take():
    """Points past what one resident grid takes (8 a thread) raise: nothing
    falls back to another path."""
    from orb_slam2_refactored_tpu_torch.ops import matching

    dev = _card()
    P = 4_000_000
    with pytest.raises(ValueError, match="past what one launch takes"):
        matching.project_candidates(
            torch.zeros((P, 3), device=dev),
            torch.zeros((P, 8), dtype=torch.int32, device=dev),
            torch.zeros((P, 3), device=dev), torch.zeros((P,), device=dev),
            torch.zeros((P,), device=dev),
            torch.zeros((P,), dtype=torch.bool, device=dev),
            torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device=dev),
            proj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0),
            torch.from_numpy(SF).to(dev))


def _feature_args(name, dev):
    f, pose = feature_case(name)
    t = {k: v.to(dev) for k, v in as_torch(f).items()}
    return t, dict(pose_cw=torch.from_numpy(pose).to(dev),
                   cam=proj.CameraIntrinsics.create(FX, FX, CX, CY, 0.0),
                   scale_factors=torch.from_numpy(SF).to(dev))


@pytest.mark.parametrize("name", list(FEATURE_CASES))
def test_project_features_kernel_equals_plain(name):
    """B6's feature mode bit for bit against its plain version (uv,
    radius, ok) with the tracker's gather, with per-feature positions and
    validities, and with both, on every feature failing, N not a multiple
    of a block's threads and N = 1; then the motion-model search
    (`search_last_frame_mapped`: B6's feature mode, K1, R's rows mode:
    three launches) and the JAX-signature `search_last_frame` against
    their plain versions."""
    from orb_slam2_refactored_tpu_torch.ops import matching

    dev = _card()
    t, rest = _feature_args(name, dev)
    common = dict(level=t["last_level"], radius=7.0, **rest)
    q = torch.clamp(t["last_mp"], 0, t["mp_pos"].shape[0] - 1).long()
    pos, ok = t["mp_pos"][q], (t["last_mp"] >= 0) & t["mp_valid"][q]
    for kw in (dict(pos=t["mp_pos"], feat_idx=t["last_mp"],
                    pos_valid=t["mp_valid"]),
               dict(pos=pos, feat_valid=t["last_valid"] & ok),
               dict(pos=t["mp_pos"], feat_idx=t["last_mp"],
                    pos_valid=t["mp_valid"], feat_valid=t["last_valid"])):
        before = kernels.counts()["project_features"]
        got = [x.clone() for x in matching.project_features(**kw, **common)]
        assert kernels.counts()["project_features"] == before + 1
        ref = matching.project_features_plain(**kw, **common)
        torch.cuda.synchronize()
        for x, y in zip(got, ref):
            assert _same_bits(x, y)
    curr = (t["curr_xy"], t["curr_level"], t["curr_desc"], t["curr_valid"])
    before = kernels.counts()
    out = matching.search_last_frame_mapped(
        *curr, t["last_level"], t["last_desc"], t["last_mp"], t["mp_pos"],
        t["mp_valid"], **rest)
    after = kernels.counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"project_features": 1, "hamming_best2": 1,
                  "resolve_claims": 1}
    ref = matching.search_last_frame_mapped_plain(
        *curr, t["last_level"], t["last_desc"], t["last_mp"], t["mp_pos"],
        t["mp_valid"], **rest)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    given = matching.search_last_frame(*curr, None, t["last_level"],
                                       t["last_desc"], ok, ok, pos, **rest)
    assert all(torch.equal(x, y) for x, y in zip(given, ref))
    if name not in ("none_pass", "one"):
        assert int(out.valid.sum()) > 20


def _r_modes(idx, dist, valid, N):
    """R in its three modes against the plain versions: keep, rows with
    the index (at two distance gates and none), and per point through a
    slot map (points without a row, the distance gate)."""
    before = kernels.counts()["resolve_claims"]
    keep = hamming.resolve_duplicates(idx, dist, valid, N)
    assert kernels.counts()["resolve_claims"] == before + 1
    assert torch.equal(keep, hamming.resolve_duplicates_plain(
        idx, dist, valid, N))
    for max_dist in (50, hamming.TH_HIGH, hamming.NO_GATE):
        got = hamming.resolve_rows(idx, dist, valid, max_dist, N)
        ref = hamming.resolve_rows_plain(idx, dist, valid, max_dist, N)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    M = idx.shape[0]
    rng = np.random.default_rng(3)
    slot = np.full(M + 777, -1, np.int32)
    slot[rng.permutation(M + 777)[:M]] = np.arange(M)
    slot = torch.from_numpy(slot).to(idx.device)
    for max_dist in (50, hamming.TH_HIGH):
        got = hamming.resolve_to_points(idx, dist, valid, max_dist, N, slot)
        ref = hamming.resolve_to_points_plain(idx, dist, valid, max_dist, N,
                                              slot)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    return keep


@pytest.mark.parametrize("name", list(R_CASES))
def test_resolve_kernel_equals_plain(name):
    """R bit for bit against its plain version in its three modes: equal
    distances keep the lowest row, invalid rows never win, one target
    claimed by many rows, all rows invalid, K1's unsearched rows (target
    0, BIG), M = 1, M and N not multiples of a block's threads."""
    dev = _card()
    idx, dist, valid, N = (torch.from_numpy(x).to(dev) if isinstance(
        x, np.ndarray) else x for x in r_case(name))
    _r_modes(idx, dist, valid, N)


def test_resolve_kernel_at_its_most_targets():
    """R at N = `_max_targets()` (every block's table fills its shared
    memory) and past it (refused): claims on the first and last targets,
    and 8,969 points through a slot map."""
    dev = _card()
    N = hamming._max_targets()
    idx, dist, valid, _ = r_case("ties", size=(8192, N))
    idx[:4] = [0, N - 1, 0, N - 1]
    keep = _r_modes(*(torch.from_numpy(x).to(dev)
                      for x in (idx, dist, valid)), N)
    assert int(keep.sum()) > 1000
    with pytest.raises(ValueError, match="targets, past"):
        hamming.resolve_duplicates(*(torch.from_numpy(x).to(dev)
                                     for x in (idx, dist, valid)), N + 1)
