"""Kernel K7's redesign (`csrc/orb_desc_learned.cu`) emulated on the CPU.

The kernel itself runs only on the card (`tests/test_torch_kernels_gpu.py`,
`chip_smoke.py`); what its design decides is held here, in numpy f32 (each
operation rounded, none fused):
- the blur: the window loaded as the kernel loads it (plain rows inside a
  level, mirrored indices decided once a keypoint past a border), the
  horizontal pass in runs of one row read once into registers, then the
  vertical pass in runs of one column, tap by tap, each product and sum
  rounded apart; bit for bit the port's plain `gaussian_blur` on the
  windows of QVGA keypoints, keypoints 19 px from every border included,
  and within 1e-4 gray of JAX's (XLA sums the 7 taps in its own order);
- the moments: 128 threads each keeping two of the first design's 256
  strided partial sums, a butterfly in each group of 32, the 8 group
  totals in order, bit for bit the first design's order; the angles equal
  the plain `ic_angles` on level 0 (integer moments are exact) and within
  3e-5 rad above it;
- the host's launch table: built on a CPU level layout like kernel K8's
  buffer with no launch, it splits the keypoints by level as the counts do,
  places the levels at K8's offsets, builds a table of addresses for
  levels laid out otherwise, and raises where the kernel does not take the
  arguments.
"""

import numpy as np
import pytest
import torch
from jax import numpy as jnp

from orb_slam2_refactored_tpu.ops import image as jimage
from orb_slam2_refactored_tpu_torch import kernels
from orb_slam2_refactored_tpu_torch.ops import image as timage
from orb_slam2_refactored_tpu_torch.ops import orb as torb

torch.set_num_threads(1)
H, W, NF, NL = 240, 320, 500, 4
REACH, HALO, RAW, BLUR, TAPS = 18, 3, 43, 37, 7
G = timage._gaussian_kernel(7, 2.0)


def _mirror(i, n):
    """The kernel's `mirror`: `jnp.pad(mode="reflect")`."""
    i = np.abs(i)
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


def _run_span(r, runs):
    base, extra = BLUR // runs, BLUR % runs
    return r * base + min(r, extra), base + (r < extra)


@pytest.fixture(scope="module")
def pyramid():
    """A QVGA frame's 4 levels (level 0 integer grays) and, on every level,
    keypoints at random and at 19, 20 and 21 px from each border and in
    each corner (the window reaches 2, 1 and 0 px past the border)."""
    rng = np.random.default_rng(15)
    img = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.float32))
    levels = timage.build_pyramid_plain(img, NL, 1.2)
    ys, xs, counts = [], [], []
    for lvl in levels:
        h, w = lvl.shape
        edge_y = [19, 20, 21, h - 22, h - 21, h - 20]
        edge_x = [19, 20, 21, w - 22, w - 21, w - 20]
        y = list(rng.integers(19, h - 19, 24)) + edge_y + edge_y
        x = list(rng.integers(19, w - 19, 24)) + edge_x + edge_x[::-1]
        y += [19, 19, h - 20, h - 20] + edge_y
        x += [19, w - 20, 19, w - 20] + [w // 2] * 6
        y += [h // 2] * 6
        x += edge_x
        ys += y
        xs += x
        counts.append(len(y))
    return (levels, np.asarray(ys, np.int32), np.asarray(xs, np.int32),
            counts)


def _windows(lvl, ys, xs):
    """[K, 43, 43] raw windows as the kernel loads them."""
    h, w = lvl.shape
    y0, x0 = ys - (REACH + HALO), xs - (REACH + HALO)
    inside = (y0 >= 0) & (x0 >= 0) & (y0 + RAW <= h) & (x0 + RAW <= w)
    rows = y0[:, None] + np.arange(RAW)
    cols = x0[:, None] + np.arange(RAW)
    rows = np.where(inside[:, None], rows, _mirror(rows, h))
    cols = np.where(inside[:, None], cols, _mirror(cols, w))
    return lvl[rows[:, :, None], cols[:, None, :]], inside


def _blur_runs(raw, threads=128):
    """The kernel's two passes over [K, 43, 43] windows: the horizontal
    pass's tasks (run, row), then the vertical pass's (run, column), each
    task's inputs read once and its outputs summed tap by tap, every
    product and sum rounded apart in f32. Also counts how often each
    output is written: every one once."""
    K = raw.shape[0]
    hp = np.zeros((K, RAW, BLUR), np.float32)
    blur = np.zeros((K, BLUR, BLUR), np.float32)
    hits_h = np.zeros((RAW, BLUR), int)
    hits_v = np.zeros((BLUR, BLUR), int)
    for tid in range(threads):
        for task in range(tid, RAW * 5, threads):
            run, r = divmod(task, RAW)
            c, n = _run_span(run, 5)
            x = raw[:, r, c:c + n + TAPS - 1]  # the registers
            for j in range(n):
                s = G[0] * x[:, j]
                for t in range(1, TAPS):
                    s = s + G[t] * x[:, j + t]
                hp[:, r, c + j] = s
                hits_h[r, c + j] += 1
    for tid in range(threads):
        for task in range(tid, BLUR * 6, threads):
            run, c = divmod(task, BLUR)
            r, n = _run_span(run, 6)
            x = hp[:, r:r + n + TAPS - 1, c]
            for j in range(n):
                s = G[0] * x[:, j]
                for t in range(1, TAPS):
                    s = s + G[t] * x[:, j + t]
                blur[:, r + j, c] = s
                hits_v[r + j, c] += 1
    assert (hits_h == 1).all() and (hits_v == 1).all()
    return blur


@pytest.mark.parametrize("level", range(NL))
def test_register_blur_equals_the_plain_blur(pyramid, level):
    """The kernel's blur order on every keypoint's window equals the
    port's plain blur of the whole level bit for bit, mirrored windows
    included, and JAX's blur within 1e-4 gray."""
    levels, ys, xs, counts = pyramid
    sl = slice(sum(counts[:level]), sum(counts[:level + 1]))
    lvl = levels[level].numpy()
    raw, inside = _windows(lvl, ys[sl], xs[sl])
    assert (~inside).sum() >= 20 and inside.sum() >= 20
    got = _blur_runs(raw)
    full = timage.gaussian_blur(levels[level], 7, 2.0).numpy()
    jfull = np.asarray(jimage.gaussian_blur(jnp.asarray(lvl), 7, 2.0))
    d = np.arange(-REACH, REACH + 1)
    rows = ys[sl, None, None] + d[None, :, None]
    cols = xs[sl, None, None] + d[None, None, :]
    assert np.array_equal(got.view(np.uint32),
                          full[rows, cols].view(np.uint32))
    assert float(np.abs(got - jfull[rows, cols]).max()) <= 1e-4


def _moments(patch, xm, ym, threads):
    """(m10, m01) f32 per keypoint in the kernel's order with `threads`
    threads a keypoint: thread tid keeps the partial sums of the first
    design's threads t = tid, tid + threads, ... (each over pixels t,
    t + 256, ...), a butterfly within each group of 32, then the 8 group
    totals added in order."""
    K = patch.shape[0]
    part = np.zeros((2, K, 256), np.float32)
    for tid in range(threads):
        for t in range(tid, 256, threads):
            a = np.zeros(K, np.float32)
            b = np.zeros(K, np.float32)
            for i in range(t, 31 * 31, 256):
                a = a + patch[:, i] * xm[i]
                b = b + patch[:, i] * ym[i]
            part[0, :, t], part[1, :, t] = a, b
    lanes = np.arange(32)
    tot = np.zeros((2, K), np.float32)
    for g in range(8):
        v = part[:, :, 32 * g:32 * g + 32]
        for off in (16, 8, 4, 2, 1):
            v = v + v[:, :, lanes ^ off]
        assert (v == v[:, :, :1]).all()  # every lane holds the total
        tot = tot + v[:, :, 0]
    return tot


@pytest.mark.parametrize("threads", [128, 64])
def test_moment_order_equals_the_first_design(pyramid, threads):
    """Fewer threads a keypoint, each standing for several of the first
    design's 256, give its moments bit for bit; atan2 of them equals the
    plain `ic_angles` on level 0 and is within 3e-5 rad above it."""
    levels, ys, xs, counts = pyramid
    _, xm, ym = torb.circular_patch_masks()
    xm, ym = xm.reshape(-1), ym.reshape(-1)
    start = 0
    for lvl, k in zip(levels, counts):
        sl = slice(start, start + k)
        start += k
        raw, _ = _windows(lvl.numpy(), ys[sl], xs[sl])
        off = REACH + HALO - 15
        patch = raw[:, off:off + 31, off:off + 31].reshape(k, -1)
        first = _moments(patch, xm, ym, 256)
        got = _moments(patch, xm, ym, threads)
        assert np.array_equal(got.view(np.uint32), first.view(np.uint32))
        ang = torch.atan2(torch.from_numpy(got[1]),
                          torch.from_numpy(got[0])).numpy()
        ref = torb.ic_angles(lvl, torch.from_numpy(ys[sl]),
                             torch.from_numpy(xs[sl])).numpy()
        d = np.abs(np.remainder(ang - ref + np.pi, 2 * np.pi) - np.pi)
        assert float(d.max()) <= (0 if start == k else 3e-5), float(d.max())


def _k8_layout(levels):
    """CPU levels laid out as kernel K8 writes them: level 0 alone, the
    others views of one buffer at `image_ops.buffer_offsets`."""
    offsets, total = timage.buffer_offsets([tuple(l.shape)
                                            for l in levels[1:]])
    buf = torch.full((total,), float("nan"))
    out = [levels[0].clone()]
    for lvl, o in zip(levels[1:], offsets):
        v = buf.as_strided(tuple(lvl.shape), (lvl.shape[1], 1), o)
        v.copy_(lvl)
        out.append(v)
    return out, buf, offsets


def test_launch_table_on_a_k8_layout(pyramid):
    """The table an extractor builds when constructed is the one its
    frames' levels find; it splits the keypoints by level as the counts
    do, reads levels 1.. at K8's offsets from one base and level 0 from
    the frame, and carries the pattern and the blur and moment tables."""
    levels, _, _, _ = pyramid
    budgets = torb.features_per_level(NF, NL, 1.2)
    plan = torb.prepare_learned(H, W, NF, 1.2, NL, "learned", "cpu")
    misses = torb._learned_plan.cache_info().misses
    assert torb._learned_plan(tuple(tuple(l.shape) for l in levels),
                              tuple(budgets), -1, "learned") is plan
    assert torb._learned_plan.cache_info().misses == misses
    t = plan.table
    assert (t.n, t.K, plan.K) == (NL, NF, NF)
    assert list(t.k0[:NL]) == list(np.cumsum([0] + budgets[:-1]))
    assert [(t.h[l], t.w[l]) for l in range(NL)] == [tuple(l.shape)
                                                     for l in levels]
    laid, buf, offsets = _k8_layout(levels)
    assert list(t.from_base[:NL]) == [0, 1, 1, 1]
    assert list(t.off[:NL]) == [0] + [4 * o for o in offsets]
    img0, base, addr, table = torb.learned_sources(laid, plan)
    assert (img0, base, addr, table) == (laid[0].data_ptr(), buf.data_ptr(),
                                         plan.address, plan.table)
    for l in range(1, NL):
        assert base + t.off[l] == laid[l].data_ptr()
    tb = torb._tables("cpu")
    assert (t.gk, t.mom) == (tb["gk"].data_ptr(), tb["mom"].data_ptr())
    _, xm, ym = torb.circular_patch_masks()
    assert torch.equal(tb["mom"], torch.from_numpy(
        np.stack([xm.reshape(-1), ym.reshape(-1)], 1)))
    assert t.pattern == plan.pattern.data_ptr()
    assert plan.pattern.dtype == torch.int8 and torch.equal(
        plan.pattern.int(), torch.from_numpy(
            torb.learned_pattern().reshape(256, 4)))


def test_launch_table_of_other_layouts_is_built_on_the_call(pyramid):
    """Levels that are not K8's buffer (separate tensors, or one level
    moved) get a table of their addresses on the call; the plan's own
    table is left as it was."""
    levels, _, _, counts = pyramid
    plan = torb._learned_plan(tuple(tuple(l.shape) for l in levels),
                              tuple(counts), -1, "learned")
    before = bytes(plan.table)
    laid, _, _ = _k8_layout(levels)
    for case in (levels, laid[:2] + [laid[2].clone()] + laid[3:]):
        img0, base, addr, t = torb.learned_sources(case, plan)
        assert (img0, base) == (0, 0) and t is not plan.table
        assert addr != plan.address
        assert list(t.from_base[:NL]) == [1] * NL
        assert list(t.off[:NL]) == [lvl.data_ptr() for lvl in case]
        assert list(t.k0[:NL]) == list(plan.table.k0[:NL])
    assert bytes(plan.table) == before


@pytest.mark.parametrize("case", ["radius", "levels", "counts", "small",
                                  "negative"])
def test_launch_table_refuses_what_the_kernel_does_not_take(case):
    """A test point at radius 18.5 or more (18.68 here; 18.44 is taken),
    more than MAX_LEVELS levels, counts that do not name every level, a
    keypoint on a level under 39 px (one with no keypoint is taken), a
    negative count: building the table raises."""
    shapes, counts = ((240, 320), (200, 267)), (10, 5)
    ok = dict(shapes=shapes, counts=counts, pattern="learned")
    if case == "radius":
        pat = torb.learned_pattern().copy()
        pat[0, 0] = (18, 4)
        torb._learned_plan(shapes, counts, -1, torb._pattern_key(pat))
        pat[0, 0] = (18, 5)
        bad = dict(ok, pattern=torb._pattern_key(pat))
    elif case == "levels":
        n = kernels.MAX_LEVELS + 1
        bad = dict(ok, shapes=((240, 320),) * n, counts=(1,) * n)
    elif case == "counts":
        bad = dict(ok, counts=(15,))
    elif case == "small":
        torb._learned_plan(((240, 320), (38, 200)), (10, 0), -1, "learned")
        bad = dict(ok, shapes=((240, 320), (38, 200)))
    else:
        bad = dict(ok, counts=(16, -1))
    with pytest.raises(ValueError):
        torb._learned_plan(bad["shapes"], bad["counts"], -1, bad["pattern"])
