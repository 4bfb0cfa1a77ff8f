"""Stereo left/right ORB matching -> per-feature disparity and depth.

Port of `orb_slam2_refactored_tpu/ops/stereo.py` (the analog of
`ORBmatcher::ComputeStereoMatches`):
- `stereo_associate`: the whole association of a stereo frame, as the
  tracker calls it: the row-band x disparity-window x level-window gate as
  a dense [N, N] pair mask, handed to kernel K1 (`ops/hamming.py`) as its
  `pair_ok` input, then everything after K1's best-2 in one launch of the
  hand-written kernel `csrc/stereo_sad.cu` (`associate_from_best2`: the
  matched u, the distance median, the level coordinates, the SAD search,
  the parabola, the gates, the SAD median and the depth), with no host
  read. On CPU tensors `stereo_associate_plain`: `stereo_match` then
  `refine_subpixel_pyramid`, the JAX package's two functions;
- `stereo_match`: the gate, K1, then the distance-median outlier filter;
- `refine_subpixel_pyramid`: the 11x11 SAD search at +-5 disparities at each
  keypoint's own pyramid level, the parabola fit and its gates (on CUDA
  tensors the kernel's SAD-only entry `refine_subpixel_sad`, on CPU tensors
  its plain version `refine_subpixel_sad_plain`); then the rescale to
  level 0 and the SAD-median outlier filter;
- `refine_subpixel`: the level-0 variant, plain torch (nothing calls it on
  the tracking path).

Both medians are the JAX package's: `jnp.median` and `jnp.nanmedian` take
the mean of the two middle values of an even count (`torch.median` takes
the lower one), so `_median_midpoint` sorts and averages.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import hamming

W_SAD = 5   # 11x11 window (reference w=5)
R_SAD = 5   # +-5 disparity search (reference L=5)
P_SAD = 2 * W_SAD + 1        # patch side
S_SAD = P_SAD + 2 * R_SAD    # right strip width
N_DISP = 2 * R_SAD + 1       # disparities searched


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an f32 scalar tensor: `x / t` is then one IEEE
    division in f32, as in JAX (torch turns `float / tensor` into a
    reciprocal and a product)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median` of a 1-D array (as f32): the mean of the two middle
    values, `(lo + hi) * 0.5`, when the count is even."""
    s = torch.sort(x.to(torch.float32)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _nanmedian_midpoint(x: torch.Tensor) -> torch.Tensor:
    """`jnp.nanmedian` of a 1-D f32 array: the midpoint median of its
    non-NaN values, NaN when there is none. Computed on the device without
    a host read (the count indexes the sorted values as a tensor)."""
    s = torch.sort(x).values  # NaN sorts last
    cnt = (~torch.isnan(x)).sum()
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"),
                     max=max(s.shape[0] - 1, 0))
    # index_select, not s[lo]: a 0-d index tensor is read to the host
    mid = s.index_select(0, torch.stack([lo, hi]))
    return (mid[0] + mid[1]) * 0.5


def _band_best2(l_xy, l_level, l_desc, l_valid, r_xy, r_level, r_desc,
                r_valid, scale_factors, bf: float, min_z: float):
    """K1's best-2 of each left feature over the right ones under the
    stereo gate (row band 2 * scale(level), disparity in [-1, bf / min_z],
    level +-1). Returns (idx i32[N], best i32[N])."""
    max_d = bf / min_z
    vL, vR = l_xy[:, 1][:, None], r_xy[:, 1][None, :]
    uL, uR = l_xy[:, 0][:, None], r_xy[:, 0][None, :]
    band = scale_factors[l_level.long()] * 2.0  # row tolerance per left kp
    row_ok = torch.abs(vL - vR) <= band[:, None]
    disp = uL - uR
    disp_ok = (disp >= -1.0) & (disp <= max_d)
    lvl_ok = torch.abs(l_level[:, None] - r_level[None, :]) <= 1
    idx, best, _ = hamming.masked_best2_gated(
        l_desc, r_desc, l_valid, r_valid, pair_ok=row_ok & disp_ok & lvl_ok)
    return idx, best


def _match_tail(l_xy, r_xy, idx, best, bf: float, max_dist: int):
    """`stereo_match` after the best-2: the matched u, the depth and the
    distance-median filter."""
    ok = best <= max_dist
    neg = torch.full_like(l_xy[:, 0], -1.0)
    matched_ur = torch.where(
        ok, r_xy[torch.clamp(idx, 0, r_xy.shape[0] - 1).long(), 0], neg)
    disparity = torch.clamp(l_xy[:, 0] - matched_ur, min=0.01)
    depth = torch.where(ok, _f32(bf, disparity) / disparity, neg)

    # median-deviation outlier filter: drop matches whose Hamming distance
    # exceeds ~2x the median of accepted matches (misses count as BIG)
    med = _median_midpoint(torch.where(ok, best, torch.full_like(
        best, hamming.BIG)))
    thr = 1.5 * 1.4 * med
    ok = ok & (best < thr)
    return torch.where(ok, matched_ur, neg), torch.where(ok, depth, neg), ok


def stereo_match(l_xy, l_level, l_desc, l_valid, r_xy, r_level, r_desc,
                 r_valid, scale_factors, bf: float, min_z: float,
                 max_dist: int = hamming.TH_HIGH):
    """Returns (u_right f32[N], depth f32[N]) for each left feature (-1 where
    unmatched), plus the match validity mask bool[N]."""
    idx, best = _band_best2(l_xy, l_level, l_desc, l_valid, r_xy, r_level,
                            r_desc, r_valid, scale_factors, bf, min_z)
    return _match_tail(l_xy, r_xy, idx, best, bf, max_dist)


# ---------------------------------------------------------------------------
# SAD sub-pixel refinement (B9)
# ---------------------------------------------------------------------------

def _flat_levels(levels):
    """The levels' pixels as one flat f32 vector and each level's offset
    and width, for gathers on every keypoint at its own level."""
    flat = torch.cat([lv.reshape(-1).to(torch.float32) for lv in levels])
    dev = flat.device
    sizes = [lv.shape[0] * lv.shape[1] for lv in levels]
    offs = torch.tensor([sum(sizes[:i]) for i in range(len(levels))],
                        dtype=torch.int64, device=dev)
    widths = torch.tensor([lv.shape[1] for lv in levels], dtype=torch.int64,
                          device=dev)
    return flat, offs, widths


def _sads_plain(levels_l, levels_r, lvl, yl, xl, ur0):
    """f32[N, 11]: the SAD of the left 11x11 patch centred at (yl, xl) of
    level `lvl` against the 11 right windows centred at (yl, ur0 - 5 + r),
    each patch minus its centre pixel. Summed over the 121 offsets in
    row-major order, one add at a time, as the kernel's lanes sum."""
    fl, offs, widths = _flat_levels(levels_l)
    fr, _, _ = _flat_levels(levels_r)
    lvl = lvl.long()
    base = offs[lvl]
    w = widths[lvl]
    y0 = yl.long() - W_SAD
    xl0 = xl.long() - W_SAD
    xr0 = ur0.long() - W_SAD - R_SAD
    r = torch.arange(N_DISP, device=fl.device)

    def left(dy, dx):
        return fl[base + (y0 + dy) * w + xl0 + dx]

    def right(dy, dx):  # [N, 11]: the pixel (dy, dx) of every window
        return fr[(base + (y0 + dy) * w + xr0 + dx)[:, None] + r[None, :]]

    cl = left(W_SAD, W_SAD)[:, None]
    cr = right(W_SAD, W_SAD)
    acc = torch.zeros((lvl.shape[0], N_DISP), dtype=torch.float32,
                      device=fl.device)
    for dy in range(P_SAD):
        for dx in range(P_SAD):
            acc = acc + torch.abs((left(dy, dx)[:, None] - cl)
                                  - (right(dy, dx) - cr))
    return acc


def _parabola(sads, flat: float):
    """The argmin of each row of SADs (the lowest index on ties, by the
    kernel's scan: a strict compare from index 0 up), its index clipped off
    the border (bi), the SAD there and the parabola's vertex offset through
    its neighbours (`flat` where the valley is flat)."""
    best = torch.zeros(sads.shape[0], dtype=torch.int64, device=sads.device)
    cur = sads[:, 0]
    for r in range(1, sads.shape[1]):
        take = sads[:, r] < cur
        best = torch.where(take, torch.full_like(best, r), best)
        cur = torch.where(take, sads[:, r], cur)
    bi = torch.clamp(best, 1, N_DISP - 2)
    s_m, s_0, s_p = (sads.gather(1, (bi + k)[:, None])[:, 0]
                     for k in (-1, 0, 1))
    denom = s_m + s_p - 2.0 * s_0
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (s_m - s_p) / denom,
                        torch.full_like(denom, flat))
    return best, bi, s_0, delta


def refine_subpixel_sad_plain(levels_l, levels_r, lvl, yl, xl, ur0):
    """Plain PyTorch version of kernel `csrc/stereo_sad.cu`, in its order
    of operations (bit-equal to it on the card). Returns (ur_lvl f32[N],
    sad_best f32[N], delta_ok bool[N]) at each keypoint's level."""
    # the reference rejects |delta| > 1 (and a flat valley) rather than
    # clipping: 2 marks the rejection
    best, bi, s_0, delta = _parabola(
        _sads_plain(levels_l, levels_r, lvl, yl, xl, ur0), flat=2.0)
    ur_lvl = ((ur0.to(torch.float32) + (bi - R_SAD).to(torch.float32))
              + torch.clamp(delta, -1.0, 1.0))
    # a border argmin means the true minimum may lie outside the window
    interior = (best != 0) & (best != N_DISP - 1)
    return ur_lvl, s_0, (torch.abs(delta) <= 1.0) & interior


def refine_subpixel_sad(levels_l, levels_r, lvl, yl, xl, ur0):
    """Per keypoint at its own pyramid level: the 11x11 SAD at 11
    disparities, the argmin (lowest index on ties), the parabola and its
    gates. levels_l, levels_r: the two pyramids, f32 [h, w] each, the same
    shapes; lvl, yl, xl, ur0: int32[N], already clipped to each level.
    Returns (ur_lvl f32[N], sad_best f32[N], delta_ok bool[N]).
    CUDA tensors -> one launch of kernel `csrc/stereo_sad.cu`; CPU ->
    `refine_subpixel_sad_plain`."""
    if not levels_l[0].is_cuda:
        return refine_subpixel_sad_plain(levels_l, levels_r, lvl, yl, xl, ur0)
    n = len(levels_l)
    if len(levels_r) != n:
        raise ValueError(f"stereo_sad: {n} left levels, {len(levels_r)} "
                         "right")
    if n > kernels.MAX_LEVELS:
        raise ValueError(f"stereo_sad: {n} levels, the kernel takes at most "
                         f"{kernels.MAX_LEVELS}")
    for a, b in zip(levels_l, levels_r):
        kernels.require(a, "stereo_sad left level", torch.float32)
        kernels.require(b, "stereo_sad right level", torch.float32,
                        a.shape)
        if a.dim() != 2 or a.shape[0] < P_SAD or a.shape[1] < S_SAD:
            raise ValueError(f"stereo_sad: level {tuple(a.shape)} is not "
                             f"[h >= {P_SAD}, w >= {S_SAD}]")
    N = lvl.shape[0]
    for t, what in ((lvl, "lvl"), (yl, "yl"), (xl, "xl"), (ur0, "ur0")):
        kernels.require(t, f"stereo_sad {what}", torch.int32, (N,))
    dev = levels_l[0].device
    ur_lvl = torch.empty((N,), dtype=torch.float32, device=dev)
    sad_best = torch.empty((N,), dtype=torch.float32, device=dev)
    delta_ok = torch.empty((N,), dtype=torch.bool, device=dev)
    fn = kernels.bind("stereo_sad", "stereo_sad",
                      [kernels.CI] + [kernels.VP] * 7 + [kernels.CI]
                      + [kernels.VP] * 4)
    kernels.LAUNCHES["stereo_sad"] += 1
    kernels.check(fn(n, kernels.ptr_array(levels_l),
                     kernels.ptr_array(levels_r),
                     kernels.int_array([d for a in levels_l for d in a.shape]),
                     kernels.ptr(lvl), kernels.ptr(yl), kernels.ptr(xl),
                     kernels.ptr(ur0), N, kernels.ptr(ur_lvl),
                     kernels.ptr(sad_best), kernels.ptr(delta_ok),
                     kernels.stream_of(levels_l[0])), "stereo_sad")
    return ur_lvl, sad_best, delta_ok


def level_coordinates(levels, l_xy, l_level, u_right, scale_factors):
    """The integer coordinates the SAD search starts from, at each
    keypoint's own level (clipped to that level's height and width):
    (lvl, yl, xl, ur0), int32[N] each. `round` is half-to-even, as
    `jnp.round`."""
    L = len(levels)
    dev = l_xy.device
    lvl = torch.clamp(l_level.long(), 0, L - 1)
    inv = 1.0 / scale_factors[lvl]
    hh = torch.tensor([lv.shape[0] for lv in levels], device=dev)[lvl]
    ww = torch.tensor([lv.shape[1] for lv in levels], device=dev)[lvl]

    def clip_round(v, lo, hi):
        return torch.minimum(torch.clamp(torch.round(v * inv).long(),
                                         min=lo), hi).to(torch.int32)

    yl = clip_round(l_xy[:, 1], W_SAD, hh - W_SAD - 1)
    xl = clip_round(l_xy[:, 0], W_SAD, ww - W_SAD - 1)
    ur0 = clip_round(u_right, W_SAD + R_SAD, ww - W_SAD - R_SAD - 1)
    return lvl.to(torch.int32), yl, xl, ur0


def refine_subpixel_pyramid(levels_l, levels_r, l_xy, l_level, u_right,
                            valid, bf: float, scale_factors):
    """Per-level SAD refinement with the reference's octave semantics: the
    coordinates scale into the keypoint's pyramid level, the 11x11 window
    slides there (kernel B9's SAD-only entry, `refine_subpixel_sad`), and
    the result scales back. Then the gates (disparity in (0.01, bf),
    |delta| <= 1, no border argmin) and the SAD-median outlier filter
    (1.5 * 1.4 x the median of the accepted SADs; none accepted -> no
    filter). Returns (u_right f32[N], depth f32[N], ok bool[N]), -1 where
    rejected."""
    return _refine_pyramid(refine_subpixel_sad, levels_l, levels_r, l_xy,
                           l_level, u_right, valid, bf, scale_factors)


def _refine_pyramid(sad, levels_l, levels_r, l_xy, l_level, u_right, valid,
                    bf: float, scale_factors):
    """`refine_subpixel_pyramid` with the SAD search `sad`."""
    lvl, yl, xl, ur0 = level_coordinates(levels_l, l_xy, l_level, u_right,
                                         scale_factors)
    ur_lvl, sad_best, delta_ok = sad(levels_l, levels_r, lvl, yl, xl, ur0)
    ur_ref = ur_lvl * scale_factors[lvl.long()]  # back to level 0
    disparity = l_xy[:, 0] - ur_ref
    good = valid & (disparity > 0.01) & (disparity < bf) & delta_ok
    med = _nanmedian_midpoint(torch.where(
        good, sad_best, torch.full_like(sad_best, float("nan"))))
    med = torch.where(torch.isnan(med), torch.full_like(med, float("inf")),
                      med)
    good = good & (sad_best < 1.5 * 1.4 * med)
    neg = torch.full_like(ur_ref, -1.0)
    depth = torch.where(
        good, _f32(bf, disparity) / torch.clamp(disparity, min=0.01), neg)
    return torch.where(good, ur_ref, neg), depth, good


# ---------------------------------------------------------------------------
# the whole association after K1 (kernel B9, one launch)
# ---------------------------------------------------------------------------

def stereo_associate(levels_l, levels_r, l_xy, l_level, l_desc, l_valid,
                     r_xy, r_level, r_desc, r_valid, scale_factors, bf: float,
                     min_z: float, max_dist: int = hamming.TH_HIGH):
    """The stereo association of a frame: for each left feature (l_xy f32[N,
    2], l_level i32[N], l_desc i32[N, 8], l_valid bool[N]) its match among
    the right ones (r_*, M of them) and its sub-pixel refinement on the two
    pyramids (levels_l, levels_r: f32 [h, w] each, the same shapes).
    Returns (u_right f32[N], depth f32[N], ok bool[N]), -1 where rejected:
    `stereo_match` then `refine_subpixel_pyramid`. The gate and K1, then
    `associate_from_best2`: on CUDA tensors one launch of kernel
    `csrc/stereo_sad.cu`, on CPU tensors its plain version (so the whole is
    `stereo_associate_plain`)."""
    idx, best = _band_best2(l_xy, l_level, l_desc, l_valid, r_xy, r_level,
                            r_desc, r_valid, scale_factors, bf, min_z)
    return associate_from_best2(levels_l, levels_r, l_xy, l_level, r_xy,
                                idx, best, scale_factors, bf, max_dist)


def stereo_associate_plain(levels_l, levels_r, l_xy, l_level, l_desc,
                           l_valid, r_xy, r_level, r_desc, r_valid,
                           scale_factors, bf: float, min_z: float,
                           max_dist: int = hamming.TH_HIGH):
    """`stereo_associate` as the JAX package computes it, after K1 in plain
    torch: `stereo_match` then `refine_subpixel_pyramid` with the plain SAD
    (`associate_from_best2_plain`). The reference of the kernel on the
    card."""
    idx, best = _band_best2(l_xy, l_level, l_desc, l_valid, r_xy, r_level,
                            r_desc, r_valid, scale_factors, bf, min_z)
    return associate_from_best2_plain(levels_l, levels_r, l_xy, l_level,
                                      r_xy, idx, best, scale_factors, bf,
                                      max_dist)


def associate_from_best2_plain(levels_l, levels_r, l_xy, l_level, r_xy, idx,
                               best, scale_factors, bf: float,
                               max_dist: int = hamming.TH_HIGH):
    """Plain PyTorch version of kernel `csrc/stereo_sad.cu`'s association:
    `stereo_match`'s tail after K1's (idx, best), then
    `refine_subpixel_pyramid` with the plain SAD. The outputs are bit-equal
    to the kernel's. One intermediate is not: a keypoint that fails the
    distance median has u_right = -1 here, so its SAD is taken at the
    clipped -1, where the kernel takes it at the matched u; such rows are
    rejected in both."""
    if l_xy.shape[0] == 0:
        neg = l_xy.new_empty((0,))
        return neg, neg.clone(), torch.zeros_like(neg, dtype=torch.bool)
    u_right, _, ok = _match_tail(l_xy, r_xy, idx, best, bf, max_dist)
    return _refine_pyramid(refine_subpixel_sad_plain, levels_l, levels_r,
                           l_xy, l_level, u_right, ok, bf, scale_factors)


MAX_ASSOC = 32768  # keypoints a call: the last block's keys in shared memory
_VP, _CI = kernels.VP, kernels.CI
# the C entry `stereo_associate`'s argument types
_ASSOC_ARGS = ([_CI] + [_VP] * 4 + [kernels.CF, _CI, _CI] + [_VP] * 3
               + [_CI] + [_VP] * 2 + [_CI] + [_VP] * 3)
_F32, _I32 = torch.float32, torch.int32


def _check_associate(levels_l, levels_r, l_xy, l_level, r_xy, idx, best,
                     scale_factors):
    """Refuses what kernel `stereo_associate` does not take (every tensor
    contiguous, of its dtype and shape, on l_xy's card); returns the C
    table of the levels' (h, w). Runs on every call: one attribute pass
    over the 22 tensors, no message built unless one is refused."""
    n = len(levels_l)
    if len(levels_r) != n:
        raise ValueError(f"stereo_sad: {n} left levels, {len(levels_r)} "
                         "right")
    if not 1 <= n <= kernels.MAX_LEVELS:
        raise ValueError(f"stereo_sad: {n} levels, the kernel takes 1 to "
                         f"{kernels.MAX_LEVELS}")
    N, M = l_xy.shape[0], r_xy.shape[0]
    if N > MAX_ASSOC:
        raise ValueError(f"stereo_sad: {N} keypoints, the kernel takes at "
                         f"most {MAX_ASSOC}")
    if N > 0 and M < 1:
        raise ValueError("stereo_sad: keypoints to match and no right one")
    want = [("l_xy", l_xy, _F32, (N, 2)), ("r_xy", r_xy, _F32, (M, 2)),
            ("l_level", l_level, _I32, (N,)), ("idx", idx, _I32, (N,)),
            ("best", best, _I32, (N,)),
            ("scale_factors", scale_factors, _F32, (n,))]
    dims = []
    for a, b in zip(levels_l, levels_r):
        s = a.shape
        if len(s) != 2 or s[0] < P_SAD or s[1] < S_SAD:
            raise ValueError(f"stereo_sad: level {tuple(s)} is not "
                             f"[h >= {P_SAD}, w >= {S_SAD}]")
        dims += s
        want += (("left level", a, _F32, None), ("right level", b, _F32, s))
    card = l_xy.get_device()
    for what, t, dtype, shape in want:
        if (t.get_device() != card or t.dtype is not dtype
                or (shape is not None and t.shape != shape)
                or not t.is_contiguous()):
            raise ValueError(
                f"stereo_sad {what}: expected a contiguous {dtype} "
                f"{tuple(shape or t.shape)} on cuda:{card}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}")
    return kernels.int_array(dims)


def associate_from_best2(levels_l, levels_r, l_xy, l_level, r_xy, idx, best,
                         scale_factors, bf: float,
                         max_dist: int = hamming.TH_HIGH):
    """Everything after K1's best-2 (idx, best: i32[N]) in one launch:
    `stereo_match`'s tail and `refine_subpixel_pyramid` (see
    `stereo_associate`). scale_factors: f32[L], one a level. Returns
    (u_right f32[N], depth f32[N], ok bool[N]), views of one allocation.
    CUDA tensors -> kernel `csrc/stereo_sad.cu`, no host read and no upload;
    CPU -> `associate_from_best2_plain`."""
    if not l_xy.is_cuda:
        return associate_from_best2_plain(levels_l, levels_r, l_xy, l_level,
                                          r_xy, idx, best, scale_factors, bf,
                                          max_dist)
    dims = _check_associate(levels_l, levels_r, l_xy, l_level, r_xy, idx,
                            best, scale_factors)
    N = l_xy.shape[0]
    dev = l_xy.device
    # rows: u_right, depth, the kernel's SAD scratch, ok (N bytes of it)
    out = torch.empty((4, N), dtype=torch.float32, device=dev)
    u_right, depth, _, ok = out.unbind(0)
    views = (u_right, depth, ok.view(torch.bool)[:N])
    if N == 0:  # nothing to launch
        return views
    fn = kernels.bind("stereo_sad", "stereo_associate", _ASSOC_ARGS)
    kernels.LAUNCHES["stereo_sad"] += 1
    kernels.check(fn(len(levels_l), kernels.ptr_array(levels_l),
                     kernels.ptr_array(levels_r), dims,
                     scale_factors.data_ptr(), bf, max_dist, hamming.BIG,
                     l_xy.data_ptr(), l_level.data_ptr(), r_xy.data_ptr(),
                     r_xy.shape[0], idx.data_ptr(), best.data_ptr(), N,
                     out.data_ptr(),
                     # the ticket, and an f32 of scratch after it
                     kernels.ticket(dev, "stereo_sad", 2).data_ptr(),
                     kernels.stream_of(l_xy)), "stereo_sad")
    return views


def refine_subpixel(img_l, img_r, l_xy, u_right, valid, bf: float):
    """SAD + parabola sub-pixel refinement on the level-0 images for every
    match at once (the JAX package's first variant; the tracker uses
    `refine_subpixel_pyramid`): the argmin's parabola offset is clipped to
    +-1 and a flat valley gives 0, with no border or median gate. Plain
    torch. Returns (u_right f32[N], depth f32[N], ok bool[N])."""
    img_l, img_r = img_l.to(torch.float32), img_r.to(torch.float32)
    H, W = img_l.shape
    yl = torch.clamp(torch.round(l_xy[:, 1]).long(), W_SAD, H - W_SAD - 1)
    xl = torch.clamp(torch.round(l_xy[:, 0]).long(), W_SAD, W - W_SAD - 1)
    ur0 = torch.clamp(torch.round(u_right).long(), W_SAD + R_SAD,
                      W - W_SAD - R_SAD - 1)
    _, bi, _, delta = _parabola(
        _sads_plain([img_l], [img_r], torch.zeros_like(yl), yl, xl, ur0),
        flat=0.0)
    ur_ref = ((ur0.to(torch.float32) + (bi - R_SAD).to(torch.float32))
              + torch.clamp(delta, -1.0, 1.0))
    disparity = l_xy[:, 0] - ur_ref
    good = valid & (disparity > 0.01) & (disparity < bf)
    neg = torch.full_like(ur_ref, -1.0)
    depth = torch.where(
        good, _f32(bf, disparity) / torch.clamp(disparity, min=0.01), neg)
    return torch.where(good, ur_ref, neg), depth, good
