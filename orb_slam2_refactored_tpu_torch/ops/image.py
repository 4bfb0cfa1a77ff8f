"""Image-space primitives: grayscale, pyramid resize, Gaussian blur.

Port of `orb_slam2_refactored_tpu/ops/image.py`.

The pyramid resize reproduces `jax.image.resize(method="linear")`, which
low-pass filters when it downsamples: a triangle kernel stretched by the
downsampling factor. `F.interpolate(mode="bilinear", antialias=False)` is
not that function (it is off by tens of gray levels), so each axis here is
one product with the same f32 weight matrix that JAX builds
(`jax/_src/image/scale.py::compute_weight_mat`); only the summation order
of the two products differs from XLA's.

`build_pyramid` runs kernel K8 (`csrc/pyramid.cu`, one launch a frame for
every level) on a CUDA image and the plain version, `build_pyramid_plain`,
on a CPU image. K8 reads each weight matrix as a table of its nonzero
taps (`resize_taps`), uploaded once per size and device. The card's f32
GEMM, which the plain version runs there, does not add an output's taps
in one chain: it adds partial sums of 8-wide blocks of its K loop, or of
split-K slices, as its heuristics choose for the shape. So on a CUDA
device each table also records, per output, where the GEMM splits its
taps (`gemm_tap_splits`, found once per shape by a probe of the GEMM),
and K8 adds the two partial chains there: its levels then equal the plain
version's bit for bit. The probes run on the card, so a geometry's tables
are built once, before its first frame: `prepare_pyramid`, which
`OrbExtractor` calls when it is given a CUDA device (the tracker gives it
its own). The same plan holds K8's work split (`pyramid_schedule`): a
block a part of the deepest level, which computes from level 0 the region
of every level its part needs, so no block waits on another.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels


def to_gray(img):
    """RGB[H,W,3] (or gray[H,W]) uint8/float tensor -> float32 gray [H,W]."""
    if img.ndim == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                         device=img.device)
        img = torch.tensordot(img.to(torch.float32), w, dims=([-1], [0]))
    return img.to(torch.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """f32[in, out] linear-resize weights, computed in f32 step by step as
    `compute_weight_mat(..., kernel=triangle, antialias=True)` does once
    XLA has compiled it: the sample position is one fused multiply-add and
    the kernel-scale division a multiply by its reciprocal. (Written as in
    the JAX source instead, the weights differ by up to 2e-5, which moves
    upper-level FAST responses and reorders keypoints.)"""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    pos = np.arange(out_size, dtype=f32) + f32(0.5)
    sample_f = (pos.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    d = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    x = d * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > f32(1000.0) * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img, out_hw: Tuple[int, int]):
    """Linear resize of a [H,W] float image (antialiased when shrinking)."""
    h, w = img.shape
    oh, ow = out_hw
    out = img
    if oh != h:
        wh = torch.as_tensor(_resize_weights_np(h, oh), device=img.device)
        out = wh.T @ out
    if ow != w:
        ww = torch.as_tensor(_resize_weights_np(w, ow), device=img.device)
        out = out @ ww
    return out


def pyramid_shapes(h: int, w: int, n_levels: int,
                   scale_factor: float) -> List[Tuple[int, int]]:
    shapes = []
    for l in range(n_levels):
        s = scale_factor ** l
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


def build_pyramid_plain(img, n_levels: int, scale_factor: float):
    """Plain PyTorch version of kernel K8: list of per-level images, level
    0 = input resolution; each level is resized from the previous one, like
    the reference's cascade."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


def build_pyramid(img, n_levels: int, scale_factor: float):
    """List of per-level f32 images, level 0 = `img` itself; each level is
    resized from the previous one, like the reference's cascade. One launch
    of kernel K8 (`pyramid_levels`) on a CUDA image, the plain version on a
    CPU image."""
    if not img.is_cuda:
        return build_pyramid_plain(img, n_levels, scale_factor)
    return pyramid_levels(img, n_levels, scale_factor)


# ---------------------------------------------------------------------------
# Kernel K8: the whole pyramid in one launch
# ---------------------------------------------------------------------------

PYR_MAX_TAPS = 8  # taps an output may have (`kMaxTaps` in csrc/pyramid.cu)


@functools.lru_cache(maxsize=64)
def resize_taps(in_size: int, out_size: int):
    """K8's table of one axis, int32[out, 5] and f32[out, PYR_MAX_TAPS]:
    per output index o its first input index, its tap count (from its
    first to its last nonzero weight of `_resize_weights_np`, zeros between
    kept), the least first index of the outputs from o on and the largest
    end (first + count) of the outputs up to o, which bound the inputs a
    run of outputs reads (`axis_parts`), and the count of taps in its
    first partial chain (here all of them: one chain); then the taps. An
    axis the resize keeps (in == out; the plain version skips its product)
    is one tap of 1.0 an output, an exact copy."""
    if in_size == out_size:
        wm = np.eye(in_size, dtype=np.float32)
    else:
        wm = _resize_weights_np(in_size, out_size)
    nz = wm != 0
    has = nz.any(axis=0)
    first = np.where(has, nz.argmax(axis=0), 0)
    last = np.where(has, in_size - 1 - nz[::-1].argmax(axis=0), -1)
    count = np.where(has, last - first + 1, 0)
    if count.max(initial=0) > PYR_MAX_TAPS:
        raise ValueError(f"pyramid: a {in_size} -> {out_size} resize needs "
                         f"{count.max()} taps, K8 takes {PYR_MAX_TAPS}")
    cols = np.arange(out_size)
    taps = np.zeros((out_size, PYR_MAX_TAPS), np.float32)
    for t in range(PYR_MAX_TAPS):
        m = t < count
        taps[m, t] = wm[first[m] + t, cols[m]]
    lo = np.minimum.accumulate(np.where(has, first, in_size)[::-1])[::-1]
    hi = np.maximum.accumulate(np.where(has, first + count, 0))
    idx = np.stack([first, count, lo, hi, count], axis=1).astype(np.int32)
    return idx, taps


def fmaf_np(a, b, c):
    """Correctly rounded f32 fused multiply-add of f32 arrays (`fmaf`), in
    numpy: the product is exact in f64, the f64 sum's error is recovered
    exactly (TwoSum), and it decides the one case the f64 sum cannot: a sum
    that lands on the midpoint of two f32 values."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    nb = np.nextafter(r, np.where(d > 0, np.float32(np.inf),
                                  np.float32(-np.inf))).astype(np.float32)
    tie = (d != 0) & (2 * s == r.astype(np.float64) + nb.astype(np.float64))
    return np.where(tie & (err * d > 0), nb, r)


def tap_sums_np(x, idx, taps, split=None):
    """K8's sums along one axis, exactly, in numpy: x f32[in, m] ->
    f32[out, m]; output o adds taps [0, s) as one `fmaf` chain from the
    first product and taps [s, count) as another, then the two (s =
    `split[o]`, by default the table's own)."""
    first, count = idx[:, 0], idx[:, 1]
    split = idx[:, 4] if split is None else split

    def chain(lo, hi):
        acc = np.zeros((idx.shape[0], x.shape[1]), np.float32)
        for t in range(taps.shape[1]):
            start = np.nonzero((t == lo) & (t < hi))[0]
            acc[start] = (taps[start, t, None].astype(np.float64)
                          * x[first[start] + t]).astype(np.float32)
            more = np.nonzero((t > lo) & (t < hi))[0]
            acc[more] = fmaf_np(taps[more, t, None], x[first[more] + t],
                                acc[more])
        return acc

    a = chain(0, split)
    two = np.nonzero(split < count)[0]
    a[two] = fmaf_np(np.float32(1.0), a[two], chain(split, count)[two])
    return a


def infer_tap_splits(xs, rs, idx, taps):
    """Where a GEMM split each output's taps, from probes `xs` (each
    f32[in, m]) and its results `rs` (f32[out, m]): first, per output, the
    first split s (no split first, then 1, 2, ...) for which `tap_sums_np`
    equals the result bit for bit; then, since the GEMM splits its K loop
    at the same input indices for every output, every output is split at
    the first of those indices found inside its taps (an output with a
    near-zero tap agrees with several splits on almost every input), kept
    where it explains the result too. Returns int32[out] and the count of
    outputs that nothing explains (they keep one chain)."""
    x, r = np.concatenate(xs, axis=1), np.concatenate(rs, axis=1)
    first, count = idx[:, 0], idx[:, 1]

    def explains(rows, split):
        return (tap_sums_np(x, idx[rows], taps[rows], split)
                == r[rows]).all(axis=1)

    every = np.arange(idx.shape[0])
    best = count.copy()
    found = explains(every, count)
    for s in range(1, taps.shape[1]):
        rows = np.nonzero(~found & (s < count))[0]
        if rows.size:
            ok = explains(rows, np.full(rows.size, s))
            best[rows[ok]] = s
            found[rows[ok]] = True
    cuts = np.unique((first + best)[found & (best < count)])
    # each output's first cut past its first tap
    nxt = np.append(cuts, np.iinfo(np.int32).max)[
        np.searchsorted(cuts, first + 1)]
    split = np.where(nxt < first + count, nxt - first, count)
    ok = found & (split == best)
    rows = np.nonzero(~ok)[0]
    ok[rows] = explains(rows, split[rows])
    split = np.where(ok, split, best)
    return split.astype(np.int32), int((~(ok | found)).sum())


PROBE_COLUMNS = 1024

# outputs whose GEMM sum no single split explained, by (in, out, other,
# axis, device): they keep one chain, and K8 may differ there in the last
# bit from the plain version
SPLIT_MISSES = {}


@functools.lru_cache(maxsize=128)
def gemm_tap_splits(in_size: int, out_size: int, other: int, vertical: bool,
                    device_str: str) -> np.ndarray:
    """Where the device's f32 GEMM splits each output's taps in the plain
    version's product of this shape: `wh.T @ x` with x [in, other]
    (`vertical`) or `x @ ww` with x [other, in]. Probes of uniform random
    gray values through the same product, at least two and PROBE_COLUMNS
    columns in all (a wrong split agrees with the GEMM on a column now and
    then, on all of thousands almost never), each result explained output
    by output (`infer_tap_splits`). Once per shape and device."""
    idx, taps = resize_taps(in_size, out_size)
    if in_size == out_size:
        return idx[:, 4].copy()
    dev = torch.device(device_str)
    wm = torch.as_tensor(_resize_weights_np(in_size, out_size), device=dev)
    rng = np.random.default_rng(in_size * 7919 + out_size)
    xs, rs = [], []
    for _ in range(max(2, -(-PROBE_COLUMNS // other))):
        if vertical:
            x = rng.uniform(0, 255, (in_size, other)).astype(np.float32)
            r = (wm.T @ torch.as_tensor(x, device=dev)).cpu().numpy()
        else:
            x = rng.uniform(0, 255, (other, in_size)).astype(np.float32)
            r = (torch.as_tensor(x, device=dev) @ wm).cpu().numpy().T
            x = x.T
        xs.append(np.ascontiguousarray(x))
        rs.append(r)
    split, misses = infer_tap_splits(xs, rs, idx, taps)
    SPLIT_MISSES[(in_size, out_size, other, vertical, device_str)] = misses
    return split


PYR_SMS = 132  # SMs of the H100: the schedule of a plan built off the card
PYR_SMEM = 232448  # bytes of shared memory a block may use on the H100


@functools.lru_cache(maxsize=128)
def _tap_records(in_size: int, out_size: int, other: int, vertical: bool,
                 device_str: str) -> torch.Tensor:
    """One axis's table in K8's layout on a device, int32[out, 12]: per
    output its first input index, its tap count, its split (on a CUDA
    device the GEMM's of this shape, `gemm_tap_splits`; elsewhere one
    chain) and a pad, then its PYR_MAX_TAPS taps as f32 bits: three
    16-byte loads an output."""
    idx, taps = resize_taps(in_size, out_size)
    split = idx[:, 4]
    if torch.device(device_str).type == "cuda":
        split = gemm_tap_splits(in_size, out_size, other, vertical,
                                device_str)
    rec = np.zeros((out_size, 4 + PYR_MAX_TAPS), np.int32)
    rec[:, 0], rec[:, 1], rec[:, 2] = idx[:, 0], idx[:, 1], split
    rec[:, 4:] = taps.view(np.int32)
    return torch.as_tensor(rec, device=torch.device(device_str))


def axis_parts(sizes, idxs, g: int) -> np.ndarray:
    """One axis of K8's schedule: the deepest level's `sizes[-1]` outputs
    cut into g parts, each followed up to level 0. int64[g, levels, 4]: per
    part and level the outputs the part computes, [need lo, need hi), and
    those it writes, [own lo, own hi). `idxs[l]` is `resize_taps`'s index
    of the resize from level l to l + 1. A part owns at level l the outputs
    from the least first tap of its first owned output at level l + 1 on,
    so the parts' owned outputs cover every level once; it needs its owned
    outputs and every input its needed outputs at level l + 1 read (the
    hull of the two). Level 0 is read, never written: it owns nothing
    there."""
    n = len(sizes)
    out = np.zeros((g, n, 4), np.int64)
    bounds = np.arange(g + 1, dtype=np.int64) * sizes[-1] // g
    out[:, -1] = np.stack([bounds[:-1], bounds[1:]] * 2, axis=1)
    for l in range(n - 2, -1, -1):
        idx = idxs[l]
        if l > 0:
            inner = bounds[1:-1]
            bounds = np.concatenate([[0], np.where(
                inner < sizes[l + 1],
                idx[np.minimum(inner, sizes[l + 1] - 1), 2], sizes[l]),
                [sizes[l]]]).astype(np.int64)
            own_lo, own_hi = bounds[:-1], bounds[1:]
        else:
            own_lo = own_hi = np.zeros(g, np.int64)
        a, c = out[:, l + 1, 0], out[:, l + 1, 1]
        some = c > a
        lo = np.where(some, idx[np.minimum(a, sizes[l + 1] - 1), 2], 0)
        hi = np.where(some, idx[np.maximum(c - 1, 0), 3], 0)
        span = hi > lo
        own = own_hi > own_lo
        need_lo = np.where(span & own, np.minimum(lo, own_lo),
                           np.where(span, lo, own_lo))
        need_hi = np.where(span & own, np.maximum(hi, own_hi),
                           np.where(span, hi, own_hi))
        out[:, l] = np.stack([need_lo, np.maximum(need_hi, need_lo), own_lo,
                              own_hi], axis=1)
    return out


def pyramid_schedule(shapes, n_sm: int = PYR_SMS):
    """K8's work split for a pyramid of `shapes`: a grid of gy x gx blocks
    over the deepest level, block (by, bx) taking row part by and column
    part bx of `axis_parts` at every level. Of the grids of at most 4 x
    n_sm blocks whose shared memory fits a block (the tap records of its
    needed rows and columns of every level, two buffers of the largest
    needed region and one of the largest vertical sums), the one whose
    slowest block computes the fewest outputs (a level's vertical sums and
    outputs, level 0's staged pixels), times the waves of n_sm blocks it
    takes. Where no grid under that cap fits (a frame past ~2560x1440:
    3840x2160 takes ~800 blocks), the cap doubles until one does; the
    deepest level's pixels bound it, and past them the geometry raises.
    Returns (rows [gy, levels, 4], cols [gx, levels, 4], records, region
    floats, sums floats)."""
    rows = [s[0] for s in shapes]
    cols = [s[1] for s in shapes]
    ridx = [resize_taps(a, b)[0] for a, b in zip(rows[:-1], rows[1:])]
    cidx = [resize_taps(a, b)[0] for a, b in zip(cols[:-1], cols[1:])]
    r_parts, c_parts = {}, {}
    most = 4 * n_sm
    while True:
        best = _best_grid(rows, cols, ridx, cidx, r_parts, c_parts, most,
                          n_sm)
        if best is not None:
            return best[1:]
        if most >= rows[-1] * cols[-1]:
            raise ValueError(f"pyramid: no work split of {shapes} fits a "
                             f"block's shared memory, up to a grid of "
                             f"{most} blocks")
        most *= 2


def _best_grid(rows, cols, ridx, cidx, r_parts, c_parts, most: int,
               n_sm: int):
    """`pyramid_schedule`'s search among the grids of at most `most`
    blocks; each axis's parts, with their per-part output counts, their
    largest count a level and their most records, are kept in `r_parts`
    and `c_parts` by the parts' number across searches. None where no grid
    fits."""
    for sizes, idxs, parts in ((rows, ridx, r_parts), (cols, cidx, c_parts)):
        for g in range(1, min(sizes[-1], most) + 1):
            if g not in parts:
                p = axis_parts(sizes, idxs, g)
                n = p[:, :, 1] - p[:, :, 0]
                parts[g] = (p, n, n.max(0), int(n[:, 1:].sum(1).max()))
    best = None
    for gy in range(1, min(rows[-1], most) + 1):
        rp, ny, ny_max, ny_rec = r_parts[gy]
        for gx in range(1, min(cols[-1], most // gy) + 1):
            cp, nx, nx_max, nx_rec = c_parts[gx]
            records = ny_rec + nx_rec
            region = int((ny_max * nx_max).max())
            sums = int((ny_max[1:] * nx_max[:-1]).max(initial=0))
            if 48 * records + 4 * (2 * region + sums) > PYR_SMEM:
                continue
            work = (ny[:, :1] * nx[:, :1].T + ny[:, 1:] @ (
                nx[:, :-1] + nx[:, 1:]).T)
            score = (-(-gy * gx // n_sm) * int(work.max()), gy * gx)
            if best is None or score < best[0]:
                best = (score, rp, cp, records, region, sums)
    return best


class PyramidPlan(NamedTuple):
    shapes: List[Tuple[int, int]]
    offsets: List[int]     # each level's first float in the buffer (1..n-1)
    total: int             # floats of the buffer
    rows: np.ndarray       # the schedule (`pyramid_schedule`)
    cols: np.ndarray
    tables: List[torch.Tensor]  # on the device: per level 1..n-1 the
    # vertical and horizontal records, then the rows and cols schedule
    args: tuple            # the C arrays and sizes of a launch


def buffer_offsets(shapes) -> Tuple[List[int], int]:
    """Each [h, w] level's first float in kernel K8's one buffer of levels
    1 to n-1 (`shapes` from level 1 on), every level at a 16-byte-aligned
    offset for kernel K2's vector loads, and the buffer's floats."""
    offsets, total = [], 0
    for a, b in shapes:
        offsets.append(total)
        total += -(-a * b // 4) * 4
    return offsets, total


@functools.lru_cache(maxsize=32)
def _pyramid_plan(h: int, w: int, n_levels: int, scale_factor: float,
                  device_str: str) -> PyramidPlan:
    """Shapes, the buffer's layout (each level at a 16-byte-aligned offset,
    for kernel K2's vector loads), the tap records and the work split of
    one geometry on one device, uploaded once."""
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    offsets, total = buffer_offsets(shapes[1:])
    tables = []
    for (ih, iw), (oh, ow) in zip(shapes[:-1], shapes[1:]):
        if oh < 1 or ow < 1:
            raise ValueError(f"pyramid: level {ih}x{iw} -> {oh}x{ow}")
        tables += [_tap_records(ih, oh, iw, True, device_str),
                   _tap_records(iw, ow, oh, False, device_str)]
    dev = torch.device(device_str)
    n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else PYR_SMS)
    rows, cols, records, region, sums = pyramid_schedule(shapes, n_sm)
    tables += [torch.as_tensor(rows.astype(np.int32), device=dev),
               torch.as_tensor(cols.astype(np.int32), device=dev)]
    args = (kernels.int_array([d for s in shapes for d in s]),
            kernels.int_array(offsets),
            (ctypes.c_void_p * (len(tables) - 2))(
                *[t.data_ptr() for t in tables[:-2]]),
            ctypes.c_void_p(tables[-2].data_ptr()),
            ctypes.c_void_p(tables[-1].data_ptr()), rows.shape[0],
            cols.shape[0], records, region, sums)
    return PyramidPlan(shapes, offsets, total, rows, cols, tables, args)


def prepare_pyramid(h: int, w: int, n_levels: int, scale_factor: float,
                    device) -> PyramidPlan:
    """Build and upload K8's tables of an [h, w] geometry on `device` now
    (on a CUDA device with the GEMM's splits, ~1.3 s of probes for VGA's 14
    products), so that no frame pays for them; cached, as `pyramid_levels`
    finds them."""
    dev = torch.empty(0, device=device).device  # "cuda" -> "cuda:<index>"
    return _pyramid_plan(h, w, n_levels, float(scale_factor), str(dev))


def pyramid_levels(img, n_levels: int, scale_factor: float):
    """Kernel K8 on a CUDA f32 [H, W] image: levels 1 to n-1 written into
    one device buffer in one launch, no block waiting on another (each
    computes from level 0 the regions its outputs need); returns `img` and
    views of the buffer with the shapes of `pyramid_shapes`. The geometry's
    tables come from `prepare_pyramid`, built here if it was not called.
    Raises where the kernel does not take the arguments; never falls
    back."""
    kernels.require(img, "pyramid level 0", torch.float32)
    if img.dim() != 2:
        raise ValueError("pyramid: level 0 must be [h, w]")
    if not 1 <= n_levels <= kernels.MAX_LEVELS:
        raise ValueError(f"pyramid: {n_levels} levels, the kernel takes 1 "
                         f"to {kernels.MAX_LEVELS}")
    if n_levels == 1:
        return [img]
    h, w = img.shape
    plan = _pyramid_plan(h, w, n_levels, float(scale_factor), str(img.device))
    buf = torch.empty((plan.total,), dtype=torch.float32, device=img.device)
    levels = [img] + [buf.as_strided((a, b), (b, 1), o) for o, (a, b) in
                      zip(plan.offsets, plan.shapes[1:])]
    fn = kernels.bind("pyramid", "pyramid_levels",
                      [kernels.CI] + [kernels.VP] * 7 + [kernels.CI] * 5
                      + [kernels.VP])
    kernels.LAUNCHES["pyramid"] += 1
    kernels.check(fn(n_levels, kernels.ptr(img), kernels.ptr(buf), *plan.args,
                     kernels.stream_of(img)), "pyramid_levels")
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _gaussian_pass(p, k, n: int, dim: int):
    """One 7-tap pass along `dim` of the padded image `p`, giving `n`
    samples: the taps' products rounded one by one and added in tap order
    (no fused multiply-add), the order kernel K7 (`csrc/orb_desc_learned.cu`)
    sums them in, so the two agree bit for bit."""
    acc = k[0] * p.narrow(dim, 0, n)
    for t in range(1, k.shape[0]):
        acc = acc + k[t] * p.narrow(dim, t, n)
    return acc


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur of an f32 [H,W] image, borders mirrored
    without repeating the edge (`jnp.pad(mode="reflect")`: -1 -> 1): a
    horizontal, then a vertical pass. The pre-descriptor blur of the
    reference (GaussianBlur(7,7,2,2), `src/ORBextractor.cc:791`)."""
    k = torch.as_tensor(_gaussian_kernel(ksize, sigma), device=img.device)
    r = ksize // 2
    h, w = img.shape
    p = torch.nn.functional.pad(img[None, None].to(torch.float32),
                                (r, r, r, r), mode="reflect")[0, 0]
    return _gaussian_pass(_gaussian_pass(p, k, w, 1), k, h, 0)
