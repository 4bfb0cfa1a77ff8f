"""FAST-9/16 corner strength, two-threshold cell fallback and 3x3 NMS.

Port of `orb_slam2_refactored_tpu/ops/fast.py`. `detect_and_rank` runs
them, the edge margin and the per-cell rank rounds of `select_spread_topk`
on every pyramid level in one call of the hand-written CUDA kernel
`csrc/fast.cu` on CUDA tensors, and the plain PyTorch version below on CPU
tensors; `detect_two_threshold` is the same for one image without ranking.
The arithmetic is f32 subtract, min and max only and ties go to the lowest
index, so the kernel, the plain version and JAX agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

# Bresenham circle of radius 3 (same circle as FAST-9/16), clockwise from top.
CIRCLE_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)  # (dx, dy) pairs
ARC_LEN = 9


def _arc_min_cascade(vals):
    """f32[16,H,W] -> out[i] = min over the circular 9-window starting at i."""
    m = vals
    w2 = torch.minimum(m, torch.roll(m, -1, dims=0))
    w4 = torch.minimum(w2, torch.roll(w2, -2, dims=0))
    w8 = torch.minimum(w4, torch.roll(w4, -4, dims=0))
    return torch.minimum(w8, torch.roll(m, -8, dims=0))


def fast_strength_map(img):
    """f32[H,W]: max over the 16 circular 9-windows of min(|I_circle - I_p|),
    zeroed within 3 px of the border."""
    img = img.to(torch.float32)
    planes = torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)),
                                     dims=(0, 1))
                          for dx, dy in CIRCLE_OFFSETS])
    d = planes - img[None]
    s_bright = _arc_min_cascade(d).amax(dim=0)
    s_dark = _arc_min_cascade(-d).amax(dim=0)
    strength = torch.maximum(s_bright, s_dark)
    h, w = img.shape
    border = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    border[3:h - 3, 3:w - 3] = True
    return torch.where(border, strength, torch.zeros_like(strength))


def nms3x3(score):
    """Keep pixels >= every 8-neighbour and > 0 (ties survive)."""
    neigh = [torch.roll(score, (dy, dx), dims=(0, 1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    nmax = torch.stack(neigh).amax(dim=0)
    return torch.where(score >= torch.clamp(nmax, min=1e-9), score,
                       torch.zeros_like(score))


def cell_pool_any(mask, cell: int):
    """bool[H,W] -> bool[H,W]: per (cell x cell) tile OR, broadcast back;
    ragged edge cells are zero-padded."""
    h, w = mask.shape
    ph, pw = (-h) % cell, (-w) % cell
    m = torch.nn.functional.pad(mask.to(torch.uint8), (0, pw, 0, ph))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    tiles = m.reshape(hc, cell, wc, cell).amax(dim=(1, 3)) > 0
    back = tiles.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    return back[:h, :w]


def _margin_mask(score, margin: int):
    if margin <= 0:
        return score
    h, w = score.shape
    inb = torch.zeros((h, w), dtype=torch.bool, device=score.device)
    inb[margin:h - margin, margin:w - margin] = True
    return torch.where(inb, score, torch.zeros_like(score))


def detect_two_threshold_plain(img, ini_th: float, min_th: float,
                               cell: int = 30, margin: int = 0):
    """Plain PyTorch version of the kernel: strength once, per-cell
    fallback from `ini_th` to `min_th`, 3x3 NMS, then zero outside
    `margin` px of the border. f32[H,W] response (0 = no corner)."""
    s = fast_strength_map(img)
    hi = torch.clamp(s - ini_th, min=0.0)
    lo = torch.clamp(s - min_th, min=0.0)
    has_hi = cell_pool_any(hi > 0, cell)
    score = torch.where(has_hi, hi, lo)
    return _margin_mask(nms3x3(score), margin)


RANK_CELL = 32  # the kernel's ranking tile: one block of 1024 pixels


def n_cells(h: int, w: int, cell: int) -> int:
    """(cell x cell) tiles covering a [h,w] level, ragged edges included."""
    return -(-h // cell) * -(-w // cell)


def n_rank_rounds(h: int, w: int, k: int, cell: int = RANK_CELL,
                  rank_rounds: int = 4) -> int:
    """Rank rounds of a [h,w] level with budget k: enough that rounds x
    cells >= 6k candidates survive sparse occupancy (the JAX expression,
    which floors)."""
    return max(rank_rounds, -(-6 * k) // max(n_cells(h, w, cell), 1))


def cell_rank_rounds(score, k: int, cell: int = RANK_CELL,
                     rank_rounds: int = 4):
    """The rank rounds of `ops/orb.py::select_spread_topk`: round r takes
    each (cell x cell) tile's r-th best pixel (argmax, lowest in-tile index
    on ties, the pick then set to -1). The level is zero-padded to whole
    tiles. Returns raw f32[rounds, C] and pos int64[rounds, C] (in-tile
    index, row-major); kernel K2 computes the same in shared memory."""
    h, w = score.shape
    ph, pw = (-h) % cell, (-w) % cell
    sp = torch.nn.functional.pad(score, (0, pw, 0, ph))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    C = hc * wc
    tiles = sp.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(
        C, cell * cell).clone()
    cidx = torch.arange(C, device=score.device)
    raws, poss = [], []
    for _ in range(n_rank_rounds(h, w, k, cell, rank_rounds)):
        am = torch.argmax(tiles, dim=1)
        raws.append(tiles[cidx, am])
        poss.append(am)
        tiles[cidx, am] = -1.0
    return torch.stack(raws), torch.stack(poss)


def detect_and_rank_plain(levels, ini_th: float, min_th: float, ks,
                          cell: int = 30, margin: int = 0,
                          rank_cell: int = RANK_CELL, rank_rounds: int = 4):
    """Plain PyTorch version of kernel K2 over several levels:
    `detect_two_threshold_plain` and then `cell_rank_rounds` on each level
    (no rank rounds where k is 0)."""
    outs = []
    for lvl, k in zip(levels, ks):
        score = detect_two_threshold_plain(lvl, ini_th, min_th, cell, margin)
        if k > 0:
            raw, pos = cell_rank_rounds(score, k, rank_cell, rank_rounds)
        else:
            C = n_cells(*lvl.shape, rank_cell)
            raw = torch.empty((0, C), dtype=torch.float32, device=lvl.device)
            pos = torch.empty((0, C), dtype=torch.int64, device=lvl.device)
        outs.append((score, raw, pos.to(torch.int32)))
    return outs


class RankRounds(list):
    """`detect_and_rank`'s result: per level (score, raw, pos). On the card
    `buffers` holds the two flat buffers that every level's raw and pos
    are views of (level l at the same offset in both, the levels in
    order), which kernel K9 reads as they are
    (`ops/orb.py::spread_topk_levels`); None off the card."""

    def __init__(self, levels, buffers=None):
        super().__init__(levels)
        self.buffers = buffers


def detect_and_rank(levels, ini_th: float, min_th: float, ks,
                    cell: int = 30, margin: int = 0,
                    rank_cell: int = RANK_CELL, rank_rounds: int = 4):
    """Two-threshold FAST with per-cell fallback, 3x3 NMS and the edge
    margin (`DetectFAST` semantics) on every level of `levels`, then the
    per-cell rank rounds of `select_spread_topk` for a level whose budget
    in `ks` is above 0. Returns, per level, (score f32[h,w], raw
    f32[rounds, C], pos int32[rounds, C]), as a `RankRounds`. One call of
    kernel `csrc/fast.cu` for all the levels on CUDA tensors (which the
    caller holds until it has run); the plain version on CPU tensors."""
    if not levels[0].is_cuda:
        return RankRounds(detect_and_rank_plain(
            levels, ini_th, min_th, ks, cell, margin, rank_cell, rank_rounds))
    n = len(levels)
    if len(ks) != n:
        raise ValueError(f"fast: {len(ks)} budgets for {n} levels")
    if n > kernels.MAX_LEVELS:
        raise ValueError(f"fast: {n} levels, the kernel takes at most "
                         f"{kernels.MAX_LEVELS}")
    if rank_cell != RANK_CELL:
        raise ValueError(f"fast: the kernel ranks {RANK_CELL}-px cells, "
                         f"not {rank_cell}")
    for lvl in levels:
        kernels.require(lvl, "fast level", torch.float32)
        if lvl.dim() != 2:
            raise ValueError("fast: each level must be [h, w]")
    dev = levels[0].device
    shapes = [tuple(lvl.shape) for lvl in levels]
    cells = [n_cells(h, w, rank_cell) for h, w in shapes]
    rounds = [n_rank_rounds(h, w, k, rank_cell, rank_rounds) if k > 0 else 0
              for (h, w), k in zip(shapes, ks)]
    npx = [h * w for h, w in shapes]
    nrank = [r * c for r, c in zip(rounds, cells)]
    nflags = sum(n_cells(h, w, cell) for h, w in shapes)
    planes = torch.empty((2 * sum(npx),), dtype=torch.float32, device=dev)
    raw = torch.empty((sum(nrank),), dtype=torch.float32, device=dev)
    ints = torch.empty((nflags + sum(nrank),), dtype=torch.int32, device=dev)
    fn = kernels.bind("fast", "fast_rank_levels",
                      [kernels.CI] + [kernels.VP] * 5 + [kernels.CI] * 2
                      + [kernels.CF] * 2 + [kernels.VP])
    kernels.LAUNCHES["fast"] += 1
    kernels.check(fn(n, kernels.ptr_array(levels),
                     kernels.int_array([d for s in shapes for d in s]
                                       + rounds),
                     kernels.ptr(planes), kernels.ptr(ints), kernels.ptr(raw),
                     cell, margin, float(ini_th), float(min_th),
                     kernels.stream_of(levels[0])), "fast_rank_levels")
    scores = planes[sum(npx):].split(npx)
    pos = ints[nflags:]
    return RankRounds(
        [(s.view(h, w), r.view(nr, c), p.view(nr, c))
         for s, r, p, (h, w), nr, c in zip(scores, raw.split(nrank),
                                           pos.split(nrank), shapes, rounds,
                                           cells)], (raw, pos))


def detect_two_threshold(img, ini_th: float, min_th: float, cell: int = 30,
                         margin: int = 0):
    """Two-threshold FAST with per-cell fallback + 3x3 NMS (`DetectFAST`
    semantics) on one image: `detect_and_rank` with a list of one and no
    rank rounds (kernel `csrc/fast.cu` on CUDA, plain on CPU)."""
    if not img.is_cuda:
        return detect_two_threshold_plain(img, ini_th, min_th, cell, margin)
    return detect_and_rank([img], ini_th, min_th, [0], cell, margin)[0][0]
