"""Packed-descriptor Hamming distance: the single matching core.

Port of `orb_slam2_refactored_tpu/ops/hamming.py`. Descriptors are
int32[..., 8]. `masked_best2_gated` fuses the distance matrix, the candidate
gate and the best-2 reduction: on a CUDA tensor it launches kernel K1
(`csrc/hamming.cu`), which writes neither the [M,N] distances nor the mask;
on a CPU tensor it runs the plain version built from the functions below.
`resolve_duplicates`, `resolve_rows` and `resolve_to_points` (the claims
after K1) launch kernel R (`csrc/resolve_claims.cu`) on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import kernels

TH_LOW = 50
TH_HIGH = 100
BIG = 10_000  # sentinel distance for masked-out candidates (> 256 max)
NO_GATE = 2 ** 31 - 1  # kernel R's `max_dist` where no distance gate applies


@functools.lru_cache(maxsize=4)
def _popcount_table(device_str: str):
    return torch.tensor([bin(i).count("1") for i in range(256)],
                        dtype=torch.int32, device=device_str)


def _popcount_words(x):
    """int32[..., 8] -> int32[...]: number of set bits over the 8 words."""
    by = x.contiguous().view(torch.uint8).to(torch.int64)
    return _popcount_table(str(x.device))[by].sum(-1, dtype=torch.int32)


def hamming_matrix(a, b):
    """a: i32[M,8], b: i32[N,8] -> i32[M,N] Hamming distances."""
    return _popcount_words(torch.bitwise_xor(a[:, None, :], b[None, :, :]))


def hamming_pairwise(a, b):
    """Row-wise distance for aligned pairs: i32[...,8] x i32[...,8] -> i32[...]."""
    return _popcount_words(torch.bitwise_xor(a, b))


def masked_best2(dist, mask):
    """Best and second-best along axis 1 under a boolean mask. Returns
    (best_idx i32[M], best i32[M], second i32[M]); masked-out entries read
    as BIG; equal minima resolve to the lowest index."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best = torch.amin(d, dim=1)
    best_idx = torch.argmin(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    d2 = d.clone()
    d2[rows, best_idx] = BIG
    return best_idx.to(torch.int32), best, torch.amin(d2, dim=1)


def candidate_mask(row_ok, col_ok, uv=None, rad=None, lvl_r=None, xy=None,
                   lvl_c=None, pair_ok=None):
    """bool[M,N] gate shared by the matchers: `row_ok[i] & col_ok[j]`,
    optionally `& |uv_i - xy_j|^2 <= r_i^2 & |lvl_j - lvl_i| <= 1`, and
    optionally `& pair_ok[i, j]`. The window gate is computed on the
    valid rows and columns only (the same bits: dx*dx + dy*dy is the
    two-term sum), which keeps the CPU's window-gated calls cheap."""
    mask = row_ok[:, None] & col_ok[None, :]
    if uv is not None:
        ri = torch.nonzero(row_ok).squeeze(1)
        ci = torch.nonzero(col_ok).squeeze(1)
        dx = uv[ri, None, 0] - xy[None, ci, 0]
        dy = uv[ri, None, 1] - xy[None, ci, 1]
        win = dx * dx + dy * dy <= rad[ri, None] * rad[ri, None]
        lvl_ok = torch.abs(lvl_c[None, ci] - lvl_r[ri, None]) <= 1
        mask = torch.zeros_like(mask)
        mask[ri[:, None], ci[None, :]] = win & lvl_ok
    if pair_ok is not None:
        mask = mask & pair_ok
    return mask


def masked_best2_gated_plain(q, t, row_ok, col_ok, uv=None, rad=None,
                             lvl_r=None, xy=None, lvl_c=None, pair_ok=None):
    """Plain PyTorch version of kernel K1 (same signature). Distances are
    computed for the candidate pairs only (masked-out pairs read as BIG
    either way), which keeps the window-gated calls cheap on the CPU."""
    mask = candidate_mask(row_ok, col_ok, uv, rad, lvl_r, xy, lvl_c, pair_ok)
    i, j = torch.nonzero(mask, as_tuple=True)
    d = torch.full(mask.shape, BIG, dtype=torch.int32, device=q.device)
    d[i, j] = hamming_pairwise(q[i], t[j])
    return masked_best2(d, mask)


def masked_best2_gated(q, t, row_ok, col_ok, uv=None, rad=None, lvl_r=None,
                       xy=None, lvl_c=None, pair_ok=None):
    """Fused Hamming best-2 under the matchers' candidate gate.

    q: i32[M,8] query descriptors, t: i32[N,8] targets, row_ok: bool[M],
    col_ok: bool[N]; optional window gate: uv f32[M,2], rad f32[M],
    lvl_r i32[M] per row and xy f32[N,2], lvl_c i32[N] per column;
    optional dense pair gate pair_ok: bool[M,N] (triangulation's epipolar
    mask). Returns (best_idx i32[M], best i32[M], second i32[M]).
    CUDA tensors -> kernel `csrc/hamming.cu` (one launch); CPU -> plain
    version."""
    if not q.is_cuda:
        return masked_best2_gated_plain(q, t, row_ok, col_ok, uv, rad, lvl_r,
                                        xy, lvl_c, pair_ok)
    return _best2(q, t, row_ok, col_ok, uv, rad, lvl_r, xy, lvl_c, pair_ok,
                  None)


def hamming_work(q, t, row_ok, col_ok, uv=None, rad=None, lvl_r=None,
                 xy=None, lvl_c=None, pair_ok=None) -> torch.Tensor:
    """Kernel K1's own account of one call on CUDA tensors: i32[3], the
    valid rows it searched, the grid cells they read (window-gated calls)
    and the target records they tested. The tracking path never asks for
    it."""
    work = torch.zeros((3,), dtype=torch.int32, device=q.device)
    _best2(q, t, row_ok, col_ok, uv, rad, lvl_r, xy, lvl_c, pair_ok, work)
    return work


def _aligned(x):
    """The kernel reads descriptors 16 bytes at a time."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _best2(q, t, row_ok, col_ok, uv, rad, lvl_r, xy, lvl_c, pair_ok, work):
    M, N = q.shape[0], t.shape[0]
    kernels.require(q, "hamming q", torch.int32, (M, 8))
    kernels.require(t, "hamming t", torch.int32, (N, 8))
    kernels.require(row_ok, "hamming row_ok", torch.bool, (M,))
    kernels.require(col_ok, "hamming col_ok", torch.bool, (N,))
    q, t = _aligned(q), _aligned(t)
    gated = uv is not None
    if gated:
        kernels.require(uv, "hamming uv", torch.float32, (M, 2))
        kernels.require(rad, "hamming rad", torch.float32, (M,))
        kernels.require(lvl_r, "hamming lvl_r", torch.int32, (M,))
        kernels.require(xy, "hamming xy", torch.float32, (N, 2))
        kernels.require(lvl_c, "hamming lvl_c", torch.int32, (N,))
        gate = [kernels.ptr(a) for a in (uv, rad, lvl_r, xy, lvl_c)]
    else:
        gate = [None] * 5
    if pair_ok is not None:
        kernels.require(pair_ok, "hamming pair_ok", torch.bool, (M, N))
        gate.append(kernels.ptr(pair_ok))
    else:
        gate.append(None)
    idx = torch.empty((M,), dtype=torch.int32, device=q.device)
    best = torch.empty((M,), dtype=torch.int32, device=q.device)
    second = torch.empty((M,), dtype=torch.int32, device=q.device)
    fn = kernels.bind("hamming", "hamming_best2",
                      [kernels.VP] * 10 + [kernels.CI] * 3 + [kernels.VP] * 5)
    kernels.LAUNCHES["hamming_best2"] += 1
    kernels.check(fn(kernels.ptr(q), kernels.ptr(t), kernels.ptr(row_ok),
                     kernels.ptr(col_ok), *gate, M, N, int(gated),
                     kernels.ptr(idx), kernels.ptr(best), kernels.ptr(second),
                     None if work is None else kernels.ptr(work),
                     kernels.stream_of(q)), "hamming_best2")
    return idx, best, second


def mutual_filter(idx_ab, idx_ba):
    """bool[M]: a->b assignment that is also b's choice (mutual NN)."""
    back = idx_ba[idx_ab.long()]
    return back == torch.arange(idx_ab.shape[0], device=idx_ab.device,
                                dtype=back.dtype)


def resolve_duplicates_plain(target_idx, dist, valid, n_targets: int):
    """Plain PyTorch version of kernel R (`resolve_duplicates`): two
    scatter-mins over the targets and their gathers."""
    tgt = target_idx.long()
    d = torch.where(valid, dist, torch.full_like(dist, BIG))
    best_per_target = torch.full((n_targets,), BIG, dtype=d.dtype,
                                 device=d.device).scatter_reduce(
        0, tgt, d, "amin", include_self=True)
    is_best = valid & (d == best_per_target[tgt])
    m = tgt.shape[0]
    rows = torch.arange(m, device=d.device)
    first_best_row = torch.full((n_targets,), m, dtype=rows.dtype,
                                device=d.device).scatter_reduce(
        0, tgt, torch.where(is_best, rows, torch.full_like(rows, m)), "amin",
        include_self=True)
    return is_best & (first_best_row[tgt] == rows)


def resolve_duplicates(target_idx, dist, valid, n_targets: int):
    """Keep, per claimed target, only the claimant with the smallest
    distance (lowest row on ties). Returns bool[M] keep-mask.
    CUDA tensors -> kernel R (`csrc/resolve_claims.cu`, one launch);
    CPU -> plain version."""
    if not target_idx.is_cuda:
        return resolve_duplicates_plain(target_idx, dist, valid, n_targets)
    M = target_idx.shape[0]
    keep = torch.empty((M,), dtype=torch.bool, device=target_idx.device)
    _resolve(target_idx, dist, valid, NO_GATE, n_targets, keep=keep)
    return keep


def resolve_rows_plain(target_idx, dist, valid, max_dist: int,
                       n_targets: int):
    """Plain PyTorch version of kernel R's rows-with-index mode: the rows'
    claims resolved (valid & dist <= max_dist), then (idx_out i32[M], the
    kept target or -1; keep bool[M]): `resolve_duplicates` and the
    matchers' `where(keep, idx, -1)` after it."""
    keep = resolve_duplicates_plain(target_idx, dist,
                                    valid & (dist <= max_dist), n_targets)
    return torch.where(keep, target_idx, torch.full_like(target_idx, -1)), keep


def resolve_rows(target_idx, dist, valid, max_dist: int, n_targets: int):
    """Kernel R's rows-with-index mode (same signature and results as
    `resolve_rows_plain`): one launch on CUDA tensors, both outputs views
    of one fresh allocation."""
    if not target_idx.is_cuda:
        return resolve_rows_plain(target_idx, dist, valid, max_dist,
                                  n_targets)
    M = target_idx.shape[0]
    out = torch.empty((M + (M + 3) // 4,), dtype=torch.int32,
                      device=target_idx.device)
    idx_out = out[:M]
    keep = out[M:].view(torch.uint8)[:M].view(torch.bool)
    _resolve(target_idx, dist, valid, max_dist, n_targets, keep=keep,
             idx_out=idx_out)
    return idx_out, keep


def resolve_to_points_plain(target_idx, dist, row_ok, max_dist: int,
                            n_targets: int, slot):
    """Plain PyTorch version of kernel R in the projection search's mode:
    the rows' claims resolved (valid = row_ok & dist <= max_dist), then
    each point's row (`slot[p]`, -1 for none) read back: (idx_p i32[P],
    -1 unless kept; best_p i32[P], BIG for none; keep_p bool[P])."""
    keep = resolve_duplicates_plain(target_idx, dist,
                                    row_ok & (dist <= max_dist), n_targets)
    has = slot >= 0
    s = torch.clamp(slot, min=0).long()
    keep_p = has & keep[s]
    idx_p = torch.where(keep_p, target_idx[s], torch.full_like(slot, -1))
    best_p = torch.where(has, dist[s], torch.full_like(slot, BIG))
    return idx_p, best_p, keep_p


def resolve_to_points(target_idx, dist, row_ok, max_dist: int,
                      n_targets: int, slot):
    """Kernel R in the projection search's mode (same signature and
    results as `resolve_to_points_plain`): one launch on CUDA tensors, the
    three outputs views of one fresh allocation (they outlive the call)."""
    if not target_idx.is_cuda:
        return resolve_to_points_plain(target_idx, dist, row_ok, max_dist,
                                       n_targets, slot)
    P = slot.shape[0]
    out = torch.empty((2 * P + (P + 3) // 4,), dtype=torch.int32,
                      device=slot.device)
    keep_p = out[2 * P:].view(torch.uint8)[:P].view(torch.bool)
    _resolve(target_idx, dist, row_ok, max_dist, n_targets, slot=slot,
             idx_p=out[:P], best_p=out[P:2 * P], keep_p=keep_p)
    return out[:P], out[P:2 * P], keep_p


_R_PTRS = ("idx", "dist", "ok", "slot", "keep", "idx_out", "idx_p",
           "best_p", "keep_p")


class _RRecord(ctypes.Structure):
    """Kernel R's launch record (`RArgs` in `csrc/resolve_claims.cu`): the
    pointers are written on every call, the sizes once a geometry."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _R_PTRS]
                + [(n, ctypes.c_int) for n in ("max_dist", "M", "N", "P")])


_r_records: dict = {}


def _r_record(thread: int, dev: int, M: int, N: int, P: int,
              max_dist: int) -> _RRecord:
    """The launch record of one geometry, built once (one a host thread:
    a call writes its pointers into it)."""
    key = (thread, dev, M, N, P, max_dist)
    rec = _r_records.get(key)
    if rec is None:
        if N > _max_targets():
            raise ValueError(f"resolve_duplicates: {N} targets, past the "
                             f"kernel's {_max_targets()}")
        rec = _RRecord(max_dist=max_dist, M=M, N=N, P=P)
        _r_records[key] = rec
    return rec


def _resolve(target_idx, dist, valid, max_dist, n_targets, slot=None,
             keep=None, idx_out=None, idx_p=None, best_p=None, keep_p=None):
    M = target_idx.shape[0]
    dev = target_idx.get_device()
    specs = [("target_idx", target_idx, torch.int32, (M,)),
             ("dist", dist, torch.int32, (M,)),
             ("valid", valid, torch.bool, (M,))]
    P = 0
    if slot is not None:
        P = slot.shape[0]
        specs.append(("slot", slot, torch.int32, (P,)))
    kernels.require_on(dev, specs, "resolve")
    rec = _r_record(threading.get_ident(), dev, M, int(n_targets), P,
                    int(max_dist))
    rec.idx = target_idx.data_ptr()
    rec.dist = dist.data_ptr()
    rec.ok = valid.data_ptr()
    rec.slot = None if slot is None else slot.data_ptr()
    rec.keep = None if keep is None else keep.data_ptr()
    rec.idx_out = None if idx_out is None else idx_out.data_ptr()
    rec.idx_p = None if idx_p is None else idx_p.data_ptr()
    rec.best_p = None if best_p is None else best_p.data_ptr()
    rec.keep_p = None if keep_p is None else keep_p.data_ptr()
    fn = kernels.bind("resolve_claims", "resolve_claims",
                      [ctypes.POINTER(_RRecord), kernels.VP])
    kernels.LAUNCHES["resolve_claims"] += 1
    kernels.check(fn(ctypes.byref(rec), kernels.stream_of(target_idx)),
                  "resolve_claims")


@functools.lru_cache(maxsize=None)
def _max_targets() -> int:
    fn = kernels.bind("resolve_claims", "resolve_claims_max_targets", [])
    return fn()
