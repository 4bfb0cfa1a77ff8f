"""The wire formats of a packed frame: the fixed-rate 8x8 DCT image codec
and the log8 depth, and their device decode (kernel K10, `wire_unpack`).

Port of `orb_slam2_refactored_tpu/ops/codec.py` and of the log8 branch of
its tracker's `_pack_rgbd` / `_unpack_impl` (`slam/tracking.py:466-531`).
The codec keeps each 8x8 block's low KEEP x KEEP DCT coefficients at a
fixed rate (16 bytes / 64 px at KEEP = 4: 307 -> 77 KB at VGA); the DC
byte is unsigned (step 8), the AC bytes signed (step AC_STEP). log8 depth
is one byte a pixel: 0 invalid, else log-spaced codes 1-255 over
[LOG8_DMIN, LOG8_DMAX] metres.

Encoding is host numpy, as in JAX. Decoding:
- `wire_unpack(buf, img, dep, lut)`: ONE launch of K10
  (`csrc/wire_unpack.cu`) decodes what the rows of a packed [k, B] uint8
  buffer on the card carry, the DCT image of each row and its log8 depth;
  a CPU tensor or anything else the kernel does not take raises;
- `wire_unpack_plain`: its plain version, per row `decode_dct_plain` (JAX's
  `decode_dct`, two contractions in torch) and `decode_log8_plain` (JAX's
  formula); the CPU path;
- `decode_dct(buf, h, w)`: K10 on one encoded image on the card.
The basis is `_dct_matrix()`'s rows, computed on the host in f32 and
passed to the kernel; the log8 table is `decode_log8_plain` of the codes
0-255 on the card (`log8_table`), so K10's depth is the plain version's bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels

BLOCK = 8
# coefficients kept per axis (4 -> 2 bit/px); the JAX package's variables
KEEP = int(os.environ.get("TPU_SLAM_DCT_KEEP", "4"))
AC_STEP = float(os.environ.get("TPU_SLAM_DCT_STEP", "6.0"))
BYTES_PER_BLOCK = KEEP * KEEP
DC_STEP = 8.0

# log8 depth range in metres (JAX `slam/tracking.py:41-42`)
LOG8_DMIN = 0.25
LOG8_DMAX = 16.0


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """Orthonormal DCT-II basis C[8,8]: X = C x C^T."""
    k = np.arange(BLOCK)
    C = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * BLOCK))
    C *= np.sqrt(2.0 / BLOCK)
    C[0] *= np.sqrt(0.5)
    return C.astype(np.float32)


def encoded_nbytes(h: int, w: int) -> int:
    return (h // BLOCK) * (w // BLOCK) * BYTES_PER_BLOCK


def encode_dct(img: np.ndarray) -> np.ndarray:
    """u8/f32 gray [H,W] (H,W multiples of 8) -> u8[encoded_nbytes].

    Per block: DC stored as round(dc/8) in u8 (the block mean, step 1
    gray); the 15 kept AC coefficients as round(ac/AC_STEP) in i8."""
    h, w = img.shape
    assert h % BLOCK == 0 and w % BLOCK == 0, (h, w)
    C = _dct_matrix()
    x = np.asarray(img, np.float32).reshape(
        h // BLOCK, BLOCK, w // BLOCK, BLOCK
    ).transpose(0, 2, 1, 3)                      # [bh,bw,8,8]
    X = C @ x @ C.T                              # batched BLAS
    K = X[..., :KEEP, :KEEP]                     # low 4x4
    out = np.empty(K.shape[:2] + (BYTES_PER_BLOCK,), np.uint8)
    dc = np.clip(np.rint(K[..., 0, 0] / 8.0), 0, 255)
    ac = np.clip(np.rint(K / AC_STEP), -127, 127).astype(np.int8)
    flat = ac.reshape(K.shape[:2] + (BYTES_PER_BLOCK,))
    out[:] = flat.view(np.uint8)
    out[..., 0] = dc.astype(np.uint8)
    return out.reshape(-1)


def decode_dct_np(buf: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host reference decoder (tests / oracles)."""
    C = _dct_matrix()
    bh, bw = h // BLOCK, w // BLOCK
    raw = np.asarray(buf, np.uint8).reshape(bh, bw, BYTES_PER_BLOCK)
    K = raw.view(np.int8).astype(np.float32) * AC_STEP
    K = K.reshape(bh, bw, KEEP, KEEP).copy()
    K[..., 0, 0] = raw[..., 0].astype(np.float32) * 8.0
    Cr = C[:KEEP]                                # [4,8]
    x = Cr.T @ K @ Cr                            # [bh,bw,8,8]
    return x.transpose(0, 2, 1, 3).reshape(h, w)


def encode_log8(depth: np.ndarray) -> np.ndarray:
    """Depth in metres -> u8 log8 codes (JAX `_pack_rgbd`'s log8 branch):
    0 for a depth <= 0, beyond LOG8_DMAX or NaN (invalid, not clamped),
    else 1 + round(log(clip(d) / DMIN) * 254 / log(DMAX / DMIN))."""
    d = np.asarray(depth).astype(np.float32)
    q = np.zeros(d.shape, np.uint8)
    pos = (d > 0) & (d <= LOG8_DMAX)
    scale = 254.0 / np.log(LOG8_DMAX / LOG8_DMIN)
    enc = np.log(np.clip(d[pos], LOG8_DMIN, LOG8_DMAX) / LOG8_DMIN) * scale
    q[pos] = np.clip(np.rint(enc), 0, 254).astype(np.uint8) + 1
    return q


def decode_log8_plain(q: torch.Tensor) -> torch.Tensor:
    """u8 log8 codes -> f32 metres: 0 for code 0, else
    LOG8_DMIN * exp((q - 1) * step), in JAX's order of operations."""
    step = float(np.log(LOG8_DMAX / LOG8_DMIN) / 254.0)
    d = LOG8_DMIN * torch.exp((q.to(torch.float32) - 1.0) * step)
    return torch.where(q > 0, d, torch.zeros_like(d))


def log8_table(device) -> torch.Tensor:
    """K10's 256-entry depth table: `decode_log8_plain` of every code, on
    `device` (so a table lookup there is the plain decode bit for bit)."""
    return decode_log8_plain(torch.arange(256, dtype=torch.uint8,
                                          device=device))


def decode_dct_plain(buf: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """JAX's `decode_dct` in torch: u8[encoded] -> f32[h,w]. The DC byte is
    unsigned, the AC bytes signed; x = Cr^T K Cr a block, one einsum."""
    bh, bw = h // BLOCK, w // BLOCK
    raw = buf.reshape(bh, bw, BYTES_PER_BLOCK)
    f = raw.to(torch.float32)
    signed = torch.where(raw < 128, f, f - 256.0)
    K = (signed * AC_STEP).reshape(bh, bw, KEEP, KEEP).clone()
    K[..., 0, 0] = raw[..., 0].to(torch.float32) * DC_STEP
    Cr = torch.as_tensor(_dct_matrix()[:KEEP], device=buf.device)
    x = torch.einsum("ak,bwkl,lc->bwac", Cr.T, K, Cr)
    return x.permute(0, 2, 1, 3).reshape(h, w)


Section = Optional[Tuple[int, int, int]]  # (byte offset in a row, h, w)


def _check_layout(buf: torch.Tensor, img: Section, dep: Section):
    if buf.dim() != 2 or buf.dtype != torch.uint8:
        raise ValueError(f"wire_unpack: expected a uint8 [k, B] buffer, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if img is None and dep is None:
        raise ValueError("wire_unpack: nothing to decode")
    B = buf.shape[1]
    if img is not None:
        off, H, W = img
        if H <= 0 or W <= 0 or H % BLOCK or W % BLOCK:
            raise ValueError(f"wire_unpack: a DCT image is [H, W] with H, W "
                             f"positive multiples of {BLOCK}, got {H}x{W}")
        if off < 0 or off + encoded_nbytes(H, W) > B:
            raise ValueError(f"wire_unpack: the image's {encoded_nbytes(H, W)}"
                             f" bytes at {off} overrun a {B}-byte row")
    if dep is not None:
        off, h, w = dep
        if h <= 0 or w <= 0 or off < 0 or off + h * w > B:
            raise ValueError(f"wire_unpack: the depth's {h}x{w} codes at "
                             f"{off} do not fit a {B}-byte row")


def wire_unpack_plain(buf: torch.Tensor, img: Section = None,
                      dep: Section = None):
    """Plain version of K10: per row of the [k, B] buffer, the DCT image
    (`img` = (offset, H, W), decoded by `decode_dct_plain`) and the log8
    depth (`dep` = (offset, h, w), `decode_log8_plain`). Returns (f32
    [k, H, W] or None, f32 [k, h, w] or None)."""
    _check_layout(buf, img, dep)
    k = buf.shape[0]
    out_img = out_dep = None
    if img is not None:
        off, H, W = img
        n = encoded_nbytes(H, W)
        out_img = torch.stack([decode_dct_plain(buf[r, off:off + n], H, W)
                               for r in range(k)])
    if dep is not None:
        off, h, w = dep
        out_dep = decode_log8_plain(buf[:, off:off + h * w]).reshape(k, h, w)
    return out_img, out_dep


@functools.lru_cache(maxsize=1)
def _basis_arg():
    """The kept rows of the DCT basis, f32 on the host, as a C array."""
    cr = _dct_matrix()[:KEEP].ravel()
    return (ctypes.c_float * cr.size)(*cr.tolist())


def wire_unpack(buf: torch.Tensor, img: Section = None, dep: Section = None,
                lut: Optional[torch.Tensor] = None):
    """ONE launch of kernel K10 over the [k, B] uint8 buffer on the card:
    the DCT image of each row (`img` = (offset, H, W)) and its log8 depth
    (`dep` = (offset, h, w), decoded through `lut`, `log8_table` on the
    buffer's device). Returns (f32 [k, H, W] or None, f32 [k, h, w] or
    None). Raises on a CPU tensor, a wrong type or shape, a layout that
    overruns a row, or KEEP past 8; never falls back."""
    kernels.require(buf, "wire_unpack buf", torch.uint8)
    _check_layout(buf, img, dep)
    if not 1 <= KEEP <= BLOCK:
        raise ValueError(f"wire_unpack: KEEP={KEEP} outside 1..{BLOCK}")
    k, B = buf.shape
    dev = buf.device
    out_img = out_dep = None
    i_off = H = W = d_off = h = w = 0
    if img is not None:
        i_off, H, W = img
        out_img = torch.empty((k, H, W), dtype=torch.float32, device=dev)
    if dep is not None:
        d_off, h, w = dep
        if lut is None:
            raise ValueError("wire_unpack: a log8 depth needs its table")
        kernels.require(lut, "wire_unpack lut", torch.float32, (256,))
        if lut.device != dev:
            raise ValueError(f"wire_unpack: table on {lut.device}, buffer "
                             f"on {dev}")
        out_dep = torch.empty((k, h, w), dtype=torch.float32, device=dev)
    fn = kernels.bind("wire_unpack", "wire_unpack",
                      [kernels.VP, ctypes.c_longlong] + [kernels.CI] * 8
                      + [kernels.CF, kernels.CF, ctypes.c_void_p]
                      + [kernels.VP] * 4)
    kernels.LAUNCHES["wire_unpack"] += 1
    kernels.check(fn(kernels.ptr(buf), B, k, i_off, H, W, d_off, h, w, KEEP,
                     AC_STEP, DC_STEP,
                     ctypes.cast(_basis_arg(), ctypes.c_void_p),
                     kernels.ptr(lut) if dep is not None else None,
                     kernels.ptr(out_img) if img is not None else None,
                     kernels.ptr(out_dep) if dep is not None else None,
                     kernels.stream_of(buf)), "wire_unpack")
    return out_img, out_dep


def decode_dct(buf: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Device decoder, u8[encoded] -> f32[h, w]: one K10 launch. The buffer
    must lie on the card (`decode_dct_plain` is the CPU's)."""
    kernels.require(buf, "decode_dct buf", torch.uint8)
    return wire_unpack(buf.reshape(1, -1), img=(0, h, w))[0][0]
