"""PNG files in numpy and `zlib`: what the JAX package reads and writes with
OpenCV (`cv2.imread`, `cv2.imwrite`), for a machine without it.

Reads non-interlaced PNGs of 8-bit gray, RGB and RGBA, and 16-bit gray
(big-endian samples), with every scanline filter (types 0-4). Adam7
interlacing and the other bit depths and colour types raise.

`read_gray` is `cv2.imread(path, cv2.IMREAD_GRAYSCALE)`: a colour image goes
to gray as libpng converts it inside OpenCV's reader
(`png_set_rgb_to_gray(png, 1, 0.299, 0.587)`), in 15-bit fixed point with
the weights libpng derives (9797, 19234, 13737) and the sum truncated, a
pixel with equal channels unchanged; on the test images it equals cv2's
result in every pixel. `read_png` is `cv2.IMREAD_UNCHANGED` for a gray image
(uint8 or uint16).

`write_png` writes 8-bit or 16-bit gray, or 8-bit RGB (the viewer's
figures, `viz/`), with no filter (type 0), so reading it back costs one
`zlib.decompress`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}
# libpng's 15-bit fixed-point weights for (0.299, 0.587): each truncated
# from (coefficient * 100000) * 32768 / 100000, blue the remainder
_GRAY_WEIGHTS = (9797, 19234, 32768 - 9797 - 19234)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters: `raw` holds h rows of a filter byte and
    `stride` bytes. Rows filtered with None, Sub or Up are undone a row at a
    time in numpy; once a row uses Average or Paeth, the whole image is
    undone along anti-diagonals of (row, pixel), whose elements depend only
    on earlier diagonals."""
    rows = raw.reshape(h, stride + 1)
    ftype = rows[:, 0].astype(np.int64)
    data = rows[:, 1:].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"PNG: unknown filter type {int(ftype.max())}")
    w = stride // bpp
    if (ftype <= 2).all():
        out = np.empty((h, stride), np.int64)
        prev = np.zeros(stride, np.int64)
        for r in range(h):
            row = data[r]
            if ftype[r] == 1:
                row = np.cumsum(row.reshape(w, bpp), axis=0).reshape(-1)
            elif ftype[r] == 2:
                row = row + prev
            prev = out[r] = row & 255
        return out.astype(np.uint8)
    # wavefront: pixel (r, i) needs (r, i - 1), (r - 1, i), (r - 1, i - 1)
    d = data.reshape(h, w, bpp)
    out = np.zeros((h + 1, w + 1, bpp), np.int64)  # a zero row and column
    for s in range(h + w - 1):
        r = np.arange(max(0, s - w + 1), min(h, s + 1))
        i = s - r
        a = out[r + 1, i]
        b = out[r, i + 1]
        c = out[r, i]
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[r + 1, i + 1] = (d[r, i] + pred) & 255
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The image as stored: uint8 [H,W] (gray), [H,W,3] (RGB) or [H,W,4]
    (RGBA), or uint16 [H,W] (16-bit gray)."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not read")
    if ctype not in _CHANNELS or depth not in (8, 16) or (
            depth == 16 and ctype != 0):
        raise ValueError(f"{path}: PNG of colour type {ctype} and bit "
                         f"depth {depth} is not read")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: image data of {raw.size} bytes for "
                         f"{w}x{h}")
    px = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        return px.reshape(h, w, 2).view(">u2")[..., 0].astype(np.uint16)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 [H,W,3|4] -> uint8 [H,W] as libpng's rgb-to-gray does inside
    OpenCV's reader (alpha dropped, 15-bit weights, truncated)."""
    c = img[..., :3].astype(np.int64)
    rw, gw, bw = _GRAY_WEIGHTS
    gray = (rw * c[..., 0] + gw * c[..., 1] + bw * c[..., 2]) >> 15
    same = (c[..., 0] == c[..., 1]) & (c[..., 0] == c[..., 2])
    return np.where(same, c[..., 0], gray).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """uint8 [H,W]: `cv2.imread(path, cv2.IMREAD_GRAYSCALE)`."""
    img = read_png(path)
    if img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    return rgb_to_gray(img) if img.ndim == 3 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write a uint8 or uint16 gray [H,W] image, or a uint8 RGB [H,W,3]
    one (`cv2.imwrite` of it, channels in RGB order)."""
    img = np.asarray(img)
    rgb = img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    if not rgb and (img.ndim != 2 or img.dtype not in (np.uint8, np.uint16)):
        raise ValueError(f"write_png takes uint8 or uint16 gray [H,W] or "
                         f"uint8 RGB [H,W,3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2").view(np.uint8).reshape(h, -1) if depth == 16 \
        else img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                              2 if rgb else 0, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + _chunk(b"IEND", b""))
