"""PNG reader and writer for 8-bit gray and RGB images, numpy and zlib only.

The datasets are PNG files; this module reads and writes them without
OpenCV or PIL. It handles non-interlaced 8-bit gray (colour type 0) and RGB
(colour type 2) with any of the five row filters on read; other PNG
flavours (palette, alpha, 16-bit or sub-byte depths, Adam7) raise. Writes
use filter 0 in one IDAT chunk.

Rows that all use filter 0 are copied out directly. Otherwise the rows are
unfiltered as a wavefront over the anti-diagonals x + y = d: each pixel
depends only on its left, upper and upper-left neighbours, which lie on the
two diagonals before it, so one numpy step per diagonal reconstructs every
pixel on it whatever each row's filter is.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    """rows: [h, 1 + w*ch] uint8 (filter byte first) -> [h, w, ch] uint8."""
    ftype = rows[:, 0]
    data = rows[:, 1:].reshape(h, w, ch)
    if not ftype.any():
        return data.copy()
    if ftype.max() > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    # Reconstructed pixels with a zero row above and a zero column to the left.
    out = np.zeros((h + 1, w + 1, ch), np.int32)
    filt = data.astype(np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        ft = ftype[y][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """[H, W] uint8 for gray files, [H, W, 3] uint8 (RGB order) for RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only non-interlaced 8-bit gray or RGB PNG is supported "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, want {h * (1 + w * ch)}")
    img = _unfilter(raw.reshape(h, 1 + w * ch), h, w, ch)
    return img[..., 0] if ch == 1 else img


def imread_rgb(path: str) -> np.ndarray:
    """[H, W, 3] uint8 in RGB order; a gray file is repeated over the three
    channels (as ``cv2.imread(IMREAD_COLOR)`` does)."""
    img = read_png(path)
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img


def imread_gray(path: str) -> np.ndarray:
    """[H, W] uint8. An RGB file is converted with cv2.cvtColor's fixed-point
    weights (0.299, 0.587, 0.114), which leave gray pixels (R = G = B)
    unchanged."""
    img = read_png(path)
    if img.ndim == 2:
        return img
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] (gray) or [H, W, 3] (RGB order) uint8 as a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes [H, W] or [H, W, 3] uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
