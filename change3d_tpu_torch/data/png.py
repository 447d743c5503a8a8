"""PNG reader and writer, numpy and zlib only, with ``cv2.imread``'s semantics.

The datasets are PNG files; this module reads and writes them without
OpenCV or PIL. It reads every standard flavour: gray, RGB, palette, gray +
alpha and RGBA (colour types 0, 2, 3, 4, 6) at bit depths 1, 2, 4, 8 and
16, with any of the five row filters, plain or Adam7-interlaced. The two
readers give what ``cv2.imread`` gives (its libpng transforms):

- ``imread_rgb`` (``IMREAD_COLOR``): palettes expand to RGB, alpha (and a
  ``tRNS`` chunk) is dropped, gray repeats over three channels, 1/2/4-bit
  gray scales to 8 bits (x255, x85, x17) and 16-bit samples keep their high
  byte;
- ``imread_gray`` (``IMREAD_GRAYSCALE``): a colour pixel becomes
  (9797 R + 19234 G + 3737 B) >> 15, libpng's ``rgb_to_gray`` with cv2's
  weights 0.299 / 0.587 in 1/32768 units, truncated (pixels with R = G = B
  keep their value). At 16 bits the sum is rounded, (... + 16384) >> 15,
  before the high byte is kept.

Writes take 8-bit gray or RGB and use filter 0 in one IDAT chunk. The
bytes forms serve HTTP bodies: ``decode_png_bytes`` gives what
``cv2.imdecode(buf, IMREAD_COLOR)`` gives for a PNG (BGR order),
``read_png_bytes`` what ``read_png`` gives, ``encode_png_bytes`` the bytes
``write_png`` writes.

Rows that all use filter 0 are copied out directly. Otherwise the rows are
unfiltered as a wavefront over the anti-diagonals x + y = d of filter units
(one pixel, or one byte below 8 bits per pixel): each unit depends only on
its left, upper and upper-left neighbours, which lie on the two diagonals
before it, so one numpy step per diagonal reconstructs every unit on it
whatever each row's filter is.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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
    """rows: [h, 1 + w*ch] uint8 (filter byte first) -> [h, w, ch] uint8,
    with ``ch`` bytes per filter unit."""
    ftype = rows[:, 0]
    data = rows[:, 1:].reshape(h, w, ch)
    if not ftype.any():
        return data.copy()
    if ftype.max() > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    # Reconstructed units with a zero row above and a zero column to the left.
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


def _decode_image(raw: np.ndarray, h: int, w: int, ch: int, depth: int) -> np.ndarray:
    """One filtered (sub-)image of ``raw`` -> samples [h, w, ch] (uint16 at
    16 bits, else uint8 holding 0 .. 2**depth - 1)."""
    bits = ch * depth
    row_bytes = -(-w * bits // 8)
    unit = max(1, bits // 8)
    data = _unfilter(raw.reshape(h, 1 + row_bytes), h, row_bytes // unit, unit).reshape(h, row_bytes)
    if depth == 16:
        return data.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth < 8:
        samples = np.unpackbits(data, axis=1)[:, :w * bits].reshape(h, w * ch, depth)
        data = (samples << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
    return data.reshape(h, w, ch)


def _decode(raw: np.ndarray, h: int, w: int, ch: int, depth: int, interlace: int) -> np.ndarray:
    bits = ch * depth
    if not interlace:
        want = h * (1 + -(-w * bits // 8))
        if raw.size != want:
            raise ValueError(f"image data holds {raw.size} bytes, want {want}")
        return _decode_image(raw, h, w, ch, depth)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no bytes, not even filter bytes
        size = ph * (1 + -(-pw * bits // 8))
        if pos + size > raw.size:
            raise ValueError(f"interlaced image data ends in pass at ({x0}, {y0})")
        out[y0::dy, x0::dx] = _decode_image(raw[pos:pos + size], ph, pw, ch, depth)
        pos += size
    if pos != raw.size:
        raise ValueError(f"interlaced image data holds {raw.size} bytes, want {pos}")
    return out


def _read(path: str):
    """(samples [H, W, ch], colour type, bit depth, palette [n, 3] or None)."""
    with open(path, "rb") as f:
        return _parse(f.read(), path)


def _parse(data: bytes, path: str):
    """``_read`` of a PNG file's bytes; ``path`` names it in errors."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if (ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or compression or filtering
            or interlace > 1):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"compression {compression}, filter {filtering}, interlace {interlace})")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        samples = _decode(raw, h, w, _CHANNELS[ctype], depth, interlace)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return samples, ctype, depth, palette


def _to_8bit(samples: np.ndarray, depth: int) -> np.ndarray:
    """16-bit samples keep their high byte; 1/2/4-bit gray scales to 0..255."""
    if depth == 16:
        return (samples >> 8).astype(np.uint8)
    if depth < 8:
        return samples * np.uint8(255 // (2 ** depth - 1))
    return samples


def _colour(path: str, data: bytes = None):
    """(pixels [H, W, 1 or 3] without alpha, bit depth): palettes expanded
    to 8-bit RGB, samples still at their depth otherwise. Reads ``data``
    when given, else the file."""
    samples, ctype, depth, palette = _read(path) if data is None else _parse(data, path)
    if ctype == 3:
        if int(samples.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the {len(palette)} PLTE entries")
        return palette[samples[..., 0]], 8
    return samples[..., :3] if ctype in (2, 6) else samples[..., :1], depth


def read_png(path: str) -> np.ndarray:
    """[H, W] uint8 for gray files (alpha dropped), [H, W, 3] uint8 (RGB
    order) for colour and palette files (alpha dropped)."""
    img, depth = _colour(path)
    img = _to_8bit(img, depth)
    return img[..., 0] if img.shape[-1] == 1 else img


def read_png_bytes(buf: bytes) -> np.ndarray:
    """``read_png`` of a PNG held in memory; ValueError if it is not one."""
    try:
        img, depth = _colour("PNG data", bytes(buf))
    except (struct.error, zlib.error) as e:
        raise ValueError(f"PNG data: {e}") from None
    img = _to_8bit(img, depth)
    return img[..., 0] if img.shape[-1] == 1 else img


def decode_png_bytes(buf: bytes) -> np.ndarray:
    """[H, W, 3] uint8 in BGR order, what ``cv2.imdecode(buf,
    IMREAD_COLOR)`` gives for a PNG: alpha dropped, gray repeated over the
    three channels. Raises ValueError for anything that is not a PNG."""
    img = read_png_bytes(buf)
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else np.ascontiguousarray(
        img[..., ::-1])


def imread_rgb(path: str) -> np.ndarray:
    """[H, W, 3] uint8 in RGB order, as ``cv2.imread(IMREAD_COLOR)`` reads
    it (then reversed to RGB); a gray file is repeated over the three
    channels."""
    img = read_png(path)
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img


def imread_gray(path: str) -> np.ndarray:
    """[H, W] uint8, as ``cv2.imread(IMREAD_GRAYSCALE)`` reads it: colour
    pixels through libpng's truncated 0.299 / 0.587 / 0.114 fixed-point sum
    (rounded at 16 bits, then the high byte)."""
    img, depth = _colour(path)
    if img.shape[-1] == 1:
        return _to_8bit(img[..., 0], depth)
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    y = 9797 * r + 19234 * g + 3737 * b
    if depth == 16:
        y = ((y + 16384) >> 15) >> 8
        r = r >> 8
    else:
        y = y >> 15
    # libpng passes R = G = B pixels through untouched.
    return np.where((img[..., 0] == img[..., 1]) & (img[..., 1] == img[..., 2]), r, y).astype(
        np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png_bytes(img: np.ndarray) -> bytes:
    """[H, W] (gray) or [H, W, 3] (RGB order) uint8 -> the bytes of a PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"a PNG takes [H, W] or [H, W, 3] uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] (gray) or [H, W, 3] (RGB order) uint8 as a PNG file."""
    data = encode_png_bytes(img)
    with open(path, "wb") as f:
        f.write(data)
