"""The port's PNG reader (change3d_tpu_torch/data/png.py) against
``cv2.imread``, which the JAX package reads its images and labels with
(change3d_tpu/data/datasets.py): gray reads of coloured pixels, and every
PNG flavour (palette, gray + alpha, RGBA, 1/2/4/16-bit, Adam7), written here
by a small zlib/struct encoder with a random row filter per row. cv2 is on
the oracle side only."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from change3d_tpu_torch.data.png import imread_gray, imread_rgb, read_png, write_png

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(rows, bpp, rs):
    """Encode each row of bytes with a random PNG filter (0..4)."""
    out, prior = b"", bytes(len(rows[0]))
    for row in rows:
        ft = int(rs.randint(0, 5))
        enc = bytearray()
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
            enc.append((x - pred) & 0xFF)
        out += bytes([ft]) + bytes(enc)
        prior = row
    return out


def _pack_rows(samples, depth):
    h, w, ch = samples.shape
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    if depth == 8:
        return [samples[y].astype(np.uint8).tobytes() for y in range(h)]
    bits = (samples.reshape(h, w * ch)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return [np.packbits(bits[y].reshape(-1).astype(np.uint8)).tobytes() for y in range(h)]


def _write(path, samples, depth, ctype, *, interlace=0, plte=None, trns=None, seed=0):
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    rs = np.random.RandomState(seed)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack_rows(sub, depth), bpp, rs)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        body += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(raw))
                + _chunk(b"IEND", b""))


def _cv2(path):
    return (cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1],
            cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_gray_of_coloured_rgb_pixels_matches_cv2(tmp_path):
    """Every (R, G) pair at 18 values of B: 1.2M coloured pixels, bit for bit."""
    r, g = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    path = str(tmp_path / "grid.png")
    for b in range(0, 256, 15):
        img = np.stack([r, g, np.full_like(r, b)], -1).astype(np.uint8)
        write_png(path, img)
        want_rgb, want_gray = _cv2(path)
        np.testing.assert_array_equal(imread_gray(path), want_gray, err_msg=f"B={b}")
        np.testing.assert_array_equal(imread_rgb(path), want_rgb, err_msg=f"B={b}")


def test_second_style_colour_label_reads_as_cv2(tmp_path):
    """A pure-green label pixel reads 149, as cv2 reads it (150 under
    cvtColor's rounded weights)."""
    path = str(tmp_path / "label.png")
    img = np.zeros((4, 4, 3), np.uint8)
    img[..., 1] = 255
    write_png(path, img)
    assert int(imread_gray(path)[0, 0]) == 149 == int(_cv2(path)[1][0, 0])


# (colour type, bit depth): gray, RGB, palette, gray + alpha, RGBA.
FLAVOURS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
            (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", FLAVOURS, ids=[f"ct{c}-{d}bit" for c, d in FLAVOURS])
def test_png_flavours_read_as_cv2_reads_them(tmp_path, ctype, depth, interlace):
    rs = np.random.RandomState(ctype * 100 + depth * 2 + interlace)
    h, w = 19, 13  # odd sizes: partial Adam7 passes and sub-byte row padding
    top = 2 ** depth - 1
    plte = None
    if ctype == 3:
        plte = rs.randint(0, 256, (top + 1, 3))
    samples = rs.randint(0, top + 1, (h, w, _CHANNELS[ctype]))
    if ctype in (2, 6):
        samples[0, :4, :3] = samples[0, :4, :1]  # some R = G = B pixels
    path = str(tmp_path / "img.png")
    _write(path, samples, depth, ctype, interlace=interlace, plte=plte, seed=depth)
    want_rgb, want_gray = _cv2(path)
    np.testing.assert_array_equal(imread_rgb(path), want_rgb)
    np.testing.assert_array_equal(imread_gray(path), want_gray)
    assert read_png(path).shape == ((h, w) if ctype in (0, 4) else (h, w, 3))


@pytest.mark.parametrize("ctype,depth,trns", [(3, 8, bytes(range(0, 250, 10))),
                                              (0, 8, b"\x00\x07"), (2, 8, b"\x00\x01\x00\x02\x00\x03")])
def test_trns_is_ignored_as_cv2_ignores_it(tmp_path, ctype, depth, trns):
    rs = np.random.RandomState(5)
    plte = rs.randint(0, 256, (256, 3)) if ctype == 3 else None
    samples = rs.randint(0, 256, (9, 11, _CHANNELS[ctype]))
    path = str(tmp_path / "t.png")
    _write(path, samples, depth, ctype, plte=plte, trns=trns)
    want_rgb, want_gray = _cv2(path)
    np.testing.assert_array_equal(imread_rgb(path), want_rgb)
    np.testing.assert_array_equal(imread_gray(path), want_gray)


def test_undecodable_files_still_raise(tmp_path):
    path = str(tmp_path / "bad.png")
    _write(path, np.zeros((4, 4, 3), np.int64), 4, 2)  # RGB has no 4-bit form
    with pytest.raises(ValueError, match="unsupported"):
        imread_rgb(path)
    _write(path, np.zeros((4, 4, 1), np.int64), 8, 3)  # palette without PLTE
    with pytest.raises(ValueError, match="PLTE"):
        imread_gray(path)
    _write(path, np.full((4, 4, 1), 9), 8, 3, plte=np.zeros((4, 3)))
    with pytest.raises(ValueError, match="palette index"):
        imread_rgb(path)
