"""The depthwise conv kernel's launch plan (``ops/depthwise_conv.py:
plan_depthwise``) and its addressing, on the CPU.

The plan at every main-path shape fits the kernel's limits (threads,
shared memory, the vector and chunk rules of csrc/depthwise_conv3d.cu) and
gives the card enough blocks. ``_emulate`` replays the kernel's index
arithmetic on bytes with numpy, block by block and thread by thread: the
16-byte staging of contiguous rows at x's alignment modulo 16, the
per-pixel pieces of a channel chunk, the skipped taps outside the clip, the
T-tiles. Every byte a thread reads must have been staged from the element
it stands for, no piece may land outside its row, and the sums must equal
the plain version's."""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.ops import depthwise_conv as dw


def _ceil(a, b):
    return -(-a // b)


# (T, H, W, C, kernel, stride, padding) of every main path: X3D-L's stem and
# strided block-0 convs at 256² (stage 4: CC only), the stride-1 blocks of
# the int8 and unfused forwards, T = 4 / 5 clips, and X3D-M's 16-frame clip.
MAIN = {
    "stem": (3, 256, 256, 24, (5, 1, 1), (1, 1, 1), (2, 0, 0)),
    "stage1_s2": (3, 256, 256, 54, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage2_s2": (3, 128, 128, 108, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage3_s2": (3, 64, 64, 216, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage4_s2": (3, 32, 32, 432, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage1_t5": (5, 256, 256, 54, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage3_t4": (4, 64, 64, 216, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    "stage1_s1": (3, 128, 128, 54, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "stage2_s1": (3, 64, 64, 108, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "stage3_s1": (3, 32, 32, 216, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "stage4_s1": (3, 16, 16, 432, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    **{f"stage{i}_s1_t{t}": (t, hw, hw, c, (3, 3, 3), (1, 1, 1), (1, 1, 1))
       for t in (4, 5) for i, hw, c in ((1, 128, 54), (2, 64, 108), (3, 32, 216))},
    "x3dm_stem": (16, 112, 112, 24, (5, 1, 1), (1, 1, 1), (2, 0, 0)),
    "x3dm_stage4_s2": (16, 14, 14, 432, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    **{f"x3dm_stage{i}_s1": (16, hw, hw, c, (3, 3, 3), (1, 1, 1), (1, 1, 1))
       for i, hw, c in ((1, 56, 54), (2, 28, 108), (3, 14, 216), (4, 7, 432))},
}


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", list(MAIN))
def test_plan_fits_the_kernel_at_main_path_shapes(shape, itemsize):
    t, h, w, c, ks, stride, pad = MAIN[shape]
    p = dw.plan_depthwise(t, h, w, c, ks, stride, pad, itemsize)
    assert c % p.vec == 0 and p.vec * itemsize <= 16 and p.cc % p.vec == 0 and p.cc <= c
    if p.cc < c:  # staged in pieces of the vector: at least 4 bytes
        assert p.vec * itemsize >= 4 and p.cc * itemsize >= dw.MIN_SEGMENT
    assert dw.MIN_THREADS <= p.threads <= dw.MAX_THREADS
    assert p.threads == p.oh * p.ow * (p.cc // p.vec)
    assert p.smem <= dw.SMEM_TARGET
    to, ho, wo = (dw.out_size(n, k, s, q) for n, k, s, q in zip((t, h, w), ks, stride, pad))
    assert p.blocks == (_ceil(to, p.tt) * _ceil(ho, p.oh) * _ceil(wo, p.ow) * _ceil(c, p.cc))
    # 16 pairs fill the card's 132 SMs twice over at the smallest shape.
    assert 16 * p.blocks >= 2 * 132
    if itemsize == 2 and c % 8 == 0:
        assert p.vec == 8  # 16-byte loads and stores


# Today's plans, held fixed, at the stem's and the strided block 0s' shapes
# of the benchmark's cells (BCD, serving and CC on T = 3, CC's stage 4
# included; SCD on T = 5) and of X3D-L's Kinetics-400 clip (16 x 312^2 at
# the (1, 2, 2) stem stride; stage 3 halves 39 to 20): (T, H, W, C, kernel,
# stride, padding) -> DwPlan.
STEM, S2 = ((5, 1, 1), (1, 1, 1), (2, 0, 0)), ((3, 3, 3), (1, 2, 2), (1, 1, 1))
PINNED = {
    (3, 256, 256, 24, *STEM): (8, 3, 1, 128, 24, 384, 18960, 512),
    (3, 256, 256, 54, *S2): (2, 3, 4, 4, 54, 432, 32616, 1024),
    (3, 128, 128, 108, *S2): (4, 3, 4, 8, 36, 288, 37584, 384),
    (3, 64, 64, 216, *S2): (8, 3, 8, 8, 32, 256, 59760, 112),
    (3, 32, 32, 432, *S2): (8, 3, 8, 8, 48, 384, 89232, 36),
    (5, 256, 256, 24, *STEM): (8, 5, 1, 128, 24, 384, 31280, 512),
    (5, 256, 256, 54, *S2): (2, 5, 4, 4, 54, 432, 50472, 1024),
    (5, 128, 128, 108, *S2): (4, 5, 4, 8, 36, 288, 60048, 384),
    (5, 64, 64, 216, *S2): (8, 5, 8, 8, 32, 256, 97296, 112),
    (16, 156, 156, 24, *STEM): (8, 16, 4, 32, 24, 384, 99808, 195),
    (16, 156, 156, 54, *S2): (2, 16, 2, 4, 54, 216, 85192, 780),
    (16, 78, 78, 108, *S2): (4, 16, 4, 4, 36, 144, 100656, 300),
    (16, 39, 39, 216, *S2): (8, 6, 4, 4, 72, 144, 102240, 225),
    (16, 20, 20, 432, *S2): (8, 6, 4, 4, 72, 144, 102240, 162),
}


@pytest.mark.parametrize("shape", list(PINNED), ids=str)
def test_depthwise_plans_are_pinned(shape):
    assert tuple(dw.plan_depthwise(*shape, 2)) == PINNED[shape]


def test_plan_vectors_follow_c():
    assert [dw.vector_width(c, 2) for c in (24, 54, 108, 216, 7)] == [8, 2, 4, 8, 1]
    assert [dw.vector_width(c, 4) for c in (24, 54, 108, 216, 7)] == [4, 2, 4, 4, 1]
    # bf16 with an odd C cannot be staged in pieces: one chunk of all of C.
    assert list(dw._chunks(9, 1, 2)) == [9]
    assert dw.plan_depthwise(3, 8, 8, 9, (3, 3, 3), (1, 1, 1), (1, 1, 1), 2).cc == 9


def test_plan_refuses_what_no_block_takes():
    with pytest.raises(ValueError, match="no output"):
        dw.plan_depthwise(3, 2, 2, 8, (3, 3, 3), (1, 1, 1), (0, 0, 0), 2)
    # An odd bf16 C above the threads of one block: no chunk, no plan.
    with pytest.raises(ValueError, match="no depthwise tile"):
        dw.plan_depthwise(3, 8, 8, 2 * dw.MAX_THREADS + 1, (3, 3, 3), (1, 1, 1), (1, 1, 1), 2)


def _row_bytes(iw, cc, es):
    return _ceil(iw * cc * es, 16) * 16 + 16


def _emulate(x, w, ks, stride, pad, plan):
    """csrc/depthwise_conv3d.cu on the CPU: x [B,T,H,W,C] (float16 stands in
    for bf16's two bytes, float32 for fp32), w [C, kt*kh*kw] float64."""
    B, T, H, W, C = x.shape
    es = x.itemsize
    kt, kh, kw = ks
    st, sh, sw = stride
    pt, ph, pw = pad
    To, Ho, Wo = (dw.out_size(n, k, s, q) for n, k, s, q in zip((T, H, W), ks, stride, pad))
    vec, tt, oh, ow, cc, threads, smem_bytes, blocks = plan
    nf, ih, iw = min((tt - 1) * st + kt, T), (oh - 1) * sh + kh, (ow - 1) * sw + kw
    rb = _row_bytes(iw, cc, es)
    ws_off = nf * ih * rb
    assert smem_bytes == ws_off + kt * kh * kw * cc * 4
    xbytes = np.frombuffer(x.tobytes(), np.uint8)
    total = xbytes.size
    out = np.full((B, To, Ho, Wo, C), np.nan)
    tiles_w, tiles_h, n_tt = _ceil(Wo, ow), _ceil(Ho, oh), _ceil(To, tt)
    for b in range(B):
        for bid in range(blocks):
            i = bid
            x0 = (i % tiles_w) * ow; i //= tiles_w
            y0 = (i % tiles_h) * oh; i //= tiles_h
            t0 = (i % n_tt) * tt
            c0 = (i // n_tt) * cc
            ccb = min(cc, C - c0)
            pb = ccb * es
            t_end, y_end, x_end = min(t0 + tt, To), min(y0 + oh, Ho), min(x0 + ow, Wo)
            f_first, y_first, x_first = t0 * st - pt, y0 * sh - ph, x0 * sw - pw
            fa, fb = max(f_first, 0), min((t_end - 1) * st - pt + kt, T)
            ya, yb = max(y_first, 0), min((y_end - 1) * sh - ph + kh, H)
            xa, xb = max(x_first, 0), min((x_end - 1) * sw - pw + kw, W)
            smem = np.zeros(ws_off, np.uint8)
            src = np.full(ws_off, -1, np.int64)  # the x byte each staged byte came from
            nr = yb - ya
            pieces = []
            if ccb == C:
                per_row = rb // 16
                for r in range((fb - fa) * nr):
                    f, y = fa + r // nr, ya + r % nr
                    pix0 = ((b * T + f) * H + y) * W
                    ga, gb = (pix0 + xa) * C * es, (pix0 + xb) * C * es
                    g_first = (pix0 + x_first) * C * es
                    row = ((f - fa) * ih + (y - y_first)) * rb
                    for k in range(per_row):
                        g = (ga & ~15) + 16 * k
                        if g < gb:
                            dst = row + (g - (g_first & ~15))
                            assert dst % 16 == 0 and g % 16 == 0
                            assert row <= dst and dst + 16 <= row + rb, "piece outside its row"
                            pieces.append((dst, g, min(16, total - g)))
            else:
                piece = vec * es
                per_px = pb // piece
                for r in range((fb - fa) * nr):
                    f, y = fa + r // nr, ya + r % nr
                    row = ((f - fa) * ih + (y - y_first)) * rb
                    for k in range((xb - xa) * per_px):
                        px, part = xa + k // per_px, k % per_px
                        pix = ((b * T + f) * H + y) * W + px
                        dst = row + (px - x_first) * pb + part * piece
                        g = (pix * C + c0) * es + part * piece
                        assert dst % piece == 0 and g % piece == 0 and dst + piece <= row + rb
                        pieces.append((dst, g, piece))
            for dst, g, n in pieces:
                smem[dst:dst + n] = xbytes[g:g + n]
                src[dst:dst + n] = np.arange(g, g + n)
            nv = cc // vec
            for tid in range(threads):
                col, cl = tid // nv, (tid % nv) * vec
                oy, ox = y0 + col // ow, x0 + col % ow
                if col >= oh * ow or oy >= Ho or ox >= Wo or cl >= ccb:
                    continue
                iy0, ix0 = oy * sh - ph, ox * sw - pw
                for to in range(t0, t_end):
                    if0 = to * st - pt
                    acc = np.zeros(vec)
                    for dt in range(max(0, -if0), min(kt, T - if0)):
                        f = if0 + dt
                        for dy in range(max(0, -iy0), min(kh, H - iy0)):
                            y = iy0 + dy
                            pix = ((b * T + f) * H + y) * W + x_first
                            shift = ((pix * C * es) & 15) if ccb == C else 0
                            base = (((f - fa) * ih + (y - y_first)) * rb + shift
                                    + (ix0 - x_first) * pb + cl * es)
                            for dx in range(max(0, -ix0), min(kw, W - ix0)):
                                a = base + dx * pb
                                assert a % (vec * es) == 0, "unaligned vector load"
                                gx = ((((b * T + f) * H + y) * W + ix0 + dx) * C + c0 + cl) * es
                                assert (src[a:a + vec * es] == np.arange(gx, gx + vec * es)).all()
                                xv = np.frombuffer(smem[a:a + vec * es].tobytes(), x.dtype)
                                tap = (dt * kh + dy) * kw + dx
                                acc += xv.astype(np.float64) * w[c0 + cl:c0 + cl + vec, tap]
                    assert np.isnan(out[b, to, oy, ox, c0 + cl:c0 + cl + vec]).all()
                    out[b, to, oy, ox, c0 + cl:c0 + cl + vec] = acc
    return out


# (B, T, H, W, C, kernel, stride, padding, dtype, plan overrides): ragged C
# (108 bytes a pixel in bf16) staged whole; channel chunks in 16-, 8- and
# 4-byte pieces with a short last chunk; T-tiles; tiles hanging over the
# edges; the stem's 5x1x1 with temporal stride 2; a 2x3x1 kernel looping at
# run time.
EMULATED = {
    "ragged_c_s2": (1, 3, 9, 11, 54, (3, 3, 3), (1, 2, 2), (1, 1, 1), np.float16, {}),
    "ragged_c_fp32": (1, 3, 6, 7, 6, (3, 3, 3), (1, 2, 2), (1, 1, 1), np.float32,
                      dict(oh=2, ow=2)),
    "chunks_16b": (1, 3, 6, 6, 40, (3, 3, 3), (1, 2, 2), (1, 1, 1), np.float16,
                   dict(cc=16, oh=2, ow=2)),
    "chunks_8b": (2, 3, 5, 6, 20, (3, 3, 3), (1, 1, 1), (1, 1, 1), np.float16,
                  dict(vec=4, cc=8, oh=2, ow=4)),
    "chunks_4b_t_tiles": (1, 5, 4, 5, 6, (3, 3, 3), (1, 1, 1), (1, 1, 1), np.float16,
                          dict(vec=2, cc=4, tt=2, oh=2, ow=2)),
    "stem_5x1x1_st2": (2, 5, 4, 6, 24, (5, 1, 1), (2, 1, 1), (2, 0, 0), np.float16, {}),
    "odd_kernel": (1, 4, 7, 5, 8, (2, 3, 1), (1, 2, 1), (0, 1, 0), np.float32,
                   dict(oh=2, ow=2)),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_kernel_stages_every_tap_and_equals_the_plain_version(case):
    b, t, h, w, c, ks, stride, pad, dtype, over = EMULATED[case]
    rs = np.random.RandomState(0)
    x = rs.randn(b, t, h, w, c).astype(dtype)
    k = rs.randn(c, 1, *ks).astype(np.float32)
    es = x.itemsize
    plan = dw.plan_depthwise(t, h, w, c, ks, stride, pad, es)
    if over:
        fields = plan._asdict()
        fields.update(over)
        vec, tt, oh, ow, cc = (fields[f] for f in ("vec", "tt", "oh", "ow", "cc"))
        nf, ih, iw = min((tt - 1) * stride[0] + ks[0], t), (oh - 1) * stride[1] + ks[1], \
            (ow - 1) * stride[2] + ks[2]
        to, ho, wo = (dw.out_size(n, q, s, p) for n, q, s, p in zip((t, h, w), ks, stride, pad))
        fields.update(threads=oh * ow * (cc // vec),
                      smem=nf * ih * _row_bytes(iw, cc, es) + int(np.prod(ks)) * cc * 4,
                      blocks=_ceil(to, tt) * _ceil(ho, oh) * _ceil(wo, ow) * _ceil(c, cc))
        plan = dw.DwPlan(**fields)
    got = _emulate(x, k.reshape(c, -1).astype(np.float64), ks, stride, pad, plan)
    want = dw.depthwise_conv3d_reference(torch.from_numpy(x.astype(np.float64)),
                                         torch.from_numpy(k.astype(np.float64)), stride, pad)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
