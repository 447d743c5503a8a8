"""The bf16 tile plan of the fused X3D block kernels (ops/fused_block.py:
plan_tiles for itemsize 2) and the plain se-sums that follow it. The
kernels themselves are tested on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from change3d_tpu_torch.ops import fused_block as fb

# (T, H, W, C, Ci) -> (tile, ck, smem_fwd, smem_sums, n_tiles), counted by
# hand from the layouts in csrc/fused_block.cu (Bf16Layout; stage 3,
# weight-resident, ResidentLayout below).
X3D_L_STAGES = {
    "stage1": ((3, 128, 128, 24, 54), (8, 54, 98944, 80128, 256)),
    "stage2": ((3, 64, 64, 48, 108), (8, 56, 114176, 91904, 64)),
    "stage3": ((3, 32, 32, 96, 216), (4, 112, 210304, 150656, 64)),
    "stage4": ((3, 16, 16, 192, 432), (4, 48, 101248, 76672, 16)),
}


# The same stages on BDA's T = 4 and SCD's T = 5 clips.
X3D_L_STAGES_T45 = {
    "t4_stage1": ((4, 128, 128, 24, 54), (8, 32, 82560, 68352, 256)),
    "t4_stage2": ((4, 64, 64, 48, 108), (8, 32, 98304, 82176, 64)),
    "t4_stage3": ((4, 32, 32, 96, 216), (4, 72, 220800, 161152, 64)),
    "t4_stage4": ((4, 16, 16, 192, 432), (4, 32, 100096, 81664, 16)),
    "t5_stage1": ((5, 128, 128, 24, 54), (8, 32, 103040, 85760, 256)),
    "t5_stage2": ((5, 64, 64, 48, 108), (8, 16, 92800, 80256, 64)),
    "t5_stage3": ((5, 32, 32, 96, 216), (4, 48, 227968, 167040, 64)),
    "t5_stage4": ((5, 16, 16, 192, 432), (4, 16, 102016, 90240, 16)),
}
# Stage 3 weight-resident (ResidentLayout): w_a 96 rows of 216 (27 16-byte
# units, odd) = 41472 B; w_c rows up to the last chunk's start + pad16(ck),
# rows of 96 + 8 (13 units); the fp32 BN vectors, (4*216 + 2*96) * 4 = 4224
# (sums: 4*216*4 = 3456); then two tiles without weights (Bf16Layout,
# staged = false). The fewest chunks that fit 227 KB = 232448 B:
# T = 3: xt 112 x 104 x 2 = 23296; ck 216 needs 41472 + 224*208 + 4224 +
#   2 * (23296 + 108*224*2 + 48*232*2) = 280192; ck 112: w_c 224 rows =
#   46592, a tile 23296 + 108*112*2 + 48*120*2 = 59008, fwd 88064 + 4224 +
#   2 * 59008 = 210304; sums (no w_c) 41472 + 3456 + 2 * (23296 + 24192 +
#   3*4*1*112*4) = 150656.
# T = 4: xt 144 x 208 = 29952; ck 112 needs 247424; ck 72: w_c 144 + 80 =
#   224 rows, a tile 29952 + 144*80*2 + 64*88*2 = 64256, fwd 220800; sums
#   41472 + 3456 + 2 * (29952 + 23040 + 4*4*1*80*4) = 161152.
# T = 5: xt 192 x 208 = 39936; ck 56 needs 41472 + 232*208 + 4224 + 2 *
#   (39936 + 180*64*2 + 80*72*2) = 242944; ck 48: w_c 192 + 48 = 240 rows =
#   49920, a tile 39936 + 180*48*2 + 80*56*2 = 66176, fwd 41472 + 49920 +
#   4224 + 132352 = 227968; sums 41472 + 3456 + 2 * (39936 + 17280 +
#   5*4*1*48*4) = 167040.
RESIDENT_STAGES = {"stage3", "t4_stage3", "t5_stage3"}
# (chunks of Ci, width of the last chunk, conv_c m16n8 accumulator tiles per
# warp, which picks the kernel's kAcc = 8 or 16).
CHUNKS_AND_ACC = {
    "stage1": ((1, 54, 5), (2, 22, 6), (2, 22, 8)),
    "stage2": ((2, 52, 9), (4, 12, 12), (7, 12, 15)),
    "stage3": ((2, 104, 5), (3, 72, 6), (5, 24, 8)),
    "stage4": ((9, 48, 9), (14, 16, 12), (27, 16, 15)),
}


@pytest.mark.parametrize("stage", list(X3D_L_STAGES) + list(X3D_L_STAGES_T45))
def test_bf16_plan_at_the_x3d_l_stages(stage):
    shape, want = {**X3D_L_STAGES, **X3D_L_STAGES_T45}[stage]
    assert fb.plan_tiles(*shape, 2) == want


@pytest.mark.parametrize("stage", list(CHUNKS_AND_ACC))
def test_bf16_chunks_and_accumulators_at_t3_t4_t5(stage):
    """SCD's stage 2 (T = 5) runs 7 chunks of 16 inner channels, the last 12
    wide, with 15 accumulator tiles per warp: the largest kAcc = 16 load."""
    _, h, w, c, ci = X3D_L_STAGES[stage][0]
    for t, want in zip((3, 4, 5), CHUNKS_AND_ACC[stage]):
        tile, ck, _, _, _ = fb.plan_tiles(t, h, w, c, ci, 2)
        chunks = -(-ci // ck)
        acc = -(-(-(-t * tile * tile // 16)) * (c // 8) // fb.WARPS)
        assert (chunks, ci - (chunks - 1) * ck, acc) == want, t
        assert acc <= fb.MAX_ACC_TILES


@pytest.mark.parametrize("shape", [(3, 128, 128, 24, 54), (3, 32, 32, 96, 216),
                                   (5, 8, 8, 96, 216), (3, 20, 12, 24, 54),
                                   (3, 16, 16, 192, 432), (3, 32, 32, 8, 18)])
def test_bf16_plan_respects_the_kernel_limits(shape):
    t, h, w, c, ci = shape
    tile, ck, smem_fwd, smem_sums, n_tiles = fb.plan_tiles(t, h, w, c, ci, 2)
    resident = fb.plan_block(t, h, w, c, ci, 2).resident
    assert tile in (16, 8, 4) and ck % 2 == 0 and min(ci, fb.MIN_CHUNK) <= ck <= ci
    assert (ck % 8 == 0) or ck == ci
    assert smem_sums < smem_fwd <= (fb.SMEM_RESIDENT if resident else fb.SMEM_TARGET)
    m_tiles = -(-t * tile * tile // 16)
    assert -(-m_tiles * (c // 8) // fb.WARPS) <= fb.MAX_ACC_TILES  # accumulators per warp
    assert n_tiles == -(-h // tile) * -(-w // tile)
    assert (smem_fwd, smem_sums) == (fb._resident_smem(t, tile, c, ci, ck) if resident
                                     else fb._bf16_smem(t, tile, c, ck))


def test_bf16_plain_se_sums_follow_the_bf16_tiles():
    """In bf16 the plain sums use the bf16 plan's tiles (row-major, tiles
    that hang over the edge sum what lies inside), as the kernel writes them."""
    rs = np.random.RandomState(6)
    t, h, w, c, ci = 3, 10, 6, 16, 20
    f = lambda *s: torch.from_numpy((rs.randn(*s) * 0.2).astype(np.float32))
    ops = [f(2, t, h, w, c).to(torch.bfloat16), f(c, ci), f(ci) * 0.1 + 1, f(ci) * 0.1,
           f(3, 3, 3, ci), f(ci) * 0.1 + 1, f(ci) * 0.1]
    tile, _, _, _, n_tiles = fb.plan_tiles(t, h, w, c, ci, 2)
    assert h % tile and w % tile  # the last tiles hang over both edges
    sums = fb.se_sums_reference(*ops)
    assert sums.shape == (2, n_tiles, ci) and sums.dtype == torch.float32
    xb = fb._front_reference(*ops)
    tiles_w = -(-w // tile)
    for k in range(n_tiles):
        y0, x0 = (k // tiles_w) * tile, (k % tiles_w) * tile
        want = xb[:, :, y0:y0 + tile, x0:x0 + tile].sum(dim=(1, 2, 3))
        torch.testing.assert_close(sums[:, k], want, rtol=1e-5, atol=1e-5)



# The X3D-M / S / XS stage shapes (the stock (1, 2, 2) stem stride, then
# stride 2 per stage): (T, input side) -> (T, H=W, C, Ci) per stage.
X3D_FAMILY = {"m": (16, 224), "s": (13, 160), "xs": (4, 160)}
FAMILY_STAGES = {f"{v}_stage{i + 1}": (t, side // 2 ** (i + 2), c, ci)
                 for v, (t, side) in X3D_FAMILY.items()
                 for i, (c, ci) in enumerate(((24, 54), (48, 108), (96, 216), (192, 432)))}

# X3D-M's 16-frame clip at stages 3 and 4 in bf16, the staged plan
# (``_plan_bf16``) counted by hand from Bf16Layout: (T, H, W, C, Ci) ->
# (tt, tile, ck, smem_fwd, smem_sums, n_tiles, resident, split). T-tiled,
# so ``plan_block`` runs them on the split design, at the staged plan's tt
# and tiles (T16_PINNED below).
# Stage 3: a whole clip needs 24 accumulator tiles per warp at tile 4, 8
# frames need 12; then F = 10 halo frames of 6 x 6 (360 rows, 368 padded),
# rows of 96 + 8, ck = 16 (14 chunks; 24 needs 124160 B):
# (368*104 + 16*104 + 360*16) * 2 = 91392, fwd + (128 + 96) * 24 * 2 = 102144,
# sums + 8*4*1*16*4 = 93440; 2 T-tiles x 4 x 4. Stage 4: tt = 4 (12 tiles per
# warp) misses the shared-memory target by 512 B at ck = 16, so tt = 3
# (ceil(16/6)): F = 5, 180 rows (192 padded) of 192 + 8:
# (192*200 + 16*200 + 180*16) * 2 = 88960, fwd + (48 + 192) * 24 * 2 = 100480,
# sums + 3*4*1*16*4 = 89728; 6 T-tiles (the last of one frame) x 2 x 2.
# X3D-L's Kinetics-400 clip, 16 x 312^2 at the (1, 2, 2) stem stride: stages
# 1 and 2 in one T-tile over ragged 4 x 4 tiles (78 and 39 are not multiples
# of 4: 20 x 20 and 10 x 10 tiles), stages 3 and 4 in the T-tiles of X3D-M's
# (the same layouts on 5 x 5 and 3 x 3 tiles; the resident route takes
# T <= 5 only).
T16_STAGED = {
    "stage3": ((16, 14, 14, 96, 216), (8, 4, 16, 102144, 93440, 32, False, False)),
    "stage4": ((16, 7, 7, 192, 432), (3, 4, 16, 100480, 89728, 24, False, False)),
    "k400_stage3": ((16, 20, 20, 96, 216), (8, 4, 16, 102144, 93440, 50, False, False)),
    "k400_stage4": ((16, 10, 10, 192, 432), (3, 4, 16, 100480, 89728, 54, False, False)),
}
# ``plan_block``'s plans at 16 frames. Stages 3 and 4 take the split design
# (SplitLayout): the staged tt and tiles, the fewest chunks of a multiple of
# 16 channels that fit 112 KB = 114688 B.
# Stage 3: 360 halo rows, C 96 (w_c rows of 104, 13 16-byte units), 128
# outputs: ck 48 needs 2*360*48*2 + 2*48*104*2 + 128*56*2 + 128*104*2 =
# 130048; ck 32 (7 chunks): 46080 + 13312 + 10240 + 26624 = 96256, sums
# 46080 + 8*4*1*32*4 = 50176. Stage 4: 180 halo rows, C 192 (rows of 200,
# 25 units), 48 outputs: ck 64 needs 46080 + 51200 + 48*72*2 + 48*200*2 =
# 123392; ck 48 (9 chunks): 34560 + 38400 + 5376 + 19200 = 97536, sums
# 34560 + 3*4*1*48*4 = 36864. Stages 1 and 2 take one T-tile: staged.
T16_PINNED = {
    "stage3": ((16, 14, 14, 96, 216), (8, 4, 32, 96256, 50176, 32, False, True)),
    "stage4": ((16, 7, 7, 192, 432), (3, 4, 48, 97536, 36864, 24, False, True)),
    "k400_stage1": ((16, 78, 78, 24, 54), (16, 4, 32, 107904, 93696, 400, False, False)),
    "k400_stage2": ((16, 39, 39, 48, 108), (16, 4, 16, 99328, 88832, 100, False, False)),
    "k400_stage3": ((16, 20, 20, 96, 216), (8, 4, 32, 96256, 50176, 50, False, True)),
    "k400_stage4": ((16, 10, 10, 192, 432), (3, 4, 48, 97536, 36864, 54, False, True)),
}


@pytest.mark.parametrize("stage", list(X3D_L_STAGES) + list(X3D_L_STAGES_T45))
def test_whole_clip_plans_take_one_t_tile(stage):
    shape, want = {**X3D_L_STAGES, **X3D_L_STAGES_T45}[stage]
    plan = fb.plan_block(*shape, 2)
    assert plan.tt == shape[0] and tuple(plan)[1:6] == want
    assert plan.resident == (stage in RESIDENT_STAGES) and not plan.split
    assert fb.halo_frames(shape[0], plan.tt) == shape[0]


@pytest.mark.parametrize("stage", list(T16_PINNED))
def test_bf16_t_tiled_plans_at_x3d_m_16_frames(stage):
    shape, want = T16_PINNED[stage]
    assert tuple(fb.plan_block(*shape, 2)) == want
    assert fb.plan_tiles(*shape, 2) == want[1:6]


@pytest.mark.parametrize("stage", list(T16_STAGED))
def test_staged_t_tiled_plans_at_16_frames(stage):
    """The staged plan of each T-tiled shape, which the split design keeps
    the tt, tiles and se-sums rows of (and the card tests run the staged
    kernel at)."""
    shape, want = T16_STAGED[stage]
    assert tuple(fb._plan_bf16(*shape)) == want
    split = fb.plan_block(*shape, 2)
    assert (split.tt, split.tile, split.n_tiles) == (want[0], want[1], want[5])


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("stage", list(FAMILY_STAGES))
def test_x3d_family_stages_plan_within_the_limits(stage, itemsize):
    t, hw, c, ci = FAMILY_STAGES[stage]
    plan = fb.plan_block(t, hw, hw, c, ci, itemsize)
    tt, tile, ck, smem_fwd, smem_sums, n_tiles = plan[:6]
    assert 1 <= tt <= t and min(ci, fb.MIN_CHUNK) <= ck <= ci
    assert n_tiles == -(-t // tt) * (-(-hw // tile)) ** 2
    assert smem_sums < smem_fwd <= (fb.SMEM_RESIDENT if plan.resident else fb.SMEM_TARGET)
    frames = fb.halo_frames(t, tt)
    assert frames == (t if tt == t else tt + 2)
    if itemsize == 2:
        assert tile in (16, 8, 4) and ck % 2 == 0 and (ck % 8 == 0 or ck == ci)
        m_tiles = -(-tt * tile * tile // 16)
        assert -(-m_tiles * (c // 8) // fb.WARPS) <= fb.MAX_ACC_TILES
        assert plan.split == (tt < t)
        if plan.resident:
            assert (smem_fwd, smem_sums) == fb._resident_smem(t, tile, c, ci, ck)
        elif plan.split:
            assert (smem_fwd, smem_sums) == fb._split_smem(tt, tile, c, ck, frames)
        else:
            assert (smem_fwd, smem_sums) == fb._bf16_smem(tt, tile, c, ck, frames)
    else:
        halo, core = frames * (tile + 2) ** 2, tt * tile * tile
        assert tile in (8, 4, 2, 1)
        assert smem_sums == halo * c * 4 + (halo + core) * 4 * ck
        assert smem_fwd == smem_sums + core * c * 4
    if t <= 5:  # X3D-XS: every stage in one T-tile
        assert tt == t


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
def test_plain_se_sums_follow_the_t_tiles(itemsize):
    """A shape whose plan takes T-tiles, the last one ragged (X3D-S's
    stage 4 in bf16, 13 frames in tiles of 3; 17 frames of 3 x 3 in fp32,
    in tiles of 9): each row of the plain sums is its tile's sum of xb, and
    the rows add up to the whole clip's, which the SE gate divides."""
    rs = np.random.RandomState(7)
    t, h, w, c, ci = (13, 5, 5, 192, 432) if itemsize == 2 else (17, 3, 3, 192, 432)
    f = lambda *s: torch.from_numpy((rs.randn(*s) * 0.2).astype(np.float32))
    ops = [f(2, t, h, w, c), f(c, ci), f(ci) * 0.1 + 1, f(ci) * 0.1, f(3, 3, 3, ci),
           f(ci) * 0.1 + 1, f(ci) * 0.1]
    if itemsize == 2:
        ops[0] = ops[0].to(torch.bfloat16)
    tt, tile, _, _, _, n_tiles = fb.plan_block(t, h, w, c, ci, itemsize)[:6]
    assert tt < t and t % tt
    sums = fb.se_sums_reference(*ops)
    assert sums.shape == (2, n_tiles, ci) and sums.dtype == torch.float32
    xb = fb._front_reference(*ops)
    tiles_h, tiles_w = -(-h // tile), -(-w // tile)
    for k in range(n_tiles):
        t0 = (k // (tiles_h * tiles_w)) * tt
        y0, x0 = ((k // tiles_w) % tiles_h) * tile, (k % tiles_w) * tile
        want = xb[:, t0:t0 + tt, y0:y0 + tile, x0:x0 + tile].sum(dim=(1, 2, 3))
        torch.testing.assert_close(sums[:, k], want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sums.sum(1), xb.sum(dim=(1, 2, 3)), rtol=1e-5, atol=1e-3)


# Which design runs each block shape (``plan_block``, from the shape alone):
# the weight-resident one exactly where the staged plan is one T-tile of the
# register-capped 4 x 4 tiles and all of w_a and w_c fit one block with two
# tiles. X3D-L at 256^2 on T = 3, 4, 5 and 16 (stage 4's weights, 2 x 192 x
# 432 bf16, do not fit; 16 frames take T-tiles at stages 3 and 4).
X3D_L_SHAPES = {"stage1": (128, 24, 54), "stage2": (64, 48, 108), "stage3": (32, 96, 216),
                "stage4": (16, 192, 432)}
RESIDENT_ROUTE = {("stage3", 3), ("stage3", 4), ("stage3", 5)}
SPLIT_ROUTE = {("stage3", 16), ("stage4", 16)}


@pytest.mark.parametrize("t", [3, 4, 5, 16])
@pytest.mark.parametrize("stage", list(X3D_L_SHAPES))
def test_route_at_every_x3d_l_stage(stage, t):
    hw, c, ci = X3D_L_SHAPES[stage]
    plan, staged = fb.plan_block(t, hw, hw, c, ci, 2), fb._plan_bf16(t, hw, hw, c, ci)
    assert plan.resident == ((stage, t) in RESIDENT_ROUTE)
    assert plan.split == ((stage, t) in SPLIT_ROUTE) == (staged.tt < t)
    # The same tiles either way: the se-sums rows and the plain sums hold.
    assert (plan.tt, plan.tile, plan.n_tiles) == (staged.tt, staged.tile, staged.n_tiles)
    fp32 = fb.plan_block(t, hw, hw, c, ci, 4)
    assert not fp32.resident and not fp32.split  # fp32 keeps its design
    if plan.split:
        assert plan == fb._plan_split(t, c, ci, staged)
        return
    if not plan.resident:
        assert plan == staged
        return
    assert (plan.tt, plan.tile) == (t, 4) and plan.ck % 8 == 0 and plan.ck >= fb.MIN_CHUNK
    assert plan.smem_sums < plan.smem_fwd <= fb.SMEM_RESIDENT
    assert (plan.smem_fwd, plan.smem_sums) == fb._resident_smem(t, 4, c, ci, plan.ck)
    chunks = -(-ci // plan.ck)  # and one chunk fewer would not fit
    fewer = min(ci, -(-(-(-ci // (chunks - 1))) // 8) * 8)
    assert fb._resident_smem(t, 4, c, ci, fewer)[0] > fb.SMEM_RESIDENT


def test_resident_layout_within_one_sm():
    """SMEM_RESIDENT is the most dynamic shared memory one block may take on
    an H100 (228 KB an SM, less 1 KB the card keeps per block), and the
    weights alone, w_a and w_c in their padded rows, are what rules stage 4
    out: 2 x 192 x 432 bf16 with padding is 342 KB even at the narrowest
    chunk."""
    assert fb.SMEM_RESIDENT == 228 * 1024 - 1024 == 232448
    assert fb._odd16_stride(216) == 216 and fb._odd16_stride(96) == 104
    assert fb._odd16_stride(432) == 440 and fb._odd16_stride(192) == 200
    w_a = 192 * 440 * 2
    w_c = (26 * 16 + 16) * 200 * 2
    assert w_a + w_c == 341760 > fb.SMEM_RESIDENT
    assert fb._resident_smem(3, 4, 192, 432, 16)[0] > w_a + w_c
    assert fb._plan_resident(3, 192, 432, fb._plan_bf16(3, 16, 16, 192, 432)) is None


@pytest.mark.parametrize("stage", list(FAMILY_STAGES))
def test_route_at_every_x3d_family_stage(stage):
    """X3D-XS's stage 3 (4 frames of 10 x 10) is the one resident shape of
    the family; X3D-M's and X3D-S's stage 3 take T-tiles and stay staged."""
    t, hw, c, ci = FAMILY_STAGES[stage]
    plan, staged = fb.plan_block(t, hw, hw, c, ci, 2), fb._plan_bf16(t, hw, hw, c, ci)
    assert plan.resident == (stage == "xs_stage3")
    assert plan.split == (staged.tt < t) == (stage in {"m_stage3", "m_stage4", "s_stage3",
                                                       "s_stage4"})
    if not plan.resident and not plan.split:
        assert plan == staged


def test_phase_clocks_read_every_fused_block_mark():
    """tools/phase_clocks.py --fused turns every C3D_PHASE mark of
    csrc/fused_block.cu into a phase (a mark's argument may pick the first
    or the last chunk's slot)."""
    import importlib.util
    import re
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    source = (repo / "change3d_tpu_torch" / "csrc" / "fused_block.cu").read_text()
    marks = {int(n) for arg in re.findall(r"C3D_PHASE\(([^;]*)\);", source)
             for n in re.findall(r"\b\d+\b", arg.replace("ci0 == 0", ""))}
    spec = importlib.util.spec_from_file_location("phase_clocks", repo / "tools" / "phase_clocks.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    read = {m for _, a, b, _ in tool.FUSED_PHASES for m in (a, b)}
    read |= set(tool.RESIDENT_PHASE[1:])
    assert marks == read == set(range(15))


# The split design (``_plan_split``) at every bf16 shape whose staged plan
# takes T-tiles, over clip lengths and the X3D stage widths at two sides
# each (T, stage): the shape alone decides.
SPLIT_GRID = [(t, stage, side) for t in (6, 8, 13, 16, 32) for stage in X3D_L_SHAPES
              for side in (X3D_L_SHAPES[stage][0] // 4, X3D_L_SHAPES[stage][0] // 8 + 1)]


@pytest.mark.parametrize("t,stage,side", SPLIT_GRID)
def test_every_t_tiled_bf16_plan_takes_the_split_design(t, stage, side):
    _, c, ci = X3D_L_SHAPES[stage]
    plan, staged = fb.plan_block(t, side, side, c, ci, 2), fb._plan_bf16(t, side, side, c, ci)
    assert plan.split == (staged.tt < t)
    if not plan.split:
        assert plan == (fb._plan_resident(t, c, ci, staged) or staged)
        return
    assert not plan.resident
    assert (plan.tt, plan.tile, plan.n_tiles) == (staged.tt, staged.tile, staged.n_tiles)
    assert plan.ck % 16 == 0 or plan.ck == ci
    frames = fb.halo_frames(t, plan.tt)
    assert plan.smem_sums < plan.smem_fwd <= fb.SMEM_TARGET
    assert (plan.smem_fwd, plan.smem_sums) == fb._split_smem(plan.tt, plan.tile, c, plan.ck,
                                                             frames)
    assert fb._xa_smem(c) <= fb.SMEM_TARGET
    chunks = -(-ci // plan.ck)  # and one chunk fewer would not fit
    if chunks > 1:
        wider = min(ci, fb._pad16(-(-ci // (chunks - 1))))
        assert fb._split_smem(plan.tt, plan.tile, c, wider, frames)[0] > fb.SMEM_TARGET
    # The plain se-sums follow the same tiles as the staged plan's.
    assert fb.plan_tiles(t, side, side, c, ci, 2)[0] == staged.tile


# The one-T-tile plans of every cell that runs none of the split design:
# BCD (T = 3), BDA (4), SCD (5) and CC (T = 3, stage 4 too) at 256^2, and
# Kinetics stages 1 and 2 (16 x 78^2, 16 x 39^2).
ONE_T_TILE = {**{f"t{t}_{stage}": (t, X3D_L_SHAPES[stage][0], *X3D_L_SHAPES[stage][1:])
                 for t in (3, 4, 5) for stage in X3D_L_SHAPES},
              "k400_stage1": (16, 78, 24, 54), "k400_stage2": (16, 39, 48, 108)}


@pytest.mark.parametrize("shape", list(ONE_T_TILE))
def test_one_t_tile_plans_keep_their_design(shape):
    t, hw, c, ci = ONE_T_TILE[shape]
    plan, staged = fb.plan_block(t, hw, hw, c, ci, 2), fb._plan_bf16(t, hw, hw, c, ci)
    assert staged.tt == t and not plan.split and fb._plan_split(t, c, ci, staged) is None
    assert plan == (fb._plan_resident(t, c, ci, staged) or staged)


def test_xa_pass_layout():
    """The xa pass's shared memory (XaLayout), counted by hand: 128 rows of
    x (pad16(C) + 8), w_a's 64 columns as pad16(C) rows of 72 (9 16-byte
    units), the 128 x 72 output tile."""
    assert (fb.XA_ROWS, fb.XA_COLS) == (128, 64) and fb._odd16_stride(64) == 72
    assert fb._xa_smem(96) == (128 * 104 + 96 * 72 + 128 * 72) * 2 == 58880
    assert fb._xa_smem(192) == (128 * 200 + 192 * 72 + 128 * 72) * 2 == 97280
    assert fb._xa_smem(24) == (128 * 40 + 32 * 72 + 128 * 72) * 2


def test_phase_clocks_name_the_split_and_xa_phases():
    """tools/phase_clocks.py --kinetics renames a split tail's phases that
    have no conv_a or weight staging, and reads the xa pass's marks, which
    csrc/fused_block.cu's fused_block_xa_kernel sets."""
    import importlib.util
    import re
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    source = (repo / "change3d_tpu_torch" / "csrc" / "fused_block.cu").read_text()
    body = source[source.index("fused_block_xa_kernel(Params p) {"):]
    body = body[:body.index("\n}\n")]
    marks = {int(n) for n in re.findall(r"C3D_PHASE\((\d+)\);", body)}
    spec = importlib.util.spec_from_file_location("phase_clocks", repo / "tools" / "phase_clocks.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert {m for _, a, b in tool.XA_PHASES for m in (a, b)} == marks == {0, 1, 2, 3}
    assert set(tool.SPLIT_NAMES) <= {name for name, _, _, _ in tool.FUSED_PHASES}
    assert [stage for stage, *_ in tool.KINETICS] == ["stage3", "stage4"]
    for _, t, hw, c, ci, _ in tool.KINETICS:
        assert fb.plan_block(t, hw, hw, c, ci, 2).split


def test_split_tail_input_is_checked():
    """``_launch_fwd`` / ``_launch_se_sums(..., xa=...)`` run a split tail on
    a given xa only if it is the xa pass's output for these operands:
    [B, T, H, W, Ci rounded up to 8] in x's dtype, contiguous; the other
    designs read none."""
    t, hw, c, ci = 16, 10, 192, 432
    x = torch.zeros(2, t, hw, hw, c, dtype=torch.bfloat16)
    args = (x, torch.zeros(c, ci, dtype=torch.bfloat16))
    split, staged = fb.plan_block(t, hw, hw, c, ci, 2), fb._plan_bf16(t, hw, hw, c, ci)
    xa = torch.zeros(2, t, hw, hw, ci, dtype=torch.bfloat16)
    assert fb._split_input(split, args, xa) is xa
    assert fb._split_input(staged, args, xa) is None
    for bad in (xa[..., :-8], xa.float(), xa.transpose(2, 3)):
        with pytest.raises(ValueError, match="xa pass"):
            fb._split_input(split, args, bad)
    ragged = (x, torch.zeros(c, 54, dtype=torch.bfloat16))  # Ci 54: rows of 56
    assert fb._split_input(split, ragged, torch.zeros(2, t, hw, hw, 56, dtype=torch.bfloat16)) \
        is not None
