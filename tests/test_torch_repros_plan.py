"""The launch plans of the port's repro kernels (ops/repros.py:
manual_dma_plan, dot_1d_rows, dot_1d_smem), what their wrappers refuse
on the CPU, and the phase names of tools/phase_clocks.py. The kernels
themselves are tested on the card by tests/test_torch_cuda.py."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from change3d_tpu_torch.ops import repros

REPO = Path(__file__).resolve().parent.parent

DMA_SHAPES = {
    "repro": (4, 128, 128),
    "small": (3, 16, 8),
    "ragged": (5, 100, 36),  # a slab of 3600 floats in chunks of 512: the last holds 16
    "one_mb_slab": (1, 512, 512),
    "four_per_block": (16, 512, 512),
    "ragged_two_per_block": (50, 300, 100),
    "one_row_slabs": (1000, 1, 4),
}


def _dma_spans(n, r, c, plan):
    """(block, slab, offset, length) of every chunk copy, by the kernel's
    index arithmetic (csrc/repros.cu manual_dma_kernel)."""
    slab, chunks = r * c, n * plan.per_slab
    for b in range(plan.grid):
        for j in range(b * plan.per_block, min(chunks, (b + 1) * plan.per_block)):
            off = (j % plan.per_slab) * plan.chunk
            yield b, j // plan.per_slab, off, min(plan.chunk, slab - off)


@pytest.mark.parametrize("shape", list(DMA_SHAPES))
def test_manual_dma_plan_covers_every_element_once(shape):
    n, r, c = DMA_SHAPES[shape]
    plan = repros.manual_dma_plan(n, r, c)
    count = np.zeros((n, r * c), np.int64)
    blocks = set()
    for b, s, off, length in _dma_spans(n, r, c, plan):
        assert length > 0 and length % 4 == 0 and (s * r * c + off) % 4 == 0  # 16-byte copies
        count[s, off:off + length] += 1
        blocks.add(b)
    assert (count == 1).all()
    assert blocks == set(range(plan.grid))  # no block without a chunk
    assert plan.chunk % 4 == 0 and plan.chunk <= repros.DMA_MAX_CHUNK
    assert plan.grid <= repros.H100_SMS
    smem = 16 + (2 if plan.per_block > 1 else 1) * plan.chunk * 4  # one or two chunks
    assert smem <= 16 + 2 * repros.DMA_MAX_CHUNK * 4 <= repros.SMEM_LIMIT


def test_manual_dma_plan_fills_one_wave_at_the_repro_shape():
    plan = repros.manual_dma_plan(*repros.MANUAL_DMA_SHAPE)
    # 32 chunks of 2 KB per slab: 128 blocks, one 16-byte store per thread
    assert plan == repros.DmaPlan(chunk=512, per_slab=32, per_block=1, grid=128)
    assert plan.grid > repros.MANUAL_DMA_SHAPE[0]
    assert plan.chunk == 4 * repros.DMA_THREADS


@pytest.mark.parametrize("shape,per_block", [((16, 512, 512), 4), ((50, 300, 100), 2),
                                             ((1, 512, 512), 1)])
def test_manual_dma_plan_loops_when_chunks_outnumber_the_sms(shape, per_block):
    plan = repros.manual_dma_plan(*shape)
    assert plan.per_block == per_block
    assert (plan.grid - 1) * plan.per_block < shape[0] * plan.per_slab <= plan.grid * plan.per_block


def test_manual_dma_plan_follows_the_sm_count():
    assert repros.manual_dma_plan(4, 128, 128, sms=66).grid == 64
    assert repros.manual_dma_plan(4, 128, 128, sms=1) == repros.DmaPlan(8192, 2, 8, 1)


@pytest.mark.parametrize("r", [5, 256, 1000])
def test_dot_1d_rows_split_r_over_the_eight_ranks(r):
    rows = repros.dot_1d_rows(r)
    assert len(rows) == repros.DOT_RANKS == 8
    assert [i for a, b in rows for i in range(a, b)] == list(range(r))  # in rank order, once
    assert all(b - a <= -(-r // 8) for a, b in rows)
    if r < 8:
        assert sum(a == b for a, b in rows) == 8 - r  # ranks without rows


def test_dot_1d_shared_memory_at_the_repro_shape():
    r, c, n = repros.DOT_1D_SHAPE
    # barrier 16 + w 32768 + partials and mean 2 * 512 + scratch 16 lanes x 128 x 4 + y 256
    assert repros.dot_1d_smem(c, n) == 16 + 32768 + 1024 + 8192 + 256 == 42256
    assert repros.dot_1d_smem(c, n) <= repros.SMEM_LIMIT == 232448
    assert repros.dot_1d_smem(40, 40) == 16 + 3200 + 320 + 4 * 51 * 40 + 80  # 51 lanes x 40 > 8 warps x 40


def test_wrappers_on_cpu_take_the_new_shapes():
    rs = np.random.RandomState(4)
    xd = torch.from_numpy(rs.randn(1, 512, 512).astype(np.float32))  # refused by a slab limit before
    assert torch.equal(repros.manual_dma(xd), 2 * xd)
    for r, c in ((1000, 40), (5, 128)):
        x = torch.from_numpy(rs.randn(r, c).astype(np.float32)).to(torch.bfloat16)
        w = torch.from_numpy(rs.randn(c, c).astype(np.float32)).to(torch.bfloat16)
        assert torch.equal(repros.dot_1d(x, w), repros.dot_1d_reference(x, w))


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("args,error,match", [
    ((torch.zeros(8, 8), _bf16(8, 8)), TypeError, "bfloat16"),
    ((_bf16(8, 8), _bf16(8, 12)), ValueError, "N % 8"),
    ((_bf16(8, 12), _bf16(12, 8)), ValueError, "C % 8"),
    ((_bf16(8, 8), _bf16(16, 8)), ValueError, r"w \[C, N\]"),
    ((_bf16(0, 8), _bf16(8, 8)), ValueError, "R > 0"),
    ((_bf16(4, 256), _bf16(256, 512)), ValueError, "shared memory"),
    ((_bf16(8, 8).to("meta"), _bf16(8, 8).to("meta")), ValueError, "CUDA or CPU"),
], ids=["fp32", "n_not_8", "c_not_8", "w_rows", "no_rows", "w_over_smem", "meta"])
def test_dot_1d_refuses_what_the_kernel_does_not_take(args, error, match):
    before = repros.dot_1d.launches
    with pytest.raises(error, match=match):
        repros.dot_1d(*args)
    assert repros.dot_1d.launches == before


@pytest.mark.parametrize("x,error,match", [
    (torch.zeros(1, 3, 3), ValueError, r"R\*C % 4"),
    (torch.zeros(2, 4), ValueError, r"x \[N, R, C\]"),
    (torch.zeros(0, 4, 4), ValueError, "non-empty"),
    (torch.zeros(1, 1, 1).expand(1, 2 ** 16, 2 ** 15), ValueError, r"R\*C < 2\*\*31"),
    (torch.zeros(1, 4, 4, dtype=torch.bfloat16), TypeError, "float32"),
    (torch.zeros(1, 4, 4, device="meta"), ValueError, "CUDA or CPU"),
], ids=["rc_not_4", "two_dims", "empty", "slab_over_int", "bf16", "meta"])
def test_manual_dma_refuses_what_the_kernel_does_not_take(x, error, match):
    before = repros.manual_dma.launches
    with pytest.raises(error, match=match):
        repros.manual_dma(x)
    assert repros.manual_dma.launches == before


def _phase_clocks_tool():
    spec = importlib.util.spec_from_file_location("phase_clocks", REPO / "tools" / "phase_clocks.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_clocks_names_every_phase_of_both_kernels():
    """tools/phase_clocks.py names one phase between each pair of
    consecutive C3D_PHASE marks of each kernel in csrc/repros.cu."""
    source = (REPO / "change3d_tpu_torch" / "csrc" / "repros.cu").read_text()
    marks = {}
    for body in source.split("__global__")[1:]:
        name = re.search(r"(\w+)_kernel\(", body).group(1)
        marks[name] = sorted({int(i) for i in re.findall(r"C3D_PHASE\((\d+)\)", body)})
    phases = _phase_clocks_tool().PHASES
    assert set(marks) == set(phases) == {"dot_1d", "manual_dma"}
    for name, names in phases.items():
        assert marks[name] == list(range(len(names) + 1)), name


def test_phase_clocks_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this checks the CUDA-less path")
    assert _phase_clocks_tool().main([]) == 2
