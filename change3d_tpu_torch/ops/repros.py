"""The two minimal Pallas repros as CUDA kernels: their plain PyTorch
versions, the dispatching wrappers, their launch plans, and an entry point
that checks both on the card.

Replaces the TPU kernels of ``tests/manual_pallas_repros.py``
(``repro_dot_1d``, ``repro_manual_dma``), each the smallest case of a
mechanism that the fused X3D block relies on:

  dot_1d(x [R, C] bf16, w [C, N] bf16) -> [R, N] bf16:
      s = bf16(mean over rows of x)        # fp32 sum
      y = bf16(s @ w)                      # fp32 accumulate, one rounding
      every row of the result is y
  manual_dma(x [N, R, C] fp32) -> 2 * x    # copy global -> shared, then 2x

The kernels are in ``csrc/repros.cu``. ``dot_1d`` runs as one cluster of 8
blocks: each sums its eighth of the rows (``dot_1d_rows``), the blocks add
each other's column sums through distributed shared memory in rank order,
and each writes the product row to its own rows. ``manual_dma`` cuts each
slab into chunks of a multiple of 16 bytes, about one wave of blocks over
the card (``manual_dma_plan``); each chunk is one bulk TMA copy on an
mbarrier, and a block with several chunks keeps the next one in flight.
Each wrapper takes its plain version for a CPU tensor, launches its kernel
for a CUDA tensor (or raises), and counts its launches in
``<wrapper>.launches``.

    python -m change3d_tpu_torch.ops.repros

runs both kernels on the card at the repros' shapes, holds them against
their plain versions and prints one line per kernel; it raises on any
disagreement.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from change3d_tpu_torch.ops import cuda_build

# The repros' shapes (tests/manual_pallas_repros.py:33-34, :47).
DOT_1D_SHAPE = (256, 128, 128)  # R, C, N
MANUAL_DMA_SHAPE = (4, 128, 128)  # N, R, C
# Dynamic shared memory a block may take on the H100 (opt-in maximum).
SMEM_LIMIT = 232448
# csrc/repros.cu: dot_1d's cluster and block, manual_dma's block and its
# largest chunk (fp32 elements; two buffers of it stay at 64 KB).
DOT_RANKS = 8
DOT_THREADS = 256
DMA_THREADS = 128
DMA_MAX_CHUNK = 8192
H100_SMS = 132


def dot_1d_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dot_1d``, rounding where the repro does."""
    s = x.float().mean(dim=0).to(torch.bfloat16).float()
    y = torch.matmul(s, w.float())
    return y.expand(x.shape[0], w.shape[1]).to(torch.bfloat16)


def manual_dma_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``manual_dma``."""
    return x * 2.0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(nbytes: int) -> int:
    return _cdiv(nbytes, 16) * 16


def dot_1d_rows(r: int) -> List[Tuple[int, int]]:
    """The rows [start, stop) of x and of the output that each block of the
    cluster owns, by rank; a block may own none."""
    per = _cdiv(r, DOT_RANKS)
    return [(min(r, k * per), min(r, (k + 1) * per)) for k in range(DOT_RANKS)]


def dot_1d_smem(c: int, n: int) -> int:
    """Shared memory of one dot_1d block (csrc/repros.cu dot_1d_layout):
    the mbarrier, w, the column partials and the mean, the fp32 scratch for
    the per-lane column sums or the per-warp products, the bf16 row."""
    lanes = DOT_THREADS // (c // 8) if c // 8 < DOT_THREADS else 1
    scratch = 4 * max(lanes * c, DOT_THREADS // 32 * n)
    return 16 + _round16(c * n * 2) + 8 * c + scratch + _round16(2 * n)


class DmaPlan(NamedTuple):
    chunk: int  # fp32 elements per chunk, a multiple of 4; a slab's last chunk may be shorter
    per_slab: int  # chunks per [R, C] slab
    per_block: int  # consecutive chunks each block copies (two buffers when more than one)
    grid: int  # blocks


def manual_dma_plan(n: int, r: int, c: int, sms: int = H100_SMS) -> DmaPlan:
    """manual_dma's launch: chunks of a multiple of one 16-byte store per
    thread (2 KB), at most DMA_MAX_CHUNK elements, about one wave of blocks
    over ``sms`` SMs; when there are more chunks than SMs each block loops
    over several."""
    slab, step = r * c, 4 * DMA_THREADS
    chunk = min(_cdiv(_cdiv(slab, max(1, sms // n)), step) * step, DMA_MAX_CHUNK, slab)
    per_slab = _cdiv(slab, chunk)
    per_block = _cdiv(n * per_slab, sms)
    return DmaPlan(chunk, per_slab, per_block, _cdiv(n * per_slab, per_block))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def dot_1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16(bf16(mean_rows(x)) @ w) broadcast to x's rows: [R, N] bf16. The
    shapes the kernel does not take are refused on either device."""
    if x.device.type not in ("cuda", "cpu") or w.device != x.device:
        raise ValueError(f"dot_1d takes CUDA or CPU tensors, got {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"dot_1d takes bfloat16, got {x.dtype} and {w.dtype}")
    if (x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] or x.shape[0] == 0
            or x.shape[1] == 0 or x.shape[1] % 8 or w.shape[1] % 8):
        raise ValueError(f"dot_1d takes x [R, C] and w [C, N] with R > 0, C % 8 == 0 and "
                         f"N % 8 == 0, got {tuple(x.shape)} and {tuple(w.shape)}")
    r, c = x.shape
    n = w.shape[1]
    if dot_1d_smem(c, n) > SMEM_LIMIT:
        raise ValueError(f"dot_1d keeps all of w in each block's shared memory: w {c}x{n} needs "
                         f"{dot_1d_smem(c, n)} bytes with the partials, over {SMEM_LIMIT}; the "
                         f"kernel has no other path")
    if x.device.type == "cpu":
        return dot_1d_reference(x, w)
    x, w = cuda_build.aligned(x), cuda_build.aligned(w)
    out = torch.empty((r, n), device=x.device, dtype=torch.bfloat16)
    lib = cuda_build.load("repros")
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.c3d_dot_1d(x.data_ptr(), w.data_ptr(), out.data_ptr(), r, c, n, _stream(x))
    cuda_build.check(lib, err, "dot_1d")
    dot_1d.launches += 1
    return out


dot_1d.launches = 0


def manual_dma(x: torch.Tensor) -> torch.Tensor:
    """2 * x for x [N, R, C] fp32, each [R, C] slab staged in shared memory
    chunk by chunk. The shapes the kernel does not take are refused on either
    device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"manual_dma takes CUDA or CPU tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"manual_dma takes float32, got {x.dtype}")
    if (x.dim() != 3 or x.numel() == 0 or (x.shape[1] * x.shape[2]) % 4
            or x.shape[1] * x.shape[2] >= 2 ** 31):
        raise ValueError(f"manual_dma takes a non-empty x [N, R, C] with R*C % 4 == 0 and "
                         f"R*C < 2**31 (the kernel's int offsets), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return manual_dma_reference(x)
    n, r, c = x.shape
    plan = manual_dma_plan(n, r, c, _sms(x.device.index))
    x = cuda_build.aligned(x)
    out = torch.empty_like(x)
    lib = cuda_build.load("repros")
    with torch.cuda.device(x.device):
        err = lib.c3d_manual_dma(x.data_ptr(), out.data_ptr(), n, r, c, *plan, _stream(x))
    cuda_build.check(lib, err, "manual_dma")
    manual_dma.launches += 1
    return out


manual_dma.launches = 0


def repro_operands(seed: int, device) -> tuple:
    """Seeded normal operands at the repros' shapes: (x, w) for dot_1d in
    bf16 and x for manual_dma in fp32."""
    g = torch.Generator().manual_seed(seed)
    r, c, n = DOT_1D_SHAPE
    x = torch.randn(r, c, generator=g).to(torch.bfloat16)
    w = torch.randn(c, n, generator=g).to(torch.bfloat16)
    xd = torch.randn(*MANUAL_DMA_SHAPE, generator=g)
    return x.to(device), w.to(device), xd.to(device)


def bf16_ulps_used(got: torch.Tensor, ref: torch.Tensor, ulps: float = 2.0) -> float:
    """max |got - ref| as a share of ``ulps`` bf16 ulps of max(|ref|, 1)."""
    got, ref = got.float(), ref.float()
    tol = ulps * torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1.0))) - 7)
    return float(((got - ref).abs() / tol).max())


def main(seed: int = 0) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the repro kernels need an NVIDIA GPU")
    from change3d_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    x, w, xd = repro_operands(seed, dev)
    got, want = dot_1d(x, w), dot_1d_reference(x, w)
    torch.cuda.synchronize()
    used = bf16_ulps_used(got, want)
    if not (got.shape == want.shape and bool(torch.isfinite(got.float()).all()) and used <= 1.0):
        raise AssertionError(f"dot_1d disagrees with its plain version: {used:.3f} of two bf16 ulps")
    print(f"dot_1d {tuple(x.shape)} x {tuple(w.shape)} bf16: max |d| "
          f"{float((got.float() - want.float()).abs().max())}, {used:.3f} of two bf16 ulps")
    got = manual_dma(xd)
    torch.cuda.synchronize()
    if not torch.equal(got, manual_dma_reference(xd)):
        raise AssertionError("manual_dma is not exactly 2 * x")
    print(f"manual_dma {tuple(xd.shape)} fp32: exact")


if __name__ == "__main__":
    main()
