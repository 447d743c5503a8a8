"""The two minimal Pallas repros as CUDA kernels: their plain PyTorch
versions, the dispatching wrappers, and an entry point that checks both on
the card.

Replaces the TPU kernels of ``tests/manual_pallas_repros.py``
(``repro_dot_1d``, ``repro_manual_dma``), each the smallest case of a
mechanism that the fused X3D block relies on:

  dot_1d(x [R, C] bf16, w [C, N] bf16) -> [R, N] bf16:
      s = bf16(mean over rows of x)        # fp32 sum
      y = bf16(s @ w)                      # fp32 accumulate, one rounding
      every row of the result is y
  manual_dma(x [N, R, C] fp32) -> 2 * x    # slab copy global -> shared, then 2x

The kernels are in ``csrc/repros.cu``. Each wrapper takes its plain version
for a CPU tensor, launches its kernel for a CUDA tensor (or raises), and
counts its launches in ``<wrapper>.launches``.

    python -m change3d_tpu_torch.ops.repros

runs both kernels on the card at the repros' shapes, holds them against
their plain versions and prints one line per kernel; it raises on any
disagreement.
"""

from __future__ import annotations

import torch

from change3d_tpu_torch.ops import cuda_build

# The repros' shapes (tests/manual_pallas_repros.py:33-34, :47).
DOT_1D_SHAPE = (256, 128, 128)  # R, C, N
MANUAL_DMA_SHAPE = (4, 128, 128)  # N, R, C
# Dynamic shared memory a block may take on the H100 (232,448 bytes) less
# the manual_dma kernel's 16-byte barrier slot.
_MAX_SLAB_BYTES = 232448 - 16


def dot_1d_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dot_1d``, rounding where the repro does."""
    s = x.float().mean(dim=0).to(torch.bfloat16).float()
    y = torch.matmul(s, w.float())
    return y.expand(x.shape[0], w.shape[1]).to(torch.bfloat16)


def manual_dma_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``manual_dma``."""
    return x * 2.0


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def dot_1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16(bf16(mean_rows(x)) @ w) broadcast to x's rows: [R, N] bf16."""
    if x.device.type == "cpu":
        return dot_1d_reference(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"dot_1d takes CUDA or CPU tensors, got {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"dot_1d takes bfloat16, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] or w.shape[1] % 8:
        raise ValueError(f"dot_1d takes x [R, C] and w [C, N] with N % 8 == 0, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    r, c = x.shape
    n = w.shape[1]
    x, w = cuda_build.aligned(x), cuda_build.aligned(w)
    out = torch.empty((r, n), device=x.device, dtype=torch.bfloat16)
    lib = cuda_build.load("repros")
    err = lib.c3d_dot_1d(x.data_ptr(), w.data_ptr(), out.data_ptr(), r, c, n, _stream(x))
    cuda_build.check(lib, err, "dot_1d")
    dot_1d.launches += 1
    return out


dot_1d.launches = 0


def manual_dma(x: torch.Tensor) -> torch.Tensor:
    """2 * x for x [N, R, C] fp32, each [R, C] slab staged in shared memory."""
    if x.device.type == "cpu":
        return manual_dma_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"manual_dma takes CUDA or CPU tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"manual_dma takes float32, got {x.dtype}")
    if x.dim() != 3 or (x.shape[1] * x.shape[2]) % 4 or x.shape[1] * x.shape[2] * 4 > _MAX_SLAB_BYTES:
        raise ValueError(f"manual_dma takes x [N, R, C] with R*C % 4 == 0 and a slab of at most "
                         f"{_MAX_SLAB_BYTES} bytes, got {tuple(x.shape)}")
    n, r, c = x.shape
    x = cuda_build.aligned(x)
    out = torch.empty_like(x)
    lib = cuda_build.load("repros")
    err = lib.c3d_manual_dma(x.data_ptr(), out.data_ptr(), n, r, c, _stream(x))
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
