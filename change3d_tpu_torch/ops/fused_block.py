"""Fused X3D bottleneck res-block (inference): CUDA kernels, their plain
PyTorch versions, and the dispatching wrapper.

Replaces the Pallas TPU kernels of ``change3d_tpu/ops/pallas/fused_block.py``
(``fused_bottleneck_block``, ``_htiled``, ``_jtiled``), which compute one
function:

  xa = round(relu(dot(x, Wa) * a_a + b_a))            # fp32 accumulate
  xb = dw3x3x3(xa) * a_b + b_b                        # fp32, zero padding
  g  = sigmoid(relu(mean_thw(xb) @ Wse1 + bse1) @ Wse2 + bse2)   # SE blocks
  xs = round(swish(xb * g))
  y  = round(relu(dot(xs, Wc) * a_c + b_c + x))

where round() is a cast to the activation dtype. Two kernels
(``csrc/fused_block.cu``): ``fused_block_fwd`` computes y given the gate, and
``fused_block_se_sums`` the per-(sample, tile) sums of xb that the gate
needs. Each is a ``torch.library`` custom op (``c3d::fused_block_fwd``,
``c3d::fused_block_se_sums``) whose CPU kernel is its plain version and
whose CUDA kernel launches the CUDA kernel (or raises); the CUDA kernel
counts its launches in ``<wrapper>.launches``. The fake kernels let
``torch.export`` keep both as single graph nodes (``export.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from change3d_tpu_torch.ops import cuda_build
from change3d_tpu_torch.ops.layers import se_gate

# Shared memory a block may take: two blocks fit one SM's 228 KB.
SMEM_TARGET = 112 * 1024
# The narrowest chunk of inner channels worth a pass over the tile.
MIN_CHUNK = 16
# bf16 kernels: threads (warps) per block, and the most conv_c m16n8 output
# tiles a warp keeps in registers (4 fp32 each).
WARPS = 8
MAX_ACC_TILES = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _bf16_smem(t: int, tile: int, c: int, ck: int, frames: Optional[int] = None) -> Tuple[int, int]:
    """(fwd, se_sums) shared-memory bytes of the bf16 kernels for ``t``
    output frames read through ``frames`` halo frames (default t: the whole
    clip, no temporal halo): the layout of csrc/fused_block.cu (Bf16Layout),
    rows padded to 16 for the mma and row strides padded by 8 elements
    against bank conflicts."""
    pad = lambda a: _ceil(a, 16) * 16
    nh, nc = (t if frames is None else frames) * (tile + 2) ** 2, t * tile * tile
    sx, ckp = pad(c) + 8, pad(ck)
    front = (pad(nh) * sx + ckp * sx + nh * ckp) * 2
    fwd = front + (pad(nc) + c) * (ckp + 8) * 2
    sums = front + t * tile * (tile // 4) * ckp * 4
    return fwd, sums


class BlockPlan(NamedTuple):
    """How the kernels cover one block shape: ``tt``-frame temporal tiles of
    ``tile`` x ``tile`` pixels, Ci walked in chunks of ``ck``, the bytes of
    shared memory of each kernel, and the blocks per sample (T-tiles x
    H-tiles x W-tiles, T outermost, each row-major)."""

    tt: int
    tile: int
    ck: int
    smem_fwd: int
    smem_sums: int
    n_tiles: int


def halo_frames(t: int, tt: int) -> int:
    """Frames a T-tile reads: its tt frames and one on each side, or the
    whole clip when one tile covers it (zero padding, nothing to read)."""
    return tt + 2 if tt < t else t


def _temporal_tiles(t: int):
    """tt = ceil(T / n) for n = 1, 2, ...: fewest T-tiles first, each count
    with its shortest tile."""
    seen = []
    for n in range(1, t + 1):
        tt = _ceil(t, n)
        if tt not in seen:
            seen.append(tt)
            yield tt


def _plan_bf16(t: int, h: int, w: int, c: int, ci: int) -> BlockPlan:
    """The fewest T-tiles, then the largest square tile in (16, 8, 4), whose
    conv_c accumulators fit MAX_ACC_TILES per warp, with the fewest chunks
    of Ci (a multiple of 8 channels, at least MIN_CHUNK) that fit
    SMEM_TARGET. One T-tile (tt = T) wherever that fits."""
    for tt in _temporal_tiles(t):
        for tile in (16, 8, 4):
            if _ceil(_ceil(tt * tile * tile, 16) * _ceil(c, 8), WARPS) > MAX_ACC_TILES:
                continue
            n_chunks = 1
            while True:
                ck = min(ci, _ceil(_ceil(ci, n_chunks), 8) * 8)
                if ck < min(ci, MIN_CHUNK):
                    break
                fwd, sums = _bf16_smem(tt, tile, c, ck, halo_frames(t, tt))
                if fwd <= SMEM_TARGET:
                    n_tiles = _ceil(t, tt) * _ceil(h, tile) * _ceil(w, tile)
                    return BlockPlan(tt, tile, ck, fwd, sums, n_tiles)
                n_chunks += 1
    raise ValueError(f"no bf16 tile fits {SMEM_TARGET} B of shared memory for T={t} C={c} Ci={ci}")


def plan_block(t: int, h: int, w: int, c: int, ci: int, itemsize: int) -> BlockPlan:
    """The kernels' plan for one block shape and I/O dtype size.

    bf16 (itemsize 2): ``_plan_bf16``. fp32: the fewest T-tiles, then the
    largest square tile in (8, 4, 2, 1), whose input tile, conv_c
    accumulator and a chunk of at least MIN_CHUNK inner channels fit
    SMEM_TARGET; Ci is then split into equal chunks. The byte counts follow
    the shared-memory layouts documented in csrc/fused_block.cu. A T-tile
    shorter than the clip reads one more frame on each side (zeros outside
    the clip) and recomputes conv_a there: 2 / tt more conv_a work.
    """
    if itemsize == 2:
        return _plan_bf16(t, h, w, c, ci)
    for tt in _temporal_tiles(t):
        for tile in (8, 4, 2, 1):
            halo, core = halo_frames(t, tt) * (tile + 2) ** 2, tt * tile * tile
            x_bytes, acc_bytes = halo * c * itemsize, core * c * 4
            per_ck = (halo + core) * 4
            ck_max = (SMEM_TARGET - x_bytes - acc_bytes) // per_ck
            if ck_max >= min(ci, MIN_CHUNK):
                n_chunks = -(-ci // min(ck_max, ci))
                ck = -(-ci // n_chunks)
                n_tiles = _ceil(t, tt) * _ceil(h, tile) * _ceil(w, tile)
                smem_sums = x_bytes + per_ck * ck
                return BlockPlan(tt, tile, ck, smem_sums + acc_bytes, smem_sums, n_tiles)
    raise ValueError(f"no tile fits {SMEM_TARGET} B of shared memory for T={t} C={c} Ci={ci}")


def plan_tiles(t: int, h: int, w: int, c: int, ci: int, itemsize: int):
    """(tile, ck, smem_fwd, smem_sums, n_tiles) of ``plan_block``: the plan
    without its temporal tile."""
    return tuple(plan_block(t, h, w, c, ci, itemsize))[1:]


# The launches' plans: a model has a handful of block shapes, and every
# launch plans one (the fake kernels call plan_block itself, on sizes that
# may be symbolic and so unhashable).
_launch_plan = functools.lru_cache(maxsize=None)(plan_block)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _front_reference(x, w_a, a_a, b_a, w_dw, a_b, b_b) -> torch.Tensor:
    """conv_a -> BN_a -> ReLU -> round -> 27 depthwise taps -> BN_b: fp32 xb."""
    dt = x.dtype
    xa = torch.matmul(x.float(), w_a.to(dt).float())
    xa = torch.relu(xa * a_a.float() + b_a.float()).to(dt).float()
    t, h, w = x.shape[1:4]
    xp = F.pad(xa, (0, 0, 1, 1, 1, 1, 1, 1))  # zero-pad T, H, W
    w_dw = w_dw.float()
    acc = torch.zeros_like(xa)
    for i in range(3):
        for j in range(3):
            for k in range(3):
                acc = acc + xp[:, i:i + t, j:j + h, k:k + w] * w_dw[i, j, k]
    return acc * a_b.float() + b_b.float()


def _back_reference(x, xb, gate, w_c, a_c, b_c) -> torch.Tensor:
    """(gate) -> swish -> round -> conv_c -> BN_c -> + x -> ReLU -> round."""
    dt = x.dtype
    if gate is not None:
        xb = xb * gate.float()[:, None, None, None, :]
    xs = (xb * torch.sigmoid(xb)).to(dt).float()
    xc = torch.matmul(xs, w_c.to(dt).float()) * a_c.float() + b_c.float()
    return torch.relu(xc + x.float()).to(dt)


def fused_block_fwd_reference(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate=None):
    """Plain version of ``fused_block_fwd``: the block given its SE gate [B, Ci]."""
    xb = _front_reference(x, w_a, a_a, b_a, w_dw, a_b, b_b)
    return _back_reference(x, xb, gate, w_c, a_c, b_c)


def se_sums_reference(x, w_a, a_a, b_a, w_dw, a_b, b_b) -> torch.Tensor:
    """Plain version of ``fused_block_se_sums``: sums of xb over each of the
    kernel's T x H x W tiles (``plan_block``: T-tiles outermost, then
    row-major), [B, n_tiles, Ci] fp32; tiles that hang over an edge sum what
    lies inside."""
    xb = _front_reference(x, w_a, a_a, b_a, w_dw, a_b, b_b)
    b, t, h, w, ci = xb.shape
    tt, tile, _, _, _, _ = plan_block(t, h, w, x.shape[-1], ci, x.element_size())
    nt, nh, nw = -(-t // tt), -(-h // tile), -(-w // tile)
    xb = F.pad(xb, (0, 0, 0, nw * tile - w, 0, nh * tile - h, 0, nt * tt - t))
    xb = xb.reshape(b, nt, tt, nh, tile, nw, tile, ci).sum(dim=(2, 4, 6))
    return xb.reshape(b, nt * nh * nw, ci)


def fused_block_reference(
    x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, se: Optional[tuple] = None
) -> torch.Tensor:
    """Plain version of the whole block, with the Pallas signature
    (``fused_bottleneck_block(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c,
    b_c, se)``), rounding at the kernel's three points."""
    xb = _front_reference(x, w_a, a_a, b_a, w_dw, a_b, b_b)
    gate = None
    if se is not None:
        gate = se_gate(xb.mean(dim=(1, 2, 3)), *se)
    return _back_reference(x, xb, gate, w_c, a_c, b_c)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda_args(x: torch.Tensor, w_a: torch.Tensor) -> Tuple[int, ...]:
    if x.device.type != "cuda":
        raise ValueError(f"fused block kernels take CUDA or CPU tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused block kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or w_a.dim() != 2 or w_a.shape[0] != x.shape[-1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_a {tuple(w_a.shape)}")
    if x.dtype == torch.bfloat16 and (x.shape[-1] % 8 or w_a.shape[1] % 2):
        raise ValueError(f"the bf16 kernels take C % 8 == 0 and Ci % 2 == 0, got C={x.shape[-1]} "
                         f"Ci={w_a.shape[1]}")
    return tuple(x.shape) + (w_a.shape[1],)



def _f32(v: torch.Tensor, x: torch.Tensor, numel: int, what: str) -> torch.Tensor:
    """v as a contiguous fp32 tensor on x's device, holding ``numel`` values
    (the kernel reads exactly that many)."""
    if v.numel() != numel:
        raise ValueError(f"{what} holds {v.numel()} values, the kernel reads {numel}")
    return cuda_build.aligned(v.to(device=x.device, dtype=torch.float32))


def _front_args(x, w_a, a_a, b_a, w_dw, a_b, b_b):
    """Kernel operands of the shared front half, on x's device, contiguous:
    conv weights in x's dtype, everything else fp32 (what the Pallas wrappers
    pass)."""
    ci = w_a.shape[1]
    if tuple(w_dw.shape) != (3, 3, 3, ci):
        raise ValueError(f"w_dw {tuple(w_dw.shape)} != {(3, 3, 3, ci)}")
    return (
        cuda_build.aligned(x), cuda_build.aligned(w_a.to(device=x.device, dtype=x.dtype)),
        _f32(a_a, x, ci, "a_a"), _f32(b_a, x, ci, "b_a"), _f32(w_dw, x, 27 * ci, "w_dw"),
        _f32(a_b, x, ci, "a_b"), _f32(b_b, x, ci, "b_b"),
    )


# The two kernels are the custom ops ``c3d::fused_block_se_sums`` and
# ``c3d::fused_block_fwd``: their CPU kernel is the plain version, their CUDA
# kernel the ctypes launch, and their fake kernel gives the output's shape
# from the static T, H, W, C and Ci (the batch may stay symbolic), so
# ``torch.export`` puts one node per kernel launch into the graph whatever
# device it traces on. No other device has a kernel: the dispatcher raises.
# The CUDA kernels launch with x's card as the current device: the C side
# sets attributes and launches on whatever card is current, which in a
# process that drives several cards need not be x's.

_SE_SUMS_SCHEMA = ("(Tensor x, Tensor w_a, Tensor a_a, Tensor b_a, Tensor w_dw, Tensor a_b, "
                   "Tensor b_b) -> Tensor")
_FWD_SCHEMA = ("(Tensor x, Tensor w_a, Tensor a_a, Tensor b_a, Tensor w_dw, Tensor a_b, "
               "Tensor b_b, Tensor w_c, Tensor a_c, Tensor b_c, Tensor? gate) -> Tensor")


def _se_sums_cpu(x, w_a, a_a, b_a, w_dw, a_b, b_b):
    return se_sums_reference(x, w_a, a_a, b_a, w_dw, a_b, b_b).contiguous()


def _fwd_cpu(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate):
    return fused_block_fwd_reference(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c,
                                     gate).contiguous()


_se_sums_op = torch.library.custom_op("c3d::fused_block_se_sums", _se_sums_cpu, mutates_args=(),
                                      device_types="cpu", schema=_SE_SUMS_SCHEMA)
_fwd_op = torch.library.custom_op("c3d::fused_block_fwd", _fwd_cpu, mutates_args=(),
                                  device_types="cpu", schema=_FWD_SCHEMA)


@_se_sums_op.register_kernel("cuda")
def _se_sums_cuda(x, w_a, a_a, b_a, w_dw, a_b, b_b):
    b, t, h, w, c, ci = _check_cuda_args(x, w_a)
    args = _front_args(x, w_a, a_a, b_a, w_dw, a_b, b_b)
    tt, tile, ck, _, smem, n_tiles = _launch_plan(t, h, w, c, ci, x.element_size())
    sums = torch.empty((b, n_tiles, ci), device=x.device, dtype=torch.float32)
    lib = cuda_build.load("fused_block")
    with torch.cuda.device(x.device):
        err = lib.c3d_fused_block_se_sums(
            _DTYPES[x.dtype], args[0].data_ptr(), sums.data_ptr(),
            *(a.data_ptr() for a in args[1:]),
            b, t, h, w, c, ci, tt, tile, ck, smem,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "fused_block_se_sums")
    fused_block_se_sums.launches += 1
    return sums


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate):
    b, t, h, w, c, ci = _check_cuda_args(x, w_a)
    if w_c.shape != (ci, c):
        raise ValueError(f"w_c {tuple(w_c.shape)} != {(ci, c)}")
    args = _front_args(x, w_a, a_a, b_a, w_dw, a_b, b_b)
    back = (
        cuda_build.aligned(w_c.to(device=x.device, dtype=x.dtype)),
        _f32(a_c, x, c, "a_c"), _f32(b_c, x, c, "b_c"),
    )
    if gate is not None:
        if gate.shape != (b, ci):
            raise ValueError(f"gate {tuple(gate.shape)} != {(b, ci)}")
        gate = _f32(gate, x, b * ci, "gate")
    tt, tile, ck, smem, _, _ = _launch_plan(t, h, w, c, ci, x.element_size())
    out = torch.empty_like(args[0])
    lib = cuda_build.load("fused_block")
    with torch.cuda.device(x.device):
        err = lib.c3d_fused_block_fwd(
            _DTYPES[x.dtype], args[0].data_ptr(), out.data_ptr(),
            *(a.data_ptr() for a in args[1:]),
            None if gate is None else gate.data_ptr(),
            *(a.data_ptr() for a in back),
            b, t, h, w, c, ci, tt, tile, ck, smem,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "fused_block_fwd")
    fused_block_fwd.launches += 1
    return out


@_se_sums_op.register_fake
def _se_sums_fake(x, w_a, a_a, b_a, w_dw, a_b, b_b):
    t, h, w, c = x.shape[1:]
    ci = w_a.shape[1]
    n_tiles = plan_block(t, h, w, c, ci, x.element_size()).n_tiles
    return x.new_empty((x.shape[0], n_tiles, ci), dtype=torch.float32)


@_fwd_op.register_fake
def _fwd_fake(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate):
    return x.new_empty(x.shape)


def fused_block_se_sums(x, w_a, a_a, b_a, w_dw, a_b, b_b) -> torch.Tensor:
    """Per-(sample, tile) sums of xb, [B, n_tiles, Ci] fp32
    (``c3d::fused_block_se_sums``)."""
    return _se_sums_op(x, w_a, a_a, b_a, w_dw, a_b, b_b)


fused_block_se_sums.launches = 0


def fused_block_fwd(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate=None) -> torch.Tensor:
    """The block given its SE gate ([B, Ci] fp32, None for non-SE blocks)
    (``c3d::fused_block_fwd``)."""
    return _fwd_op(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate)


fused_block_fwd.launches = 0


def blocks_per_sm(dtype: torch.dtype, se_sums: bool, t: int, h: int, w: int, c: int,
                  ci: int) -> int:
    """Blocks of the kernel for this shape that one SM of the current card
    holds at once (CUDA's occupancy calculator)."""
    tt, tile, ck, smem_fwd, smem_sums, _ = plan_block(
        t, h, w, c, ci, torch.empty((), dtype=dtype).element_size())
    lib = cuda_build.load("fused_block")
    return lib.c3d_fused_block_blocks_per_sm(_DTYPES[dtype], int(se_sums), t, tt, c, ci, tile,
                                             ck, smem_sums if se_sums else smem_fwd)


def fused_bottleneck_block(
    x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, se: Optional[tuple] = None
) -> torch.Tensor:
    """x: [B,T,H,W,C]; w_a: [C,Ci]; w_dw: [3,3,3,Ci]; w_c: [Ci,C]; a_*/b_*
    folded BN vectors; se: (w1 [Ci,Cr], b1, w2 [Cr,Ci], b2) or None.
    Stride-1, dim-preserving blocks only. SE blocks launch both kernels,
    the gate FCs run in plain torch between them."""
    gate = None
    if se is not None:
        t, h, w = x.shape[1:4]
        sums = fused_block_se_sums(x, w_a, a_a, b_a, w_dw, a_b, b_b)
        gate = se_gate(sums.sum(dim=1) / (t * h * w), *se)
    return fused_block_fwd(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate)
