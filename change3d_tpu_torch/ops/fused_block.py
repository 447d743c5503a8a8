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
counts its launches in ``<wrapper>.launches``. Where ``plan_block`` gives a
T-tiled bf16 shape the split design, the CUDA kernel of either op runs
the xa pass (xa at every position, into a scratch buffer) and then the
kernel's tail on it. The fake kernels let ``torch.export`` keep both as
single graph nodes (``export.py``).
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
# ... and a weight-resident block, alone on its SM: the most one block may
# take on an H100 (227 KB).
SMEM_RESIDENT = 227 * 1024
# Tiles a weight-resident block works on at once, each by WARPS warps, and
# the most conv_c accumulator tiles its warps keep (it is built for 8).
RESIDENT_GROUPS = 2
RESIDENT_ACC_TILES = 8
# The narrowest chunk of inner channels worth a pass over the tile.
MIN_CHUNK = 16
# bf16 kernels: threads (warps) per block, and the most conv_c m16n8 output
# tiles a warp keeps in registers (4 fp32 each).
WARPS = 8
MAX_ACC_TILES = 16
# The split design's xa pass: positions x channels a block computes.
XA_ROWS, XA_COLS = 16 * WARPS, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pad16(a: int) -> int:
    return _ceil(a, 16) * 16


def _bf16_smem(t: int, tile: int, c: int, ck: int, frames: Optional[int] = None,
               staged: bool = True) -> Tuple[int, int]:
    """(fwd, se_sums) shared-memory bytes of the bf16 kernels for ``t``
    output frames read through ``frames`` halo frames (default t: the whole
    clip, no temporal halo): the layout of csrc/fused_block.cu (Bf16Layout),
    rows padded to 16 for the mma and row strides padded by 8 elements
    against bank conflicts. ``staged`` False: one tile of a weight-resident
    block, without the chunk's weights."""
    nh, nc = (t if frames is None else frames) * (tile + 2) ** 2, t * tile * tile
    sx, ckp = _pad16(c) + 8, _pad16(ck)
    front = (_pad16(nh) * sx + (ckp * sx if staged else 0) + nh * ckp) * 2
    fwd = front + (_pad16(nc) + (c if staged else 0)) * (ckp + 8) * 2
    sums = front + t * tile * (tile // 4) * ckp * 4
    return fwd, sums


def _odd16_stride(n: int) -> int:
    """A row stride (elements) for rows of n bf16 that is an odd number of
    16-byte units (csrc/fused_block.cu: odd16_stride)."""
    s = _ceil(n, 8) * 8
    return s if s // 8 % 2 else s + 8


def _resident_smem(t: int, tile: int, c: int, ci: int, ck: int) -> Tuple[int, int]:
    """(fwd, se_sums) shared-memory bytes of the weight-resident block
    (csrc/fused_block.cu: ResidentLayout): w_a as [pad16(C)] rows and, for
    fwd, w_c as rows up to the last chunk's start plus pad16(ck), each row
    an odd number of 16-byte units; the fp32 BN vectors (four of Ci, and
    for fwd two of C); then RESIDENT_GROUPS tiles without weights."""
    w_a = _pad16(c) * _odd16_stride(ci) * 2
    w_c = ((_ceil(ci, ck) - 1) * ck + _pad16(ck)) * _odd16_stride(c) * 2
    fwd, sums = _bf16_smem(t, tile, c, ck, staged=False)
    return (w_a + w_c + (4 * ci + 2 * c) * 4 + RESIDENT_GROUPS * fwd,
            w_a + 4 * ci * 4 + RESIDENT_GROUPS * sums)


def _split_smem(tt: int, tile: int, c: int, ck: int, frames: int) -> Tuple[int, int]:
    """(fwd, se_sums) shared-memory bytes of a split tail's tile
    (csrc/fused_block.cu: SplitLayout): two buffers of the xa halo chunk,
    [nh][pad16(ck)]; for fwd two of w_c's chunk rows, [pad16(ck)][C as an
    odd number of 16-byte units], xs [pad16(nc)][pad16(ck) + 8] and x's core
    [nc][pad16(C) + 8]; for se_sums the partial sums after the xa buffers."""
    nh, nc, ckp = frames * (tile + 2) ** 2, tt * tile * tile, _pad16(ck)
    xa = 2 * nh * ckp * 2
    fwd = xa + (2 * ckp * _odd16_stride(c) + _pad16(nc) * (ckp + 8) + nc * (_pad16(c) + 8)) * 2
    return fwd, xa + tt * tile * (tile // 4) * ckp * 4


def _xa_smem(c: int) -> int:
    """Shared-memory bytes of the xa pass (csrc/fused_block.cu: XaLayout):
    XA_ROWS rows of x, w_a's XA_COLS columns as [pad16(C)] rows of an odd
    number of 16-byte units, the output tile."""
    kp = _pad16(c)
    return (XA_ROWS * (kp + 8) + kp * _odd16_stride(XA_COLS) + XA_ROWS * (XA_COLS + 8)) * 2


class BlockPlan(NamedTuple):
    """How the kernels cover one block shape: ``tt``-frame temporal tiles of
    ``tile`` x ``tile`` pixels, Ci walked in chunks of ``ck``, the bytes of
    shared memory of each kernel, the tiles per sample (T-tiles x H-tiles x
    W-tiles, T outermost, each row-major), and the design that runs them:
    weight-resident (``resident``: persistent blocks that keep w_a and w_c
    in shared memory), split (``split``: an xa pass computes conv_a once per
    position, then a block per tile reads its xa halo), else a block per
    tile that stages each chunk's weights and computes conv_a on its halo."""

    tt: int
    tile: int
    ck: int
    smem_fwd: int
    smem_sums: int
    n_tiles: int
    resident: bool = False
    split: bool = False


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


def _plan_resident(t: int, c: int, ci: int, staged: BlockPlan) -> Optional[BlockPlan]:
    """The weight-resident plan for a block whose staged plan is one
    T-tile of the register-capped 4 x 4 tiles (at most RESIDENT_ACC_TILES
    accumulator tiles a warp): the fewest chunks of Ci (a multiple of 8
    channels, at least MIN_CHUNK) with which all of w_a and w_c, the BN
    vectors and RESIDENT_GROUPS tiles fit SMEM_RESIDENT; None where the
    weights do not fit (X3D-L's stage 4) or the plan is another."""
    acc_tiles = _ceil(_ceil(t * 16, 16) * _ceil(c, 8), WARPS)
    if staged.tile != 4 or staged.tt != t or c % 8 or ci % 8 or acc_tiles > RESIDENT_ACC_TILES:
        return None
    n_chunks = 1
    while True:
        ck = min(ci, _ceil(_ceil(ci, n_chunks), 8) * 8)
        if ck < min(ci, MIN_CHUNK):
            return None
        fwd, sums = _resident_smem(t, 4, c, ci, ck)
        if fwd <= SMEM_RESIDENT:
            return BlockPlan(t, 4, ck, fwd, sums, staged.n_tiles, True)
        n_chunks += 1


def _plan_split(t: int, c: int, ci: int, staged: BlockPlan) -> Optional[BlockPlan]:
    """The split plan for a block whose staged plan takes T-tiles (tt < T,
    where each tile recomputes conv_a on a halo of tt + 2 frames): the
    staged plan's tt and tile (so the se-sums rows), with the fewest chunks
    of Ci, each a multiple of 16 channels (conv_c's K steps then group the
    channels as at any such ck: the same numbers bit for bit), with which
    the tail fits SMEM_TARGET; None for a one-T-tile plan or an xa pass
    that does not fit."""
    if staged.tt == t or _xa_smem(c) > SMEM_TARGET:
        return None
    frames = halo_frames(t, staged.tt)
    for n_chunks in range(1, _ceil(ci, MIN_CHUNK) + 1):
        ck = min(ci, _pad16(_ceil(ci, n_chunks)))
        fwd, sums = _split_smem(staged.tt, staged.tile, c, ck, frames)
        if fwd <= SMEM_TARGET:
            return staged._replace(ck=ck, smem_fwd=fwd, smem_sums=sums, split=True)
    return None


def plan_block(t: int, h: int, w: int, c: int, ci: int, itemsize: int) -> BlockPlan:
    """The kernels' plan for one block shape and I/O dtype size.

    bf16 (itemsize 2): ``_plan_bf16``, run by the split design where
    ``_plan_split`` gives a plan (T-tiles shorter than the clip), by the
    weight-resident design where ``_plan_resident`` does (the shape alone
    decides either). fp32:
    the fewest T-tiles, then the largest square tile in (8, 4, 2, 1), whose
    input tile, conv_c accumulator and a chunk of at least MIN_CHUNK inner
    channels fit SMEM_TARGET; Ci is then split into equal chunks. The byte
    counts follow the shared-memory layouts documented in
    csrc/fused_block.cu. A T-tile shorter than the clip reads one more frame
    on each side (zeros outside the clip); in fp32 it recomputes conv_a
    there: 2 / tt more conv_a work.
    """
    if itemsize == 2:
        staged = _plan_bf16(t, h, w, c, ci)
        return _plan_split(t, c, ci, staged) or _plan_resident(t, c, ci, staged) or staged
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
    without its temporal tile and its design."""
    return tuple(plan_block(t, h, w, c, ci, itemsize))[1:6]


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
    tt, tile = plan_block(t, h, w, x.shape[-1], ci, x.element_size())[:2]
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


def _design(plan: BlockPlan) -> int:
    """The design as the C entry points take it: 0 staged, 1 resident, 2 split."""
    return 2 if plan.split else int(plan.resident)


def _launch_xa(x, w_a, a_a, b_a) -> torch.Tensor:
    """The split design's xa pass on the card: round(relu(x @ w_a * a_a +
    b_a)) at every position, [B, T, H, W, Ci rounded up to 8] bf16 (zeros
    in the channels from Ci on; ``fused_block_xa_kernel``; the operands as
    ``_front_args`` makes them)."""
    b, t, h, w, c, ci = _check_cuda_args(x, w_a)
    xa = torch.empty((b, t, h, w, _ceil(ci, 8) * 8), device=x.device, dtype=x.dtype)
    lib = cuda_build.load("fused_block")
    with torch.cuda.device(x.device):
        err = lib.c3d_fused_block_xa(
            x.data_ptr(), xa.data_ptr(), w_a.data_ptr(), a_a.data_ptr(), b_a.data_ptr(),
            b, t, h, w, c, ci, _xa_smem(c), torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "fused_block_xa")
    return xa


def _split_input(plan: BlockPlan, args, xa: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The xa a split plan's tail reads: ``xa`` where given (checked), else
    the xa pass's output on ``_front_args``' operands; None for the other
    designs."""
    if not plan.split:
        return None
    if xa is None:
        return _launch_xa(*args[:4])
    b, t, h, w, _ = args[0].shape
    want = (b, t, h, w, _ceil(args[1].shape[1], 8) * 8)
    if xa.shape != want or xa.dtype != args[0].dtype or not xa.is_contiguous():
        raise ValueError(f"xa {tuple(xa.shape)} {xa.dtype} is not the xa pass's {want}")
    return xa


def _launch_se_sums(x, w_a, a_a, b_a, w_dw, a_b, b_b, plan: Optional[BlockPlan] = None,
                    xa: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fused_block_se_sums`` on the card under ``plan_block``'s plan, or
    under ``plan`` (the card tests and tools/phase_clocks.py run a shape's
    staged plan too). A split plan runs the xa pass, then the tail on its
    output, or the tail alone on ``xa`` where given (the tools time the two
    apart)."""
    b, t, h, w, c, ci = _check_cuda_args(x, w_a)
    plan = plan or _launch_plan(t, h, w, c, ci, x.element_size())
    args = _front_args(x, w_a, a_a, b_a, w_dw, a_b, b_b)
    xa = _split_input(plan, args, xa)
    sums = torch.empty((b, plan.n_tiles, ci), device=x.device, dtype=torch.float32)
    lib = cuda_build.load("fused_block")
    with torch.cuda.device(x.device):
        err = lib.c3d_fused_block_se_sums(
            _DTYPES[x.dtype], args[0].data_ptr(), sums.data_ptr(),
            *(a.data_ptr() for a in args[1:]),
            b, t, h, w, c, ci, plan.tt, plan.tile, plan.ck, plan.smem_sums, _design(plan),
            None if xa is None else xa.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "fused_block_se_sums")
    return sums


@_se_sums_op.register_kernel("cuda")
def _se_sums_cuda(x, w_a, a_a, b_a, w_dw, a_b, b_b):
    sums = _launch_se_sums(x, w_a, a_a, b_a, w_dw, a_b, b_b)
    fused_block_se_sums.launches += 1
    return sums


def _launch_fwd(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate,
                plan: Optional[BlockPlan] = None, xa: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``fused_block_fwd`` on the card (plans and ``xa`` as ``_launch_se_sums``)."""
    b, t, h, w, c, ci = _check_cuda_args(x, w_a)
    plan = plan or _launch_plan(t, h, w, c, ci, x.element_size())
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
    xa = _split_input(plan, args, xa)
    out = torch.empty_like(args[0])
    lib = cuda_build.load("fused_block")
    with torch.cuda.device(x.device):
        err = lib.c3d_fused_block_fwd(
            _DTYPES[x.dtype], args[0].data_ptr(), out.data_ptr(),
            *(a.data_ptr() for a in args[1:]),
            None if gate is None else gate.data_ptr(),
            *(a.data_ptr() for a in back),
            b, t, h, w, c, ci, plan.tt, plan.tile, plan.ck, plan.smem_fwd, _design(plan),
            None if xa is None else xa.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "fused_block_fwd")
    return out


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate):
    out = _launch_fwd(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, gate)
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
    plan = plan_block(t, h, w, c, ci, torch.empty((), dtype=dtype).element_size())
    lib = cuda_build.load("fused_block")
    return lib.c3d_fused_block_blocks_per_sm(
        _DTYPES[dtype], int(se_sums), t, plan.tt, c, ci, plan.tile, plan.ck,
        plan.smem_sums if se_sums else plan.smem_fwd, _design(plan))


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
