"""Multi-process runs (counterpart of ``change3d_tpu/parallel/distributed.py``):
one process per card, ``torch.distributed`` with NCCL on the card and gloo
on the CPU.

JAX runs the data-parallel step as one program over the global batch; here
every process runs the model on its slice of that batch and the collectives
make the step the global one: ``all_reduce_sum`` sums a tensor over the
processes with a summing backward, so batch-norm statistics and every loss
whose denominator depends on the data are the global batch's, and the
gradients are averaged after the backward (``train/engine.py``).

Host-side agreement (the preemption flag, barriers around rank-0 file
writes, the caption gather) runs on a gloo group of its own, so it never
waits on the card.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

_STATE = {"done": False, "control": None, "exit_hook": False}


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               timeout: Optional[float] = None) -> None:
    """Idempotent process-group start-up with env-var fallbacks
    (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID). With neither an
    address nor a process count the run is single-process and nothing
    starts. ``coordinator_address`` is ``host:port`` of process 0; on
    ``device="cuda"`` each process takes card ``process_id % count`` before
    any CUDA work and the group uses NCCL, on ``"cpu"`` gloo. ``timeout``
    (seconds) bounds every collective; a peer that never arrives raises."""
    if _STATE["done"]:
        return
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address is None and num_processes is None:
        _STATE["done"] = True
        return
    if address is None:
        raise ValueError("a multi-process run needs --coordinator_address host:port "
                         "(or COORDINATOR_ADDRESS)")
    n = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    pid = process_id if process_id is not None else int(os.environ.get("PROCESS_ID", "0"))
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} is not in [0, {n})")
    dev = torch.device(device)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if dev.type == "cuda":
        from change3d_tpu_torch.device import resolve_device

        resolve_device("cuda")
        local = pid % torch.cuda.device_count()
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        kw["device_id"] = dev
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}")
    init = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=init, world_size=n, rank=pid, **kw)
    _STATE["control"] = dist.new_group(backend="gloo", **kw) if backend == "nccl" else None
    # Open every connection now, while all processes stand at one point,
    # and check that the group sums: one all-reduce on the device, one
    # barrier on the host group.
    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)
    assert float(ones) == n, f"warm-up all-reduce gave {float(ones)}, want {n}"
    dist.barrier(group=_STATE["control"])
    _STATE["done"] = True
    if not _STATE["exit_hook"]:
        # Tear the group down before the interpreter does: left to the
        # interpreter's teardown, a gloo process whose peer was still
        # sending to it could die by SIGABRT ("terminate called without an
        # active exception") in place of its own exit code.
        atexit.register(shutdown)
        _STATE["exit_hook"] = True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every process (on the host group); a no-op alone."""
    if world_size() > 1:
        dist.barrier(group=_STATE["control"])


def shutdown() -> None:
    """Tear the process group down; ``initialize`` may run again after."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(done=False, control=None)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the processes, differentiable: the backward sums the
    incoming gradient over the processes too. Every process must call it
    at the same point; alone it returns x itself.

    Each process backpropagates the same global loss, so a process's
    gradient is the world size times its own share of the true gradient;
    the mean over processes is the true gradient (``train/engine.py``)."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x)


def reduce_sum_(tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the processes in place (no autograd). Tensors
    of one dtype go in one flat all-reduce."""
    if world_size() == 1 or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def any_process(flag: bool) -> bool:
    """True on every process if ``flag`` is true on any (a MAX all-reduce
    on the host group)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_STATE["control"])
    return bool(t.item())


def allgather_padded(x: np.ndarray, fill=-1) -> List[np.ndarray]:
    """Every process's ``x`` in process order, on every process. The arrays
    may differ in shape (not in rank or dtype): each is padded with
    ``fill`` to the largest extent of every axis for the gather and cut back
    to its own shape after it."""
    x = np.asarray(x)
    n = world_size()
    if n == 1:
        return [x]
    group = _STATE["control"]
    shape = torch.tensor(x.shape, dtype=torch.int64)
    shapes = [torch.empty_like(shape) for _ in range(n)]
    dist.all_gather(shapes, shape, group=group)
    shapes = [tuple(int(d) for d in s) for s in shapes]
    big = tuple(max(s[k] for s in shapes) for k in range(x.ndim))
    padded = np.full(big, fill, x.dtype)
    padded[tuple(slice(0, d) for d in x.shape)] = x
    mine = torch.from_numpy(padded)
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    return [p.numpy()[tuple(slice(0, d) for d in s)] for p, s in zip(parts, shapes)]
