"""Batch norm with torch BatchNorm3d semantics (counterpart of
``change3d_tpu/ops/norm.py``).

In ``train()`` mode the statistics are the batch's, always in fp32: the mean
and the biased variance E[x^2] - mean^2 (clamped at 0) normalise, and the
running statistics move by the torch momentum rule (running = (1 - m) *
running + m * batch, m = 0.1) with the unbiased variance, var * n / (n - 1)
over the n = B*T*H*W values per channel. The running update happens under
``torch.no_grad()``; gradients flow through the batch statistics. In
``eval()`` mode only the running statistics are used. Either way a/b are
folded in fp32 and applied in the activation dtype.

Under a process group of more than one process, train mode takes the
global batch's statistics, as the JAX step over a sharded batch does: the
per-channel sums of x and x^2 are summed over the processes
(``all_reduce_sum``, whose backward sums too) and divided by the global
count n (every process holds an equal slice, so n is the local count times
the world size); the same formula follows, and the running statistics move
identically on every process.

Under ``recomputing`` (the recompute context that ``models/x3d.py`` gives
``torch.utils.checkpoint`` for ``remat``) train mode computes the batch
statistics again, collectives included, so every process issues the same
all-reduces in the same order, but leaves the running statistics alone:
they move once per step, as in JAX.

``F.batch_norm`` is not used: its variance rounds differently from the JAX
formula this module is held to (and ``nn.SyncBatchNorm`` likewise).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
from torch import nn

from change3d_tpu_torch.parallel import distributed


class _Recomputing(threading.local):
    """Whether this thread is recomputing a checkpointed segment."""

    active = False

    @contextlib.contextmanager
    def _during(self):
        before, self.active = self.active, True
        try:
            yield
        finally:
            self.active = before

    def contexts(self):
        """``checkpoint``'s ``context_fn``: (forward, recompute) contexts."""
        return contextlib.nullcontext(), self._during()


recomputing = _Recomputing()


class BatchNorm(nn.Module):
    """Channel-last BN over all leading axes. Parameters ``scale``/``bias``,
    buffers ``mean``/``var`` (the JAX variable names)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 per-channel (a, b) with y = x * a + b, from the running stats."""
        a = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
        return a, self.bias.float() - self.mean.float() * a

    def _batch_stats(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 batch mean and biased variance; updates the running stats
        (not when recomputing)."""
        x32 = x.float()
        dims = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        world = distributed.world_size()
        if world == 1:
            mean = x32.mean(dims)
            mean_sq = x32.square().mean(dims)
        else:
            n *= world
            sums = distributed.all_reduce_sum(torch.stack([x32.sum(dims),
                                                           x32.square().sum(dims)]))
            mean, mean_sq = sums[0] / n, sums[1] / n
        var = torch.clamp_min(mean_sq - mean.square(), 0.0)
        if recomputing.active:
            return mean, var
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_((1.0 - m) * self.mean + m * mean)
            self.var.copy_((1.0 - m) * self.var + m * (var * (n / max(n - 1, 1))))
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
            a = self.scale * torch.rsqrt(var + self.eps)
            b = self.bias - mean * a
        else:
            a, b = self.folded()
        return x * a.to(x.dtype) + b.to(x.dtype)
