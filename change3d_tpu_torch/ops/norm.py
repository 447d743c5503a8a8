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

In eval the folded (a, b) are kept (``InferenceCache``) while the four
tensors they come from are unchanged and no gradient is recorded, so a
forward does not fold again what the last one folded.

``F.batch_norm`` is not used: its variance rounds differently from the JAX
formula this module is held to (and ``nn.SyncBatchNorm`` likewise).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence, Tuple

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


class InferenceCache:
    """A value made from parameters and buffers, kept for as long as they
    are unchanged: the key is each source's version counter (which every
    in-place write bumps: an optimizer step, ``load_state_dict``, a running
    statistic) and its address (``.to``, a replaced parameter), and the
    sources are held with the value, so no other tensor can take their
    address meanwhile. While autograd records, under a trace such as
    ``torch.export``, or for a source without a version counter (an
    inference tensor) the value is made anew every time and not kept."""

    def __init__(self):
        self._key = self._value = self._held = None

    def get(self, make: Callable, sources: Sequence[torch.Tensor], *extra):
        """``make()``, or the value it gave under the same sources and
        ``extra`` (hashable, e.g. a dtype)."""
        if (torch.is_grad_enabled() or torch.compiler.is_compiling()
                or any(t.is_inference() for t in sources)):
            return make()
        key = (*extra, *((t._version, t.data_ptr()) for t in sources))
        if key != self._key:
            self._value, self._key = make(), key
            self._held = [t.detach() for t in sources]
        return self._value


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
        self._folded = InferenceCache()

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 per-channel (a, b) with y = x * a + b, from the running stats."""

        def fold():
            a = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
            return a, self.bias.float() - self.mean.float() * a

        return self._folded.get(fold, (self.scale, self.bias, self.mean, self.var), self.eps)

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
