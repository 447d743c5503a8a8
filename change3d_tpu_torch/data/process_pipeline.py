"""The worker-process loader (counterpart of
``change3d_tpu/data/grain_pipeline.py``, the JAX package's ``--loader
grain``): decoding and augmentation spread over processes for corpora
where threads are not enough.

It uses ``torch.utils.data`` worker processes, not grain (whose import
pulls in jax). Its surface and batches are the threaded ``DataLoader``'s
(``data/pipeline.py``), which are the JAX package's threaded loader's:
``len``, ``set_epoch``, ``iter_from`` (resume mid-epoch without decoding
the prefix), the same collate functions, the epoch order of
``RandomState(seed + epoch)``, training dropping the ragged final batch and
evaluation padding it with a ``valid`` mask on every batch, and
``num_shards`` / ``shard_index`` slicing each global batch contiguously.
As in the grain loader, each record draws its augmentation from a generator
of its own, here the threaded loader's ``default_rng((seed, epoch, batch,
slot))`` with the global batch index and the record's slot in the global
batch: batches do not depend on the worker count or the shard count. (The
JAX grain loader shuffles and seeds otherwise, so its batches are not these.)

A worker assembles one whole (shard of a) batch and hands its arrays back
as tensors in shared memory, read here as numpy arrays without a copy.

Workers start by ``forkserver``. The parent has CUDA up (the loops move the
model to the card before the first batch) and runs threads, so it must not
fork. The fork server is a fresh single-threaded interpreter that imports
torch and the data modules once (``PRELOAD``), never touches CUDA, and
forks every worker of every loader of the process from itself; ``spawn``
would start each worker as a new interpreter importing torch, seconds per
loader. Each worker imports the parent's main module as ``__mp_main__``
(``python -m change3d_tpu_torch.cli`` keeps ``main()`` behind its
``__main__`` check). Workers start at the first iteration and persist
across epochs; the loader's ``close`` (or its collection) stops them. At
the exit of a process that started workers, the fork server and the
resource tracker that came with it are stopped and waited for, so that no
process outlives its parent. ``num_workers=0`` runs in process.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import multiprocessing.util
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.utils.data

from change3d_tpu_torch.data.pipeline import DataLoader

# Batches each worker may assemble ahead of the consumer.
_PREFETCH = 2
# What the fork server imports before it forks a worker.
PRELOAD = ["change3d_tpu_torch.data.process_pipeline", "change3d_tpu_torch.data.datasets"]
_stop_registered = False


def _fork_server():
    global _stop_registered
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)  # no effect once the server runs
    if not _stop_registered:
        # Priority -1: multiprocessing's exit hook runs it last, after it has
        # joined the workers and released their queues' semaphores.
        multiprocessing.util.Finalize(None, _stop_servers, exitpriority=-1)
        _stop_registered = True
    return ctx


def _stop_servers() -> None:
    """Stops the fork server and the resource tracker and waits for both
    to end. Left alone, each ends only after this process has exited."""
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


class _Batches(torch.utils.data.Dataset):
    """Assembles the batch a spec (epoch, global batch index, this shard's
    sample indices, valid count) names; runs in a worker."""

    def __init__(self, loader: "ProcessDataLoader"):
        self.dataset = loader.dataset
        self.collate = loader.collate
        self.seed = loader.seed
        self.batch_size = loader.batch_size
        self.pad_final = loader.pad_final
        self.lo = loader.shard_index * loader.local_batch_size

    def __getitem__(self, spec) -> Dict[str, object]:
        epoch, bi, idxs, valid = spec
        # Seeded by the global slot, as the threaded loader's samples are.
        samples = [self.dataset.__getitem__(
            int(idx), np.random.default_rng((self.seed, epoch, bi, self.lo + j)))
            for j, idx in enumerate(idxs)]
        batch = self.collate(samples)
        if self.pad_final:
            rows = np.arange(self.batch_size) < valid
            batch["valid"] = rows[self.lo:self.lo + len(idxs)]
        if torch.utils.data.get_worker_info() is None:
            return batch
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


class _Specs(torch.utils.data.Sampler):
    """The specs of the epoch being iterated, set before each iteration."""

    def __init__(self):
        self.specs = []

    def __iter__(self):
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)


def _as_is(batch):
    return batch


class ProcessDataLoader(DataLoader):
    """The threaded ``DataLoader``'s surface over ``num_workers`` worker
    processes (0: in process). ``dataset`` and ``collate`` are pickled to
    the workers once, at the first iteration."""

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 4, **kwargs):
        super().__init__(dataset, batch_size, num_workers=num_workers, **kwargs)
        self.num_workers = max(0, num_workers)
        self._specs = _Specs()
        self._loader: Optional[torch.utils.data.DataLoader] = None

    def _torch_loader(self) -> torch.utils.data.DataLoader:
        if self._loader is None:
            workers = self.num_workers
            self._loader = torch.utils.data.DataLoader(
                _Batches(self), batch_size=None, sampler=self._specs, num_workers=workers,
                collate_fn=_as_is, persistent_workers=workers > 0,
                prefetch_factor=_PREFETCH if workers else None,
                multiprocessing_context=_fork_server() if workers else None)
        return self._loader

    def iter_from(self, skip_batches: int) -> Iterator:
        """Iterate from batch ``skip_batches`` of this epoch; the skipped
        prefix is never decoded."""
        epoch = self._epoch
        self._specs.specs = [(epoch, bi, idxs, valid)
                             for bi, idxs, valid in self._shard_batches(skip_batches)]
        for batch in self._torch_loader():
            yield {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}

    def close(self) -> None:
        """Stops the worker processes (the next iteration starts new ones)."""
        loader, self._loader = self._loader, None
        iterator = getattr(loader, "_iterator", None)
        if iterator is not None and hasattr(iterator, "_shutdown_workers"):
            iterator._shutdown_workers()
