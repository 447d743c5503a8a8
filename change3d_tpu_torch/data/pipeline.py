"""Input pipeline (counterpart of ``change3d_tpu/data/pipeline.py``):
threaded decode/augment workers and a double-buffered copy to the card.

The batch order is the JAX loader's: the epoch's permutation is
``np.random.RandomState(seed + epoch)``, every sample draws its augmentation
from ``np.random.default_rng((seed, epoch, batch, slot))`` with the global
batch index, training drops the incomplete final batch and eval pads it
(repeating the last index) with a ``valid`` mask. So batch k of an epoch is
the same whether the epoch started at 0 or was resumed at k
(``DataLoader.iter_from``).

Multi-process runs shard it as JAX does: ``batch_size`` is the global batch,
every process computes the same global batches and decodes only its
contiguous ``batch_size // num_shards`` slice of each, and a sample's rng is
seeded by its global slot, so the global batch of a sharded run is sample
for sample the single-process batch. ``make_data_loader`` shards by process
when a process group of more than one process is up, and gives the
worker-process loader (``data/process_pipeline.py``) for 'grain'.
"""

from __future__ import annotations

import collections
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from change3d_tpu_torch.parallel import distributed

# Batches the workers may assemble ahead of the consumer.
_PREFETCH = 4


class DataLoader:
    """Deterministic, seedable batch loader with background worker threads.

    ``dataset`` exposes ``__len__`` and ``__getitem__(idx, rng)``; batches
    are what ``collate`` makes of a list of samples (a dict of stacked numpy
    arrays). With ``num_shards`` > 1 it yields this shard's slice of every
    global batch of ``batch_size``; a ragged final batch cannot be split, so
    sharding needs ``drop_last`` or ``pad_final``."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False, seed: int = 16,
                 drop_last: Optional[bool] = None, num_workers: int = 4, pad_final: bool = False,
                 collate: Optional[Callable] = None, num_shards: int = 1, shard_index: int = 0):
        if batch_size % max(num_shards, 1) != 0:
            raise ValueError(
                f"global batch_size {batch_size} must divide over {num_shards} processes")
        drop_last = shuffle if drop_last is None else drop_last
        if num_shards > 1 and not (drop_last or pad_final):
            raise ValueError(
                "sharded DataLoader needs drop_last=True or pad_final=True "
                "(a ragged final batch cannot be split across processes)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.pad_final = pad_final
        self.collate = collate or pair_collate
        self.num_shards = max(num_shards, 1)
        self.shard_index = shard_index
        self.local_batch_size = batch_size // self.num_shards
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last and not self.pad_final:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        batches = []
        for i in range(0, n, self.batch_size):
            idxs = order[i:i + self.batch_size]
            if len(idxs) < self.batch_size:
                if self.drop_last and not self.pad_final:
                    break
                if self.pad_final:
                    pad = np.full(self.batch_size - len(idxs), idxs[-1])
                    batches.append((np.concatenate([idxs, pad]), len(idxs)))
                    continue
            batches.append((idxs, len(idxs)))
        return batches

    def __iter__(self) -> Iterator:
        return self.iter_from(0)

    def _shard_batches(self, skip_batches: int):
        """(global batch index, this shard's sample indices, valid count) of
        every batch of the epoch from ``skip_batches`` on."""
        lo = self.shard_index * self.local_batch_size
        hi = lo + self.local_batch_size
        batches = [(bi, idxs[lo:hi], valid)
                   for bi, (idxs, valid) in enumerate(self._index_batches())]
        if skip_batches and skip_batches >= len(batches):
            raise RuntimeError(
                f"resume checkpoint is ahead of the dataset: cannot skip "
                f"{skip_batches} of {len(batches)} batches (did the train "
                f"split shrink since the preemption save?)"
            )
        return batches[skip_batches:]

    def iter_from(self, skip_batches: int) -> Iterator:
        """Iterate from batch ``skip_batches`` of this epoch; the skipped
        prefix is never decoded."""
        lo = self.shard_index * self.local_batch_size
        hi = lo + self.local_batch_size
        batches = self._shard_batches(skip_batches)
        out_q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()
        epoch = self._epoch

        def load_sample(bi, j, idx):
            rng = np.random.default_rng((self.seed, epoch, bi, j))
            return self.dataset.__getitem__(int(idx), rng)

        def offer(item) -> bool:
            """Blocking put that gives up when the consumer has gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                # A window of two batches of sample futures keeps decode ahead
                # of assembly; bi is the epoch's global batch index.
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    window: "deque" = deque()
                    it = iter(batches)

                    def submit():
                        nxt = next(it, None)
                        if nxt is not None:
                            bi, idxs, valid = nxt
                            window.append(([pool.submit(load_sample, bi, lo + j, idx)
                                            for j, idx in enumerate(idxs)], valid))

                    submit()
                    submit()
                    while window and not stop.is_set():
                        futs, valid = window.popleft()
                        samples = [f.result() for f in futs]
                        submit()
                        batch = self.collate(samples)
                        if self.pad_final:
                            # By global position, cut to this shard's rows.
                            batch["valid"] = (np.arange(self.batch_size) < valid)[lo:hi]
                        if not offer(batch):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                offer(e)
            finally:
                offer(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


LOADERS = ("threaded", "grain")


def make_data_loader(kind: str, dataset, batch_size: int, **kwargs) -> DataLoader:
    """Loader factory: ``kind`` is 'threaded' (this module's DataLoader) or
    'grain', which on the port is the worker-process loader
    (``data/process_pipeline.py``, the counterpart of the JAX package's
    grain loader). Both have the same surface and batches. Under a process
    group of more than one process the loader is sharded by process unless
    ``num_shards`` is given."""
    if kind not in LOADERS:
        raise ValueError(f"unknown loader kind: {kind!r} (expected one of {LOADERS})")
    if "num_shards" not in kwargs and distributed.world_size() > 1:
        kwargs.update(num_shards=distributed.world_size(), shard_index=distributed.rank())
    if kind == "grain":
        from change3d_tpu_torch.data.process_pipeline import ProcessDataLoader

        return ProcessDataLoader(dataset, batch_size, **kwargs)
    return DataLoader(dataset, batch_size, **kwargs)


def pair_collate(samples) -> Dict[str, np.ndarray]:
    """(image [H,W,6], label [H,W,C]) samples -> {'pre', 'post', 'label'}."""
    imgs = np.stack([s[0] for s in samples])
    labels = np.stack([s[1] for s in samples])
    return {
        "pre": np.ascontiguousarray(imgs[..., 0:3]),
        "post": np.ascontiguousarray(imgs[..., 3:6]),
        "label": labels,
    }


def caption_collate(samples) -> Dict[str, np.ndarray]:
    """CaptionDataset samples -> {'pre', 'post', 'caption', 'length'[,
    'all_captions']}."""
    out = {k: np.stack([s[k] for s in samples]) for k in ("pre", "post", "caption")}
    out["length"] = np.asarray([s["length"] for s in samples], np.int32)
    if "all_captions" in samples[0]:
        out["all_captions"] = np.stack([s["all_captions"] for s in samples])
    return out


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; on the card through pinned host
    memory with a non-blocking copy."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_prefetch(iterator, device: torch.device, depth: int = 2):
    """Start the copies of the next ``depth`` batches before yielding one,
    so batch N+1's copy overlaps step N."""
    buf = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(to_device(batch, device))
        if len(buf) == depth:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(to_device(nxt, device))
        yield out
