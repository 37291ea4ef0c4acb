"""Data loading: Subset, collation, batched loaders with background
prefetch.

The port's copy of garment_pattern_estimation_tpu/data/loader.py:1-156.
Samples stay numpy; `default_collate` stacks them with numpy and hands the
batch over as torch CPU tensors (strings collect into lists), which the
trainer moves to the device. An optional prefetch thread overlaps host-side
sample assembly with device compute.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class Subset:
    """A view over a dataset restricted to `indices`."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(int(i) for i in indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def default_collate(samples):
    """Stack a list of sample dicts into a batch dict (recursively): arrays
    become torch CPU tensors of the stacked numpy array's dtype."""
    if not samples:
        raise ValueError('default_collate::empty batch')
    first = samples[0]
    if isinstance(first, dict):
        return {key: default_collate([s[key] for s in samples]) for key in first}
    if isinstance(first, str):
        return [s for s in samples]
    return torch.from_numpy(np.stack([np.asarray(s) for s in samples]))


def _pinned(batch):
    """The batch with every tensor in page-locked memory."""
    if isinstance(batch, dict):
        return {key: _pinned(value) for key, value in batch.items()}
    return batch.pin_memory() if isinstance(batch, torch.Tensor) else batch


class DataLoader:
    """Batched iteration over a dataset/Subset.

    * `batch_sampler`: iterable of index lists (overrides batch_size/shuffle)
    * `shuffle`: fresh permutation per epoch from its own RNG
    * `prefetch`: assemble the next batch on a worker thread while the
      current one is being consumed
    * `pin_memory`: hand the batch's tensors over in page-locked memory,
      so that a copy to the card with `non_blocking=True` does not wait
      for the card's queue (the port's own addition; the trainer turns it
      on for a CUDA device)
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, batch_sampler=None,
                 drop_last=False, collate_fn=default_collate, prefetch=1, seed=None,
                 pin_memory=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.batch_sampler = batch_sampler
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self._rng = np.random.default_rng(seed)

    def _batches(self):
        if self.batch_sampler is not None:
            yield from iter(self.batch_sampler)
            return
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = self._rng.permutation(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk.tolist()

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        return _LoaderIter(self)


class _LoaderIter:
    """Loader iterator with per-batch error surfacing and clean shutdown.

    An exception raised while assembling batch i (e.g.
    InvalidPatternDefError from the pattern codec) is raised from that
    next() call and iteration CONTINUES with batch i+1 — callers that
    catch-and-continue per batch (train/eval_utils.py, mirroring the
    reference's skip-bad-batch eval loop) see one bad batch, not a
    terminated epoch. A consumer that abandons iteration early stops the
    prefetch worker instead of leaving it blocked on a full queue."""

    _END = object()

    def __init__(self, loader):
        self._loader = loader
        self._batches = loader._batches()
        self._prefetching = bool(loader.prefetch and loader.prefetch > 0)
        if self._prefetching:
            self._q = queue.Queue(maxsize=loader.prefetch)
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def __iter__(self):
        return self

    def _assemble(self, ids):
        batch = self._loader.collate_fn([self._loader.dataset[i] for i in ids])
        return _pinned(batch) if self._loader.pin_memory else batch

    def _put(self, item):
        """Bounded put that gives up when the consumer is gone."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for ids in self._batches:
                if self._stop.is_set():
                    return
                try:
                    item = ('ok', self._assemble(ids))
                except BaseException as e:  # noqa: BLE001 — forwarded per batch
                    item = ('err', e)
                if not self._put(item):
                    return
        finally:
            self._put(('end', self._END))

    def __next__(self):
        if self._prefetching:
            kind, payload = self._q.get()
            if kind == 'end':
                raise StopIteration
            if kind == 'err':
                raise payload
            return payload
        ids = next(self._batches)  # StopIteration ends iteration
        return self._assemble(ids)  # assembly errors surface; iterator lives

    def close(self):
        if self._prefetching:
            self._stop.set()

    def __del__(self):
        self.close()
