"""Balanced batch sampling: every batch preserves the garment-type mix.

Counterpart of nn/data/utils.py:16-92 — proportional per-type quota + random
fill, in-batch shuffle, drop-last by default.

The port's copy of garment_pattern_estimation_tpu/data/sampler.py:1-71.
"""
from __future__ import annotations

import numpy as np


class BalancedBatchSampler:
    """Yields batches (lists of subset-local indices) with per-type
    proportions matching the overall subset composition."""

    def __init__(self, ids_by_type, batch_size=10, drop_last=True, seed=None):
        if len(ids_by_type) > batch_size:
            raise NotImplementedError(
                f'{self.__class__.__name__}::Error::batches smaller than the '
                'number of data classes are not supported')

        self.data_ids_by_type = {
            cls: list(np.asarray(ids).tolist()) for cls, ids in ids_by_type.items()
        }
        self.class_names = list(self.data_ids_by_type.keys())
        self.batch_size = batch_size
        self.data_size = sum(len(v) for v in self.data_ids_by_type.values())
        self.num_full_batches = self.data_size // batch_size

        last_batch_len = self.data_size - self.batch_size * self.num_full_batches
        self.drop_last = drop_last or last_batch_len == 0

        self.batch_len_per_type = {
            cls: int(len(ids) / self.data_size * batch_size)
            for cls, ids in self.data_ids_by_type.items()
        }
        if sum(self.batch_len_per_type.values()) > self.batch_size:
            raise RuntimeError(
                f'{self.__class__.__name__}::Error::failed to evaluate '
                'per-type length correctly')
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        pools = {cls: list(ids) for cls, ids in self.data_ids_by_type.items()}
        for pool in pools.values():
            self._rng.shuffle(pool)

        batches = []
        for _ in range(self.num_full_batches):
            batch = []
            for cls in self.class_names:
                for _ in range(self.batch_len_per_type[cls]):
                    if not pools[cls]:
                        break
                    batch.append(pools[cls].pop())
            while len(batch) < self.batch_size:
                non_empty = [c for c in self.class_names if pools[c]]
                if not non_empty:
                    break
                chosen = non_empty[int(self._rng.integers(len(non_empty)))]
                batch.append(pools[chosen].pop())
            self._rng.shuffle(batch)
            batches.append(batch)

        if not self.drop_last:
            batch = [i for pool in pools.values() for i in pool]
            self._rng.shuffle(batch)
            batches.append(batch)
        return iter(batches)

    def __len__(self):
        return self.num_full_batches + (not self.drop_last)
