"""Batching over an indexable dataset: the JAX package's
``data/prefetch.py::BatchLoader`` with one worker.  Batches are stacked
numpy arrays; with ``shuffle`` the order is
``np.random.default_rng(seed).shuffle`` of the indices, as in the JAX
loader, so one seed gives one order in both packages.  The last partial
batch is dropped, as every caller of the JAX loader has it.  Worker
threads and pinned memory come with the data slice (``ROADMAP.md``
A.11)."""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        bs = self.batch_size
        for b in range(len(self)):
            yield collate([self.dataset[int(i)]
                           for i in order[b * bs:(b + 1) * bs]])
