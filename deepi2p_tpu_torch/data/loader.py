"""Ordered batching over an indexable dataset: the JAX package's
``data/prefetch.py::BatchLoader`` with ``shuffle=False`` and one worker.
Batches are stacked numpy arrays, in index order; the last partial batch
is dropped, as the JAX loader's default does.  The threaded loader with
pinned memory comes with the data slice (``ROADMAP.md`` A.11)."""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        for start in range(0, len(self) * bs, bs):
            yield collate([self.dataset[i] for i in range(start, start + bs)])
