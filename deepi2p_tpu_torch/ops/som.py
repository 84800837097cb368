"""SOM node assignment with the API of the reference's ``util/som.py:5-42``,
counterpart of the JAX package's ``ops/som.py``.  The neighbours come from
the port's :func:`~.knn.knn`, so on the card they are the kNN kernel's."""
from __future__ import annotations

import torch

from .knn import knn


def query_topk(node: torch.Tensor, x: torch.Tensor, M: int, k: int):
    """Args:
      node: (B, M, 3) SOM nodes; x: (B, N, 3) points.
    Returns:
      mask (B, kN, M) f32 one-hot of the assigned node per expanded point,
      mask_row_max (B, M) f32, 1 where a node has any point among the
      k-NN hits, min_idx (B, kN) int32 the k nearest node indices, rank by
      rank (all rank-0 indices, then rank-1, ...; ``util/som.py:24-30``).
    """
    _, idx = knn(x, node, k)                       # (B, N, k), nearest first
    min_idx = torch.cat([idx[:, :, i] for i in range(k)], dim=1)
    mask = torch.nn.functional.one_hot(min_idx.long(), M).to(torch.float32)
    mask_row_max = (mask.sum(dim=1) > 0).to(torch.float32)
    return mask, mask_row_max, min_idx
