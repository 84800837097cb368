"""k-nearest-neighbour primitives.

Counterpart of the JAX package's ``ops/knn.py``.  :func:`knn` sends a
CUDA tensor to the hand-written kernel (:mod:`.knn_cuda`, replacing the
Pallas ``knn_pallas``) and a CPU tensor to :func:`knn_plain`, the
kernel's plain PyTorch version.  Both give the same answer: direct
``(db - q)^2`` distances summed over coordinates in order, the ``k``
smallest in increasing distance, ties to the lowest index.
"""
from __future__ import annotations

import torch

from .knn_cuda import knn_cuda


def pairwise_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B,N,D), (B,M,D) -> (B,N,M) squared distances, f32.

    Direct differences, coordinate by coordinate (never the
    ``|x|^2+|y|^2-2xy`` form): each product and sum rounds exactly as the
    CUDA kernel's do."""
    x = x.float()
    y = y.float()
    d2 = None
    for d in range(x.shape[-1]):
        diff = y[:, None, :, d] - x[:, :, None, d]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def knn_plain(query: torch.Tensor, database: torch.Tensor, k: int):
    """Plain version of the kNN kernel: a stable sort (``torch.topk``
    leaves the order of ties undefined; NaN sorts last)."""
    d2 = pairwise_dist2(query, database)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].to(torch.int32)


def knn(query: torch.Tensor, database: torch.Tensor, k: int):
    """Indices and squared distances of the ``k`` nearest database points.

    Args:
      query: (B, N, D); database: (B, M, D), any float dtype (cast to f32).
    Returns:
      (d2 (B,N,k) f32, idx (B,N,k) int32), nearest first.  No gradient:
      every call site consumes coordinates, as in the JAX package.
    """
    with torch.no_grad():
        q = query.float().contiguous()
        db = database.float().contiguous()
        if q.device.type == "cpu":
            return knn_plain(q, db, k)
        return knn_cuda(q, db, k)


def gather_knn(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,M,C) features, (B,N,k) indices -> (B,N,k,C)."""
    B, N, k = idx.shape
    flat = idx.reshape(B, N * k).long()
    out = torch.gather(features, 1,
                       flat[:, :, None].expand(B, N * k, features.shape[-1]))
    return out.reshape(B, N, k, features.shape[-1])
