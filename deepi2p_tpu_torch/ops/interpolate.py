"""Inverse-distance feature interpolation, counterpart of the JAX
package's ``ops/interpolate.py``.

Weights are the reference's ``1 - d / sum_k(d)`` (not ``1/d``; with k=3
they sum to 2), with the sqrt clamped at 1e-12.  The k weights of a query
are scattered into a dense (B, N, M) matrix, so duplicate indices sum, and
the combination is one batched matmul, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .knn import gather_knn


def _weights(query, database, topk_idx, dist2: Optional[torch.Tensor]):
    if dist2 is None:
        nb = gather_knn(database.float(), topk_idx)
        dist2 = torch.sum((query.float()[:, :, None, :] - nb) ** 2, dim=-1)
    d = torch.sqrt(torch.clamp(dist2.float(), min=1e-12))
    return 1.0 - d / torch.sum(d, dim=2, keepdim=True)      # (B, N, k)


def interpolate_inverse_dist(query: torch.Tensor, database: torch.Tensor,
                             database_features: torch.Tensor,
                             topk_idx: torch.Tensor,
                             dist2: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(B,N,3) query, (B,M,3) database, (B,M,C) features, (B,N,k) indices
    [, (B,N,k) squared distances] -> (B,N,C) in the features' dtype."""
    w = _weights(query, database, topk_idx, dist2)
    feat = database_features
    B, N, _ = w.shape
    M = feat.shape[1]
    wd = torch.zeros(B, N, M, dtype=torch.float32, device=w.device)
    wd.scatter_add_(2, topk_idx.long(), w)
    return torch.bmm(wd.to(feat.dtype), feat)
