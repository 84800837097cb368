"""SOM-node pooling ops, counterpart of the JAX package's ``ops/segment.py``.

* cluster mean: ``sum(pc * onehot) / detach(count + 1e-5)``, as an
  ``index_add_`` (no (B, N, M) one-hot tensor);
* node max-pool: ``scatter_reduce(amax)`` in the feature dtype, empty
  nodes 0 (max is pure selection, so pooling bf16 features is exact);
* scatter back to points: a gather.
None of these was a Pallas kernel in the JAX package.
"""
from __future__ import annotations

import torch

from .dtypes import widen


def _flat_seg(idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    B = idx.shape[0]
    off = torch.arange(B, device=idx.device, dtype=torch.long)[:, None]
    return (idx.long() + off * num_nodes).reshape(-1)


def node_count(idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """(B, N) node assignment -> (B, M) f32 counts."""
    B = idx.shape[0]
    cnt = torch.zeros(B * num_nodes, dtype=torch.float32, device=idx.device)
    cnt.index_add_(0, _flat_seg(idx, num_nodes),
                   torch.ones(idx.numel(), dtype=torch.float32,
                              device=idx.device))
    return cnt.reshape(B, num_nodes)


def node_mean_and_count(points: torch.Tensor, idx: torch.Tensor,
                        num_nodes: int):
    """(B,N,D) points, (B,N) assignment -> (mean (B,M,D) f32, or f64 for
    f64 points; count (B,M) f32).

    Empty nodes get mean 0; the denominator is detached."""
    B, N, D = points.shape
    points = widen(points)
    total = torch.zeros(B * num_nodes, D, dtype=points.dtype,
                        device=points.device)
    total.index_add_(0, _flat_seg(idx, num_nodes),
                     points.reshape(B * N, D))
    total = total.reshape(B, num_nodes, D)
    count = node_count(idx, num_nodes)
    mean = total / (count.to(total.dtype) + 1e-5).detach()[:, :, None]
    return mean, count


def node_pool_max(features: torch.Tensor, idx: torch.Tensor, num_nodes: int,
                  *, has_points: torch.Tensor | None = None):
    """Max-pool (B,N,C) features into (B,M,C) nodes, in the feature dtype.

    Returns (pooled, has_points (B, M)); rows of empty nodes are 0."""
    B, N, C = features.shape
    seg = _flat_seg(idx, num_nodes)[:, None].expand(B * N, C)
    pooled = torch.zeros(B * num_nodes, C, dtype=features.dtype,
                         device=features.device)
    pooled = pooled.scatter_reduce(0, seg, features.reshape(B * N, C),
                                   reduce="amax", include_self=False)
    pooled = pooled.reshape(B, num_nodes, C)
    if has_points is None:
        has_points = (node_count(idx, num_nodes) > 0).to(features.dtype)
    pooled = torch.where(has_points[:, :, None] > 0, pooled,
                         torch.zeros((), dtype=pooled.dtype,
                                     device=pooled.device))
    return pooled, has_points


def scatter_to_points(node_features: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """Broadcast node features back to points: (B,M,C), (B,N) -> (B,N,C)."""
    B, N = idx.shape
    C = node_features.shape[-1]
    return torch.gather(node_features, 1,
                        idx.long()[:, :, None].expand(B, N, C))
