"""Ball query: the first ``k`` neighbours within a radius, cyclically
padded; counterpart of the JAX package's ``ops/ball_query.py`` (the
reference's ``ball_query`` CUDA extension,
``models/ball_query_ext/ball_query_cuda.cu:23-47``, which the reference
builds but never imports).

For each query row of a distance matrix: the indices of the first ``k``
database entries with ``dist < radius``, in index order; fewer than ``k``
are repeated cyclically; none gives zeros.  Plain PyTorch on every
device (the JAX package's is XLA, not Pallas).
"""
from __future__ import annotations

import torch


def ball_query(dist: torch.Tensor, radius: float, k: int) -> torch.Tensor:
    """dist (B, M, N) -> indices (B, M, k) int32."""
    B, M, N = dist.shape
    inside = dist < radius
    rank = torch.cumsum(inside.to(torch.int64), dim=-1) - 1
    take = inside & (rank < k)
    col = torch.arange(N, device=dist.device).expand(B, M, N)
    # slot rank <- column of the rank-th hit; everything else to slot k
    slot = torch.where(take, rank, torch.full_like(rank, k))
    slots = torch.zeros(B, M, k + 1, dtype=torch.int64, device=dist.device)
    slots = slots.scatter_reduce(-1, slot, torch.where(take, col, 0), "amax")
    count = inside.sum(dim=-1)
    wrapped = torch.arange(k, device=dist.device) % torch.clamp(
        count, min=1)[..., None]
    out = torch.gather(slots[..., :k], -1, wrapped)
    return torch.where(count[..., None] > 0, out, 0).to(torch.int32)
