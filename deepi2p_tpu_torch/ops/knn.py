"""k-nearest-neighbour primitives.

Counterpart of the JAX package's ``ops/knn.py``.  :func:`knn` sends a
CUDA tensor to the hand-written kernel (:mod:`.knn_cuda`, replacing the
Pallas ``knn_pallas``) and a CPU tensor to :func:`knn_plain`, the
kernel's plain PyTorch version.  Both give the same answer: direct
``(db - q)^2`` distances summed over coordinates in order, the ``k``
smallest in increasing distance, ties to the lowest index.

:func:`nn1` is the same for ``k = 1`` against a large database (the ICP
inner loop, the Pallas ``nn1_pallas``): the CUDA kernel streams the
database through shared memory, :func:`nn1_plain` through row chunks.
"""
from __future__ import annotations

import torch

from .knn_cuda import knn_cuda, nn1_cuda

NN1_CHUNK = 512      # database rows per chunk of the plain 1-NN, at most
NN1_BUDGET = 1 << 26  # distances per chunk (256 MB of f32)


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


def nn1_plain(query: torch.Tensor, database: torch.Tensor,
              chunk: int = NN1_CHUNK):
    """Plain version of the 1-NN kernel.

    query (B*Q, N, D), database (B, M, D), f32.  The database is walked in
    pieces of at most ``chunk`` rows and :data:`NN1_BUDGET` distances, so
    memory stays bounded; each piece's (min, first argmin) is folded into
    the running pair with a strict ``<``, rows in increasing index (the
    piece size does not change the answer).  NaN distances sort after
    every number, as in the kernel (all-NaN: d2 NaN, index 0)."""
    S, N, D = query.shape
    B, M, _ = database.shape
    chunk = max(1, min(chunk, NN1_BUDGET // max(S * N, 1)))
    q = query.float().reshape(B, S // B, N, 1, D)
    best = torch.full((B, S // B, N), float("nan"), dtype=torch.float32,
                      device=query.device)
    best_i = torch.zeros((B, S // B, N), dtype=torch.int64,
                         device=query.device)
    for m0 in range(0, M, chunk):
        db = database[:, m0:m0 + chunk].float()[:, None, None]  # (B,1,1,c,D)
        d2 = None
        for d in range(D):
            diff = db[..., d] - q[..., d]
            sq = diff * diff
            d2 = sq if d2 is None else d2 + sq                 # (B,Q,N,c)
        nan = torch.isnan(d2)
        cmin = torch.where(nan, float("inf"), d2).amin(dim=-1)
        has = ~nan.all(dim=-1)
        cmin = torch.where(has, cmin, float("nan"))
        carg = torch.argmax((d2 == cmin[..., None]).to(torch.uint8), dim=-1)
        better = (cmin < best) | (torch.isnan(best) & has)
        best = torch.where(better, cmin, best)
        best_i = torch.where(better, carg + m0, best_i)
    return best.reshape(S, N), best_i.reshape(S, N).to(torch.int32)


def nn1(query: torch.Tensor, database: torch.Tensor):
    """Nearest database point of every query, for large databases.

    Args:
      query: (B*Q, N, D) -- Q query sets per database, set s against
        database s // Q; database: (B, M, D), any M; any float dtype
        (cast to f32).
    Returns:
      (d2 (B*Q, N) f32, idx (B*Q, N) int32), exact; ties to the lowest
      index.  CUDA tensors go to the kernel, CPU tensors to
      :func:`nn1_plain`.
    """
    with torch.no_grad():
        q = query.float().contiguous()
        db = database.float().contiguous()
        if q.device.type == "cpu":
            return nn1_plain(q, db)
        return nn1_cuda(q, db)


def gather_knn(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,M,C) features, (B,N,k) indices -> (B,N,k,C)."""
    B, N, k = idx.shape
    flat = idx.reshape(B, N * k).long()
    out = torch.gather(features, 1,
                       flat[:, :, None].expand(B, N * k, features.shape[-1]))
    return out.reshape(B, N, k, features.shape[-1])
