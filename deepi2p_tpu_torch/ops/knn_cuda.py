"""Wrapper of the CUDA kNN kernel (``csrc/knn.cu``).

Counterpart of the JAX package's ``ops/knn_pallas.py::knn_pallas``.  The
wrapper checks its inputs, allocates the outputs and launches on the
current stream; ``knn_cuda.launches`` counts its launches.
"""
from __future__ import annotations

import torch

from .. import _build

MAX_M = 512      # database rows staged in shared memory
MAX_D = 8
MAX_K = 16       # register list capacity (the main path uses 3 and 16)


def knn_cuda(query: torch.Tensor, database: torch.Tensor, k: int):
    """Exact kNN on the card: (B,N,D), (B,M,D) f32 -> d2 (B,N,k) f32 and
    idx (B,N,k) int32, nearest first, ties to the lowest index."""
    if query.device.type != "cuda" or database.device != query.device:
        raise ValueError("knn_cuda needs both tensors on one CUDA device")
    if query.dtype != torch.float32 or database.dtype != torch.float32:
        raise TypeError("knn_cuda takes float32 tensors")
    if not (query.is_contiguous() and database.is_contiguous()):
        raise ValueError("knn_cuda takes contiguous tensors")
    B, N, D = query.shape
    Bd, M, Dd = database.shape
    if Bd != B or Dd != D:
        raise ValueError(f"shape mismatch: {tuple(query.shape)} vs "
                         f"{tuple(database.shape)}")
    if not (0 < M <= MAX_M and 0 < D <= MAX_D and 0 < k <= min(M, MAX_K)
            and B <= 65535):
        raise ValueError(f"knn_cuda supports M<={MAX_M}, D<={MAX_D}, "
                         f"k<=min(M,{MAX_K}), B<=65535; got M={M}, D={D}, "
                         f"k={k}, B={B}")
    d2 = torch.empty((B, N, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
    if N == 0 or B == 0:
        return d2, idx
    lib = _build.load_library()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    code = lib.knn_f32(query.data_ptr(), database.data_ptr(), d2.data_ptr(),
                       idx.data_ptr(), B, N, M, D, k, stream)
    _build.check(code, "knn_f32")
    knn_cuda.launches += 1
    return d2, idx


knn_cuda.launches = 0
