"""Wrappers of the CUDA kNN kernels (``csrc/knn.cu``, ``csrc/nn1.cu``).

Counterparts of the JAX package's ``ops/knn_pallas.py::knn_pallas`` and
``nn1_pallas``.  Each wrapper checks its inputs, allocates the outputs and
launches on the current stream; ``knn_cuda.launches`` and
``nn1_cuda.launches`` count the launches.
"""
from __future__ import annotations

import torch

from .. import _build

MAX_M = 512      # database rows staged in shared memory
MAX_D = 8
MAX_K = 16       # register list capacity (the main path uses 3 and 16)
MAX_SETS = 65535  # query sets of one nn1 launch (the grid's y extent)


def _check_pair(name, query, database):
    if query.device.type != "cuda" or database.device != query.device:
        raise ValueError(f"{name} needs both tensors on one CUDA device")
    if query.dtype != torch.float32 or database.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tensors")
    if not (query.is_contiguous() and database.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def knn_cuda(query: torch.Tensor, database: torch.Tensor, k: int):
    """Exact kNN on the card: (B,N,D), (B,M,D) f32 -> d2 (B,N,k) f32 and
    idx (B,N,k) int32, nearest first, ties to the lowest index, NaN
    distances last (written as NaN)."""
    _check_pair("knn_cuda", query, database)
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


def nn1_cuda(query: torch.Tensor, database: torch.Tensor):
    """Exact 1-NN on the card: query (B*Q, N, D) f32 against database
    (B, M, D) f32, query set s against database s // Q, any M.  Returns
    d2 (B*Q, N) f32 and idx (B*Q, N) int32: the smallest direct (db-q)^2
    sum, ties to the lowest index, NaN distances after every number (a
    query with only NaN distances gets NaN and index 0)."""
    _check_pair("nn1_cuda", query, database)
    S, N, D = query.shape
    B, M, Dd = database.shape
    if Dd != D or B == 0 or S % B != 0:
        raise ValueError(f"shape mismatch: {tuple(query.shape)} vs "
                         f"{tuple(database.shape)} (query sets must be a "
                         f"multiple of the databases)")
    if not (0 < M and 0 < D <= MAX_D and S <= MAX_SETS):
        raise ValueError(f"nn1_cuda supports M>0, D<={MAX_D}, "
                         f"{MAX_SETS} query sets; got M={M}, D={D}, S={S}")
    d2 = torch.empty((S, N), dtype=torch.float32, device=query.device)
    idx = torch.empty((S, N), dtype=torch.int32, device=query.device)
    if N == 0 or S == 0:
        return d2, idx
    lib = _build.load_library()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    code = lib.nn1_f32(query.data_ptr(), database.data_ptr(), d2.data_ptr(),
                       idx.data_ptr(), S, N, M, D, S // B, stream)
    _build.check(code, "nn1_f32")
    nn1_cuda.launches += 1
    return d2, idx


nn1_cuda.launches = 0
