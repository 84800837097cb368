"""Wrappers of the CUDA kNN kernels (``csrc/knn.cu``, ``csrc/nn1.cu``).

Counterparts of the JAX package's ``ops/knn_pallas.py::knn_pallas`` and
``nn1_pallas``.  Each wrapper checks its inputs, allocates the outputs and
launches on the current stream; ``knn_cuda.launches`` and
``nn1_cuda.launches`` count the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

MAX_M = 512      # database rows staged in shared memory
MAX_D = 8
MAX_K = 16       # register list capacity (the main path uses 3 and 16)
MAX_SETS = 65535  # query sets of one nn1 launch (the grid's y extent)

# The 1-NN kernel's own sizes (csrc/nn1.cu): NN1_THREADS threads per
# block, rows per tracked tile (the rescan's length) and per streamed tile.
_NN1 = _build.constants("nn1.cu")
NN1_THREADS, NN1_TRACK, NN1_TILE = (_NN1["kThreads"], _NN1["kTrack"],
                                    _NN1["kTile"])


class NN1Plan(NamedTuple):
    qt: int          # queries per thread
    chunk: int       # queries per chunk: NN1_THREADS * qt
    chunks: int      # chunks per database
    blocks: int      # blocks per database
    resident: bool   # the database stays in shared memory


class NN1Card(NamedTuple):
    """What :func:`nn1_plan` needs of the card, for one database shape."""
    sms: int         # SMs
    block_smem: int  # the most shared memory one block may take
    per_sm: int      # resident blocks one SM holds (0: does not fit)


@functools.lru_cache(maxsize=None)
def nn1_card(device_index: int, D: int, M: int) -> NN1Card:
    """The current card's :class:`NN1Card` for databases of M rows of D
    coordinates, from the CUDA runtime (``nn1_limits``)."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        _build.check(_build.load_library().nn1_limits(D, M, out),
                     "nn1_limits")
    return NN1Card(*out)


def nn1_plan(S: int, N: int, M: int, D: int, B: int,
             card: NN1Card) -> NN1Plan:
    """The 1-NN kernel's launch for S query sets of N points against B
    databases of M rows of D coordinates, on ``card``.

    A thread keeps 16 queries (8 for D > 4), a chunk is a block's worth
    of queries, and a database's Q N queries (Q = S / B) are its chunks.  A
    database of 16-byte rows (32 for D > 4) that fits a block's shared
    memory stays there: then as many blocks run as the card holds at once
    (``card.per_sm`` per SM), each walking an equal share of its
    database's chunks.  At the ICP launch (512 sets of 20480 against 8
    clouds of 5120) on an H100 (132 SMs, two blocks of 238 registers per
    thread per SM) that is 32 blocks of 20 chunks per cloud, 256 blocks of
    4 warps and 80 KB on 264 places.  Otherwise one block per chunk
    streams the database."""
    qt = 16 if D <= 4 else 8
    row_bytes = 16 if D <= 4 else 32
    chunk = NN1_THREADS * qt
    chunks = -(-(S // B) * N // chunk)
    if M * row_bytes > card.block_smem or card.per_sm < 1:
        return NN1Plan(qt, chunk, chunks, chunks, False)
    per_block = -(-B * chunks // (card.sms * card.per_sm))
    return NN1Plan(qt, chunk, chunks, -(-chunks // per_block), True)


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
    query with only NaN distances gets NaN and index 0).  The launch is
    :func:`nn1_plan`'s."""
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
    plan = nn1_plan(S, N, M, D, B,
                    nn1_card(query.device.index or 0, D, M))
    code = lib.nn1_f32(query.data_ptr(), database.data_ptr(), d2.data_ptr(),
                       idx.data_ptr(), S, N, M, D, S // B, plan.qt,
                       plan.blocks, int(plan.resident), stream)
    _build.check(code, "nn1_f32")
    nn1_cuda.launches += 1
    return d2, idx


nn1_cuda.launches = 0
