"""ICP's iteration around the 1-NN on the card (``csrc/icp.cu``): the
wrappers.

:func:`transform` moves every pair's source cloud by each of its inits'
poses into one reused buffer, bitwise ``icp._transform``.  :func:`update`
takes the 1-NN's ``d2`` and ``idx`` as they are, sums the inlier moments
in float64 and solves the 3x3 weighted Kabsch in float64 (a one-sided
Jacobi SVD), one block a query set, and writes the new poses in place.
Neither waits for the host.  ``register/icp.py::_icp_solve`` runs them on
CUDA tensors; the CPU keeps its own code (``_icp_solve_plain``).

Poses travel as rows of 12 float32 (:func:`pose_rows`): R row-major, then
t.  The update gathers from the target clouds padded to 16-byte rows
(:func:`pad_rows`), made once a solve.  ``launches`` counts the kernels'
launches: two an iteration (the transform and the update) and one for
the fitness pass's transform.

The plain version is ``icp._kabsch`` on the same inliers: run in float64,
it gives the update's float64 R and t (``stats``) to float64 rounding
(the card tests).
"""
from __future__ import annotations

import torch

from .. import _build

_K = _build.constants("icp.cu")
SUMS = _K["kSums"]          # W, sum src (3), sum dst (3), sum src dst^T (9)
STATS = _K["kStats"]        # those, then the solve's R (9) and t (3)
MIN_INLIERS = _K["kMinInliers"]
MAX_BLOCKS_Y = 65535

launches = 0


def pose_rows(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3), t (..., 3) -> contiguous (prod(...), 12) float32."""
    lead = R.shape[:-2]
    return torch.cat([R.reshape(*lead, 9), t.reshape(*lead, 3)],
                     dim=-1).reshape(-1, 12).float().contiguous()


def pad_rows(target: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) -> contiguous (B, M, 4) float32, each point (x, y, z, 0):
    the update reads a target point in one 16-byte load."""
    return torch.nn.functional.pad(target.float(), (0, 1)).contiguous()


def _check(name: str, shapes: dict, dtypes: dict, device,
           vectors=("rt", "tgt4")) -> None:
    """Shapes, dtypes, contiguity and the 16-byte alignment of the tensors
    the kernels read as float4 (``vectors``), then one CUDA device, so
    that each refusal can be shown without a card.  The others are read
    element by element: a view at any offset will do."""
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
    for key, (t, want) in dtypes.items():
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
    for key, (t, _) in shapes.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in vectors and t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    for key, (t, _) in shapes.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} needs every tensor on one CUDA device "
                             f"({key} is on {t.device})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def transform(src: torch.Tensor, rt: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """``out[b I + i] = R src[b] + t`` for pose row ``b I + i``:
    src (B, N, 3), rt (B I, 12), out (B I, N, 3), float32 on one card.
    Bitwise ``icp._transform``."""
    global launches
    if src.dim() != 3 or rt.dim() != 2 or src.shape[0] == 0 \
            or rt.shape[0] % max(src.shape[0], 1) != 0:
        raise ValueError(f"transform: src (B, N, 3) and rt (B*I, 12), got "
                         f"{tuple(src.shape)} and {tuple(rt.shape)}")
    B, N = src.shape[:2]
    S = rt.shape[0]
    f32 = torch.float32
    _check("transform", {"src": (src, (B, N, 3)), "rt": (rt, (S, 12)),
                         "out": (out, (S, N, 3))},
           {"src": (src, f32), "rt": (rt, f32), "out": (out, f32)},
           src.device)
    if B > MAX_BLOCKS_Y:
        raise ValueError(f"transform: at most {MAX_BLOCKS_Y} pairs, got {B}")
    if N == 0 or S == 0:
        return out
    lib = _build.load_library()
    _build.check(lib.icp_transform_f32(src.data_ptr(), rt.data_ptr(),
                                       out.data_ptr(), B, S // B, N,
                                       _stream(src)), "icp_transform_f32")
    launches += 1
    return out


def update(src: torch.Tensor, tgt4: torch.Tensor, d2: torch.Tensor,
           idx: torch.Tensor, rt: torch.Tensor, thr: float,
           stats=None) -> torch.Tensor:
    """One ICP update of every query set, in place on ``rt``.

    src (B, N, 3), tgt4 (B, M, 4) float32 (:func:`pad_rows`); d2 (B I, N)
    float32 and idx (B I, N) int32 as ``nn1`` returns them; rt (B I, 12)
    the poses.
    Inliers: ``sqrt(d2) < thr``; where a set has fewer than
    :data:`MIN_INLIERS`, its pose stays.  ``stats`` (B I, :data:`STATS`)
    float64, optional: the set's moments and the solve's float64 R and t
    (written whether or not the pose is kept), for tests."""
    global launches
    if src.dim() != 3 or tgt4.dim() != 3 or rt.dim() != 2 \
            or src.shape[0] == 0 or rt.shape[0] % max(src.shape[0], 1) != 0:
        raise ValueError(f"update: src (B, N, 3), tgt4 (B, M, 4), rt "
                         f"(B*I, 12), got {tuple(src.shape)}, "
                         f"{tuple(tgt4.shape)}, {tuple(rt.shape)}")
    B, N = src.shape[:2]
    M, S = tgt4.shape[1], rt.shape[0]
    f32 = torch.float32
    shapes = {"src": (src, (B, N, 3)), "tgt4": (tgt4, (B, M, 4)),
              "d2": (d2, (S, N)), "idx": (idx, (S, N)), "rt": (rt, (S, 12))}
    dtypes = {"src": (src, f32), "tgt4": (tgt4, f32), "d2": (d2, f32),
              "idx": (idx, torch.int32), "rt": (rt, f32)}
    if stats is not None:
        shapes["stats"] = (stats, (S, STATS))
        dtypes["stats"] = (stats, torch.float64)
    _check("update", shapes, dtypes, src.device)
    if M == 0:
        raise ValueError("update: the target clouds are empty")
    if N == 0 or S == 0:
        return rt
    lib = _build.load_library()
    _build.check(lib.icp_update_f32(
        src.data_ptr(), tgt4.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        rt.data_ptr(), 0 if stats is None else stats.data_ptr(), B, S // B,
        N, M, float(thr), _stream(src)), "icp_update_f32")
    launches += 1
    return rt
